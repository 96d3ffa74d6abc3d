"""One run of one cell: set-up, the warm episode, the measured window of fixed
episodes, the traced steps, the reference comparison and the metrics.

Traffic is fixed episodes. Set-up builds the cell's initial state through
the program's entry (`create_simulation(..., device, backend="auto")`) and
moves each particle by the seeded jitter; the warm-up runs whole episodes
until one runs without growing the capacity (any growth and split deferral
happen there, at most three episodes). Every episode then restarts from that initial state, padded to the capacity the warm-up
reached, with the step count reset, and the window steps episode after
episode until `seconds` have passed. A step is one operation: `attempted`
counts the steps started in the window, `failed` those that raised
SimulationFailed or broke the solver contract (benchlib/contract.py); after
a failed step the episode restarts.

With trace, after the window one more whole episode runs, and `trace_steps`
of its steps, spread evenly over it (every E // trace_steps-th), run under
torch.profiler (CPU and CUDA activities), so that the traced steps have the
window's mix of short and long solves; the per-layer metrics read those
steps and the window's step records.

The process uses the host threads that the configuration states under
`assumed` (`host_threads`: torch's intra-op threads here, OMP_NUM_THREADS in
run.py).
"""

from __future__ import annotations

import gc
import math
import random
import subprocess
import sys
import time
import types

import numpy as np

from . import contract, inputs, trace as trace_mod, verify
from .spec import Spec

FORBIDDEN = ("jax", "jaxlib", "flax", "adaptive_sph_tpu")
# steps of the window held against the reference: its first, and a sample
# drawn from the seed (the reference works one out in 0.4-4 s on the card)
CHECKED_STEPS = 4


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN})


def host_threads(spec: Spec, cell_name: str) -> int:
    """The host threads of the cell's configuration (`assumed.host_threads`)."""
    return int(spec.config(spec.cell(cell_name)["config"])["assumed"]["host_threads"])


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"


class Episodes:
    """The program's simulation driven in fixed episodes."""

    def __init__(self, sim, init, episode_steps: int, params: dict, failure_type):
        self.sim, self.init, self.E = sim, init, int(episode_steps)
        self.params, self.failure_type = params, failure_type
        self.ep_step = 0
        self.episodes = 0

    def restore(self):
        from adaptive_sph_torch.runner import pad_state_to

        if self.init.capacity != self.sim.state.capacity:
            self.init = pad_state_to(self.init, self.sim.state.capacity)
        self.sim.state = self.init
        self.sim.step_number = 0
        self.ep_step = 0
        self.episodes += 1

    def warm_up(self, most: int = 3) -> int:
        """Whole episodes until one runs without growing the capacity (at most
        `most`), so that the window's episodes all run at the capacity the
        last one reached; returns the episodes run."""
        for k in range(1, most + 1):
            cap = self.sim.state.capacity
            self.restore()
            for _ in range(self.E):
                self.step()
            if self.sim.state.capacity == cap:
                return k
        return most

    def step(self):
        """One step of the running episode, restarting it first where it is
        done. Returns (state before, step number, diag or None, failed)."""
        if self.ep_step >= self.E:
            self.restore()
        before, sn = self.sim.state, self.sim.step_number + 1
        try:
            d = self.sim.step()
        except self.failure_type as exc:
            log(f"step {self.ep_step} of episode {self.episodes}: {exc}")
            self.ep_step = self.E
            return before, sn, None, True
        viol, _ = contract.judge(d, self.params)
        self.ep_step += 1
        if viol:
            self.ep_step = self.E
        return before, sn, d, bool(viol)


def setup(spec: Spec, cell_name: str, seed: int, device: str = "cuda",
          overrides: dict = None):
    """The cell's inputs and the program's simulation on `device`, its initial
    state jittered from the seed, driven in episodes (not yet started)."""
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    pd = inputs.params_dict(config)
    pd_port = inputs.params_dict(config, overrides)
    sd = inputs.scene_dict(config, traffic)

    import torch

    from adaptive_sph_torch.models.scene import scene_from_dict
    from adaptive_sph_torch.runner import SimulationFailed, create_simulation
    from adaptive_sph_torch.utils.params import params_from_dict

    dev = torch.device("cuda", 0) if device == "cuda" else torch.device(device)
    sim = create_simulation(params_from_dict(pd_port), scene_from_dict(sd), device=dev,
                            counters_enabled=False, backend="auto")
    st = sim.state
    amp = float(config["assumed"]["jitter"])
    jit = inputs.jitter(st.mass, st.alive, float(pd["rest_density"]), amp, seed)
    sim.state = st.replace(position=st.position + jit)
    eps = Episodes(sim, sim.state, traffic["episode_steps"], pd_port, SimulationFailed)
    return types.SimpleNamespace(cell=cell, config=config, traffic=traffic, params=pd,
                                 params_port=pd_port, scene=sd, sim=sim, init=sim.state,
                                 eps=eps)


def run(cell_name: str, seed: int, seconds: float, trace: bool, *, spec: Spec = None,
        device: str = "cuda", t_start: float = None, overrides: dict = None,
        wrap_step=None) -> dict:
    """One run; returns the result line's fields and `checks`. device="cpu",
    overrides (the program's parameters only: the control) and wrap_step
    (applied to the program's step function after the warm-up: the planted
    faults) serve the benchmark's own tests and calibration."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = spec or Spec()
    import torch

    from adaptive_sph_torch.ops import _native, pair_ops

    torch.set_num_threads(host_threads(spec, cell_name))
    cuda = device == "cuda"
    if cuda:
        log(f"card: {card()}; {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")
    c = setup(spec, cell_name, seed, device, overrides)
    sim, init, eps, pd, traffic = c.sim, c.init, c.eps, c.params, c.traffic
    dev = sim.device
    log(f"cell {cell_name}: backend {sim.backend}, n {sim.num_fluid_particles}, capacity "
        f"{init.capacity}, seed {seed}")
    t0 = time.perf_counter()
    warm = eps.warm_up()
    if cuda:
        torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log(f"warm-up: {warm} episode(s) of {eps.E} steps in {warm_s:.3f} s, capacity "
        f"{sim.state.capacity}; kernel build {_native.build_seconds} s")
    if wrap_step is not None:
        sim.step_fn = wrap_step(sim.step_fn)

    # the measured window
    rng = random.Random(inputs.stream_seed(seed, "checked steps"))
    K = CHECKED_STEPS
    kept, seen, item = [], 0, None
    steps = []
    eps.restore()
    # no collector pauses inside the window (the step makes no cycles to speak of)
    gc.collect()
    gc.disable()
    setup_s = time.perf_counter() - t_start
    t_w0 = time.perf_counter()
    deadline = t_w0 + float(seconds)
    while time.perf_counter() < deadline:
        ep, k = eps.episodes, eps.ep_step if eps.ep_step < eps.E else 0
        a = time.perf_counter()
        before, sn, d, failed = eps.step()
        b = time.perf_counter()
        rec = {"wall_s": b - a, "failed": failed, "episode": ep, "episode_step": k}
        if d is not None:
            rec.update(_diag_numbers(d))
        steps.append(rec)
        if d is None:
            continue
        item = (before, sn, sim.state, d)
        if not kept:
            kept.append(item)
        elif K > 1:
            seen += 1
            if len(kept) < K:
                kept.append(item)
            else:
                r = rng.randrange(seen)
                if r < K - 1:
                    kept[1 + r] = item
    if cuda:
        torch.cuda.synchronize()
    window_s = time.perf_counter() - t_w0
    gc.enable()
    attempted = len(steps)
    failed = sum(1 for s in steps if s["failed"])
    walls = np.array([s["wall_s"] * 1e3 for s in steps] or [np.nan])
    log(f"window: {attempted} steps in {window_s:.3f} s over {eps.episodes} episodes "
        f"(warm-up included in the count), {failed} failed; step ms p50 "
        f"{np.percentile(walls, 50):.2f}, p95 {np.percentile(walls, 95):.2f}, "
        f"max {walls.max():.2f}")

    traced = None
    if trace:
        traced = _traced_stretch(sim, eps, int(traffic.get("trace_steps", 32)), pair_ops, cuda)
    mem_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0

    # the comparison, once the window has closed and the peak is read
    port_init = verify.host_state(init)
    port_kept = [(sn, verify.host_state(af), d) for _, sn, af, d in kept]
    full_kept = [_full_state(bf) for bf, _, _, _ in kept]
    sim = eps = kept = init = item = before = c.sim = c.eps = c.init = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    readings = _compare(pd, c.scene, c.config, seed, port_init, port_kept, full_kept, dev)
    limits = spec.limits(cell_name)
    correct, checks = verify.judge(readings, limits)
    log("readings not compared: " + ", ".join(
        f"{k} {v!r}" for k, v in sorted(readings.items()) if k not in checks))

    ctx = types.SimpleNamespace(steps=steps, window_s=window_s, setup_s=setup_s,
                                trace=traced, params=c.params_port, cell=c.cell,
                                traffic=traffic)
    metrics = {}
    for m in spec.metrics(cell_name, trace):
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(0) if cuda else dev.type,
                   "count": 1, "memory_peak_bytes": mem_peak}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": device_info}
    if traced is not None:
        device_info["busy_s"] = traced["busy_s"]
        device_info["window_s"] = traced["window_s"]
        out["breakdown"] = {"device_ops": trace_mod.device_ops(traced["kernels"]),
                            "idle_gaps": [[k, v] for k, v in traced["idle_gaps"]]}
    out["checks"] = checks
    out["readings"] = readings
    return out


def _diag_numbers(d: dict) -> dict:
    keys = ("dt", "particle_count", "density_iterations", "div_iterations",
            "wavefront_sweeps", "num_pairs")
    return {k: d[k] for k in keys if k in d and isinstance(d[k], (int, float))}


def _full_state(st) -> dict:
    from adaptive_sph_torch.models.state import FIELDS

    return {k: getattr(st, k).detach().cpu().numpy() for k in FIELDS}


def _traced_stretch(sim, eps, n: int, pair_ops, cuda: bool) -> dict:
    """One whole episode with n of its steps, spread evenly over it (every
    E // n-th), under torch.profiler; a schedule warms the profiler up on the
    step before each traced one. Each traced step starts with the card idle
    and is timed alone; per traced step the launch counters' increments and
    the list's shape."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    every = max(eps.E // max(n, 1), 2)
    n = eps.E // every
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    parts, rows = [], []

    def ready(p):
        parts.append(trace_mod.read(p, rows[-1]["wall_s"]))

    eps.restore()
    with profile(activities=acts, schedule=schedule(wait=every - 2, warmup=1, active=1,
                                                    repeat=n), on_trace_ready=ready) as prof:
        for i in range(eps.E):
            traced = i % every == every - 1
            if traced:
                c0 = dict(pair_ops.launches)
                t0 = time.perf_counter()
            _, _, d, failed = eps.step()
            if traced:
                # the step ends in its diagnostics read, which waits for the card
                row = {k: pair_ops.launches[k] - c0[k] for k in c0}
                row.update(wall_s=time.perf_counter() - t0, capacity=sim.state.capacity,
                           failed=failed, episode_step=i)
                if d is not None:
                    row.update(_diag_numbers(d))
                rows.append(row)
            elif i % every == every - 2:
                sync()  # the next step is traced: it starts with the card idle
            prof.step()
    out = trace_mod.merge(parts)
    out["steps"] = rows
    log(f"traced: {len(rows)} steps of a {eps.E}-step episode (every {every}th) in "
        f"{out['window_s']:.4f} s, busy {out['busy_s']:.4f} s, {out['kernel_count']} kernels, "
        f"{out['syncs']} synchronisations; sweeps per traced step "
        f"{[r.get('density_iterations', 0) + r.get('div_iterations', 0) for r in rows]}")
    return out


def _compare(pd, sd, config, seed, port_init, port_kept, full_kept, dev) -> dict:
    """The numbers of verify's docstring, the reference on `dev`."""
    import torch

    from reference.step import Reference

    t0 = time.perf_counter()
    ref = Reference(pd, sd, device=dev)
    rinit = ref.initial_state()
    amp = float(config["assumed"]["jitter"])
    jit = inputs.jitter(torch.as_tensor(rinit["mass"]).to(dev),
                        torch.as_tensor(rinit["alive"]).to(dev), float(pd["rest_density"]), amp,
                        seed).cpu().numpy()
    rinit["position"] = rinit["position"] + jit
    rows = [{"start_gap": verify.start_gap(port_init, rinit)}]
    levels = ref.params.level_estimation_active()
    rho0 = float(pd["rest_density"])
    its_keys = ("density_iterations", "div_iterations")
    cap = int(pd["max_iters"])
    for (sn, pa, d), full in zip(port_kept, full_kept):
        ra, rd = ref.step(full, sn)
        its = {k: (d.get(k), rd.get(k)) for k in its_keys}
        gap = max(abs(int(a or 0) - int(b or 0)) for a, b in its.values())
        early = _early_sweeps(its, cap)
        followed = ""
        if gap:
            # a solve stopped a sweep apart: the reference works the step
            # again with the program's sweep counts
            ra, rd = ref.step(full, sn, follow={k: d.get(k) for k in its_keys})
            followed = " (reference followed the program's sweep counts)"
        row = verify.step_gaps(pa, ra, float(d["dt"]), float(rd["dt"]), rho0, levels)
        row["iters_gap"] = float(gap)
        row["early_sweeps"] = early
        rows.append(row)
        log(f"checked step {sn}: iterations (program, reference) {its}{followed}; "
            + ", ".join(f"{k} {v:.3e}" for k, v in row.items()))
    numbers = verify.worst(rows)
    log(f"reference: {len(port_kept)} steps worked out again in "
        f"{time.perf_counter() - t0:.3f} s")
    return {k: (v if math.isfinite(v) else None) for k, v in numbers.items()}


def _early_sweeps(its: dict, cap: int) -> float:
    """The most sweeps by which a solve of the program stopped before the
    reference's own exit test, where it stopped below the cap (0 where none
    did); a count the reference has and the program leaves out reads inf."""
    early = 0.0
    for prog, ref in its.values():
        if ref is None:
            continue
        if prog is None:
            return math.inf
        if int(prog) < cap:
            early = max(early, float(int(ref) - int(prog)))
    return early
