"""Run the slab-decomposed step on several ranks, one process each.

    python -m adaptive_sph_torch.multichip [--ranks 4] [--backend gloo|nccl]
        [--device cuda|cpu] [--steps 200] [--spacing 0.0075] [--check-every 10]
        [--profile-steps 0] [--out RESULT.json]

Counterpart of scripts/multichip_longrun.py: the wide dam column (a 2.4 x 1.2
block at `--spacing`, about 51k particles at 0.0075, adaptive HybridDFSPH
with share / merge / split) collapses sideways, so the count-balanced slab
edges go stale and the run reshards. Every `--check-every` steps the ranks
hold the script's invariants: mass drift < 5e-3, the census (the summed
alive rows equal n), containment in the box plus 0.1, and no solve ending
above its tolerance before the iteration cap. Without a reshard by the last
`--check-every` steps, one is forced there: it must keep every field of every
particle exactly, and the last steps run on the new slabs. The JSON goes to
`--out` (nothing is written otherwise).

Ranks are spawned (never forked after CUDA is up). `--backend` and
`--device` are explicit: "nccl" needs one card per rank; "gloo" runs the
ranks on the CPU, or several ranks on one card, rank r on cuda:(r % device
count). The CUDA library is built here before the ranks start, so that they
load it instead of building it at once. A rank that raises makes the
launcher raise (the other ranks are stopped).

`run_ranks(job, ranks, backend, device, hooks=None)` runs any job with a
`run(comm, hooks)` method on every rank, a `SlabJob` or the particle-sharded
list step's `parallel.sharding.ShardedListJob` (the tests and chip_smoke.py
drive it, with their `RunHooks`), and returns rank 0's result.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import pickle
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch

from . import convert, spans
from .models import scene as scene_mod
from .models.state import FIELDS
from .models import tile_step
from .ops import pair_ops
from .ops.grid import GridConfig
from .parallel.tile_sharding import SlabComm, SlabConfig, SlabSimulation
from .runner import create_simulation, grid_config_for
from .tally import SolveTally

MASS_DRIFT_MAX = 5e-3
SLAB_TQ = 16  # the query-tile width of every slab (scripts/multichip_longrun.py's)
KERNELS = ("pair_build", "pair_matvec", "pair_visc", "pair_sweep")


@dataclasses.dataclass
class SlabJob:
    """What every rank runs. params: `convert.params_to_dict` of the
    parameters; scene: the scene dictionary (`scene_from_dict`); state:
    numpy arrays of the global initial state (default: the scene's); gcfg /
    scfg: the grid and a slab decomposition of the initial state (default:
    computed); reshard_at: step indices before which a reshard is forced;
    snapshots: step counts after which rank 0 keeps the global state;
    check_every: the soak's invariants every so many steps (0: none);
    profile_steps: torch.profiler over the last so many steps on every rank
    (CUDA only); force_reshard: scripts/multichip_longrun.py's rule, a
    reshard forced before the last `check_every` (or profiled) steps if none
    happened by then. Every forced reshard must keep every field of every
    alive particle exactly."""

    params: dict
    scene: dict
    steps: int
    capacity: Optional[int] = None
    state: Optional[dict] = None
    gcfg: Optional[GridConfig] = None
    scfg: Optional[SlabConfig] = None
    split_patterns: Optional[tuple] = None
    reshard_at: tuple = ()
    snapshots: tuple = ()
    check_every: int = 0
    profile_steps: int = 0
    force_reshard: bool = False

    def run(self, comm: SlabComm, hooks: Optional["RunHooks"] = None) -> dict:
        return run_slab(self, comm, hooks)


def longrun_job(spacing: float = 0.0075, steps: int = 200, check_every: int = 10,
                profile_steps: int = 0) -> SlabJob:
    """scripts/multichip_longrun.py's scene and parameters: particles start
    just under the optimal size (r0 = sqrt(0.93 / pi) spacing), the base size
    1.35 r0 and the fine 0.98 r0, so that resampling stays active as the
    dam collapses."""
    r0 = (0.93 / 3.14159265) ** 0.5 * spacing
    params = {"particle_sizes": "Adaptive", "pressure_solver_method": "HybridDFSPH",
              "init_boundary_handler": "AnalyticOverestimate",
              "level_estimation_method": "EmptyAngle",
              "merging": True, "sharing": True, "splitting": True,
              "max_iters": 100, "max_dt": 0.002,
              "particle_radius_fine": r0 * 0.98, "particle_radius_base": r0 * 1.35,
              "maximum_surface_distance": 2.0, "warm_start_pressure": True}
    scene = {"boundary": {"type": "box", "width": 6.0, "height": 2.0},
             "blocks": [{"pos": [-2.9, -0.95], "size": [2.4, 1.2], "spacing": spacing,
                         "volume_fill_ratio": 0.93, "velocity": [0, 0]}]}
    return SlabJob(params=params, scene=scene, steps=steps, check_every=check_every,
                   profile_steps=profile_steps, force_reshard=True)


@dataclasses.dataclass(frozen=True)
class RunHooks:
    """Instrumentation of a slab run, for the tests and chip_smoke.py (the
    launcher passes none): fail_at, (rank, step): that rank raises before
    that step; capture: a path where rank 0 saves the kernel inputs of its
    first step (see `_Capture`)."""

    fail_at: Optional[tuple] = None
    capture: Optional[str] = None

    def around_step(self, rank: int, k: int):
        """The context step k of `rank` runs in."""
        if self.fail_at is not None and tuple(self.fail_at) == (rank, k):
            raise RuntimeError(f"rank {rank}: injected failure before step {k}")
        if self.capture and rank == 0 and k == 0:
            return _Capture(self.capture)
        return contextlib.nullcontext()


class _Capture:
    """The kernel inputs of the calls inside the context, saved to `path`
    (torch.save) when it ends: the first call of pair_build, pair_visc,
    pair_matvec with two outputs ("pair_matvec:accel") and with one
    ("pair_matvec:div"), and of pair_sweep per op and mode
    ("pair_sweep:<op>:<its parameters>", the op saved as its name and
    parameters)."""

    def __init__(self, path: str):
        self.path = path
        self.calls = {}
        self.real = []

    def __enter__(self):
        from .models import adaptivity

        for mod, name in ((pair_ops, "pair_build"), (pair_ops, "pair_matvec"),
                          (pair_ops, "pair_visc"), (tile_step, "pair_sweep"),
                          (adaptivity, "pair_sweep")):
            fn = getattr(mod, name)
            self.real.append((mod, name, fn))
            setattr(mod, name, self._spy(name, fn))
        return self

    def _spy(self, name, fn):
        def spy(*a, **k):
            key, saved = name, a
            if name == "pair_sweep":  # one op name can come with two parameter sets
                op = a[4]
                key = f"pair_sweep:{op.name}:{sorted(op.params.items())}"
                saved = a[:4] + ((op.name, dict(op.params)),) + a[5:]
            elif name == "pair_matvec":
                key = "pair_matvec:accel" if k.get("k_out") == 2 else "pair_matvec:div"
            self.calls.setdefault(key, (saved, dict(k)))
            return fn(*a, **k)
        return spy

    def __exit__(self, exc_type, *exc):
        for mod, name, fn in self.real:
            setattr(mod, name, fn)
        if exc_type is None:
            torch.save(self.calls, self.path)
        return False


def _profile_window(fn, steps: int) -> dict:
    """torch.profiler over `steps` calls of fn(): wall seconds, device
    seconds of the kernels, host synchronisations."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    events = prof.key_averages()
    device = sum(e.self_device_time_total for e in spans.device_ops(events)) / 1e6
    syncs = sum(e.count for e in events if "Synchronize" in e.key)
    return {"steps": steps, "wall_s": wall, "device_s": device, "syncs": syncs,
            "busy": device / wall if wall > 0 else 0.0}


def _invariants(ssim: SlabSimulation, mass0: float, scene):
    """The soak's checks on the global state (reductions over the ranks):
    returns (mass drift, alive count, the signed margin of the particle
    farthest out: the largest |x| or |y| past the box plus 0.1, below 0)."""
    st = ssim.local
    comm = ssim.comm
    alive = st.alive
    pos = st.position[alive].double()
    loc = torch.stack([torch.sum(st.mass[alive].double()), alive.sum().double()])
    mass, n = comm.psum(loc).tolist()
    ext = comm.pmax(torch.stack([pos[:, 0].abs().max() if len(pos) else pos.new_zeros(()),
                                 pos[:, 1].abs().max() if len(pos) else pos.new_zeros(())]))
    w2 = scene.boundary_width / 2 + 0.1
    h2 = scene.boundary_height / 2 + 0.1
    drift = abs(mass - mass0) / mass0
    if not drift < MASS_DRIFT_MAX:
        raise AssertionError(f"mass drift {drift:.3e} >= {MASS_DRIFT_MAX}")
    if int(st.n) != int(n):
        raise AssertionError(f"census: n = {int(st.n)}, alive rows {int(n)}")
    if not (float(ext[0]) < w2 and float(ext[1]) < h2):
        raise AssertionError(f"containment: max |x| {float(ext[0]):.4f}, |y| "
                             f"{float(ext[1]):.4f} outside {w2} x {h2}")
    return drift, int(n), max(float(ext[0]) - w2, float(ext[1]) - h2)


def _checked_reshard(ssim: SlabSimulation):
    """A forced reshard, which must keep every field of every alive particle
    (matched by position) and the step's scalars exactly."""
    before = ssim.gather()
    ssim.reshard()
    after = ssim.gather()

    def by_position(b):
        alive = b["alive"]
        pos = b["position"][alive]
        order = np.lexsort((pos[:, 1], pos[:, 0]))
        return {k: (v if v.ndim == 0 else v[alive][order]) for k, v in b.items()}

    a, b = by_position(before), by_position(after)
    changed = [k for k in FIELDS if a[k].shape != b[k].shape or not np.array_equal(a[k], b[k])]
    if changed:
        raise AssertionError(f"a forced reshard changed {changed}")


def run_slab(job: SlabJob, comm: SlabComm, hooks: Optional[RunHooks] = None) -> dict:
    """One rank's run of `job`; every rank returns the same global numbers,
    rank 0 also the snapshots."""
    hooks = hooks or RunHooks()
    dev = comm.device
    params = convert.params_from_dict(job.params)
    scene = scene_mod.scene_from_dict(job.scene)
    split_patterns = job.split_patterns
    sim = create_simulation(params, scene, capacity=job.capacity, counters_enabled=False,
                            device=dev, split_patterns=split_patterns)
    host = job.state if job.state is not None else convert.state_to_numpy(sim.state)
    gcfg = job.gcfg if job.gcfg is not None else grid_config_for(
        sim.params, scene, host, np.asarray(host["alive"]).shape[0])
    ssim = SlabSimulation(sim.params, gcfg, sim.boundary_handler, host, comm, tq=SLAB_TQ,
                          split_patterns=sim.split_patterns, scfg=job.scfg)
    alive0 = np.asarray(host["alive"])
    mass0 = float(np.sum(np.asarray(host["mass"], np.float64)[alive0]))
    n0 = int(alive0.sum())
    # the scenario gates' rule: a solve above its tolerance before the cap
    tally = SolveTally(sim.params.max_iters, sim.params.rest_density,
                       sim.params.hybrid_dfsph_max_avg_density_error,
                       sim.params.hybrid_dfsph_max_avg_divergence_error)
    out = {"n0": n0, "mass0": mass0, "scfg0": ssim.scfg, "diags": [], "step_s": [],
           "snapshots": {}, "checks": []}

    out["forced_reshard"] = False
    # the soak's rule: a reshard before the last chunk if none happened by then
    force_at = job.steps - max(job.profile_steps, job.check_every, 1) if job.force_reshard else -1

    def before_step(k):
        if k in job.reshard_at or (k == force_at and ssim.n_reshards == 0):
            _checked_reshard(ssim)
            out["forced_reshard"] = True

    pair_ops.reset_launches()
    stats0 = dict(comm.stats)
    t_run = time.perf_counter()
    timed_steps = job.steps - job.profile_steps
    for k in range(timed_steps):
        before_step(k)
        t0 = time.perf_counter()
        with hooks.around_step(comm.rank, k):
            d = ssim.step()
        out["step_s"].append(time.perf_counter() - t0)
        out["diags"].append(d)
        tally.add(d, ssim.time)
        if k + 1 in job.snapshots and comm.rank == 0:
            out["snapshots"][k + 1] = ssim.gather()
        elif k + 1 in job.snapshots:
            ssim.gather()
        if job.check_every and ((k + 1) % job.check_every == 0 or k + 1 == job.steps):
            drift, n, excess = _invariants(ssim, mass0, scene)
            out["checks"].append({"step": k + 1, "t": ssim.time, "n": n, "mass_drift": drift,
                                  "excess": excess, "reshards": ssim.n_reshards,
                                  "wall_s": time.perf_counter() - t_run})
            if comm.rank == 0:
                c = out["checks"][-1]
                print(f"step {c['step']}/{job.steps} t={c['t']:.4f} n={n} reshards="
                      f"{c['reshards']} mass_drift={drift:.2e} wall={c['wall_s']:.1f}s",
                      flush=True)
    if job.profile_steps:
        before_step(timed_steps)
        diags = []
        out["profile"] = _profile_window(lambda: diags.append(ssim.step()), job.profile_steps)
        for d in diags:
            out["diags"].append(d)
            tally.add(d, ssim.time)
        if job.check_every:
            drift, n, excess = _invariants(ssim, mass0, scene)
            out["checks"].append({"step": job.steps, "t": ssim.time, "n": n,
                                  "mass_drift": drift, "excess": excess,
                                  "reshards": ssim.n_reshards,
                                  "wall_s": time.perf_counter() - t_run})
    out["run_s"] = time.perf_counter() - t_run
    out["launches"] = dict(pair_ops.launches)
    out["comm"] = {k: comm.stats[k] - stats0[k] for k in comm.stats}
    out["n_reshards"] = ssim.n_reshards
    out["tol_violations"] = dict(tally.viol)
    out["tally"] = {**tally.summary(), "dt_collapse_t": tally.dt_collapse_t}
    if job.check_every and any(tally.viol.values()):
        raise AssertionError(f"solves ended above their tolerance before the cap: {tally.viol}")
    out["t_end"] = ssim.time
    out["scfg"] = ssim.scfg
    final = ssim.gather()
    if comm.rank == 0:
        out["final"] = final
    return out


def _rank_entry(rank: int, world: int, backend: str, device: str, init_file: str,
                job: SlabJob, hooks: Optional[RunHooks], result_path: str):
    if device == "cpu":
        torch.set_num_threads(1)
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    try:
        comm = SlabComm.init(rank, world, backend, dev, "file://" + init_file)
    except BaseException:
        _record_failure(result_path, rank)
        raise
    try:
        res = job.run(comm, hooks)
        import torch.distributed as dist

        gathered = [None] * world
        dist.all_gather_object(gathered, {k: res[k] for k in ("launches", "comm", "step_s",
                                                               "run_s", "profile")
                                          if k in res})
        if rank == 0:
            res["ranks"] = gathered
            with open(result_path + ".tmp", "wb") as f:
                pickle.dump(res, f)
            os.replace(result_path + ".tmp", result_path)
    except BaseException:
        _record_failure(result_path, rank)
        raise
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()


def _record_failure(result_path: str, rank: int):
    """The rank's traceback beside the result, for the launcher's error: a
    rank that raises drops its connections, and its neighbours then fail
    too, so the first failure is the cause."""
    import traceback

    with open(f"{result_path}.rank{rank}.err", "w") as f:
        f.write(traceback.format_exc())


def run_ranks(job, ranks: int, backend: str = "gloo", device: str = "cuda",
              hooks: Optional[RunHooks] = None) -> dict:
    """Spawn `ranks` processes that run `job` (its `run(comm, hooks)`) over
    one process group (a file:// rendezvous in a fresh temporary directory)
    and return rank 0's result, with per rank ("ranks") the kernel launches,
    the communication counts, the step times and the profile. A SlabJob's
    result: per-step diagnostics, the global state at `job.snapshots` and at
    the end (slab-blocked numpy arrays) and the final decomposition; the
    exchanges, reductions and bytes sent per rank. Raises if a rank raises.
    hooks: the tests' fault injection and input capture."""
    import torch.multiprocessing as mp

    if device not in ("cpu", "cuda"):
        raise ValueError(f"device {device!r}: 'cpu' or 'cuda'")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device='cuda' without a CUDA device; pass device='cpu'")
        if backend == "nccl" and torch.cuda.device_count() < ranks:
            raise ValueError(f"nccl needs one card per rank: {ranks} ranks, "
                             f"{torch.cuda.device_count()} cards")
        from .ops import _native

        _native.load()  # build once, before the ranks start
    with tempfile.TemporaryDirectory(prefix="asph_slab_") as tmp:
        result_path = os.path.join(tmp, "rank0.pkl")
        try:
            mp.start_processes(_rank_entry, args=(ranks, backend, device,
                                                  os.path.join(tmp, "rendezvous"), job,
                                                  hooks, result_path),
                               nprocs=ranks, join=True, start_method="spawn")
        except Exception as e:
            errs = sorted((os.path.getmtime(os.path.join(tmp, f)), f)
                          for f in os.listdir(tmp) if f.endswith(".err"))
            text = "\n".join(f"-- {f.split('.')[-2]} (failure {i + 1} of {len(errs)}):\n"
                             + open(os.path.join(tmp, f)).read()
                             for i, (_, f) in enumerate(errs))
            raise RuntimeError(f"slab run on {ranks} ranks failed\n{text}") from e
        with open(result_path, "rb") as f:
            return pickle.load(f)


def summary(res: dict, ranks: int, backend: str, device: str) -> dict:
    """The launcher's JSON: the soak's counts and invariants, per-rank
    ms/step, exchanges and reductions per rank-step, strip bytes."""
    steps = len(res["diags"])
    per_rank = []
    for r, rr in enumerate(res["ranks"]):
        c = rr["comm"]
        row = {"rank": r, "ms_per_step": 1e3 * float(np.mean(rr["step_s"])),
               "exchanges_per_step": c["exchanges"] / steps,
               "reductions_per_step": c["reductions"] / steps,
               "bytes_sent_per_step": c["bytes"] / steps,
               "launches": {k: rr["launches"][k] for k in KERNELS}}
        if "profile" in rr:
            p = rr["profile"]
            row.update(busy=p["busy"], syncs_per_step=p["syncs"] / p["steps"],
                       profiled_ms_per_step=1e3 * p["wall_s"] / p["steps"])
        per_rank.append(row)
    alive = res["final"]["alive"]
    return {"ranks": ranks, "backend": backend, "device": device, "n_initial": res["n0"],
            "n_final": int(alive.sum()), "steps": steps, "t_end": res["t_end"],
            "reshards": res["n_reshards"], "forced_reshard": res["forced_reshard"],
            "mass_drift": max(c["mass_drift"] for c in res["checks"]) if res["checks"] else None,
            "tol_violations": res["tol_violations"], "wall_s": res["run_s"],
            "strip": res["scfg"].strip, "c_dev": res["scfg"].c_dev, "per_rank": per_rank}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m adaptive_sph_torch.multichip",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--spacing", type=float, default=0.0075)
    ap.add_argument("--check-every", type=int, default=10)
    ap.add_argument("--profile-steps", type=int, default=0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    if a.profile_steps and a.device != "cuda":
        ap.error("--profile-steps profiles the card: --device cuda")
    job = longrun_job(a.spacing, a.steps, a.check_every, a.profile_steps)
    res = run_ranks(job, a.ranks, a.backend, a.device)
    out = summary(res, a.ranks, a.backend, a.device)
    if a.out:
        with open(a.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
