#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA GPU and check it.

    python3 chip_smoke.py                # all phases (one GPU)
    python3 chip_smoke.py --kernels-only # build + kernel-vs-plain checks only

Phases (any failure raises; the exit code is then non-zero):
  1. the card's name and power limit (nvidia-smi) and the nvcc build of the
     kernels from adaptive_sph_torch/csrc/;
  2. each hand-written kernel against its plain PyTorch version on the same
     CUDA tensors, at the stress scene's first-step shapes: max error and
     median times (CUDA events);
  3. 10 steps of the stress scene (parity options) against the JAX reference
     trajectory in tests/data/torch_port_stress_ref.npz;
  4. timed runs of ~200 steps with the parity options and with the bench
     options through create_simulation -> Simulation.step; the kernel launch
     counters are reset just before the bench-options run and must all be
     > 0 after it.
The line before last is a JSON object with one entry per kernel; the last line
is {"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_stress_ref.npz")

KERNEL_SOURCE = "adaptive_sph_torch/csrc/pair_ops.cu"
REPLACES = {
    "pair_build": "adaptive_sph_tpu/ops/pallas_matvec.py:786",
    "pair_matvec": "adaptive_sph_tpu/ops/pallas_matvec.py:253",
    "pair_visc": "adaptive_sph_tpu/ops/pallas_matvec.py:666",
}
TOL_F32 = 1e-5   # relative to max |plain|: only the summation order differs
TOL_BF16 = 4e-3  # stored bf16 entries: one bf16 half-ulp where f32 inputs differ in the last bit
STEPS_TRAJ = 10
STEPS_TIMED = 200
WARMUP = 10


def log(*a):
    print(*a, flush=True)


def time_ms(fn, reps):
    """Median milliseconds of fn() between CUDA events, after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    ts.sort()
    return ts[len(ts) // 2]


def rel_err(got, want):
    """(max |got - want|, that over max |want|) in float64."""
    got = got.double()
    want = want.double()
    err = float((got - want).abs().max()) if want.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    return err, err / max(scale, 1e-30)


def phase_header():
    import torch
    from adaptive_sph_torch.ops import _native

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"gpu: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    t0 = time.perf_counter()
    _native.load()
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s (nvcc "
        f"{_native.build_seconds if _native.build_seconds is not None else 'cached'} s), "
        f"flags {' '.join(_native.NVCC_FLAGS)}")
    return smi


def phase_kernels():
    """Each kernel vs its plain version on the stress scene's first-step inputs."""
    import numpy as np
    import torch
    from adaptive_sph_torch.models.tile_step import physics_scale, step_geometry
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import stress_params, stress_scene

    dev = torch.device("cuda")
    results = {}
    for bench in (False, True):
        tag = "bf16" if bench else "f32"
        params = stress_params(bench)
        sim = create_simulation(params, stress_scene(), device=dev, counters_enabled=False)
        tcfg = sim.tile_cfg
        _, bins, cols, wm = step_geometry(sim.state, sim.params, tcfg)
        wdtype = torch.bfloat16 if bench else torch.float32
        # the first step starts at rest, which would zero every viscosity
        # factor: give the live particles seeded velocities for this check
        rng = np.random.default_rng(7)
        C = tcfg.capacity
        flat = cols["flat"].clone()
        live = (flat[:, 2] > 0).float()[:, None]
        flat[:, 4:6] = torch.from_numpy(rng.normal(0, 0.4, (C, 2)).astype(np.float32)).to(dev) * live
        args = (bins.cell_starts, wm, flat, tcfg.tq, float(physics_scale(sim.params)),
                float(sim.params.viscosity), True, wdtype)
        k = pair_ops.pair_build(*args)
        r = pair_ops.pair_build_ref(*args)
        torch.cuda.synchronize()
        if not torch.equal(k.row_ptr, r.row_ptr) or not torch.equal(k.col, r.col):
            nd = int((k.row_ptr != r.row_ptr).sum())
            raise AssertionError(f"K1 pair_build [{tag}]: pair structure differs from the "
                                 f"plain version ({nd} row pointers differ, "
                                 f"{k.num_pairs} vs {r.num_pairs} pairs)")
        tol_w = TOL_BF16 if bench else TOL_F32
        errs = {}
        for name, got, want, tol in (
                ("w", k.w, r.w, tol_w), ("s", k.s, r.s, tol_w),
                ("prep", k.prep, r.prep, TOL_F32)):
            for row in range(got.shape[0]):
                e, rel = rel_err(got[row], want[row])
                errs[f"{name}{row}"] = (e, rel)
                if not rel < tol:
                    raise AssertionError(f"K1 pair_build [{tag}] {name}[{row}]: max rel err "
                                         f"{rel:.3e} >= {tol:g}")
        k1_abs = max(e for e, _ in errs.values())
        k1_rel = max(rel for _, rel in errs.values())
        t_k1 = time_ms(lambda: pair_ops.pair_build(*args), 20)
        t_k1r = time_ms(lambda: pair_ops.pair_build_ref(*args), 5)
        log(f"K1 pair_build [{tag}]: {k.num_pairs} pairs, structure equal, max abs err "
            f"{k1_abs:.3e}, max rel err {k1_rel:.3e} (tol {tol_w:g} stored, {TOL_F32:g} sums); "
            f"kernel {t_k1:.4f} ms, plain {t_k1r:.4f} ms")

        # K2 / K3 on the kernel-built list; the plain versions read the same
        # stored entries, so f32 accumulation order is the only difference
        alive = live[:, 0]
        u = torch.from_numpy(rng.uniform(0, 10, C).astype(np.float32)).to(dev) * alive
        tx = torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).to(dev) * alive
        ty = torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).to(dev) * alive
        rho = torch.from_numpy(rng.uniform(0.8, 1.2, C).astype(np.float32)).to(dev)
        checks = {
            "pair_matvec_accel": (lambda: pair_ops.pair_matvec(k, u, 2),
                                  lambda: pair_ops.pair_matvec_ref(k, u, 2)),
            "pair_matvec_div": (lambda: (pair_ops.pair_matvec(k, (tx, ty), 1),),
                                lambda: (pair_ops.pair_matvec_ref(k, (tx, ty), 1),)),
            "pair_visc": (lambda: pair_ops.pair_visc(k, rho),
                          lambda: pair_ops.pair_visc_ref(k, rho)),
        }
        out = {"pair_build": (k1_abs, t_k1, t_k1r)}
        for name, (fk, fr) in checks.items():
            got, want = fk(), fr()
            torch.cuda.synchronize()
            worst_abs = worst_rel = 0.0
            for g, w in zip(got, want):
                e, rel = rel_err(g, w)
                worst_abs, worst_rel = max(worst_abs, e), max(worst_rel, rel)
            if not worst_rel < TOL_F32:
                raise AssertionError(f"{name} [{tag}]: max rel err {worst_rel:.3e} >= {TOL_F32:g}")
            tk = time_ms(fk, 200)
            tr = time_ms(fr, 50)
            out[name] = (worst_abs, tk, tr)
            log(f"{name} [{tag}]: max abs err {worst_abs:.3e}, max rel err {worst_rel:.3e} "
                f"(tol {TOL_F32:g}); kernel {tk:.4f} ms, plain {tr:.4f} ms")
        results[tag] = out
        del sim, k, r
        torch.cuda.empty_cache()
    return results


def match_by_position(pa, pb):
    """Index j with pb[j] nearest to pa; asserts a bijection."""
    import numpy as np
    from scipy.spatial import cKDTree

    _, j = cKDTree(pb).query(pa, k=1)
    if not (np.sort(j) == np.arange(len(pb))).all():
        raise AssertionError("position match is not a bijection")
    return j


def phase_trajectory():
    """10 parity steps on the GPU against the JAX reference fixture."""
    import numpy as np
    import torch
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import stress_params, stress_scene

    ref = np.load(FIXTURE)
    sim = create_simulation(stress_params(False), stress_scene(), device="cuda",
                            counters_enabled=False)
    div_it, den_it, dts = [], [], []
    for _ in range(STEPS_TRAJ):
        d = sim.step()
        div_it.append(d["div_iterations"])
        den_it.append(d["density_iterations"])
        dts.append(d["dt"])
    st = sim.state
    alive = st.alive.cpu().numpy()
    pos = st.position.cpu().numpy()[alive]
    vel = st.velocity.cpu().numpy()[alive]
    rho = st.density.cpu().numpy()[alive]
    if len(pos) != len(ref["position"]):
        raise AssertionError(f"particle count {len(pos)} != reference {len(ref['position'])}")
    j = match_by_position(pos, ref["position"])
    dpos = float(np.abs(pos - ref["position"][j]).max())
    drho = float(np.abs(rho / ref["density"][j] - 1.0).max())
    dvel = float(np.abs(vel - ref["velocity"][j]).max())
    ddt = float(np.abs(np.asarray(dts, np.float32) - ref["dt"]).max())
    log(f"trajectory vs JAX ({STEPS_TRAJ} steps, n={len(pos)}): max |dx| {dpos:.3e} (tol 2e-5), "
        f"max rel drho {drho:.3e} (tol 2e-5), max |dv| {dvel:.3e} (tol 2e-4), max |ddt| {ddt:.3e}")
    log(f"  div iterations {div_it} (JAX {ref['div_iterations'].tolist()}), density iterations "
        f"{den_it} (JAX {ref['density_iterations'].tolist()})")
    if not (dpos < 2e-5 and drho < 2e-5 and dvel < 2e-4):
        raise AssertionError("trajectory differs from the JAX reference beyond tolerance")
    if div_it != ref["div_iterations"].tolist() or den_it != ref["density_iterations"].tolist():
        raise AssertionError("solver iteration counts differ from the JAX reference")
    del sim
    torch.cuda.empty_cache()


def timed_run(bench: bool, reset_counters: bool):
    import numpy as np
    import torch
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import stress_params, stress_scene

    params = stress_params(bench)
    sim = create_simulation(params, stress_scene(), device="cuda", counters_enabled=False)
    n = sim.num_fluid_particles
    for _ in range(WARMUP):
        sim.step()
    torch.cuda.synchronize()
    if reset_counters:
        pair_ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    diags = sim.step_chunk(STEPS_TIMED)
    torch.cuda.synchronize()
    el = time.perf_counter() - t0
    launches = dict(pair_ops.launches)
    st = sim.state
    alive = st.alive
    for name in ("position", "velocity", "density", "pressure"):
        v = getattr(st, name)[alive]
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"non-finite {name} after the timed run")
    # every density solve ends inside its tolerance unless it ran to max_iters
    # (NaN: no unclamped particle, trivially converged)
    tol_den = params.hybrid_dfsph_max_avg_density_error * params.rest_density
    errs = np.asarray(diags["density_avg_error"], np.float64)
    capped = np.asarray(diags["density_iterations"]) >= params.max_iters
    above = np.isfinite(errs) & (np.abs(errs) >= tol_den) & ~capped
    if above.any():
        raise AssertionError(f"{int(above.sum())} density solves exited above their tolerance")
    ms = el / STEPS_TIMED * 1e3
    tag = "bench (bf16, warm start, momentum 0.9)" if bench else "parity (f32, cold, momentum 0)"
    log(f"timed {tag}: {STEPS_TIMED} steps, {ms:.4f} ms/step, {n * STEPS_TIMED / el:.1f} "
        f"updates/s (n={n}), mean div iters {np.mean(diags['div_iterations']):.2f}, mean "
        f"density iters {np.mean(diags['density_iterations']):.2f}, pairs/step "
        f"{int(np.mean(diags['num_pairs']))}, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, launches {launches}")
    del sim
    torch.cuda.empty_cache()
    return launches


def main(argv):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    smi = phase_header()
    kres = phase_kernels()
    if "--kernels-only" in argv:
        return 0
    phase_trajectory()
    timed_run(bench=False, reset_counters=False)
    launches = timed_run(bench=True, reset_counters=True)
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    f32 = kres["f32"]
    entries = []
    for name, key in (("pair_build", "pair_build"), ("pair_matvec", "pair_matvec_accel"),
                      ("pair_visc", "pair_visc")):
        err, ms, plain = f32[key]
        if name == "pair_matvec":
            err = max(err, f32["pair_matvec_div"][0])
        entries.append({"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                        "replaces": REPLACES[name], "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain})
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
