#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA GPU and check them.

    python3 chip_smoke.py                # all phases (one GPU)
    python3 chip_smoke.py --kernels-only # build + kernel-vs-plain checks only

Phases (any failure raises; the exit code is then non-zero):
  1. the card's name and power limit (nvidia-smi) and the nvcc build of the
     kernels from adaptive_sph_torch/csrc/ (one nvcc per source, in parallel, linked into one library);
  2. K1-K3 against their plain PyTorch versions on the same CUDA tensors, at
     the stress scene's first-step shapes: max error, median times (CUDA
     events), the bound of each from this run's pairs inside the radius
     (the tested candidates outside it are not counted), and for K2 the
     time of a CSR sparse-times-dense product computing the same function;
  2b. pair_sweep against its plain version for each of the nine sweep ops,
     on the inputs the default dam break's first step gives them (captured
     from that step; C = 3,072, 8 populated levels): counts and maxima
     equal, sums within 1e-5 of the column max, medians, tested pairs;
  3. 10 steps of the stress scene (parity options) against the JAX reference
     trajectory in tests/data/torch_port_stress_ref.npz;
  3b. 10 steps of the default dam break against
     tests/data/torch_port_dambreak_ref.npz: per-step census, capacity,
     resampling counts, dt and iteration counts equal, then the state;
  4. timed stress runs (parity and bench options) through create_simulation
     -> Simulation.step; the launch counts are set to 0 just before the
     bench-options run and read just after: K1-K3 must have launched;
  4b. the timed default dam break, 300 steps through create_simulation (the
     launch counts set to 0 just before, read just after: all four kernels
     must have launched), then 20 steps through
     adaptive_sph_torch.cli.main(["run", ..., "--max-steps", "20"]).
Output: a JSON object with one entry per kernel, then the card's name and
power limit (nvidia-smi), then, last, {"ok": true, "device": {...}}. Without
a CUDA device it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_stress_ref.npz")
DAMBREAK_FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_dambreak_ref.npz")
CONFIG = os.path.join(ROOT, "configs", "default-config.yaml")
SCENE = os.path.join(ROOT, "configs", "default-scene.yaml")

SOURCES = {
    "pair_build": "adaptive_sph_torch/csrc/pair_ops.cu",
    "pair_matvec": "adaptive_sph_torch/csrc/pair_ops.cu",
    "pair_visc": "adaptive_sph_torch/csrc/pair_ops.cu",
    "pair_sweep": "adaptive_sph_torch/csrc/pair_sweep.cu",
}
REPLACES = {
    "pair_build": "adaptive_sph_tpu/ops/pallas_matvec.py:786",
    "pair_matvec": "adaptive_sph_tpu/ops/pallas_matvec.py:253",
    "pair_visc": "adaptive_sph_tpu/ops/pallas_matvec.py:666",
    "pair_sweep": "adaptive_sph_tpu/ops/pallas_sweeps.py:120",
}
# the least time the card could take: bytes at the HBM rate, float32
# operations at the non-tensor-core float32 peak (NVIDIA H100 SXM data sheet)
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 operations of each pair inside the radius, the only pairs the
# function needs: the geometry (h_ij, dx, dy, r2, radius test) and the
# kernel's terms (sqrt and divisions counted as one each). Candidates of the
# tile walk outside the radius are overhead of the layout, not work the
# output needs, and are not counted.
OPS_PAIR_GEOM = 12
OPS_K1_PAIR = 45
OPS_K1_VISC = 12
OPS_SWEEP_EMIT = {"count": 1, "normal": 35, "cone": 12, "wavefront": 4, "smooth": 40,
                  "adapt_cnt0": 12, "adapt_cnt1": 16, "adapt_claim": 18, "adapt_partner": 18}
TOL_F32 = 1e-5   # relative to max |plain|: only the summation order differs
TOL_BF16 = 4e-3  # stored bf16 entries: one bf16 half-ulp where f32 inputs differ in the last bit
STEPS_TRAJ = 10
STEPS_TIMED = 100
STEPS_DAMBREAK = 300
STEPS_CLI = 20
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
    log(f"kernel build+load: {time.perf_counter() - t0:.2f} s (parallel nvcc "
        f"{_native.build_seconds if _native.build_seconds is not None else 'cached'} s), "
        f"flags {' '.join(_native.NVCC_FLAGS)}")
    return smi


def bound_ms(nbytes: float, ops: float):
    """(least ms, "bytes" or "operations") for moving nbytes and doing ops."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / FP32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def pair_census(cell_starts, wm, statics, scale, tq):
    """(tested pairs, pairs inside the radius) of one tile walk."""
    import numpy as np
    import torch
    from adaptive_sph_torch.ops.numerics import fma
    from adaptive_sph_torch.ops.pair_ops import walk_pairs

    tested = inside = 0
    s32 = float(np.float32(scale))
    for qi, cj in walk_pairs(cell_starts, wm, statics[:, 2] > 0.0, tq):
        sq, sc = statics[qi], statics[cj]
        h_ij = torch.clamp(0.5 * (sq[:, 2] + sc[:, 2]), min=1e-6)
        dx, dy = sq[:, 0] - sc[:, 0], sq[:, 1] - sc[:, 1]
        rad = s32 * h_ij
        tested += qi.numel()
        inside += int(((fma(dx, dx, dy * dy) < rad * rad) & (sc[:, 2] > 0)).sum())
    return tested, inside


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
        C = tcfg.capacity
        P = k.num_pairs
        tested, _ = pair_census(bins.cell_starts, wm, flat[:, 0:4].contiguous(),
                                physics_scale(sim.params), tcfg.tq)
        wb = 2 if bench else 4
        b_k1 = bound_ms(C * 24 + (C + 1) * 4 + P * (4 + 4 * wb) + C * 16,
                        P * (OPS_PAIR_GEOM + OPS_K1_PAIR + OPS_K1_VISC))
        log(f"K1 pair_build [{tag}]: {P} pairs of {tested} tested, structure equal, max abs err "
            f"{k1_abs:.3e}, max rel err {k1_rel:.3e} (tol {tol_w:g} stored, {TOL_F32:g} sums); "
            f"kernel {t_k1:.4f} ms, plain {t_k1r:.4f} ms, bound {b_k1[0]:.4f} ms ({b_k1[1]})")

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
        # the library yardstick for K2: one CSR sparse-times-dense product
        # with the x and y weight rows stacked into a (2C, C) matrix
        rp2 = torch.cat([k.row_ptr, k.row_ptr[1:] + P])
        a2 = torch.sparse_csr_tensor(rp2, torch.cat([k.col, k.col]), k.w.float().reshape(-1),
                                     size=(2 * C, C))
        lib = a2 @ u[:, None]
        torch.cuda.synchronize()
        e_lib, _ = rel_err(lib[:, 0], torch.cat(pair_ops.pair_matvec_ref(k, u, 2)))
        t_lib = time_ms(lambda: a2 @ u[:, None], 200)
        log(f"K2 library yardstick (torch.sparse_csr_tensor @ dense, both rows) [{tag}]: "
            f"{t_lib:.4f} ms, max abs diff to the plain version {e_lib:.3e}")
        b_k2 = bound_ms((C + 1) * 4 + P * (4 + 2 * wb) + C * 4 + 2 * C * 4, 4 * P)
        b_k3 = bound_ms((C + 1) * 4 + P * (4 + 2 * wb) + C * 4 + 2 * C * 4, 7 * P)
        out = {"pair_build": (k1_abs, t_k1, t_k1r, b_k1, None)}
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
            bnd = b_k3 if name == "pair_visc" else b_k2
            out[name] = (worst_abs, tk, tr, bnd, t_lib if name == "pair_matvec_accel" else None)
            log(f"{name} [{tag}]: max abs err {worst_abs:.3e}, max rel err {worst_rel:.3e} "
                f"(tol {TOL_F32:g}); kernel {tk:.4f} ms, plain {tr:.4f} ms, bound "
                f"{bnd[0]:.4f} ms ({bnd[1]})")
        results[tag] = out
        del sim, k, r
        torch.cuda.empty_cache()
    return results


def phase_sweeps():
    """pair_sweep vs its plain version for the nine ops, on the inputs the
    default dam break's first step hands them (captured from that step)."""
    import torch
    from adaptive_sph_torch.models import adaptivity, scene, tile_step
    from adaptive_sph_torch.ops import sweeps
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.utils.params import load_params

    sim = create_simulation(load_params(CONFIG), scene.load_scene(SCENE), device="cuda",
                            counters_enabled=False)
    C, levels = sim.state.capacity, len(sim.tile_cfg.populated)
    captured = {}
    real = sweeps.pair_sweep

    def spy(cell_starts, wm, statics, dyn, op, scale, tq):
        if op.name not in captured:
            captured[op.name] = (cell_starts.clone(), wm.clone(), statics.clone(),
                                 None if dyn is None else dyn.clone(), op, scale, tq)
        return real(cell_starts, wm, statics, dyn, op, scale, tq)

    tile_step.pair_sweep = adaptivity.pair_sweep = spy
    try:
        sim.step()
    finally:
        tile_step.pair_sweep = adaptivity.pair_sweep = real
    torch.cuda.synchronize()
    want = list(OPS_SWEEP_EMIT)
    if sorted(captured) != sorted(want):
        raise AssertionError(f"the first step ran the sweeps {sorted(captured)}, expected {want}")
    log(f"pair_sweep inputs: the default dam break's first step, C = {C}, {levels} populated "
        f"levels")
    per_op = {}
    for name in want:
        cs, wm, st, dyn, op, scale, tq = captured[name]
        got = sweeps.pair_sweep(cs, wm, st, dyn, op, scale, tq)
        ref = sweeps.pair_sweep_ref(cs, wm, st, dyn, op, scale, tq)
        torch.cuda.synchronize()
        g, r = got.double(), ref.double()
        err = float((g - r).abs().max())
        if op.reduce == "max" or name in ("count", "adapt_cnt0", "adapt_cnt1"):
            if not torch.equal(got, ref):
                raise AssertionError(f"pair_sweep {name}: {int((got != ref).sum())} values "
                                     f"differ from the plain version (must be equal)")
            tol_txt = "equal"
        else:
            rel = float(((g - r).abs() / (r.abs().amax(0, keepdim=True) + 1e-30)).max())
            if not rel < TOL_F32:
                raise AssertionError(f"pair_sweep {name}: rel err {rel:.3e} >= {TOL_F32:g}")
            tol_txt = f"rel err {rel:.3e} (tol {TOL_F32:g} of the column max)"
        tested, inside = pair_census(cs, wm, st, scale, tq)
        D = 0 if dyn is None else dyn.shape[1]
        if st.shape[0] != C:
            raise AssertionError(f"pair_sweep {name}: captured at C = {st.shape[0]}, not {C}")
        b = bound_ms(C * 16 + C * D * 4 + C * op.n_out * 4 + cs.numel() * 4 + wm.numel() * 4,
                     inside * (OPS_PAIR_GEOM + OPS_SWEEP_EMIT[name]))
        tk = time_ms(lambda: sweeps.pair_sweep(cs, wm, st, dyn, op, scale, tq), 50)
        tr = time_ms(lambda: sweeps.pair_sweep_ref(cs, wm, st, dyn, op, scale, tq), 5)
        per_op[name] = (err, tk, tr, b)
        log(f"pair_sweep {name}: {tested} tested pairs, {inside} inside the radius "
            f"(scale {scale:.6g}); {tol_txt}, max abs err {err:.3e}; kernel {tk:.4f} ms, "
            f"plain {tr:.4f} ms, bound {b[0]:.5f} ms ({b[1]})")
    err = max(v[0] for v in per_op.values())
    tk = sum(v[1] for v in per_op.values())
    tr = sum(v[2] for v in per_op.values())
    tb = sum(v[3][0] for v in per_op.values())
    by = "bytes" if sum(v[3][1] == "bytes" for v in per_op.values()) > len(per_op) / 2 \
        else "operations"
    log(f"pair_sweep, one launch of each of the nine ops: kernel {tk:.4f} ms, plain {tr:.4f} ms, "
        f"bound {tb:.5f} ms")
    del sim
    torch.cuda.empty_cache()
    return err, tk, tr, (tb, by)


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


def phase_dambreak_trajectory():
    """10 steps of the default dam break on the GPU against the JAX fixture:
    per-step census and counts equal, then the matched state."""
    import numpy as np
    import torch
    from adaptive_sph_torch.models import scene
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.utils.params import load_params

    ref = np.load(DAMBREAK_FIXTURE)
    sim = create_simulation(load_params(CONFIG), scene.load_scene(SCENE), device="cuda",
                            counters_enabled=False)
    ints = ("n", "capacity", "div_iterations", "density_iterations", "shares",
            "merge_or_split_count", "split_deferred")
    for k in range(len(ref["n"])):
        d = sim.step()
        d = {**d, "n": sim.num_fluid_particles, "capacity": sim.state.capacity}
        bad = [f"{x} {d[x]} != {int(ref[x][k])}" for x in ints if int(d[x]) != int(ref[x][k])]
        if np.float32(d["dt"]) != ref["dt"][k]:
            bad.append(f"dt {d['dt']} != {ref['dt'][k]}")
        if bad:
            raise AssertionError(f"dam break step {k + 1}: " + "; ".join(bad))
    st = sim.state
    a = st.alive.cpu().numpy()
    got = {x: getattr(st, x).cpu().numpy()[a] for x in ("position", "velocity", "density",
                                                        "mass", "level")}
    if len(got["position"]) != len(ref["position"]):
        raise AssertionError("dam break particle count differs from the reference")
    j = match_by_position(ref["position"], got["position"])
    dev = {"dx": float(np.abs(got["position"][j] - ref["position"]).max()),
           "drho_rel": float(np.abs(got["density"][j] / ref["density"] - 1).max()),
           "dv": float(np.abs(got["velocity"][j] - ref["velocity"]).max()),
           "dm_rel": float(np.abs(got["mass"][j] / ref["mass"] - 1).max()),
           "dlevel": float(np.abs(got["level"][j] - ref["level"]).max())}
    log(f"dam break vs JAX ({len(ref['n'])} steps, n {ref['n'].tolist()}): census, capacity, "
        f"resampling counts, dt and iterations equal at every step; max |dx| {dev['dx']:.3e} "
        f"(tol 2e-5), rel drho {dev['drho_rel']:.3e} (2e-5), |dv| {dev['dv']:.3e} (2e-4), "
        f"rel dm {dev['dm_rel']:.3e} (1e-5), |dlevel| {dev['dlevel']:.3e} (2e-5)")
    if not (dev["dx"] < 2e-5 and dev["drho_rel"] < 2e-5 and dev["dv"] < 2e-4
            and dev["dm_rel"] < 1e-5 and dev["dlevel"] < 2e-5):
        raise AssertionError("dam break state differs from the JAX reference beyond tolerance")
    del sim
    torch.cuda.empty_cache()


def timed_dambreak():
    """The default dam break through create_simulation (timed), then through
    the CLI entry point; returns the launch counts of the timed run."""
    import numpy as np
    import torch
    from adaptive_sph_torch import cli
    from adaptive_sph_torch.models import scene
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.utils.params import load_params

    params = load_params(CONFIG)
    sim = create_simulation(params, scene.load_scene(SCENE), device="cuda")
    n0, cap0 = sim.num_fluid_particles, sim.state.capacity
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    pair_ops.reset_launches()
    t0 = time.perf_counter()
    diags = sim.step_chunk(STEPS_DAMBREAK)
    torch.cuda.synchronize()
    el = time.perf_counter() - t0
    launches = dict(pair_ops.launches)
    st = sim.state
    alive = st.alive
    for name in ("position", "velocity", "density", "mass", "level"):
        if not bool(torch.isfinite(getattr(st, name)[alive]).all()):
            raise AssertionError(f"non-finite {name} after the timed dam break")
    if max(diags["mass_conservation_error"]) >= 0.005:
        raise AssertionError("mass not conserved in the timed dam break")
    counts = np.asarray(diags["particle_count"], np.float64)
    growths = sim.counters.values.get("capacity-growth", [])
    log(f"timed dam break: {STEPS_DAMBREAK} steps, {el / STEPS_DAMBREAK * 1e3:.4f} ms/step, "
        f"{counts.sum() / el:.1f} particle updates/s, n {n0} -> {sim.num_fluid_particles} "
        f"(mean {counts.mean():.1f}), capacity {cap0} -> {st.capacity} "
        f"({len(growths)} growths), t = {sim.time:.4f} s, wavefront sweeps/step "
        f"{np.mean(diags['wavefront_sweeps']):.2f}, pair_sweep launches/step "
        f"{launches['pair_sweep'] / STEPS_DAMBREAK:.2f}, mean div / density iters "
        f"{np.mean(diags['div_iterations']):.2f} / {np.mean(diags['density_iterations']):.2f}, "
        f"pairs/step {np.mean(diags['num_pairs']):.1f}, peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, launches {launches}")
    del sim
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc = cli.main(["run", CONFIG, SCENE, "--max-steps", str(STEPS_CLI)])
    if rc != 0:
        raise AssertionError(f"adaptive_sph_torch.cli run returned {rc}")
    log(f"cli run: {STEPS_CLI} steps on the default device in {time.perf_counter() - t0:.2f} s")
    return launches


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
    sweep_res = phase_sweeps()
    if "--kernels-only" in argv:
        return 0
    phase_trajectory()
    phase_dambreak_trajectory()
    timed_run(bench=False, reset_counters=False)
    stress = timed_run(bench=True, reset_counters=True)
    missing = [k for k in ("pair_build", "pair_matvec", "pair_visc") if stress[k] <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the stress path: {missing}")
    launches = timed_dambreak()
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels never launched on the dam-break path: {missing}")

    f32 = kres["f32"]
    rows = {"pair_build": f32["pair_build"], "pair_matvec": f32["pair_matvec_accel"],
            "pair_visc": f32["pair_visc"], "pair_sweep": (*sweep_res, None)}
    entries = []
    for name, (err, ms, plain, bnd, lib) in rows.items():
        if name == "pair_matvec":
            err = max(err, f32["pair_matvec_div"][0])
        entries.append({"name": name, "route": "cuda", "source": SOURCES[name],
                        "replaces": REPLACES[name], "launches": launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd[0],
                        "bound_by": bnd[1], "library_ms": lib})
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
