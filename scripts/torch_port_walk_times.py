"""Device times of the default dam break's pair sweeps, of the whole-solve
kernels (pair_jacobi, pair_hybrid) and of the steps that run them, on one
CUDA GPU.

    python scripts/torch_port_walk_times.py [--root DIR] [--out FILE] [--solves]

`--root DIR` imports adaptive_sph_torch from DIR (a checkout of another
commit, with its own kernels), so two commits can be measured in one
call on one card, in turns: parent, change, change, parent. Prints the
card's name and power limit, one line per measurement and, last, one JSON
object of them all (also written to FILE with --out).

Measured (torch.profiler device time per call, the mean of 20 calls; the
walks on the stress layouts, K1 in each mode and the DENSITY sweep, are
timed by chip_smoke.py phase 2f):
  - the whole-solve kernels, device ms per launch and per sweep (sweeps
    from the launch's own statistics): the stage timer's synthetic density
    solve (a_ii = -1, source -0.05, 200 iterations, the cap; pair_jacobi)
    and hybrid section (pair_hybrid) on the weights-only list of the
    stress scene at x1 and x4 (bench options, as adaptive_sph_torch.timing
    builds them); the impact scene's iterating solves (HybridDFSPH and
    OnlyDivergence step 4, IISPH step 5); and an empty pair list of 8,192
    rows run to 200 iterations, whose sweeps are the grid syncs and the
    exit test alone;
  - the stress x1 step (parity options): ms/step over 30 steps after 10
    warm-up steps (host clock, synchronised), then device ms/step over 10
    profiled steps; the same on the resident (classic) branch, whose solves
    are pair_hybrid launches, at x1 and x4;
  - the nine pair_sweep ops of the default dam break's first step, on the
    inputs that step gives them, and the default dam break: ms/step over
    its first 100 steps, then 10 profiled steps: device ms/step and
    pair_sweep's share of it.
`--solves` runs the whole-solve kernels and the resident steps only.
`--matvec` runs the pair-list products and the steps that stream them only:
  - K2 `pair_matvec` (accel, div), K3 `pair_visc`, K2s
    `pair_matvec_scalar` (accel) and K3s `pair_visc_scalar`, device ms per
    launch, on the stress scene's first-step lists at x1 and x4 (parity
    options: K1 mega mode with viscosity, f32 storage, and its scalar-g
    mode) and on the default dam break's list at step 101; K2 accel on the
    x1 list with every row empty (`obase`: the launch's fixed cost);
  - the streamed stress step (parity options) at x1 and x4 and the default
    dam break, ms/step and device ms/step as above.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(HERE))
    ap.add_argument("--out", default=None)
    ap.add_argument("--solves", action="store_true",
                    help="only the whole-solve kernels and the resident steps")
    ap.add_argument("--matvec", action="store_true",
                    help="only the pair-list products K2 / K3 and the streamed steps")
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_port_walk_times: needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    print(f"package: {root}", flush=True)
    out = {"card": card, "root": root}

    def put(key, value, unit=" ms"):
        out[key] = value
        print(f"{key}: {value:.4f}{unit}", flush=True)

    if args.matvec:
        from adaptive_sph_torch.ops import pair_ops

        shape = [getattr(pair_ops, k, None) for k in ("STREAM_K", "STREAM_SHAPES")]
        print(f"K2 / K3 shape (K, (G, threads, blocks per SM) per shape): {shape}", flush=True)
        matvec_times(put)
        step_times(put, root, "matvec")
    else:
        solve_times(put)
        if not args.solves:
            walk_times(put, root)
        step_times(put, root, "solves" if args.solves else "all")
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)


def stream_times(put, tag, two, sc, live, seed=0):
    """Device ms per launch of K2 (accel, div), K3, K2s (accel) and K3s on
    the two-row list `two` and the scalar-g list `sc` of the same pairs;
    first the list's pairs per live row (live: (C,) bool), mean and max."""
    import numpy as np
    import torch

    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.timing import device_ms

    C = two.row_ptr.shape[0] - 1
    per_row = (two.row_ptr[1:] - two.row_ptr[:-1])[live].float()
    put(f"{tag} pairs per live row, mean", float(per_row.mean()), "")
    put(f"{tag} pairs per live row, max", float(per_row.max()), "")
    rng = np.random.default_rng(seed)
    u, tx, ty = (torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).cuda()
                 for _ in range(3))
    rho = torch.from_numpy(rng.uniform(0.8, 1.2, C).astype(np.float32)).cuda()
    runs = (("K2 accel", lambda: pair_ops.pair_matvec(two, u, 2), "pair_matvec_kernel"),
            ("K2 div", lambda: pair_ops.pair_matvec(two, (tx, ty), 1), "pair_matvec_kernel"),
            ("K3", lambda: pair_ops.pair_visc(two, rho), "pair_visc_kernel"),
            ("K2s accel", lambda: pair_ops.pair_matvec_scalar(sc, u, 2), "pair_matvec_kernel"),
            ("K3s", lambda: pair_ops.pair_visc_scalar(sc, rho), "pair_visc_kernel"))
    for name, fn, kernel in runs:
        put(f"{tag} {name}", device_ms(fn, 50, kernel))


def matvec_times(put):
    """K2 / K3 / K2s / K3s on the stress scene's first-step lists, and K2 on
    the x1 list with every row empty."""
    import torch

    from adaptive_sph_torch.models.tile_step import physics_scale, step_geometry
    from adaptive_sph_torch.ops import pair_ops
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import stress_params, stress_scene
    from adaptive_sph_torch.timing import device_ms

    for replicas in (1, 4):
        sim = create_simulation(stress_params(), stress_scene(replicas), device="cuda",
                                counters_enabled=False)
        params, tcfg = sim.params, sim.tile_cfg
        _, bins, cols, wm = step_geometry(sim.state, params, tcfg)
        args = (bins.cell_starts, wm, cols["flat"], tcfg.tq, float(physics_scale(params)),
                float(params.viscosity), True, torch.float32)
        two = pair_ops.pair_build(*args)
        sc = pair_ops.pair_build(*args, scalar=True)
        C = tcfg.capacity
        live = cols["flat"][:, 2] > 0
        stream_times(put, f"stress x{replicas} (C = {C}, {int(live.sum())} live rows, "
                     f"{two.num_pairs} pairs)", two, sc, live)
        if replicas == 1:
            empty = pair_ops.PairCSR(torch.zeros_like(two.row_ptr), two.col[:0],
                                     two.w[:, :0].contiguous(), None, None)
            u = torch.zeros(C, dtype=torch.float32, device=two.col.device)
            put(f"obase: K2 accel, C = {C}, every row empty",
                device_ms(lambda: pair_ops.pair_matvec(empty, u, 2), 50, "pair_matvec_kernel"))
        del sim, two, sc
        torch.cuda.empty_cache()


def solve_device_ms(put, tag, kernel, fn, sweeps):
    """Device ms per launch of `kernel` under fn() and per sweep."""
    from adaptive_sph_torch.timing import device_ms

    d = device_ms(fn, 20, kernel)
    put(f"{tag} {kernel} per solve", d)
    put(f"{tag} {kernel} per sweep ({sweeps} sweeps)", d / sweeps)


def solve_times(put):
    """The whole-solve kernels' device time per launch and per sweep."""
    import numpy as np
    import torch

    from adaptive_sph_torch.models import tile_physics as tp
    from adaptive_sph_torch.models.solver import DENSITY_ERROR
    from adaptive_sph_torch.models.tile_step import physics_scale
    from adaptive_sph_torch.ops import jacobi, kernels, pair_ops
    from adaptive_sph_torch.ops.tiles import build_tiles, sort_fields, window_meta
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import (IMPACT_CAPACITY, impact_params, impact_scene,
                                           stress_params, stress_scene)
    from adaptive_sph_torch.utils.params import PressureSolverMethod as M

    # the stage timer's synthetic solves on the stress scene's weights-only list
    for replicas in (1, 4):
        sim = create_simulation(stress_params(bench=True), stress_scene(replicas),
                                device="cuda", counters_enabled=False)
        st, params, tcfg = sim.state, sim.params, sim.tile_cfg
        h = kernels.smoothing_length_from_mass(st.mass, params.rest_density, 2)
        bins = build_tiles(st.position, h * tcfg.mscale, h, st.alive, tcfg)
        stt = sort_fields(bins, [st.position, h, st.mass, h])[:, 0:4].contiguous()
        wm = window_meta(tcfg, bins, stt)
        wl = pair_ops.pair_weights(bins.cell_starts, wm, stt, tcfg.tq,
                                   float(physics_scale(params)))
        C = tcfg.capacity
        rho = torch.full((C,), params.rest_density, dtype=torch.float32, device=st.device)
        rinv, zc = 1.0 / rho, torch.zeros_like(rho)
        alive = stt[:, 2] > 0.0
        aii = torch.where(alive, -torch.ones_like(zc), zc)
        src = torch.where(alive, torch.full_like(zc, -0.05), zc)
        dt = torch.tensor(1e-3, dtype=torch.float32, device=st.device)

        # the zero S1, (S2,) G rows: a tree given by --root may predate the S2
        # arguments
        zs = (zc,) * (6 if "s2x" in inspect.signature(tp.tile_jacobi_resident).parameters else 4)

        def resident():
            return tp.tile_jacobi_resident(wl, aii, src, alive, 0.0005, DENSITY_ERROR, params,
                                           dt, rho, rinv, *zs, "none")

        def hybrid():
            return tp.tile_hybrid_resident(wl, aii, alive, params, dt, rho, rinv, *zs, "none", zc,
                                           zc, True, p0_div=zc, p0_den=zc)

        tag = f"stress x{replicas} (C = {C}, {wl.num_pairs} pairs)"
        solve_device_ms(put, tag + " synthetic density solve", "pair_jacobi", resident,
                        int(resident().iterations) + 1)
        res_div, res_den = hybrid()[:2]
        solve_device_ms(put, tag + " hybrid section", "pair_hybrid", hybrid,
                        int(res_div.iterations) + int(res_den.iterations) + 2)
        del sim, wl
        torch.cuda.empty_cache()

    # the impact scene's iterating solves, on the inputs their step gives them
    for method, step in ((M.HybridDFSPH, 4), (M.OnlyDivergence, 4), (M.IISPH, 5)):
        sim = create_simulation(impact_params(method), impact_scene(), capacity=IMPACT_CAPACITY,
                                device="cuda", counters_enabled=False)
        for _ in range(step - 1):
            sim.step()
        name = "hybrid_solve" if method == M.HybridDFSPH else "jacobi_solve"
        real, seen = getattr(jacobi, name), []

        def spy(*a, **k):
            seen.append((a, k))
            return real(*a, **k)

        setattr(jacobi, name, spy)
        try:
            sim.step()
        finally:
            setattr(jacobi, name, real)
        a, kw = seen[0]
        stats = real(*a, **kw)[1]
        offs = (0, 8) if name == "hybrid_solve" else (0,)
        sweeps = sum(int(stats[o + jacobi.S_ITERS]) + 1 for o in offs)
        kernel = "pair_hybrid" if name == "hybrid_solve" else "pair_jacobi"
        solve_device_ms(put, f"impact {method.value} step {step}", kernel,
                        lambda: real(*a, **kw), sweeps)
        del sim

    # an empty pair list: each sweep is the grid syncs and the exit test
    C, rng = 8192, np.random.default_rng(0)
    T = np.zeros((jacobi.T_ROWS, C), np.float32)
    T[[jacobi.T_NSING, jacobi.T_RINV, jacobi.T_ALIVE]] = 1.0
    T[jacobi.T_SRC] = rng.uniform(1.0, 2.0, C)
    T[jacobi.T_WAII] = 0.01
    T[jacobi.T_RHO] = 1000.0
    dev = torch.device("cuda")
    table = torch.from_numpy(T).to(dev)
    empty = pair_ops.PairCSR(torch.zeros(C + 1, dtype=torch.int32, device=dev),
                             torch.zeros(0, dtype=torch.int32, device=dev),
                             torch.zeros(2, 0, dtype=torch.float32, device=dev), None, None)
    scal = torch.tensor([1e-3, 0.0, 1000.0, 0.0], dtype=torch.float32, device=dev)

    def barrier():
        return jacobi.jacobi_solve(empty, table, scal, density_type=True, max_iters=200, mp=0.0)

    stats = barrier()[1]
    grid = int(stats[jacobi.S_GRID])
    solve_device_ms(put, f"empty list (C = {C}, grid {grid} blocks)", "pair_jacobi", barrier,
                    int(stats[jacobi.S_ITERS]) + 1)


def walk_times(put, root):
    """The dam break's first-step sweeps."""
    import torch

    from adaptive_sph_torch.models import adaptivity, scene, tile_step
    from adaptive_sph_torch.ops import sweeps
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.timing import device_ms
    from adaptive_sph_torch.utils.params import load_params

    # the dam break's first-step sweeps, on the inputs that step gives them
    config = os.path.join(root, "configs", "default-config.yaml")
    scene_file = os.path.join(root, "configs", "default-scene.yaml")
    sim = create_simulation(load_params(config), scene.load_scene(scene_file), device="cuda",
                            counters_enabled=False)
    captured = {}
    real = sweeps.pair_sweep

    def spy(*a):
        captured.setdefault(a[4].name, tuple(x.clone() if torch.is_tensor(x) else x for x in a))
        return real(*a)

    tile_step.pair_sweep = adaptivity.pair_sweep = spy
    try:
        sim.step()
    finally:
        tile_step.pair_sweep = adaptivity.pair_sweep = real
    for name, a in sorted(captured.items()):
        put(f"dam-break pair_sweep {name}", device_ms(lambda a=a: real(*a), 20, "pair_sweep_kernel"))
    del sim
    torch.cuda.empty_cache()


def step_times(put, root, mode):
    """ms/step and device ms/step of the stress steps, then the dam break.
    mode "solves": the resident steps only; "matvec": the streamed stress
    steps at x1 and x4, then the dam break with its list at step 101 timed
    by stream_times; "all": the parity x1 and resident steps, the dam
    break."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from adaptive_sph_torch.models import scene
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.stress import stress_params, stress_scene
    from adaptive_sph_torch.utils.params import load_params

    def profiled(sim, steps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sim.step_chunk(steps)
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in ev)
        sweep = sum(e.self_device_time_total for e in ev if "pair_sweep_kernel" in e.key)
        return total / 1e3 / steps, sweep / max(total, 1e-30)

    runs = [("stress x1 resident", stress_params(resident=True), 1),
            ("stress x4 resident", stress_params(resident=True), 4)]
    if mode == "matvec":
        runs = [("stress x1 parity", stress_params(), 1), ("stress x4 parity", stress_params(), 4)]
    elif mode == "all":
        runs.insert(0, ("stress x1 parity", stress_params(), 1))
    for tag, p, replicas in runs:
        sim = create_simulation(p, stress_scene(replicas), device="cuda",
                                counters_enabled=False)
        sim.step_chunk(10)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step_chunk(30)
        torch.cuda.synchronize()
        put(f"{tag} ms/step", (time.perf_counter() - t0) / 30 * 1e3)
        put(f"{tag} device ms/step", profiled(sim, 10)[0])
        del sim
        torch.cuda.empty_cache()
    if mode == "solves":
        return

    config = os.path.join(root, "configs", "default-config.yaml")
    scene_file = os.path.join(root, "configs", "default-scene.yaml")
    sim = create_simulation(load_params(config), scene.load_scene(scene_file), device="cuda",
                            counters_enabled=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim.step_chunk(100)
    torch.cuda.synchronize()
    put("dam break ms/step (steps 1-100)", (time.perf_counter() - t0) / 100 * 1e3)
    if mode == "matvec":
        from adaptive_sph_torch.ops import pair_ops

        # step 101's list (mega mode with viscosity) and its scalar-g twin
        real, seen = pair_ops.pair_build, []

        def spy(*a, **k):
            seen.append((tuple(x.clone() if torch.is_tensor(x) else x for x in a), k))
            return real(*a, **k)

        pair_ops.pair_build = spy
        try:
            sim.step()
        finally:
            pair_ops.pair_build = real
        a, k = seen[0]
        two = real(*a, **k)
        sc = real(*a, **dict(k, scalar=True))
        live = a[2][:, 2] > 0
        stream_times(put, f"dam break step 101 (C = {a[2].shape[0]}, {int(live.sum())} live "
                     f"rows, {two.num_pairs} pairs)", two, sc, live)
        del two, sc
    dev, share = profiled(sim, 10)
    put("dam break device ms/step (steps 101-110)", dev)
    put("dam break pair_sweep share of device time", share, "")


if __name__ == "__main__":
    main()
