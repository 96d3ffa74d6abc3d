"""The ratio-stress-test configuration of bench.py, the impact scene, and a
profiler for the step.

`stress_scene()` and `stress_params(...)` rebuild bench.py's scene (n =
11,835, 50:1 radius ratio) and parameters for the port:

- parity options (the default): f32 pair weights, cold-start solves,
  momentum 0; bench=True: the bench options, bf16 pair storage, warm start
  and momentum 0.9;
- resident=True: the whole-solve kernels (`resident_solver`). They have no
  momentum: with jacobi_momentum != 0 the reference keeps `resident_solver`'s
  classic branch but solves it streamed, so the bench options set momentum 0
  here: bench.py's default momentum 0.9 never reaches the resident kernels;
- iisph=True: IISPH with the solver settings of
  configs/media/ratio-stress-test-video.yaml (iisph_max_avg_density_error
  0.001, cfl_factor 0.2, max_dt 0.001). Departure from that config: the
  boundary stays bench.py's AnalyticOverestimate box; its
  AnalyticUnderestimate polygon is not ported.

`impact_scene()` / `impact_params(method)`: one block of 144 particles
thrown at the floor (velocity (3, -3)), uniform sizes, no resampling,
max_iters 60, capacity 1024. Unlike the stress scene's first steps, whose
solves stop at the 2-iteration floor, its solves iterate (13-60 sweeps,
the 60 cap included), so it exercises the exit test.

    python -m adaptive_sph_torch.stress [--bench] [--resident] [--iisph] [--steps 20]
        [--trace OUT.json]
    python -m adaptive_sph_torch.stress --config configs/default-config.yaml \
        --scene configs/default-scene.yaml [--steps 20]

profiles the step on a CUDA GPU (the stress scene, or the given config and
scene YAML files): warm-up, then `--steps` steps under torch.profiler;
prints ms/step (host clock, synchronised), the device-busy share of that
wall time and the kernels by total device time.
"""

from __future__ import annotations

import argparse
import subprocess
import time

from .models import scene as scene_mod
from .utils.params import ParticleSizes, PressureSolverMethod, SimulationParams

STRESS_SCENE = {
    "boundary": {"type": "box", "width": 2, "height": 2},
    "blocks": [
        {"pos": [0.4, -0.5], "size": [0.55, 1.4], "spacing": 0.4,
         "volume_fill_ratio": 0.93, "velocity": [0, 0]},
        {"pos": [-0.95, -0.5], "size": [0.55, 1.4], "spacing": 0.008,
         "volume_fill_ratio": 0.93, "velocity": [0, 0]},
    ],
}
IMPACT_SCENE = {
    "boundary": {"type": "box", "width": 2, "height": 2},
    "blocks": [{"pos": [0.4, -0.9], "size": [0.55, 1.0], "spacing": 0.06,
                "volume_fill_ratio": 0.93, "velocity": [3.0, -3.0]}],
}
IMPACT_CAPACITY = 1024


def stress_scene(replicas: int = 1):
    """The stress scene, or `replicas` copies of its two blocks side by side
    in a box 2 x replicas wide (bench.py's build_sim layout; x4: n = 47,340)."""
    if replicas == 1:
        return scene_mod.scene_from_dict(STRESS_SCENE)
    blocks = []
    for k in range(replicas):
        off = 2.0 * k - (replicas - 1.0)
        for b in STRESS_SCENE["blocks"]:
            blocks.append({**b, "pos": [b["pos"][0] + off, b["pos"][1]]})
    return scene_mod.scene_from_dict({"boundary": {"type": "box", "width": 2 * replicas,
                                                   "height": 2}, "blocks": blocks})


def impact_scene():
    return scene_mod.scene_from_dict(IMPACT_SCENE)


def stress_params(bench: bool = False, resident: bool = False,
                  iisph: bool = False) -> SimulationParams:
    p = SimulationParams(
        merging=False, sharing=False, splitting=False, max_iters=200,
        hybrid_dfsph_max_avg_density_error=0.001,
        hybrid_dfsph_max_avg_divergence_error=0.0001,
        hybrid_dfsph_factor=1000000.0, cfl_factor=0.3, max_dt=0.003,
        warm_start_pressure=bench, weight_cache_bf16=bench,
        jacobi_momentum=0.9 if bench and not resident else 0.0,
        resident_solver=resident,
    )
    if iisph:
        p = p.replace(pressure_solver_method=PressureSolverMethod.IISPH,
                      iisph_max_avg_density_error=0.001, cfl_factor=0.2, max_dt=0.001)
    return p


def impact_params(method: PressureSolverMethod, resident: bool = True, **kw) -> SimulationParams:
    return SimulationParams(particle_sizes=ParticleSizes.Uniform, merging=False, sharing=False,
                            splitting=False, max_iters=60, pressure_solver_method=method,
                            resident_solver=resident, **kw)


def resident_runs():
    """The resident trajectories of tests/data/torch_port_resident_ref.npz:
    run name -> (params, scene dict, capacity or None, steps)."""
    M = PressureSolverMethod
    return {
        "stress_hybrid": (stress_params(resident=True), STRESS_SCENE, None, 10),
        "stress_iisph": (stress_params(resident=True, iisph=True), STRESS_SCENE, None, 10),
        "impact_hybrid": (impact_params(M.HybridDFSPH), IMPACT_SCENE, IMPACT_CAPACITY, 6),
        "impact_iisph": (impact_params(M.IISPH), IMPACT_SCENE, IMPACT_CAPACITY, 6),
        "impact_only_divergence": (impact_params(M.OnlyDivergence), IMPACT_SCENE,
                                   IMPACT_CAPACITY, 6),
    }


MEDIA_CONFIG = "configs/media/winchenbach-iisph-instabilities.yaml"


def media_run():
    """(params, scene dict) of the first entry of the Winchenbach
    IISPH-instabilities export list (configs/media/ of this checkout): its
    config_path loaded with its update_attributes, as the reference's image
    export loads them, and its scene_file."""
    import os

    import yaml

    from .utils.params import load_params

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), MEDIA_CONFIG)
    with open(path) as f:
        cfg = yaml.safe_load(f)[0]
    base = os.path.dirname(path)
    params = load_params(os.path.join(base, cfg["config_path"]),
                         update_attributes=cfg.get("update_attributes") or {})
    with open(os.path.join(base, cfg["scene_file"])) as f:
        scene = yaml.safe_load(f)
    return params, scene


# steps of the media configuration's trajectory. The configuration is
# chaotic by design: the JAX package against itself with 1-ulp noise in the
# initial positions leaves the trajectory tolerances at the first step
# (velocity 2.5e-4) but keeps equal per-step dt, iteration and negative-a_ii
# counts over 238 steps (scripts/torch_port_solvers_ref.py --spread 300), so
# the run is held to those counts over these steps
MEDIA_STEPS = 200


def solver_runs():
    """The trajectories of tests/data/torch_port_solvers_ref.npz (the rest of
    the solver surface: Winchenbach2020, IISPH2, WCSPH viscosity, the
    non-pressure step after the divergence solve): run name -> (params,
    scene dict, capacity or None, steps)."""
    import dataclasses

    from .utils.params import OperatorDiscretization, ViscosityType

    M = PressureSolverMethod
    W2020 = dict(operator_discretization=OperatorDiscretization.Winchenbach2020)
    rep = dataclasses.replace
    media, media_scene = media_run()
    return {
        "stress_w2020_hybrid": (rep(stress_params(), **W2020), STRESS_SCENE, None, 10),
        "stress_w2020_hybrid_resident": (rep(stress_params(resident=True), **W2020),
                                         STRESS_SCENE, None, 10),
        "stress_iisph2_wcsph_resident": (
            rep(stress_params(resident=True, iisph=True), pressure_solver_method=M.IISPH2,
                viscosity_type=ViscosityType.WCSPH, viscosity=0.003), STRESS_SCENE, None, 10),
        "stress_wcsph_visc_after_div": (
            rep(stress_params(), viscosity_type=ViscosityType.WCSPH, viscosity=0.003,
                hybrid_dfsph_non_pressure_accel_before_divergence_free=False),
            STRESS_SCENE, None, 10),
        "impact_w2020_hybrid": (impact_params(M.HybridDFSPH, **W2020), IMPACT_SCENE,
                                IMPACT_CAPACITY, 6),
        "impact_w2020_iisph": (impact_params(M.IISPH, **W2020), IMPACT_SCENE, IMPACT_CAPACITY, 6),
        "impact_w2020_only_divergence": (impact_params(M.OnlyDivergence, **W2020), IMPACT_SCENE,
                                         IMPACT_CAPACITY, 6),
        "winchenbach_instabilities": (media, media_scene, None, MEDIA_STEPS),
    }


def card() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--bench", action="store_true", help="bench options instead of parity")
    ap.add_argument("--resident", action="store_true", help="the whole-solve kernels")
    ap.add_argument("--iisph", action="store_true", help="IISPH (video config's settings)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace", default=None, help="write a chrome trace here")
    ap.add_argument("--config", default=None, help="simulation config YAML instead of the "
                    "stress scene (with --scene)")
    ap.add_argument("--scene", default=None, help="scene YAML (with --config)")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .runner import create_simulation

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(card())
    if args.config:
        from .utils.params import load_params

        sim = create_simulation(load_params(args.config), scene_mod.load_scene(args.scene),
                                device="cuda", counters_enabled=False)
        label = args.config
    else:
        sim = create_simulation(stress_params(args.bench, args.resident, args.iisph),
                                stress_scene(), device="cuda", counters_enabled=False)
        label = ("iisph " if args.iisph else "") + ("bench" if args.bench else "parity") + (
            " resident" if args.resident else "")
    for _ in range(10):
        sim.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        diags = sim.step_chunk(args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA)
    print(f"{label}: {wall / args.steps * 1e3:.4f} ms/step "
          f"(profiled), device busy {dev_us / 1e3 / (wall * 1e3):.3f} of wall, "
          f"div iters {diags.get('div_iterations')}, "
          f"density iters {diags.get('density_iterations')}, "
          f"particles {diags['particle_count'][-1]}")
    kernels = sum(e.count for e in events if e.device_type == torch.autograd.DeviceType.CUDA)
    syncs = sum(e.count for e in events if "Synchronize" in e.key)
    print(f"per step: {kernels / args.steps:.1f} device kernels, {syncs / args.steps:.1f} "
          f"host synchronisations, {dev_us / 1e3 / args.steps:.4f} ms device time")
    print(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
