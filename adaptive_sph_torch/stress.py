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
  boundary stays bench.py's AnalyticOverestimate box, not the config's
  AnalyticUnderestimate polygon.

`impact_scene()` / `impact_params(method)`: one block of 144 particles
thrown at the floor (velocity (3, -3)), uniform sizes, no resampling,
max_iters 60, capacity 1024. Unlike the stress scene's first steps, whose
solves stop at the 2-iteration floor, its solves iterate (13-60 sweeps,
the 60 cap included), so it exercises the exit test.

    python -m adaptive_sph_torch.stress [--bench] [--resident] [--iisph] [--steps 20]
        [--trace OUT.json]
    python -m adaptive_sph_torch.stress --config configs/default-config.yaml \
        --scene configs/default-scene.yaml [--steps 20]
    python -m adaptive_sph_torch.stress --nowcache stress_nowcache_hybrid [--steps 20]

profiles the step on a CUDA GPU (the stress scene, the given config and
scene YAML files, or a run of `nowcache_runs()` under ASPH_NO_WCACHE=1):
warm-up, then `--steps` steps under torch.profiler;
prints ms/step (host clock, synchronised), the device-busy share of that
wall time, the kernels by total device time and the idle device seconds by
the innermost span of adaptive_sph_torch/spans.py open at each gap (the
profiler turns the spans on; `--trace` shows them above the kernels).
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
# a fine block (spacing 0.03) beside a coarse one (0.12), touching: the coarse
# particles at the interface count 20-40 neighbours, so the neighbourhood
# constraint shrinks their h
TWO_SIZE_SCENE = {
    "boundary": {"type": "box", "width": 2, "height": 2},
    "blocks": [{"pos": [-0.95, -0.95], "size": [0.45, 0.6], "spacing": 0.03,
                "volume_fill_ratio": 0.93, "velocity": [0, 0]},
               {"pos": [-0.5, -0.95], "size": [0.45, 0.6], "spacing": 0.12,
                "volume_fill_ratio": 0.93, "velocity": [0, 0]}],
}


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


def media_run(path: str = MEDIA_CONFIG, entry: int = 0):
    """(params, scene dict) of entry `entry` (0-based) of the export list at
    `path` (relative to this checkout's root, a file of configs/media/),
    loaded as the reference's image export loads it: its config_path with
    its update_attributes; force_diagnostic_fields when it visualizes
    ConstantField or NeighborCount, force_level_estimation when it
    visualizes Distance or shows the surface flag; its scene_file."""
    import os

    import yaml

    from .utils.params import load_params

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), path)
    with open(path) as f:
        cfg = yaml.safe_load(f)[entry]
    base = os.path.dirname(path)
    params = load_params(os.path.join(base, cfg["config_path"]),
                         update_attributes=cfg.get("update_attributes") or {})
    viz = dict(cfg.get("visualization_params") or {})
    # some export files keep the attribute at the top level
    attr = viz.get("visualized_attribute", cfg.get("visualized_attribute"))
    if attr == "Distance" or viz.get("show_flag_is_fluid_surface"):
        params = params.replace(force_level_estimation=True)
    if attr in ("ConstantField", "NeighborCount"):
        params = params.replace(force_diagnostic_fields=True)
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


# steps of each sweep-mode run on scene-ratio2to1 (~1,000 particles), of
# the constrained stress run (whose constraint reduces no particle before
# the blocks meet), of the constrained two-size dam (where it does) and of
# the impact run
SWEEP_MODE_STEPS = 10
STRESS_CHECKED_STEPS = 3
# steps of the constrained, checked stress run over which check_aii's
# per-step deviation is held against JAX's (scripts/torch_port_aii_drift_ref.py)
DRIFT_STEPS = 140
TWO_SIZE_STEPS = 4
IMPACT_CHECK_STEPS = 6


def sweep_mode_runs():
    """The trajectories of tests/data/torch_port_sweep_modes_ref.npz (the
    last modes of the pair sweep: h from the particle distribution, the
    diagnostic fields, the stash, CenterDiff after advection, the debug
    checks): run name -> (params, scene dict, capacity or None, steps).

    The two unclamped estimators (FromDistribution, FromDistribution2) take
    surface-distance.yaml's first entry with the estimator replaced: level
    estimation runs there (resampling is on), so the range-limited cone and
    wavefront run, and h_next passes through merges, shares and splits.
    constant-field.yaml's first entry, which has no resampling, grows h out
    of its populated levels under them: the JAX package stops with a level
    overflow within four steps."""
    import dataclasses

    from .utils.params import OperatorDiscretization, SupportLengthEstimation

    rep = dataclasses.replace
    S = SupportLengthEstimation
    cf, cf_scene = media_run("configs/media/constant-field.yaml", 0)
    runs = {
        "media_constant_field": (cf, cf_scene),
        "media_neighbor_numbers": media_run("configs/media/neighbor-numbers.yaml", 0),
        "media_surface_distance_first": media_run("configs/media/surface-distance.yaml", 0),
        "media_surface_distance_middle": media_run("configs/media/surface-distance.yaml", 1),
        "media_surface_detection_centerdiff": media_run("configs/media/surface-detection.yaml",
                                                        0),
    }
    sd, sd_scene = runs["media_surface_distance_first"]
    for tag, mode in (("", S.FromDistribution), ("2", S.FromDistribution2)):
        runs["ratio2to1_from_distribution" + tag] = (
            rep(sd, support_length_estimation=mode, fill_stash_with=None), sd_scene)
    out = {k: (p, sc, None, SWEEP_MODE_STEPS) for k, (p, sc) in runs.items()}
    out["stress_checked_constrained"] = (
        rep(stress_params(), constrain_neighborhood_count=True, check_aii=True,
            check_neighborhood=True), STRESS_SCENE, None, STRESS_CHECKED_STEPS)
    out["two_size_constrained"] = (
        SimulationParams(merging=False, sharing=False, splitting=False,
                         constrain_neighborhood_count=True, check_aii=True,
                         check_neighborhood=True), TWO_SIZE_SCENE, None, TWO_SIZE_STEPS)
    out["impact_w2020_check_aii"] = (
        impact_params(PressureSolverMethod.HybridDFSPH, check_aii=True,
                      operator_discretization=OperatorDiscretization.Winchenbach2020),
        IMPACT_SCENE, IMPACT_CAPACITY, IMPACT_CHECK_STEPS)
    return out


# the sweep-only step (ASPH_NO_WCACHE=1): steps of its full-width runs and of
# its small impact run
NOWCACHE_STEPS = 10
NOWCACHE_IMPACT_STEPS = 6


def nowcache_runs():
    """The trajectories of tests/data/torch_port_nowcache_ref.npz, run under
    ASPH_NO_WCACHE=1 (the tile step without a pair list: every pair sum a
    pair_sweep): run name -> (params, scene dict, capacity or None, steps).

    stress_nowcache_hybrid: the parity options (HybridDFSPH, ApproxLaplace
    before the divergence solve, ConsistentSimpleGradient, SDF box): the
    DENSITY, prep, accel and div sweeps. stress_nowcache_w2020_resident:
    Winchenbach2020 with resident_solver, which this branch solves streamed
    (prep, div_w2020). stress_nowcache_wcsph_after_div: the WCSPH viscosity
    after the divergence solve (aii_sums, visc). stress_nowcache_iisph2_wcsph:
    IISPH2 with WCSPH (prep with WCSPH, omega). dambreak_nowcache: the
    default dam break (levels, share / merge / split, capacity growth).
    impact_nowcache_resident: the impact scene with resident_solver, whose
    solves iterate (the small run the CPU tests regenerate)."""
    import dataclasses
    import os

    import yaml

    from .utils.params import OperatorDiscretization, ViscosityType, load_params

    M = PressureSolverMethod
    rep = dataclasses.replace
    wcsph = dict(viscosity_type=ViscosityType.WCSPH, viscosity=0.003)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "default-scene.yaml")) as f:
        dam_scene = yaml.safe_load(f)
    return {
        "stress_nowcache_hybrid": (stress_params(), STRESS_SCENE, None, NOWCACHE_STEPS),
        "stress_nowcache_w2020_resident": (
            rep(stress_params(resident=True),
                operator_discretization=OperatorDiscretization.Winchenbach2020),
            STRESS_SCENE, None, NOWCACHE_STEPS),
        "stress_nowcache_wcsph_after_div": (
            rep(stress_params(), hybrid_dfsph_non_pressure_accel_before_divergence_free=False,
                **wcsph), STRESS_SCENE, None, NOWCACHE_STEPS),
        "stress_nowcache_iisph2_wcsph": (
            rep(stress_params(iisph=True), pressure_solver_method=M.IISPH2, **wcsph),
            STRESS_SCENE, None, NOWCACHE_STEPS),
        "dambreak_nowcache": (load_params(os.path.join(root, "configs", "default-config.yaml")),
                              dam_scene, None, NOWCACHE_STEPS),
        "impact_nowcache_resident": (impact_params(M.HybridDFSPH), IMPACT_SCENE,
                                     IMPACT_CAPACITY, NOWCACHE_IMPACT_STEPS),
    }


# the particle (Akinci) boundary, uniform sizes only as in the reference
AKINCI = {"particle_sizes": "Uniform", "init_boundary_handler": "Particles"}
AKINCI_DAM_STEPS = 10
AKINCI_MEDIA_STEPS = 3
AKINCI_MEDIA = ("configs/media/motivation-video.yaml", 0)


def akinci_dam_scene() -> dict:
    """The default dam break (configs/default-scene.yaml) with its blocks in
    the other order. Uniform sizes take h from the first block: from the
    0.06 block both blocks are resolved (n = 1,035, 264 boundary particles
    at the 0.03 spacing). In the file's order h comes from the 0.03 block,
    the 0.06 block's particles carry four times the mass that h resolves,
    and the first density solve takes 245 sweeps and throws 182 particles
    out of the box, with either boundary model, in the JAX package too."""
    import os

    import yaml

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "configs", "default-scene.yaml")) as f:
        scene = yaml.safe_load(f)
    scene["blocks"] = scene["blocks"][::-1]
    return scene


def akinci_runs():
    """The particle-boundary trajectories of tests/data/torch_port_akinci_ref.npz:
    run name -> (params, scene dict, capacity or None, steps).

    dam_hybrid / dam_iisph_resident: akinci_dam_scene() under
    configs/default-config.yaml (HybridDFSPH, streamed) and with IISPH and
    the resident solver; scene2_hybrid: the "Uniform SPH" entry of
    configs/media/motivation-video.yaml (motivation-scene2.yaml, n = 33,750,
    1,000 boundary particles) at full width, both with the particle boundary
    and uniform sizes."""
    import dataclasses
    import os

    from .utils.params import load_params

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dam = load_params(os.path.join(root, "configs", "default-config.yaml"),
                      update_attributes=AKINCI)
    media, media_scene = media_run(*AKINCI_MEDIA)
    media = dataclasses.replace(media, **{k: type(getattr(media, k))(v)
                                          for k, v in AKINCI.items()})
    return {
        "dam_hybrid": (dam, akinci_dam_scene(), None, AKINCI_DAM_STEPS),
        "dam_iisph_resident": (
            dataclasses.replace(dam, pressure_solver_method=PressureSolverMethod.IISPH,
                                resident_solver=True), akinci_dam_scene(), None,
            AKINCI_DAM_STEPS),
        "scene2_hybrid": (media, media_scene, None, AKINCI_MEDIA_STEPS),
    }


# the list backend's runs: levels after advection over the stale pre-advection
# pair set (the setting the tile engine refuses), clipped in time or steps
STALE_PAIRS = {"use_extended_range_for_level_estimation": False}
SURFACE_DETECTION = "configs/media/surface-detection.yaml"
LIST_EXPORT_TIME = 0.05
LIST_DAMBREAK_STEPS = 10


def list_export_attributes(entry: int) -> dict:
    """What surface-detection.yaml entry `entry` (0-based) adds to its
    update_attributes for the stale-pair setting: the extended range off, and
    for entry 2 (EmptyAngle) levels after advection, which entry 1
    (CenterDiff) already asks for."""
    extra = dict(STALE_PAIRS)
    if entry == 1:
        extra["level_estimation_after_advection"] = True
    return extra


def list_runs():
    """The list-backend trajectories of tests/data/torch_port_lists_ref.npz:
    run name -> (params, scene dict, steps or None, end time or None).

    surface_centerdiff / surface_emptyangle: surface-detection.yaml entries
    1 and 2 (scene-ratio2to1, n = 1,035) with `list_export_attributes`, run
    to LIST_EXPORT_TIME as the image export runs them (steps until the time
    reaches it); dambreak: configs/default-config.yaml with
    default-scene.yaml (n = 1,035; share / merge / split) with levels after
    advection and the extended range off, LIST_DAMBREAK_STEPS steps."""
    import os

    import yaml

    from .utils.params import load_params

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    runs = {}
    for name, entry in (("surface_centerdiff", 0), ("surface_emptyangle", 1)):
        params, scene = media_run(SURFACE_DETECTION, entry)
        runs[name] = (params.replace(**list_export_attributes(entry)), scene, None,
                      LIST_EXPORT_TIME)
    dam = load_params(os.path.join(root, "configs", "default-config.yaml")).replace(
        level_estimation_after_advection=True, **STALE_PAIRS)
    with open(os.path.join(root, "configs", "default-scene.yaml")) as f:
        runs["dambreak"] = (dam, yaml.safe_load(f), LIST_DAMBREAK_STEPS, None)
    return runs


# the dense grid engine's runs (backend="grid"): the stress scene, the default
# dam break without resampling, and a small two-size dam with resampling (the
# reference's engine populates every level of the sizing band there, so its
# pair blocks grow with the band: the default dam break with resampling asks
# for more memory than a card holds)
GRID_STRESS_STEPS = 5
GRID_DAMBREAK_STEPS = 10
GRID_ADAPTIVE_STEPS = 3
GRID_ADAPTIVE_SCENE = {
    "boundary": {"type": "box", "width": 1, "height": 1},
    "blocks": [{"pos": [-0.45, -0.45], "size": [0.3, 0.4], "spacing": 0.03,
                "volume_fill_ratio": 0.93, "velocity": [0, 0]},
               {"pos": [-0.15, -0.45], "size": [0.3, 0.4], "spacing": 0.06,
                "volume_fill_ratio": 0.93, "velocity": [0, 0]}],
}


def grid_runs():
    """The dense grid engine's trajectories of tests/data/torch_port_grid_ref.npz
    (backend="grid"): run name -> (params, scene dict, capacity or None, steps).

    stress_grid: the stress scene with the parity options (7 levels, 2
    populated, finest grid 128 x 128, 24 slots per cell); dambreak_grid:
    configs/default-config.yaml with merging, sharing and splitting off on
    default-scene.yaml (2 populated levels, finest 36 x 36); adaptive_grid:
    GRID_ADAPTIVE_SCENE (a fine and a coarse block in a 1 x 1 box) with
    share / merge / split, particle radii 0.02 / 0.01 and
    maximum_surface_distance 0.45, every other parameter at its default (4
    populated levels, finest 40 x 40, 64 slots per cell; 40 once the
    capacity growth after its first step rebuilds the grid)."""
    import os

    import yaml

    from .utils.params import load_params

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    dam = load_params(os.path.join(root, "configs", "default-config.yaml")).replace(
        merging=False, sharing=False, splitting=False)
    with open(os.path.join(root, "configs", "default-scene.yaml")) as f:
        dam_scene = yaml.safe_load(f)
    adaptive = SimulationParams(particle_radius_base=0.02, particle_radius_fine=0.01,
                                maximum_surface_distance=0.45)
    return {
        "stress_grid": (stress_params(), STRESS_SCENE, None, GRID_STRESS_STEPS),
        "dambreak_grid": (dam, dam_scene, None, GRID_DAMBREAK_STEPS),
        "adaptive_grid": (adaptive, GRID_ADAPTIVE_SCENE, None, GRID_ADAPTIVE_STEPS),
    }


# a fine block (spacing 0.03) touching a coarser one (0.06) on its right:
# two populated levels whose particles meet, so the clique layout's
# cross-level list is not empty (the stress scene's first steps have no
# cross-level pair: its three coarse particles sit far from the fine block)
TOUCHING_SCENE = {
    "boundary": {"type": "box", "width": 2, "height": 2},
    "blocks": [{"pos": [-0.6, -0.9], "size": [0.6, 0.8], "spacing": 0.03,
                "volume_fill_ratio": 0.93, "velocity": [0, 0]},
               {"pos": [0.0, -0.9], "size": [0.6, 0.8], "spacing": 0.06,
                "volume_fill_ratio": 0.93, "velocity": [0, 0]}],
}
CLIQUE_STRESS_STEPS = 5
CLIQUE_TOUCHING_STEPS = 10


def touching_params(**kw) -> SimulationParams:
    """HybridDFSPH, adaptive sizes without resampling, max_iters 60, every
    other parameter at its default (AnalyticOverestimate box)."""
    return SimulationParams(particle_sizes=ParticleSizes.Adaptive, merging=False, sharing=False,
                            splitting=False, max_iters=60, **kw)


def clique_runs():
    """The clique layout's trajectories of tests/data/torch_port_clique_ref.npz,
    run under ASPH_CLIQUE=1: run name -> (params, scene dict, capacity or
    None, steps, extra environment of the JAX run).

    stress_clique: the stress scene with the parity options (P = 4, the
    capacity grown from 14,336 to 28,672; no cross-level pair in its first
    steps); touching_clique: TOUCHING_SCENE (n = 650, P = 4, capacity 3,072,
    levels (0, 1), cross-level pairs from the first step); touching_nxcap1:
    the same with ASPH_NX_CAP=1, under which the reference's cross-block
    budget overflows on the first step and its runner falls back to the
    packed layout; the port has no such budget (its K1 list is sized
    exactly) and stays on the clique layout."""
    return {
        "stress_clique": (stress_params(), STRESS_SCENE, None, CLIQUE_STRESS_STEPS, {}),
        "touching_clique": (touching_params(), TOUCHING_SCENE, None, CLIQUE_TOUCHING_STEPS, {}),
        "touching_nxcap1": (touching_params(), TOUCHING_SCENE, None, CLIQUE_TOUCHING_STEPS,
                            {"ASPH_NX_CAP": "1"}),
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
    ap.add_argument("--nowcache", default=None, choices=sorted(nowcache_runs()),
                    help="a run of nowcache_runs(), stepped with ASPH_NO_WCACHE=1")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import spans
    from .runner import create_simulation

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(card())
    if args.nowcache:
        import os

        params, scene, capacity, _ = nowcache_runs()[args.nowcache]
        os.environ["ASPH_NO_WCACHE"] = "1"
        sim = create_simulation(params, scene_mod.scene_from_dict(scene), capacity=capacity,
                                device="cuda", counters_enabled=False)
        label = args.nowcache + " (ASPH_NO_WCACHE=1)"
    elif args.config:
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
    ops = spans.device_ops(events)
    dev_us = sum(e.self_device_time_total for e in ops)
    print(f"{label}: {wall / args.steps * 1e3:.4f} ms/step "
          f"(profiled), device busy {dev_us / 1e3 / (wall * 1e3):.3f} of wall, "
          f"div iters {diags.get('div_iterations')}, "
          f"density iters {diags.get('density_iterations')}, "
          f"particles {diags['particle_count'][-1]}")
    kernels = sum(e.count for e in ops)
    syncs = sum(e.count for e in events if "Synchronize" in e.key)
    print(f"per step: {kernels / args.steps:.1f} device kernels, {syncs / args.steps:.1f} "
          f"host synchronisations, {dev_us / 1e3 / args.steps:.4f} ms device time")
    print(events.table(sort_by="self_device_time_total", row_limit=25, max_name_column_width=60))
    idle = spans.idle_by_span(prof.events())
    print(f"idle device s by innermost span, {args.steps} steps: "
          + ", ".join(f"{k} {v:.6f}" for k, v in idle.items()))
    if args.trace:
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
