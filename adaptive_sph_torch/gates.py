"""Long-horizon scenario gates: the committed scenarios run to physically
meaningful end times under the reference's solver contract.

    python -m adaptive_sph_torch.gates [dam stress stress_plain resampling onlydiv
        motivation slab_soak ...] [--t-scale S] [--momentum B] [--record-as KEY]
        [--backend B] [--capacity C] [--device cuda|cpu] [--out FILE]

Counterpart of scripts/scenario_gates.py, with its scenarios, parameters and
end times:

  dam        the default dam break (configs/default-config.yaml +
             default-scene.yaml), HybridDFSPH with resampling, to 1.0 s;
  stress     the ratio stress scene as bench.py's build_sim(replicas=1,
             bf16=False, momentum=B) builds it (f32 pair weights, warm start,
             momentum B), to 1.0 s;
  onlydiv    media/only-divergence-free.yaml's update_attributes on the dam
             break: OnlyDivergence with full resampling, to 20 s;
  motivation media/motivation.yaml's update_attributes on
             configs/media/motivation-scene.yaml: 350:1 radii, to 5 s;
  resampling media/resampling-gravity-free.yaml's "Hybrid DFSPH c=150"
             entry on resampling-gravity-free-scene.yaml, to 0.4 s;
  slab_soak  `multichip.longrun_job`: the 51,200-particle dam column on 4
             gloo ranks (scripts/multichip_longrun.py), 200 steps.

Every solve is held to the reference's contract (simulation.rs:1453-1478):
converge, or stop at the iteration cap. A solve over its tolerance that
stopped below the cap is a violation; one that stopped at the cap is counted
as `capped_*` (the reference prints "not converged" and moves on). The
density error is relative to the rest density, the divergence error is
|avg| x dt against the divergence tolerance. Mass must be conserved (drift
< 1e-3), the particles must stay inside the box plus a slack (0.1; for
onlydiv one support radius of the coarsest particle) with finite positions,
and dt must not collapse (non-finite or below 1e-9 stops the run).

Runs on the card unless `--device cpu` is given; without a CUDA device it
raises, as `create_simulation` does. Each scenario's record (the reference
script's keys, with "platform", "device" (nvidia-smi's name and power limit),
"t_scale" and the pair census of the final state in place of the TPU block
census) is printed and merged into PARITY_RUNS_TORCH.json at the root of the
checkout (`--out` names another file). The exit code is 0 only if every
scenario passes.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np
import torch

from .tally import SolveTally, gate_ok

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORD = os.path.join(ROOT, "PARITY_RUNS_TORCH.json")

# the reference script's end times, seconds of simulated time
TARGETS = {"dam": 1.0, "stress": 1.0, "onlydiv": 20.0, "resampling": 0.4, "motivation": 5.0}
SLAB_SOAK_STEPS = 200  # scripts/multichip_longrun.py's horizon
SLAB_SOAK_RANKS = 4
PROGRESS_EVERY = 512


def scenario(name: str, momentum: float = 0.0):
    """(params, scene, tol_den, tol_div) of a scenario, parameters as the
    reference script sets them."""
    from .models import scene as scene_mod
    from .utils.params import load_params

    config = os.path.join(ROOT, "configs", "default-config.yaml")
    dam_scene = os.path.join(ROOT, "configs", "default-scene.yaml")
    if name == "dam":
        params, scene = load_params(config), scene_mod.load_scene(dam_scene)
    elif name == "stress":
        from .stress import stress_params, stress_scene

        # bench.build_sim(replicas=1, bf16=False, momentum=m) with bench.py's
        # defaults otherwise: warm start on, no resident solver
        params = stress_params(bench=True).replace(weight_cache_bf16=False,
                                                   jacobi_momentum=momentum)
        scene = stress_scene(1)
    elif name == "onlydiv":
        # media/only-divergence-free.yaml's update_attributes
        params = load_params(config, update_attributes={
            "pressure_solver_method": "OnlyDivergence",
            "max_dt": 0.006, "viscosity_type": "ApproxLaplace",
            "viscosity": 0.001, "cfl_factor": 0.4,
            "hybrid_dfsph_factor": 20,
            "hybrid_dfsph_max_avg_divergence_error": 0.0001,
            "merging": True, "splitting": True, "sharing": True,
            "sizing_function": "Mass", "maximum_surface_distance": 2.0,
            "particle_radius_base": 0.06, "particle_radius_fine": 0.003,
            "boundary_is_fluid_surface": False,
        })
        scene = scene_mod.load_scene(dam_scene)
    elif name == "motivation":
        # media/motivation.yaml's update_attributes: full resampling at 350:1
        params = load_params(config, update_attributes={
            "merging": True, "sharing": True, "splitting": True,
            "support_length_estimation": "FromMass",
            "hybrid_dfsph_factor": 0.0,
            "pressure_solver_method": "HybridDFSPH",
            "cfl_factor": 0.4, "max_dt": 0.002, "viscosity": 0.001,
            "iisph_max_avg_density_error": 0.002,
            "hybrid_dfsph_max_avg_divergence_error": 0.0004,
            "init_boundary_handler": "AnalyticOverestimate",
            "particle_radius_base": 0.7, "particle_radius_fine": 0.002,
        })
        scene = scene_mod.load_scene(os.path.join(ROOT, "configs", "media",
                                                  "motivation-scene.yaml"))
    elif name == "resampling":
        # media/resampling-gravity-free.yaml's "After resampling (Hybrid DFSPH
        # c=150)" entry: merge / share / split churn without gravity
        params = load_params(config, update_attributes={
            "merging": True, "sharing": True, "splitting": True,
            "gravity": 0.0, "hybrid_dfsph_factor": 150,
            "init_boundary_handler": "AnalyticUnderestimate",
            "max_dt": 0.002,
        })
        scene = scene_mod.load_scene(os.path.join(
            ROOT, "configs", "media", "resampling-gravity-free-scene.yaml"))
    else:
        raise ValueError(f"unknown scenario {name!r}: one of {sorted(TARGETS)} or slab_soak")
    if momentum and name != "stress":
        params = params.replace(jacobi_momentum=momentum)
    tol_den = None if name == "onlydiv" else params.hybrid_dfsph_max_avg_density_error
    return params, scene, tol_den, params.hybrid_dfsph_max_avg_divergence_error


def containment_slack(name: str, params) -> float:
    """0.1; onlydiv (no density control, a penalty boundary that resolves
    overlap within one kernel support) is held to one support radius of the
    coarsest particle."""
    if name != "onlydiv":
        return 0.1
    from .ops import kernels

    h_base = float(kernels.smoothing_length_from_volume(
        kernels.radius_to_sphere_volume(params.particle_radius_base, 2), 2))
    return max(0.1, h_base * kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH)


def device_label(device: torch.device) -> str:
    """nvidia-smi's "name, power limit" of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()
        return out[device.index or 0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def pair_census(sim) -> dict:
    """The tile engine's structure on the final state: the pairs inside the
    physics radius in K1's list, the CSR rows with a pair, the (query,
    candidate) slots the walk tests."""
    from .models.tile_step import physics_scale, step_geometry
    from .ops import pair_ops

    tcfg = sim.tile_cfg
    _, bins, cols, wm = step_geometry(sim.state, sim.params, tcfg)
    flat = cols["flat"]
    scale = float(physics_scale(sim.params))
    csr = pair_ops.pair_build(bins.cell_starts, wm, flat, tcfg.tq, scale, 0.0, False,
                              torch.float32)
    NT = flat.shape[0] // tcfg.tq
    live_q = (flat[:, 2] > 0.0).reshape(NT, tcfg.tq).sum(1)
    tested = pair_ops.tile_candidates(bins.cell_starts, wm, NT) * live_q
    return {"k1_pairs": int(csr.num_pairs),
            "k1_live_rows": int((csr.row_ptr[1:] > csr.row_ptr[:-1]).sum()),
            "k1_candidates_tested": int(tested.sum())}


def _extent(state, w2: float, h2: float):
    """(alive positions, max excess over the box plus slack, non-finite rows),
    in the positions' float32 as the reference script computes them."""
    alive = state.alive.cpu().numpy()
    pos = state.position.cpu().numpy()[alive]
    finite = np.isfinite(pos).all(axis=1)
    pos = pos[finite]
    excess = max(float(np.max(np.abs(pos[:, 0]) - w2, initial=0.0)),
                 float(np.max(np.abs(pos[:, 1]) - h2, initial=0.0)))
    return pos, excess, int((~finite).sum())


def run_scenario(name: str, t_end: float, chunk: int = 64, backend: Optional[str] = None,
                 capacity: Optional[int] = None, momentum: float = 0.0, device="cuda",
                 log=None):
    """Run `name` to simulated time t_end and hold it to the gates. Returns
    (record, ok, tally): the record has the reference script's keys (the
    TPU block census replaced by `pair_census`), tally the per-step lists.
    Adaptive scenarios step once per call, the others `chunk` steps per
    `step_chunk`. log: where the progress lines go (default stderr), one
    every PROGRESS_EVERY steps."""
    from .runner import create_simulation

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    params, scene, tol_den, tol_div = scenario(name, momentum)
    sim = create_simulation(params, scene, capacity=capacity, counters_enabled=True,
                            device=device, backend=backend or "auto")
    params = sim.params
    n0 = sim.num_fluid_particles
    alive = sim.state.alive
    mass0 = float(torch.sum(sim.state.mass[alive].double()))
    slack = containment_slack(name, params)
    w2 = scene.boundary_width / 2 + slack
    h2 = scene.boundary_height / 2 + slack
    tally = SolveTally(params.max_iters, params.rest_density, tol_den, tol_div)
    adaptive = params.splitting or params.merging or params.sharing
    if sim.device.type == "cuda":
        from .ops import _native

        _native.load()  # the kernels' build stays out of wall_s
    t0 = time.perf_counter()
    while sim.time < t_end:
        if adaptive:
            d = sim.step()
        else:
            d = {k: v for k, v in sim.step_chunk(chunk).items()
                 if not isinstance(v[0], tuple)}
        n_call = len(np.atleast_1d(d["dt"]))
        if not tally.add(d, sim.time):
            log(f"  [{name}] DT COLLAPSE at t~{tally.dt_collapse_t:.4f} (step {tally.steps}); "
                "aborting run")
            break
        if tally.steps % PROGRESS_EVERY < n_call:
            _, exc, _ = _extent(sim.state, w2, h2)
            log(f"  [{name}] t={sim.time:.3f}/{t_end} steps={tally.steps} "
                f"n={sim.num_fluid_particles} excess={exc:.4f} "
                f"wall={time.perf_counter() - t0:.0f}s")
    if sim.device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t_now = sim.time

    pos, excess, nonfinite = _extent(sim.state, w2, h2)
    alive = sim.state.alive
    mass1 = float(torch.sum(sim.state.mass[alive].double()))
    contained = bool((np.abs(pos[:, 0]) < w2).all() and (np.abs(pos[:, 1]) < h2).all()
                     and nonfinite == 0)
    out = {
        "scenario": name,
        "t_end": t_now if np.isfinite(t_now) else (tally.dt_collapse_t or 0.0),
        "t_scale": t_end / TARGETS[name],
        "steps": tally.steps,
        "jacobi_momentum": momentum,
        "dt_collapse_t": tally.dt_collapse_t,
        "nonfinite_positions": nonfinite,
        "n_initial": n0,
        "n_final": sim.num_fluid_particles,
        "capacity_final": sim.state.capacity,
        "mass_drift": abs(mass1 - mass0) / mass0,
        "contained": contained,
        "max_boundary_excess": excess,
        **tally.summary(),
        "wall_s": wall,
        "ms_per_step": wall / max(tally.steps, 1) * 1000,
        "backend": sim.backend,
        "platform": "gpu" if sim.device.type == "cuda" else "cpu",
        "device": device_label(sim.device),
    }
    if sim.backend == "tiles":
        out.update(pair_census(sim))
    return out, gate_ok(out), tally


def slab_soak(steps: int = SLAB_SOAK_STEPS, ranks: int = SLAB_SOAK_RANKS, device="cuda",
              spacing: float = 0.0075):
    """scripts/multichip_longrun.py's soak through `multichip.longrun_job` on
    `ranks` gloo ranks (sharing the card, or on the CPU): (record, ok). The
    ranks hold mass drift (< 5e-3), the census (the summed alive rows equal
    n) and containment every 10 steps and raise on a failure; the record
    adds the gates' mass rule, the tally's counts and the reshards."""
    from . import multichip

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("adaptive_sph_torch: no CUDA device is available; pass "
                           "device='cpu' (CLI: --device cpu) to run on the CPU")
    t0 = time.perf_counter()
    res = multichip.run_ranks(multichip.longrun_job(spacing, steps), ranks, "gloo", dev.type)
    wall = time.perf_counter() - t0
    s = multichip.summary(res, ranks, "gloo", dev.type)
    tally = res["tally"]
    checks = res["checks"]
    out = {
        "scenario": "slab_soak",
        "ranks": ranks, "comm_backend": "gloo",
        "t_end": s["t_end"], "steps": s["steps"],
        "n_initial": s["n_initial"], "n_final": s["n_final"],
        "census_checks": len(checks),
        "mass_drift": s["mass_drift"],
        # each check's signed margin: the largest |x| or |y| past the box plus 0.1
        "contained": all(c["excess"] < 0.0 for c in checks),
        "max_boundary_excess": max(0.0, max(c["excess"] for c in checks)),
        "dt_collapse_t": tally["dt_collapse_t"],
        "reshards": s["reshards"], "forced_reshard": s["forced_reshard"],
        **{k: tally[k] for k in ("density_tol_violations", "div_tol_violations",
                                 "capped_density_solves", "capped_div_solves", "max_iters_cap",
                                 "max_density_iters", "max_div_iters", "avg_density_iters",
                                 "avg_div_iters", "avg_dt", "min_dt", "tol_density",
                                 "tol_divergence")},
        "wall_s": wall,
        "ms_per_step_per_rank": [r["ms_per_step"] for r in s["per_rank"]],
        "platform": "gpu" if dev.type == "cuda" else "cpu",
        "device": device_label(dev),
    }
    return out, gate_ok(out)


def merge_records(results: dict, path: str = RECORD):
    """Merge `results` into the JSON file at path, keeping the records of
    scenarios not run this time."""
    merged = {}
    if os.path.exists(path):
        with open(path) as f:
            merged = json.load(f)
    merged.update(results)
    with open(path + ".tmp", "w") as f:
        json.dump(merged, f, indent=1)
    os.replace(path + ".tmp", path)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m adaptive_sph_torch.gates",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("scenarios", nargs="*", default=["dam", "stress"],
                    help=f"of {sorted(TARGETS)} and slab_soak (default: dam stress)")
    ap.add_argument("--t-scale", type=float, default=1.0,
                    help="run to this fraction of each end time (slab_soak: of its steps)")
    ap.add_argument("--capacity", type=int, default=None, help="initial particle capacity")
    ap.add_argument("--backend", default=None, help="auto (default), tiles, lists or grid")
    ap.add_argument("--momentum", type=float, default=0.0,
                    help="Jacobi heavy-ball beta (0: the reference's plain schedule)")
    ap.add_argument("--record-as", default=None,
                    help="record the (single) scenario under this key instead of its name")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--out", default=RECORD, help="the JSON file the records merge into")
    a = ap.parse_args(argv)
    if a.record_as and len(a.scenarios) != 1:
        ap.error("--record-as names one scenario's record")
    unknown = [n for n in a.scenarios if n not in TARGETS and n != "slab_soak"]
    if unknown:
        ap.error(f"unknown scenarios {unknown}")
    results, all_ok = {}, True
    for name in a.scenarios:
        if name == "slab_soak":
            out, ok = slab_soak(max(1, round(SLAB_SOAK_STEPS * a.t_scale)), device=a.device)
            out["t_scale"] = a.t_scale
        else:
            out, ok, _ = run_scenario(name, TARGETS[name] * a.t_scale,
                                      backend=a.backend, capacity=a.capacity,
                                      momentum=a.momentum, device=a.device)
        print(json.dumps(out, indent=1), flush=True)
        results[a.record_as or name] = out
        all_ok = all_ok and ok
        print(f"{name}: {'PASS' if ok else 'FAIL'}", flush=True)
    merge_records(results, a.out)
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
