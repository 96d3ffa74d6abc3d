"""Write the JAX reference trajectories of the pair sweep's last modes for the PyTorch port.

Runs the JAX package on the CPU (its Pallas sweeps in interpret mode, as its
own tests run them) and writes tests/data/torch_port_sweep_modes_ref.npz.
Runs: `adaptive_sph_torch.stress.sweep_mode_runs()`, converted to the JAX
package's parameters:

  media_constant_field               configs/media/constant-field.yaml entry 1
                                     (FromDistributionClamped1, the diagnostic
                                     fields) on scene-ratio2to1.yaml
  media_neighbor_numbers             neighbor-numbers.yaml entry 1
  media_surface_distance_first       surface-distance.yaml entry 1 (Clamped1,
                                     resampling, the stash before the first
                                     wavefront sweep)
  media_surface_distance_middle      surface-distance.yaml entry 2 (the stash
                                     after it)
  media_surface_detection_centerdiff surface-detection.yaml entry 1 (CenterDiff
                                     after advection)
  ratio2to1_from_distribution(2)     surface-distance.yaml entry 1 with
                                     FromDistribution / FromDistribution2
  stress_checked_constrained         the stress scene (n = 11,835) with
                                     constrain_neighborhood_count, check_aii
                                     and check_neighborhood
  two_size_constrained               the same three on a fine block beside a
                                     coarse one, where the constraint reduces h
  impact_w2020_check_aii             the impact scene, resident
                                     Winchenbach2020 hybrid, check_aii

Per run, keys "<run>__<field>":
  dt, div_iterations, density_iterations, aii_deviation,
  neighborhood_check_mismatch : one entry per step (-1 where the step has no
      such solve or check)
  position, velocity, density, h, h_next, level, flag_is_fluid_surface,
  flag_insufficient_neighs, flag_neighborhood_reduced, stash,
  constant_field, neighbor_count : the alive particles after the last step

`chip_smoke.py` compares the port's GPU runs with this file (the GPU machine
has no JAX); tests/test_torch_sweep_modes.py checks its small run against
the JAX package and the port on the CPU.

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_sweep_modes_ref.py [--only RUN ...]

(~10 min on the CPU.)
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_sweep_modes_ref.npz")
PER_STEP_INT = ("div_iterations", "density_iterations", "neighborhood_check_mismatch")
STATE = ("position", "velocity", "density", "h", "h_next", "level", "flag_is_fluid_surface",
         "flag_insufficient_neighs", "flag_neighborhood_reduced", "stash", "constant_field",
         "neighbor_count")


def jax_simulation(params, scene: dict, capacity):
    from adaptive_sph_torch import convert
    from adaptive_sph_tpu.models import scene as j_scene
    from adaptive_sph_tpu.runner import create_simulation
    from adaptive_sph_tpu.utils import params as j_params

    return create_simulation(j_params.params_from_dict(convert.params_to_dict(params)),
                             j_scene.scene_from_dict(scene), capacity=capacity,
                             counters_enabled=False, backend="tiles")


def step_record(d) -> dict:
    out = {"dt": float(d["dt"]),
           "aii_deviation": float(d["aii_deviation"]) if "aii_deviation" in d else -1.0}
    for k in PER_STEP_INT:
        out[k] = int(d[k]) if k in d else -1
    return out


def alive_state(state) -> dict:
    alive = np.asarray(state.alive)
    return {k: np.asarray(getattr(state, k), np.float32)[alive] for k in STATE}


def reference_run(params, scene: dict, capacity, steps: int):
    """(alive state arrays, per-step arrays) of one JAX run."""
    sim = jax_simulation(params, scene, capacity)
    recs = [step_record(sim.step()) for _ in range(steps)]
    per_step = {k: np.asarray([r[k] for r in recs], np.float32)
                for k in ("dt", "aii_deviation")}
    per_step.update({k: np.asarray([r[k] for r in recs], np.int32) for k in PER_STEP_INT})
    return alive_state(sim.state), per_step


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=None, help="runs to compute (others kept "
                    "from the existing file)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from adaptive_sph_torch.stress import sweep_mode_runs

    out = dict(np.load(OUT)) if args.only and os.path.exists(OUT) else {}
    for name, (params, scene, capacity, steps) in sweep_mode_runs().items():
        if args.only and name not in args.only:
            continue
        state, per_step = reference_run(params, scene, capacity, steps)
        out = {k: v for k, v in out.items() if not k.startswith(name + "__")}
        out.update({f"{name}__{k}": v for k, v in {**state, **per_step}.items()})
        print(f"{name}: n={len(state['position'])}, steps={steps}, div iters "
              f"{per_step['div_iterations'].tolist()}, density iters "
              f"{per_step['density_iterations'].tolist()}, aii deviation "
              f"{per_step['aii_deviation'].tolist()}, mismatch "
              f"{per_step['neighborhood_check_mismatch'].tolist()}, reduced "
              f"{int(state['flag_neighborhood_reduced'].sum())}, surface "
              f"{int(state['flag_is_fluid_surface'].sum())}", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
