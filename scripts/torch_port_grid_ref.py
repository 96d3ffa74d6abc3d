"""Write the JAX reference trajectories of the dense grid engine for the PyTorch port.

Runs the JAX package on the CPU through `create_simulation(backend="grid")`
for every run of `adaptive_sph_torch.stress.grid_runs()`:

  stress_grid   : the stress scene with the parity options, 5 steps (~50 s);
  dambreak_grid : the default dam break without resampling, 10 steps (~20 s);
  adaptive_grid : the two-size dam in a 1 x 1 box with share / merge / split,
                  3 steps (~140 s: two of them compile a new capacity or census).

and writes tests/data/torch_port_grid_ref.npz, keys "<run>/<name>":

  per step : n, capacity, dt, div_iterations, density_iterations, shares,
             merge_or_split_count, split_deferred (0 where the step has none)
  position, velocity, density, mass, h, level, stash, has_level,
  flag_is_fluid_surface, flag_insufficient_neighs : the alive particles after
             the last step, in the state's order
  mpc, populated : the grid configuration the JAX runner holds after the last
             step (capacity growth rebuilds it from the state of that moment)

chip_smoke.py holds the port's runs on the GPU (phases G1, G2) to this file
(the GPU machine has no JAX); tests/test_torch_grid_step.py holds the small
ones on the CPU.

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_grid_ref.py [--only RUN ...]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_grid_ref.npz")
PER_STEP = {
    "n": np.int32, "capacity": np.int32, "dt": np.float32, "div_iterations": np.int32,
    "density_iterations": np.int32, "shares": np.int32, "merge_or_split_count": np.int32,
    "split_deferred": np.int32,
}
STATE = ("position", "velocity", "density", "mass", "h", "level", "stash", "has_level",
         "flag_is_fluid_surface", "flag_insufficient_neighs")


def reference_run(params, scene: dict, capacity, steps: int):
    """(alive state arrays, per-step diag arrays, grid config) of the JAX grid run."""
    from adaptive_sph_torch import convert
    from adaptive_sph_tpu.models import scene as j_scene
    from adaptive_sph_tpu.runner import create_simulation
    from adaptive_sph_tpu.utils import params as j_params

    sim = create_simulation(j_params.params_from_dict(convert.params_to_dict(params)),
                            j_scene.scene_from_dict(scene), capacity=capacity, backend="grid")
    per_step = {k: [] for k in PER_STEP}
    for _ in range(steps):
        d = sim.step()
        d = {**d, "n": sim.num_fluid_particles, "capacity": sim.state.capacity}
        for name in PER_STEP:
            per_step[name].append(np.asarray(d.get(name, 0)).item())
    alive = np.asarray(sim.state.alive)
    state = {name: np.asarray(getattr(sim.state, name))[alive] for name in STATE}
    cfg = {"mpc": np.int32(sim.grid_cfg.mpc),
           "populated": np.asarray(sim.grid_cfg.populated, np.int32)}
    return state, {name: np.asarray(v, PER_STEP[name]) for name, v in per_step.items()}, cfg


def main():
    sys.path.insert(0, ROOT)
    from adaptive_sph_torch.stress import grid_runs

    runs = grid_runs()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=sorted(runs), default=None,
                    help="regenerate these runs and keep the file's others")
    args = ap.parse_args()
    out = {}
    if args.only and os.path.exists(OUT):
        old = np.load(OUT)
        out = {k: old[k] for k in old.files if k.split("/")[0] not in args.only}
    for name, (params, scene, capacity, steps) in runs.items():
        if args.only and name not in args.only:
            continue
        t0 = time.perf_counter()
        state, per_step, cfg = reference_run(params, scene, capacity, steps)
        for k, v in {**per_step, **state, **cfg}.items():
            out[f"{name}/{k}"] = v
        print(f"{name}: {steps} steps in {time.perf_counter() - t0:.1f} s, n = "
              f"{per_step['n'].tolist()}, capacity {per_step['capacity'][-1]}, iterations "
              f"{per_step['div_iterations'].tolist()} / {per_step['density_iterations'].tolist()}"
              f", mpc {int(cfg['mpc'])}, populated {cfg['populated'].tolist()}", flush=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} B)")


if __name__ == "__main__":
    main()
