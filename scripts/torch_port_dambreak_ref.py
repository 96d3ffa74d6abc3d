"""Write the JAX reference trajectory of the default dam break for the PyTorch port.

Runs the JAX package on the CPU (interpret-mode Pallas): configs/default-config.yaml
with configs/default-scene.yaml (n = 1,035 at the start; EmptyAngle level
estimation, share every step, merge on even and split on odd steps) for 10
steps through `create_simulation`, and writes tests/data/torch_port_dambreak_ref.npz:

  per step : n, capacity, dt, div_iterations, density_iterations, shares,
             merge_or_split_count, split_deferred, mass_conservation_error
  position, velocity, density, mass, level : the alive particles after the
             last step (f32)

`chip_smoke.py` compares the port's trajectory on the GPU with this file (the
GPU machine has no JAX); tests/test_torch_dambreak.py checks the port against
it on the CPU, and (marked slow) the file against the JAX package.

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_dambreak_ref.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_dambreak_ref.npz")
CONFIG = os.path.join(ROOT, "configs", "default-config.yaml")
SCENE = os.path.join(ROOT, "configs", "default-scene.yaml")
STEPS = 10
PER_STEP = {
    "n": np.int32, "capacity": np.int32, "dt": np.float32, "div_iterations": np.int32,
    "density_iterations": np.int32, "shares": np.int32, "merge_or_split_count": np.int32,
    "split_deferred": np.int32, "mass_conservation_error": np.float32,
}
STATE = ("position", "velocity", "density", "mass", "level")


def reference_run(steps: int = STEPS):
    """(alive state arrays, per-step diag arrays) of the JAX run."""
    sys.path.insert(0, ROOT)
    from adaptive_sph_tpu.models import scene as scene_mod
    from adaptive_sph_tpu.runner import create_simulation
    from adaptive_sph_tpu.utils.params import load_params

    sim = create_simulation(load_params(CONFIG), scene_mod.load_scene(SCENE))
    per_step = {k: [] for k in PER_STEP}
    for _ in range(steps):
        d = sim.step()
        d = {**d, "n": sim.num_fluid_particles, "capacity": sim.state.capacity}
        for k in PER_STEP:
            per_step[k].append(np.asarray(d[k]).item())
    alive = np.asarray(sim.state.alive)
    state = {k: np.asarray(getattr(sim.state, k), np.float32)[alive] for k in STATE}
    return state, {k: np.asarray(v, PER_STEP[k]) for k, v in per_step.items()}


def main():
    state, per_step = reference_run()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **state, **per_step)
    print(f"wrote {OUT}: " + ", ".join(f"{k} {v.tolist()}" for k, v in per_step.items()))


if __name__ == "__main__":
    main()
