"""Write the JAX reference trajectory of the stress scene for the PyTorch port.

Runs the JAX package on the CPU: the ratio-stress-test scene of bench.py
(n = 11,835, 50:1 radius ratio) with the parity options (f32 pair weights,
cold-start solves, no Jacobi momentum) for 10 steps, and writes
tests/data/torch_port_stress_ref.npz:

  position, velocity, density : the alive particles after the last step (f32)
  dt, div_iterations, density_iterations : one entry per step

`chip_smoke.py` compares the port's trajectory on the GPU with this file (the
GPU machine has no JAX); tests/test_torch_stress.py checks the file against
the JAX package on the CPU.

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_stress_ref.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_stress_ref.npz")
STEPS = 10


def reference_run(steps: int = STEPS):
    """(alive state arrays, per-step diag arrays) of the JAX parity run."""
    sys.path.insert(0, ROOT)
    import bench

    sim = bench.build_sim(replicas=1, bf16=False, momentum=0.0, cold=True)
    per_step = {"dt": [], "div_iterations": [], "density_iterations": []}
    for _ in range(steps):
        d = sim.step()
        per_step["dt"].append(float(d["dt"]))
        per_step["div_iterations"].append(int(d["div_iterations"]))
        per_step["density_iterations"].append(int(d["density_iterations"]))
    alive = np.asarray(sim.state.alive)
    state = {
        "position": np.asarray(sim.state.position, np.float32)[alive],
        "velocity": np.asarray(sim.state.velocity, np.float32)[alive],
        "density": np.asarray(sim.state.density, np.float32)[alive],
    }
    return state, {"dt": np.asarray(per_step["dt"], np.float32),
                   "div_iterations": np.asarray(per_step["div_iterations"], np.int32),
                   "density_iterations": np.asarray(per_step["density_iterations"], np.int32)}


def main():
    state, per_step = reference_run()
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **state, **per_step)
    print(f"wrote {OUT}: n={len(state['position'])}, steps={len(per_step['dt'])}, "
          f"div iters {per_step['div_iterations'].tolist()}, "
          f"density iters {per_step['density_iterations'].tolist()}")


if __name__ == "__main__":
    main()
