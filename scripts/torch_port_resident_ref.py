"""Write the JAX reference trajectories of the resident solver for the PyTorch port.

Runs the JAX package on the CPU with `resident_solver=True` (its whole-solve
Pallas kernels in interpret mode) and writes
tests/data/torch_port_resident_ref.npz. Runs (the port's definitions,
`adaptive_sph_torch.stress.resident_runs`, converted to the JAX package's
parameters):

  stress_hybrid : the stress scene, parity options, 10 steps
  stress_iisph  : the stress scene, IISPH with the video config's settings,
                  10 steps
  impact_hybrid, impact_iisph, impact_only_divergence : the impact scene,
                  6 steps each

Per run, keys "<run>__<field>":
  dt, div_iterations, density_iterations : one entry per step (-1 where the
      solver has no such solve)
  position, velocity, density, pressure  : the alive particles after the
      last step (float32)

`chip_smoke.py` compares the port's resident trajectories on the GPU with
this file (the GPU machine has no JAX); tests/test_torch_resident*.py check
the file against the JAX package on the CPU.

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_resident_ref.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_resident_ref.npz")


def reference_run(params, scene: dict, capacity, steps: int):
    """(alive state arrays, per-step arrays) of one JAX run."""
    from adaptive_sph_torch import convert
    from adaptive_sph_tpu.models import scene as j_scene
    from adaptive_sph_tpu.runner import create_simulation
    from adaptive_sph_tpu.utils import params as j_params

    sim = create_simulation(j_params.params_from_dict(convert.params_to_dict(params)),
                            j_scene.scene_from_dict(scene), capacity=capacity,
                            counters_enabled=False, backend="tiles")
    per_step = {"dt": [], "div_iterations": [], "density_iterations": []}
    for _ in range(steps):
        d = sim.step()
        per_step["dt"].append(float(d["dt"]))
        for k in ("div_iterations", "density_iterations"):
            per_step[k].append(int(d[k]) if k in d else -1)
    alive = np.asarray(sim.state.alive)
    state = {k: np.asarray(getattr(sim.state, k), np.float32)[alive]
             for k in ("position", "velocity", "density", "pressure")}
    return state, {"dt": np.asarray(per_step["dt"], np.float32),
                   "div_iterations": np.asarray(per_step["div_iterations"], np.int32),
                   "density_iterations": np.asarray(per_step["density_iterations"], np.int32)}


def main():
    sys.path.insert(0, ROOT)
    from adaptive_sph_torch.stress import resident_runs

    out = {}
    for name, (params, scene, capacity, steps) in resident_runs().items():
        state, per_step = reference_run(params, scene, capacity, steps)
        out.update({f"{name}__{k}": v for k, v in {**state, **per_step}.items()})
        print(f"{name}: n={len(state['position'])}, steps={steps}, div iters "
              f"{per_step['div_iterations'].tolist()}, density iters "
              f"{per_step['density_iterations'].tolist()}", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
