"""Write the JAX reference trajectories of the particle (Akinci) boundary for the PyTorch port.

Runs the JAX package's tile backend on the CPU and writes
tests/data/torch_port_akinci_ref.npz. Runs (the port's definitions,
`adaptive_sph_torch.stress.akinci_runs`, converted to the JAX package's
parameters):

  dam_hybrid         : the default dam break with its blocks swapped
                       (`stress.akinci_dam_scene`), HybridDFSPH streamed,
                       10 steps
  dam_iisph_resident : the same scene, IISPH with the resident solver,
                       10 steps
  scene2_hybrid      : configs/media/motivation-video.yaml's "Uniform SPH"
                       entry (n = 33,750) at full width, 3 steps

all with `init_boundary_handler: Particles` and uniform sizes. Per run, keys
"<run>__<field>" as in scripts/torch_port_resident_ref.py: dt,
div_iterations, density_iterations (one entry per step, -1 where the solver
has no such solve); position, velocity, density, pressure of the alive
particles after the last step.

`chip_smoke.py` compares the port's runs on the GPU with this file (the GPU
machine has no JAX); tests/test_torch_particle_boundary.py checks the file
against the JAX package on the CPU.

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_akinci_ref.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_akinci_ref.npz")


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from torch_port_resident_ref import reference_run

    from adaptive_sph_torch.stress import akinci_runs

    out = {}
    for name, (params, scene, capacity, steps) in akinci_runs().items():
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
