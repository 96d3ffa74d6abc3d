"""Write the JAX reference trajectory of the stress scene's scalar-g path.

Runs the JAX package on the CPU with ASPH_SCALAR_BLOCKS=1, set before the
step is first traced: the reference's opt-in v7 scalar-g pair blocks on its
mega branch (tq = 128). Scene and options as scripts/torch_port_stress_ref.py
(bench.py's ratio-stress-test scene, n = 11,835, parity options), 10 steps;
writes tests/data/torch_port_scalar_ref.npz with the same keys:

  position, velocity, density : the alive particles after the last step (f32)
  dt, div_iterations, density_iterations : one entry per step

`chip_smoke.py` compares the port's scalar path on the GPU with this file;
tests/test_torch_scalar.py checks the file against the JAX package on the CPU.

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_scalar_ref.py
"""

from __future__ import annotations

import os
import sys

import numpy as np

os.environ["ASPH_SCALAR_BLOCKS"] = "1"
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_port_stress_ref import ROOT, reference_run  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "torch_port_scalar_ref.npz")


def main():
    state, per_step = reference_run()
    np.savez_compressed(OUT, **state, **per_step)
    print(f"wrote {OUT}: n={len(state['position'])}, steps={len(per_step['dt'])}, "
          f"div iters {per_step['div_iterations'].tolist()}, "
          f"density iters {per_step['density_iterations'].tolist()}")


if __name__ == "__main__":
    main()
