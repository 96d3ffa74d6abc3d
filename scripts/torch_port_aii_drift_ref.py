"""Write the JAX reference of check_aii's per-step deviation on the constrained stress run.

Runs the JAX package on the CPU (its Pallas sweeps in interpret mode, as its
own tests run them) on `adaptive_sph_torch.stress.sweep_mode_runs()`'s
"stress_checked_constrained" run (the stress scene, n = 11,835, with
constrain_neighborhood_count, check_aii and check_neighborhood) for
DRIFT_STEPS steps from its initial state, then again with every alive
particle's initial position moved by one float32 step (a seeded sign per
slot and axis): the spread that rounding alone leaves in the deviation as
the flow turns chaotic. Writes tests/data/torch_port_aii_drift_ref.npz:

  aii_deviation, dt : one float32 entry per step (the unperturbed run)
  div_iterations, density_iterations : one int32 entry per step
  aii_deviation_1ulp, dt_1ulp : the same of the perturbed run

`chip_smoke.py` runs the port on the card over the same steps and holds its
per-step deviation against this record (the GPU machine has no JAX).

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_aii_drift_ref.py [--steps N]

(~8 min on the CPU.)
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_aii_drift_ref.npz")
RUN = "stress_checked_constrained"
KEYS = ("aii_deviation", "dt", "div_iterations", "density_iterations")


def run(steps: int, perturb: bool) -> dict:
    """The JAX run's per-step records; perturb: the initial positions moved
    by one float32 step."""
    import jax.numpy as jnp
    from torch_port_sweep_modes_ref import jax_simulation

    from adaptive_sph_torch.stress import sweep_mode_runs

    params, scene, capacity, _ = sweep_mode_runs()[RUN]
    sim = jax_simulation(params, scene, capacity)
    if perturb:
        st = sim.state
        signs = np.random.default_rng(12).choice(np.float32([-1.0, 1.0]), st.position.shape)
        moved = jnp.nextafter(st.position, jnp.asarray(signs) * jnp.float32(jnp.inf))
        sim.state = st.replace(position=jnp.where(st.alive[:, None], moved, st.position))
    rec = {k: [] for k in KEYS}
    t0 = time.perf_counter()
    for step in range(1, steps + 1):
        d = sim.step()
        for k in rec:
            rec[k].append(d[k])
        print(f"{'1-ulp ' if perturb else ''}step {step}: aii deviation "
              f"{float(d['aii_deviation']):.6g}, dt {float(d['dt']):.6g}, iterations "
              f"{int(d['div_iterations'])} / {int(d['density_iterations'])} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)
    return {k: np.asarray(v, np.float32 if k in ("aii_deviation", "dt") else np.int32)
            for k, v in rec.items()}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    sys.path.insert(0, ROOT)
    from adaptive_sph_torch.stress import DRIFT_STEPS

    ap.add_argument("--steps", type=int, default=DRIFT_STEPS)
    args = ap.parse_args()
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    out = run(args.steps, False)
    spread = run(args.steps, True)
    out.update({"aii_deviation_1ulp": spread["aii_deviation"], "dt_1ulp": spread["dt"]})
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    dev, dev1 = out["aii_deviation"], out["aii_deviation_1ulp"]
    print(f"wrote {OUT}: max deviation {float(dev.max()):.6g} at step "
          f"{int(dev.argmax()) + 1}, 1-ulp run {float(dev1.max()):.6g} at step "
          f"{int(dev1.argmax()) + 1}; largest per-step difference between the two "
          f"{float(np.abs(dev1 - dev).max()):.6g}")


if __name__ == "__main__":
    main()
