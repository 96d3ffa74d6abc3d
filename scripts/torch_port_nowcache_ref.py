"""Write the JAX reference trajectories of the sweep-only tile step for the PyTorch port.

Runs the JAX package on the CPU (its Pallas kernels in interpret mode) with
ASPH_NO_WCACHE=1, the setting under which its tile step keeps no pair list
and runs every pair sum as a sweep, and writes
tests/data/torch_port_nowcache_ref.npz. Runs: `adaptive_sph_torch.stress.nowcache_runs`
(the stress scene at full width, n = 11,835, with the parity options,
Winchenbach2020 with resident_solver, WCSPH viscosity after the divergence
solve, IISPH2 with WCSPH; the default dam break; the impact scene), converted
to the JAX package's parameters.

Per run, keys "<run>__<field>":
  dt, div_iterations, density_iterations, negative_aii, n, capacity : one
      entry per step (-1 where the solver has no such solve)
  position, velocity, density, pressure, mass : the alive particles after the
      last step (float32)

`chip_smoke.py` (phase N2) compares the port's runs on the GPU with this file
(the GPU machine has no JAX); tests/test_torch_nowcache.py checks its small
run against the JAX package and the port on the CPU.

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_nowcache_ref.py [--only RUN ...]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_nowcache_ref.npz")
PER_STEP = ("div_iterations", "density_iterations", "negative_aii")
STATE = ("position", "velocity", "density", "pressure", "mass")


def reference_run(params, scene: dict, capacity, steps: int):
    """(alive state arrays, per-step arrays) of one JAX run under
    ASPH_NO_WCACHE=1 (the JAX package reads it when it first traces the
    step, so it stays set for the whole run)."""
    from adaptive_sph_torch import convert
    from adaptive_sph_tpu.models import scene as j_scene
    from adaptive_sph_tpu.runner import create_simulation
    from adaptive_sph_tpu.utils import params as j_params

    old = os.environ.get("ASPH_NO_WCACHE")
    os.environ["ASPH_NO_WCACHE"] = "1"
    try:
        sim = create_simulation(j_params.params_from_dict(convert.params_to_dict(params)),
                                j_scene.scene_from_dict(scene), capacity=capacity,
                                counters_enabled=False, backend="tiles")
        recs = []
        for _ in range(steps):
            d = sim.step()
            rec = {"dt": float(d["dt"]), "n": sim.num_fluid_particles,
                   "capacity": sim.state.capacity}
            rec.update({k: int(d[k]) if k in d else -1 for k in PER_STEP})
            recs.append(rec)
    finally:
        if old is None:
            os.environ.pop("ASPH_NO_WCACHE")
        else:
            os.environ["ASPH_NO_WCACHE"] = old
    per_step = {"dt": np.asarray([r["dt"] for r in recs], np.float32)}
    per_step.update({k: np.asarray([r[k] for r in recs], np.int32)
                     for k in (*PER_STEP, "n", "capacity")})
    alive = np.asarray(sim.state.alive)
    state = {k: np.asarray(getattr(sim.state, k), np.float32)[alive] for k in STATE}
    return state, per_step


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=None, help="runs to compute (others kept "
                    "from the existing file)")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from adaptive_sph_torch.stress import nowcache_runs

    out = dict(np.load(OUT)) if args.only and os.path.exists(OUT) else {}
    for name, (params, scene, capacity, steps) in nowcache_runs().items():
        if args.only and name not in args.only:
            continue
        state, per_step = reference_run(params, scene, capacity, steps)
        out = {k: v for k, v in out.items() if not k.startswith(name + "__")}
        out.update({f"{name}__{k}": v for k, v in {**state, **per_step}.items()})
        print(f"{name}: n={len(state['position'])}, steps={steps}, div iters "
              f"{per_step['div_iterations'].tolist()}, density iters "
              f"{per_step['density_iterations'].tolist()}, negative a_ii "
              f"{per_step['negative_aii'].tolist()}, capacity {per_step['capacity'].tolist()}",
              flush=True)
        os.makedirs(os.path.dirname(OUT), exist_ok=True)
        np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
