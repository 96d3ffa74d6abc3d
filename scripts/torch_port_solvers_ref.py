"""Write the JAX reference trajectories of the rest of the solver surface for the PyTorch port.

Runs the JAX package on the CPU (its Pallas kernels in interpret mode) and
writes tests/data/torch_port_solvers_ref.npz. Runs (the port's definitions,
`adaptive_sph_torch.stress.solver_runs`, converted to the JAX package's
parameters):

  stress_w2020_hybrid          : the stress scene, parity options,
                                 Winchenbach2020 (the classic branch, K2
                                 streamed solves), 10 steps
  stress_w2020_hybrid_resident : the same with resident_solver (one
                                 pair_hybrid launch per step), 10 steps
  stress_iisph2_wcsph_resident : IISPH2 with WCSPH viscosity (nu 0.003) and
                                 resident_solver, 10 steps
  stress_wcsph_visc_after_div  : HybridDFSPH, WCSPH viscosity, the
                                 non-pressure step after the divergence
                                 solve (mega branch), 10 steps
  impact_w2020_hybrid, impact_w2020_iisph, impact_w2020_only_divergence :
                                 the impact scene, resident, Winchenbach2020,
                                 6 steps each
  winchenbach_instabilities    : configs/media/winchenbach-iisph-instabilities.yaml's
                                 first entry (IISPH, Winchenbach2020, max_dt
                                 0.001, no resampling) on its scene,
                                 stress.MEDIA_STEPS steps

Per run, keys "<run>__<field>":
  dt, div_iterations, density_iterations, negative_aii : one entry per step
      (-1 where the solver has no such solve)
  position, velocity, density, pressure : the alive particles after the last
      step (float32)

`chip_smoke.py` compares the port's trajectories on the GPU with this file
(the GPU machine has no JAX); tests/test_torch_solvers.py checks the file
against the JAX package on the CPU.

`--spread N` writes nothing: it runs the media configuration N steps twice,
the second time with every initial position moved by one float32 step (a
seeded sign per slot and axis), and prints per step whether the two still
agree to the trajectory tolerances (positions atol 2e-5, density rtol 2e-5,
velocity atol 2e-4, equal iteration counts): the steps over which float32
rounding alone keeps the configuration inside them.

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_solvers_ref.py [--only RUN ...]
    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_solvers_ref.py --spread 200
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_solvers_ref.npz")
PER_STEP = ("div_iterations", "density_iterations", "negative_aii")


def jax_simulation(params, scene: dict, capacity):
    from adaptive_sph_torch import convert
    from adaptive_sph_tpu.models import scene as j_scene
    from adaptive_sph_tpu.runner import create_simulation
    from adaptive_sph_tpu.utils import params as j_params

    return create_simulation(j_params.params_from_dict(convert.params_to_dict(params)),
                             j_scene.scene_from_dict(scene), capacity=capacity,
                             counters_enabled=False, backend="tiles")


def step_record(d) -> dict:
    out = {"dt": float(d["dt"])}
    for k in PER_STEP:
        out[k] = int(d[k]) if k in d else -1
    return out


def alive_state(state) -> dict:
    alive = np.asarray(state.alive)
    return {k: np.asarray(getattr(state, k), np.float32)[alive]
            for k in ("position", "velocity", "density", "pressure")}


def reference_run(params, scene: dict, capacity, steps: int):
    """(alive state arrays, per-step arrays) of one JAX run."""
    sim = jax_simulation(params, scene, capacity)
    recs = [step_record(sim.step()) for _ in range(steps)]
    per_step = {"dt": np.asarray([r["dt"] for r in recs], np.float32)}
    per_step.update({k: np.asarray([r[k] for r in recs], np.int32) for k in PER_STEP})
    return alive_state(sim.state), per_step


def states_agree(a: dict, b: dict) -> str:
    """'' when b's alive particles match a's (by position) within the
    trajectory tolerances, else what differs."""
    from scipy.spatial import cKDTree

    if len(a["position"]) != len(b["position"]):
        return "census"
    _, j = cKDTree(b["position"]).query(a["position"], k=1)
    if not (np.sort(j) == np.arange(len(j))).all():
        return "matching"
    errs = []
    if not np.allclose(b["position"][j], a["position"], rtol=0, atol=2e-5):
        errs.append(f"position {np.abs(b['position'][j] - a['position']).max():.2e}")
    if not np.allclose(b["density"][j], a["density"], rtol=2e-5, atol=0):
        errs.append(f"density {np.abs(b['density'][j] / a['density'] - 1).max():.2e}")
    if not np.allclose(b["velocity"][j], a["velocity"], rtol=0, atol=2e-4):
        errs.append(f"velocity {np.abs(b['velocity'][j] - a['velocity']).max():.2e}")
    return ", ".join(errs)


def spread(steps: int):
    import jax.numpy as jnp

    from adaptive_sph_torch.stress import solver_runs

    params, scene, capacity, _ = solver_runs()["winchenbach_instabilities"]
    a = jax_simulation(params, scene, capacity)
    b = jax_simulation(params, scene, capacity)
    C = int(np.asarray(b.state.alive).shape[0])
    sign = np.random.default_rng(11).choice(np.float32([-1.0, 1.0]), (C, 2))
    pos = b.state.position
    b.state = b.state.replace(position=jnp.where(b.state.alive[:, None], jnp.nextafter(
        pos, jnp.asarray(sign) * jnp.float32(jnp.inf)), pos))
    last_ok = 0
    for k in range(1, steps + 1):
        ra, rb = step_record(a.step()), step_record(b.step())
        why = "" if ra == rb else f"per-step {ra} != {rb}"
        why = why or states_agree(alive_state(a.state), alive_state(b.state))
        if not why and last_ok == k - 1:
            last_ok = k
        print(f"step {k}: {'agree' if not why else why}; iterations "
              f"{ra['density_iterations']} / {rb['density_iterations']}, negative a_ii "
              f"{ra['negative_aii']} / {rb['negative_aii']}", flush=True)
    print(f"the 1-ulp runs agree over the first {last_ok} steps")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="*", default=None, help="runs to compute (others kept "
                    "from the existing file)")
    ap.add_argument("--spread", type=int, default=0, help="the 1-ulp spread of the media "
                    "configuration over this many steps; writes nothing")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    if args.spread:
        return spread(args.spread)
    from adaptive_sph_torch.stress import solver_runs

    out = dict(np.load(OUT)) if args.only and os.path.exists(OUT) else {}
    for name, (params, scene, capacity, steps) in solver_runs().items():
        if args.only and name not in args.only:
            continue
        state, per_step = reference_run(params, scene, capacity, steps)
        out = {k: v for k, v in out.items() if not k.startswith(name + "__")}
        out.update({f"{name}__{k}": v for k, v in {**state, **per_step}.items()})
        print(f"{name}: n={len(state['position'])}, steps={steps}, div iters "
              f"{per_step['div_iterations'].tolist()}, density iters "
              f"{per_step['density_iterations'].tolist()}, negative a_ii "
              f"{per_step['negative_aii'].tolist()}", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
