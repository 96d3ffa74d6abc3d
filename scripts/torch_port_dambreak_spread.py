"""How far float32 rounding alone moves the default dam break's masses.

The PyTorch port's 10-step dam break matches the JAX trajectory
(tests/data/torch_port_dambreak_ref.npz) with equal per-step census, but its
per-particle masses differ by up to a few 1e-6 relative. This script shows
where that comes from, on the CPU:

  jax-1ulp : the JAX package again, with every alive particle's level moved by
             one float32 step (a seeded sign per slot) inside every step,
             between level estimation and the adaptivity step: the size of
             the difference a different summation order leaves in the level;
  port     : the port's plain CPU path.

Each is held to the unperturbed JAX run (the fixture) with particles matched
by position, and the port's mass errors are set beside the sizing function's
sensitivity d ln m_opt / d level at each particle's level and the level error.

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_dambreak_spread.py [--skip-jax]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_dambreak_ref.npz")
STATE = ("position", "velocity", "density", "mass", "level")
SIGNS = np.random.default_rng(11).choice(np.float32([-1.0, 1.0]), 1 << 17)


def perturbed_jax_run():
    """reference_run with each alive level moved by one float32 step before
    every adaptivity step."""
    import jax.numpy as jnp

    from adaptive_sph_tpu.models import adaptivity as adapt
    from torch_port_dambreak_ref import reference_run

    real = adapt.single_step_adaptivity

    def perturbed(state, *args, **kwargs):
        sign = jnp.asarray(SIGNS[:state.capacity])
        moved = jnp.nextafter(state.level, sign * jnp.float32(jnp.inf))
        return real(state.replace(level=jnp.where(state.alive, moved, state.level)),
                    *args, **kwargs)

    adapt.single_step_adaptivity = perturbed
    try:
        return reference_run()
    finally:
        adapt.single_step_adaptivity = real


def port_run(steps):
    import torch

    from adaptive_sph_torch.models import scene
    from adaptive_sph_torch.runner import create_simulation
    from adaptive_sph_torch.utils.params import load_params

    torch.set_num_threads(2)
    sim = create_simulation(load_params(os.path.join(ROOT, "configs", "default-config.yaml")),
                            scene.load_scene(os.path.join(ROOT, "configs", "default-scene.yaml")),
                            device="cpu")
    per_step = {"n": [], "shares": [], "merge_or_split_count": []}
    for _ in range(steps):
        d = sim.step()
        d["n"] = sim.num_fluid_particles
        for k in per_step:
            per_step[k].append(int(d[k]))
    a = sim.state.alive.numpy()
    state = {k: getattr(sim.state, k).numpy()[a] for k in STATE}
    return state, {k: np.asarray(v) for k, v in per_step.items()}, sim.params


def deviation(got: dict, ref) -> dict:
    """Max deviations of `got` from the reference, matched by position, and
    the matched per-particle relative mass and absolute level errors."""
    from scipy.spatial import cKDTree

    if len(got["position"]) != len(ref["position"]):
        return {"n": len(got["position"]), "n_ref": len(ref["position"])}, None
    _, j = cKDTree(got["position"]).query(ref["position"], k=1)
    assert (np.sort(j) == np.arange(len(j))).all(), "position match not a bijection"
    g = {k: v[j].astype(np.float64) for k, v in got.items()}
    r = {k: ref[k].astype(np.float64) for k in STATE}
    dm = np.abs(g["mass"] / r["mass"] - 1.0)
    dl = np.abs(g["level"] - r["level"])
    out = {"max_dx": float(np.abs(g["position"] - r["position"]).max()),
           "max_rel_drho": float(np.abs(g["density"] / r["density"] - 1.0).max()),
           "max_dv": float(np.abs(g["velocity"] - r["velocity"]).max()),
           "max_rel_dm": float(dm.max()), "max_dlevel": float(dl.max()),
           "n_rel_dm_above_1e-6": int((dm > 1e-6).sum()), "n": int(len(dm))}
    return out, (dm, dl, r["level"])


def sizing_sensitivity(level, params):
    """|d ln m_opt / d level| of the Radius sizing function, per particle."""
    msd = float(params.maximum_surface_distance)
    rf, rb = float(params.particle_radius_fine), float(params.particle_radius_base)
    i = np.clip(level, -msd, 0.0) / -msd
    radius = rf * (1.0 - i) + rb * i
    return np.where(level > -msd, 2.0 * (rb - rf) / (msd * radius), 0.0)


def main(argv):
    ref = np.load(FIXTURE)
    report = {}
    if "--skip-jax" not in argv:
        state, per_step = perturbed_jax_run()
        report["jax-1ulp"], _ = deviation(state, ref)
        report["jax-1ulp"]["census_equal"] = all(
            np.array_equal(per_step[k], ref[k]) for k in ("n", "shares", "merge_or_split_count"))
    state, per_step, params = port_run(len(ref["n"]))
    report["port"], (dm, dl, lvl) = deviation(state, ref)
    report["port"]["census_equal"] = all(
        np.array_equal(per_step[k], ref[k]) for k in ("n", "shares", "merge_or_split_count"))
    sens = sizing_sensitivity(lvl, params)
    worst = np.argsort(dm)[::-1][:5]
    report["port_worst_mass"] = [
        {"rel_dm": float(dm[k]), "level": float(lvl[k]), "dlevel": float(dl[k]),
         "d_ln_mopt_d_level": float(sens[k]),
         "rel_dm_over_sensitivity_times_dlevel": float(dm[k] / max(sens[k] * dl[k], 1e-30))}
        for k in worst]
    report["port_max_sensitivity"] = float(sens.max())
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main(sys.argv[1:])
