"""Probe the dense grid engine's pair terms against the JAX package's compiled sweeps, pair by pair.

Places N isolated pairs of particles on a lattice whose spacing exceeds the
support radius, so that each particle's pair sums hold one term of the other
particle (beside its own self term and exact zeros): a sum then equals its
pair term bit for bit, in any order. Each slot sweep of
adaptive_sph_tpu/models/grid_physics.py runs compiled by jax.jit on the CPU,
its counterpart of adaptive_sph_torch/models/grid_physics.py on the CPU, on
the same bins; the script prints, per sweep and output, the fraction of
particles whose float32 results differ. The sweeps: density, the fused prep
sweep (the four a_ii sums and the viscosity, ApproxLaplace and WCSPH), the
pressure acceleration, the divergence (both discretizations), the
non-pressure acceleration and IISPH2's Omega sum.

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_grid_roundings.py [--pairs N]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def isolated_pairs(n_pairs: int, h_max: float, seed: int = 0):
    """(pos, h) of n_pairs pairs on a square lattice of spacing 4 * 2 h_max,
    each pair's second particle within the support radius of the first."""
    rng = np.random.default_rng(seed)
    side = int(np.ceil(np.sqrt(n_pairs)))
    spacing = 8.0 * h_max
    k = np.arange(n_pairs)
    anchor = np.stack([k % side, k // side], -1) * spacing - 0.5 * side * spacing
    h = rng.uniform(0.8 * h_max, h_max, (n_pairs, 2))
    dist = rng.uniform(0.02, 1.0, n_pairs) * (h[:, 0] + h[:, 1])  # < 2 h_ij
    ang = rng.uniform(0.0, 2.0 * np.pi, n_pairs)
    other = anchor + dist[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    pos = np.concatenate([anchor, other]).astype(np.float32)
    return pos, np.concatenate([h[:, 0], h[:, 1]]).astype(np.float32), side * spacing


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=3000)
    n_pairs = ap.parse_args().pairs
    sys.path.insert(0, ROOT)
    import jax
    import jax.numpy as jnp
    import torch

    from adaptive_sph_torch import convert
    from adaptive_sph_torch.models import grid_physics as t_gp
    from adaptive_sph_torch.ops import grid as t_grid
    from adaptive_sph_torch.utils.params import (
        OperatorDiscretization,
        SimulationParams,
        ViscosityType,
    )
    from adaptive_sph_tpu.models import grid_physics as j_gp
    from adaptive_sph_tpu.ops import grid as j_grid
    from adaptive_sph_tpu.utils import params as j_params

    h_max = 0.01
    pos, h, extent = isolated_pairs(n_pairs, h_max)
    C = len(pos)
    rng = np.random.default_rng(1)
    fields = dict(pos=pos, h=h, mass=rng.uniform(0.5, 2.0, C).astype(np.float32),
                  rho=rng.uniform(0.8, 1.2, C).astype(np.float32))
    vel = rng.normal(size=(C, 2)).astype(np.float32)
    q = rng.normal(size=(C, 2)).astype(np.float32)
    p = rng.uniform(0.0, 50.0, C).astype(np.float32)
    sc = rng.integers(0, 5, C).astype(np.int32)
    G = np.zeros((C, 2), np.float32)
    half = 0.5 * extent + 4 * h_max
    jcfg = j_grid.make_grid_config((-half, -half), (half, half), 2.0, h_max, h_max, C, mpc=4)
    tcfg = convert.grid_config_from_dict(dataclasses.asdict(jcfg))
    alive = np.ones(C, bool)
    jb = j_grid.build_bins(jnp.asarray(pos), jnp.asarray(h * 2.0), jnp.asarray(alive), jcfg)
    tb = t_grid.build_bins(torch.from_numpy(pos), torch.from_numpy(h * np.float32(2.0)),
                           torch.from_numpy(alive), tcfg)
    assert int(jb.overflow) == 0 and int(jb.level_overflow) == 0

    def js(x):
        return j_grid.scatter_field(jb, jcfg, jnp.asarray(x))

    def ts(x):
        return t_grid.scatter_field(tb, tcfg, torch.from_numpy(x))

    sfj = {k: js(v) for k, v in fields.items()}
    sft = {k: ts(v) for k, v in fields.items()}
    s = jnp.float32(2.0)

    def frac(name, got, want):
        if isinstance(want, dict):
            for k in want:
                frac(f"{name}.{k}", got[k], want[k])
            return
        g = t_grid.gather_result(tb, tcfg, got).numpy().reshape(C, -1)
        w = np.asarray(j_grid.gather_result(jb, jcfg, want)).reshape(C, -1)
        print(f"  {name}: {np.mean(np.any(g != w, axis=1)):.6f}")

    cases = {
        "ApproxLaplace, ConsistentSimpleGradient": SimulationParams(),
        "WCSPH, Winchenbach2020": SimulationParams(
            viscosity_type=ViscosityType.WCSPH, viscosity=0.003,
            operator_discretization=OperatorDiscretization.Winchenbach2020),
    }
    print(f"{n_pairs} isolated pairs ({C} particles); fraction of particles whose sum "
          "differs from JAX's compiled sweep:")
    for label, params in cases.items():
        jp = j_params.params_from_dict(convert.params_to_dict(params))
        print(label)
        frac("density", t_gp.density_slots(tcfg, tb, sft, 2.0),
             jax.jit(lambda sf: j_gp.density_slots(jcfg, jb, sf, s))(sfj))
        sums, visc = t_gp.fused_prep_sweep(tcfg, tb, sft, 2.0, ts(vel), params)
        jsums, jvisc = jax.jit(lambda sf, v: j_gp.fused_prep_sweep(jcfg, jb, sf, s, v, jp))(
            sfj, js(vel))
        frac("prep", sums, jsums)
        frac("prep.visc", visc, jvisc)
        frac("pressure_accel", t_gp.pressure_accel_slots(tcfg, tb, sft, 2.0, ts(p), ts(G),
                                                          "none", params),
             jax.jit(lambda sf, pp: j_gp.pressure_accel_slots(jcfg, jb, sf, s, pp, js(G), "none",
                                                              jp))(sfj, js(p)))
        frac("divergence", t_gp.divergence_slots(tcfg, tb, sft, 2.0, ts(q), torch.zeros(2),
                                                  ts(G), "none", params),
             jax.jit(lambda sf, qq: j_gp.divergence_slots(jcfg, jb, sf, s, qq,
                                                          jnp.zeros(2, jnp.float32), js(G),
                                                          "none", jp))(sfj, js(q)))
        frac("non_pressure_accel", t_gp.non_pressure_accel_slots(tcfg, tb, sft, 2.0, ts(vel),
                                                                  params),
             jax.jit(lambda sf, v: j_gp.non_pressure_accel_slots(jcfg, jb, sf, s, v, jp))(
                 sfj, js(vel)))
        frac("omega", t_gp.omega_iisph2_slots(tcfg, tb, sft, 2.0, ts(sc), params),
             jax.jit(lambda sf, c: j_gp.omega_iisph2_slots(jcfg, jb, sf, s, c, jp))(sfj, js(sc)))


if __name__ == "__main__":
    main()
