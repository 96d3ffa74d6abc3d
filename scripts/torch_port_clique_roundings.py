"""Probe the clique operator's pair terms against the JAX package's compiled ones, pair by pair.

Two probes, each JAX's ops/cliques.py compiled by jax.jit on the CPU against
adaptive_sph_torch/ops/cliques.py on the CPU, on the same patch layout:

- blocks: the same-level weight blocks wx, wy of `clique_build` hold one
  pair term per entry, so they are compared entry by entry on a dense
  two-level cloud (tests/test_torch_cliques.py's `_scene`, seed 0);
- sums: N isolated pairs on a lattice whose spacing exceeds the support
  radius, so that each row sum of `clique_build` (s1x, s1y, s1sq, den) and
  `clique_visc` (ApproxLaplace and WCSPH) holds the partner's term and the
  self term beside exact zeros, and equals them bit for bit in any order.

Prints, per output, the entries or rows whose float32 results differ.

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_clique_roundings.py [--pairs N]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def isolated_pairs(n_pairs: int, h: float, C: int, seed: int = 0):
    """(pos, h, mass, alive) of n_pairs pairs on a lattice of spacing 8 h in
    the (-1, 1)^2 box, each pair's partner within 2 h of its anchor; the
    other rows of C dead."""
    rng = np.random.default_rng(seed)
    spacing = 8.0 * h
    side = int(np.floor(1.8 / spacing))
    assert side * side >= n_pairs, "too many pairs for the box"
    k = np.arange(n_pairs)
    anchor = np.stack([k % side, k // side], -1) * spacing - 0.9
    dist = rng.uniform(0.02, 1.0, n_pairs) * 2.0 * h
    ang = rng.uniform(0.0, 2.0 * np.pi, n_pairs)
    other = anchor + dist[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    n = 2 * n_pairs
    pos = np.zeros((C, 2), np.float32)
    pos[:n] = np.concatenate([anchor, other])
    hh = np.zeros(C, np.float32)
    hh[:n] = rng.uniform(0.9 * h, h, n)
    mass = np.where(hh > 0, hh * hh * 1000.0 / 3.61, 0.0).astype(np.float32)
    alive = hh > 0
    return pos, hh, mass, alive


def differ(a, b) -> str:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    bad = int(np.sum(a.view(np.int32) != b.view(np.int32)))
    return f"{bad} of {a.size} apart (max |diff| {float(np.max(np.abs(a - b))):.3g})"


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=100)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import jax
    import jax.numpy as jnp
    import torch

    from adaptive_sph_torch.ops import cliques as t_cliques
    from adaptive_sph_tpu.ops import cliques as j_cliques
    from test_torch_cliques import configs, layouts, scene

    def both(pos, h, mass, alive):
        C = len(h)
        jcfg, tcfg = configs(h, alive, C)
        jb, tb, jst, tst, jhalo, thalo = layouts(pos, h, mass, alive, jcfg, tcfg)
        assert int(tb.overflow) == 0 and int(thalo[1]) == 0
        return jcfg, tcfg, jst, tst, jhalo[0], thalo[0]

    print("blocks (dense two-level cloud, seed 0):")
    jcfg, tcfg, jst, tst, jhs, ths = both(*scene(0, 700, 4096, True))
    jout = jax.jit(lambda: j_cliques.clique_build(jcfg, jhs, jst, 2.0, jnp.float32))()
    tout = t_cliques.clique_build(ths, tst, 2.0)
    valid = np.asarray(jout[0]) != 0
    print(f"  pairs: {int(valid.sum())}")
    for k, name in enumerate(("wx", "wy")):
        print(f"  {name}: {differ(tout[k].numpy(), jout[k])}")

    print(f"sums ({args.pairs} isolated pairs):")
    # about one pair per patch, and each occupied patch takes 128 slots
    pos, h, mass, alive = isolated_pairs(args.pairs, 0.01, 128 * 128)
    jcfg, tcfg, jst, tst, jhs, ths = both(pos, h, mass, alive)
    jout = jax.jit(lambda: j_cliques.clique_build(jcfg, jhs, jst, 2.0, jnp.float32))()
    tout = t_cliques.clique_build(ths, tst, 2.0)
    for k, name in enumerate(("wx", "wy", "s1x", "s1y", "s1sq", "den")):
        print(f"  clique_build {name}: {differ(tout[k].numpy(), jout[k])}")
    rng = np.random.default_rng(1)
    C = len(h)
    vx, vy = (rng.standard_normal(C).astype(np.float32) for _ in range(2))
    rho = (1000.0 + 30 * rng.standard_normal(C)).astype(np.float32)
    for mode in ("laplace", "wcsph"):
        jv = jax.jit(lambda m=mode: j_cliques.clique_visc(
            jcfg, jhs, jst, jnp.asarray(vx), jnp.asarray(vy), jnp.asarray(rho), 2.0, m, 0.02))()
        tv = t_cliques.clique_visc(ths, tst, torch.from_numpy(vx), torch.from_numpy(vy),
                                   torch.from_numpy(rho), 2.0, mode, 0.02)
        for k, name in enumerate(("ax", "ay")):
            print(f"  clique_visc {mode} {name}: {differ(tv[k].numpy(), jv[k])}")


if __name__ == "__main__":
    main()
