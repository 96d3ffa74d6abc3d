"""PyTorch port, the list backend's neighbour structure and pair sums against
the JAX package.

ops/neighbors.py: `build_neighborhood` on the cases of
tests/test_neighbors.py (uniform, mild and 50:1 size ratios, the extended
radius) and on narrow rows and cells, where the row and cell overflow flags
fire; `filter_down` to a smaller radius. idx, mask, cross, bwd_perm,
bwd_seg, count and the three overflow flags must be equal, element for
element. ops/pairwise.py: `sym_sum` and `sym_max` within rtol 1e-6 of the
JAX package's; ops/edge_cache.py: the cached geometry and `reduce_edges`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sph_torch.ops import edge_cache as t_ec
from adaptive_sph_torch.ops import neighbors as t_nbr
from adaptive_sph_torch.ops import pairwise as t_pw
from adaptive_sph_tpu.ops import edge_cache as j_ec
from adaptive_sph_tpu.ops import neighbors as j_nbr
from adaptive_sph_tpu.ops import pairwise as j_pw

FIELDS = ("idx", "mask", "cross", "bwd_perm", "bwd_seg", "count", "cell_overflow",
          "row_overflow", "level_overflow")
CASES = [
    # seed, n, C, h range, levels, radius scale (tests/test_neighbors.py)
    (0, 200, 256, (0.05, 0.05), 1, 2.0),
    (1, 300, 512, (0.03, 0.12), 4, 2.0),
    (2, 250, 256, (0.02, 1.0), 8, 2.0),
    (3, 200, 256, (0.05, 0.05), 1, 2.894736),
    (4, 300, 512, (0.03, 0.12), 4, 2.894736),
]


def make_case(seed, n, C, h_range, extent=2.0):
    rng = np.random.default_rng(seed)
    pos = np.zeros((C, 2), dtype=np.float32)
    pos[:n] = rng.uniform(-extent / 2, extent / 2, size=(n, 2))
    h = np.full((C,), h_range[0], dtype=np.float32)
    h[:n] = np.exp(rng.uniform(np.log(h_range[0]), np.log(h_range[1]), size=n)).astype(np.float32)
    alive = np.zeros((C,), dtype=bool)
    alive[:n] = True
    return pos, h, alive


def both(pos, h, alive, scale, C, K, L, MPC):
    jn = j_nbr.build_neighborhood(jnp.asarray(pos), jnp.asarray(h), jnp.asarray(alive),
                                  jnp.float32(scale), j_nbr.NeighborConfig(C, K, L, MPC))
    tn = t_nbr.build_neighborhood(torch.from_numpy(pos), torch.from_numpy(h),
                                  torch.from_numpy(alive), scale,
                                  t_nbr.NeighborConfig(C, K, L, MPC))
    return jn, tn


def assert_same_structure(jn, tn, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(getattr(tn, f).numpy(), np.asarray(getattr(jn, f)),
                                      err_msg=f)


@pytest.mark.parametrize("rows", ["wide", "narrow"])
@pytest.mark.parametrize("case", CASES, ids=[f"case{c[0]}" for c in CASES])
def test_build_neighborhood_equals_jax(case, rows):
    seed, n, C, h_range, levels, scale = case
    K, MPC = (96, 64) if rows == "wide" else (16, 4)
    pos, h, alive = make_case(seed, n, C, h_range)
    jn, tn = both(pos, h, alive, scale, C, K, levels, MPC)
    assert_same_structure(jn, tn)
    assert tn.n_cross == int(np.sum(np.asarray(jn.bwd_seg) < C))
    if rows == "narrow" and seed in (1, 2):
        assert int(tn.cell_overflow) == 1  # the narrow cells overflow here
    if rows == "wide":
        assert int(tn.row_overflow) == int(tn.cell_overflow) == int(tn.level_overflow) == 0
        ref = np.asarray(j_nbr.brute_force_counts(jnp.asarray(pos), jnp.asarray(h),
                                                  jnp.asarray(alive), jnp.float32(scale)))
        got = t_nbr.brute_force_counts(torch.from_numpy(pos), torch.from_numpy(h),
                                       torch.from_numpy(alive), scale).numpy()
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(tn.count.numpy()[alive], ref[alive])


def test_level_overflow_equals_jax():
    pos, h, alive = make_case(2, 250, 256, (0.02, 1.0))
    jn, tn = both(pos, h, alive, 2.0, 256, 96, 3, 64)
    assert int(tn.level_overflow) == 1
    assert_same_structure(jn, tn)


@pytest.mark.parametrize("case", CASES[1:3], ids=["case1", "case2"])
def test_filter_down_equals_jax(case):
    seed, n, C, h_range, levels, _ = case
    pos, h, alive = make_case(seed, n, C, h_range)
    jn, tn = both(pos, h, alive, 2.894736, C, 96, levels, 64)
    h2 = (h * np.float32(0.9)).astype(np.float32)
    jf = j_nbr.filter_down(jn, jnp.asarray(pos), jnp.asarray(h2), jnp.asarray(alive),
                           jnp.float32(2.0), levels)
    tf = t_nbr.filter_down(tn, torch.from_numpy(pos), torch.from_numpy(h2),
                           torch.from_numpy(alive), 2.0, levels)
    assert_same_structure(jf, tf)
    assert int(tf.mask.sum()) < int(tn.mask.sum())


def pair_values(seed, C):
    rng = np.random.default_rng(seed + 100)
    return {"q": rng.normal(size=C).astype(np.float32),
            "v": rng.normal(size=(C, 2)).astype(np.float32),
            "m": rng.uniform(0.5, 2.0, size=C).astype(np.float32)}


def sum_edge(vi, vj):
    """A tree of edge contributions, finite on the self edge."""
    return {"a": vj["m"] * (vi["q"] - vj["q"]) ** 2,
            "b": vj["m"][..., None] * (vj["v"] - vi["v"]) + vi["q"][..., None]}


def max_edge(vi, vj):
    return vj["q"] * vi["m"] - vj["m"]


@pytest.mark.parametrize("case", [CASES[1], CASES[2]], ids=["case1", "case2"])
def test_sym_sum_and_sym_max_equal_jax(case):
    seed, n, C, h_range, levels, scale = case
    pos, h, alive = make_case(seed, n, C, h_range)
    jn, tn = both(pos, h, alive, scale, C, 96, levels, 64)
    assert tn.n_cross > 0  # cross-level edges reach the segmented reduction
    vals = pair_values(seed, C)
    jv = {k: jnp.asarray(v) for k, v in vals.items()}
    tv = {k: torch.from_numpy(v) for k, v in vals.items()}
    js, ts = j_pw.sym_sum(jn, jv, sum_edge), t_pw.sym_sum(tn, tv, sum_edge)
    for k in ("a", "b"):
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    jm = j_pw.sym_max(jn, jv, max_edge, fill=-3.0e38)
    tm = t_pw.sym_max(tn, tv, max_edge, fill=-3.0e38)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-6)
    # a second run is bit-identical (the segmented reduction has one order)
    assert torch.equal(t_pw.sym_sum(tn, tv, sum_edge)["b"], ts["b"])


def test_edge_cache_and_reduce_edges_equal_jax():
    seed, n, C, h_range, levels, scale = CASES[2]
    pos, h, alive = make_case(seed, n, C, h_range)
    jn, tn = both(pos, h, alive, scale, C, 96, levels, 64)
    mass = pair_values(seed, C)["m"]
    jc = j_ec.build_edge_cache(jn, jnp.asarray(pos), jnp.asarray(h), jnp.asarray(mass))
    tc = t_ec.build_edge_cache(tn, torch.from_numpy(pos), torch.from_numpy(h),
                               torch.from_numpy(mass))
    m = tn.mask.numpy()
    for k in ("diff", "r", "h_ij", "w", "grad", "mass_j"):
        got, want = getattr(tc, k).numpy()[m], np.asarray(getattr(jc, k))[m]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max(),
                                   err_msg=k)
    rho = np.asarray(j_ec.reduce_edges(jn, jc.mass_j * jc.w, jnp.asarray(mass)[:, None] * jc.w))
    got = t_ec.reduce_edges(tn, tc.mass_j * tc.w, torch.from_numpy(mass)[:, None] * tc.w)
    np.testing.assert_allclose(got.numpy(), rho, rtol=1e-6)
    dens = torch.from_numpy(rho.copy())
    assert torch.equal(t_ec.with_density(tc, tn, dens).rho_j, dens[tn.idx])
