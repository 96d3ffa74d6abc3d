"""PyTorch port, tile layout: build_tiles, sort_fields and the window meta must
equal the JAX package's EXACTLY (integers bit for bit, sorted floats equal) on
jittered two-level clouds over the (capacity, tq) grid of the reference's
small-shape differential. The JAX side runs jitted, as inside its step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sph_torch.ops import grid as t_grid
from adaptive_sph_torch.ops import tiles as t_tiles
from adaptive_sph_tpu.ops import grid as j_grid
from adaptive_sph_tpu.ops import tiles as j_tiles
from test_torch_kernels import GRID, N_FINE, two_level_cloud

torch.set_num_threads(2)


def configs(C, tq):
    """(JAX TileConfig, port TileConfig) of the two-level cloud box."""
    jg = j_grid.make_grid_config((-1, -1), (1, 1), 2.0, 0.009, 0.35, C)
    jg = dataclasses.replace(jg, populated=(0, jg.levels - 1))
    tg = t_grid.make_grid_config((-1, -1), (1, 1), 2.0, 0.009, 0.35, C)
    tg = dataclasses.replace(tg, populated=(0, tg.levels - 1))
    return j_tiles.TileConfig.from_grid(jg, 2.0, tq=tq), t_tiles.TileConfig.from_grid(tg, 2.0, tq=tq)


def layouts(C, tq, seed):
    """Both packages' layouts of one cloud: (jcfg, tcfg, jbins, tbins, jst, tst)."""
    pos, h, mass, alive = two_level_cloud(C, N_FINE[C], seed=seed)
    jcfg, tcfg = configs(C, tq)
    jb = j_tiles.build_tiles(jnp.asarray(pos), jnp.asarray(h * 2.0), jnp.asarray(h),
                             jnp.asarray(alive), jcfg)
    tb = t_tiles.build_tiles(torch.from_numpy(pos), torch.from_numpy(h) * 2.0,
                             torch.from_numpy(h), torch.from_numpy(alive), tcfg)
    jst = j_tiles.sort_fields(jb, [jnp.asarray(pos), jnp.asarray(h), jnp.asarray(mass)])
    tst = t_tiles.sort_fields(tb, [torch.from_numpy(pos), torch.from_numpy(h),
                                   torch.from_numpy(mass)])
    return jcfg, tcfg, jb, tb, jst, tst


def jax_window_meta(cfg, bins, st):
    """The reference's window meta as its jitted step computes it."""
    return jax.jit(lambda b, s: j_tiles.window_ranges(cfg, b, s))(bins, st)


def test_configs_equal():
    for C, tq in GRID:
        jcfg, tcfg = configs(C, tq)
        for f in dataclasses.fields(tcfg):
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), (f.name, C, tq)
        assert tcfg.cell_offsets == jcfg.cell_offsets


@pytest.mark.parametrize("C,tq", GRID)
def test_layout_and_window_meta_exact(C, tq):
    jcfg, tcfg, jb, tb, jst, tst = layouts(C, tq, seed=13 + C + tq)
    for name in ("perm", "pp", "cell_starts", "n_padded", "overflow", "level_overflow"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(tb.h_max_lvl.numpy(), np.asarray(jb.h_max_lvl))
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    jwm, jcol = jax_window_meta(jcfg, jb, jst)
    twm, tcol = t_tiles.window_ranges(tcfg, tb, tst)
    np.testing.assert_array_equal(twm.numpy(), np.asarray(jwm))
    assert int(tcol) == int(jcol)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_layout_exact_three_levels_with_collapse(seed):
    # a third, mid-size class and coarse particles spanning many rows: tiles
    # whose candidate rows exceed RL collapse into one spanning range
    C, tq = 2048, 64
    rng = np.random.default_rng(seed)
    pos, h, mass, alive = two_level_cloud(C, 700, n_coarse=6, seed=seed)
    mid = np.where(alive)[0][:40]
    h[mid] = 0.06
    pos[mid] = rng.uniform(-0.5, 0.5, (40, 2))
    jg = j_grid.make_grid_config((-1, -1), (1, 1), 2.0, 0.009, 0.35, C)
    tg = t_grid.make_grid_config((-1, -1), (1, 1), 2.0, 0.009, 0.35, C)
    lv = sorted({0, 3, jg.levels - 1})
    jcfg = j_tiles.TileConfig.from_grid(dataclasses.replace(jg, populated=tuple(lv)), 2.0, tq=tq)
    tcfg = t_tiles.TileConfig.from_grid(dataclasses.replace(tg, populated=tuple(lv)), 2.0, tq=tq)
    jb = j_tiles.build_tiles(jnp.asarray(pos), jnp.asarray(h * 2.0), jnp.asarray(h),
                             jnp.asarray(alive), jcfg)
    tb = t_tiles.build_tiles(torch.from_numpy(pos), torch.from_numpy(h) * 2.0,
                             torch.from_numpy(h), torch.from_numpy(alive), tcfg)
    np.testing.assert_array_equal(tb.cell_starts.numpy(), np.asarray(jb.cell_starts))
    np.testing.assert_array_equal(tb.perm.numpy(), np.asarray(jb.perm))
    assert int(tb.level_overflow) == int(jb.level_overflow)
    jst = j_tiles.sort_fields(jb, [jnp.asarray(pos), jnp.asarray(h), jnp.asarray(mass)])
    tst = t_tiles.sort_fields(tb, [torch.from_numpy(pos), torch.from_numpy(h),
                                   torch.from_numpy(mass)])
    jwm, jcol = jax_window_meta(jcfg, jb, jst)
    twm, tcol = t_tiles.window_ranges(tcfg, tb, tst)
    np.testing.assert_array_equal(twm.numpy(), np.asarray(jwm))
    assert int(tcol) == int(jcol)
