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


def test_layout_with_more_than_eight_populated_levels():
    # ten size classes h0 2^k, one per level (configs/media/motivation-images.yaml
    # entry 1 populates ten): the same sort as the reference's, and the per-level
    # h maxima for all ten, where the reference's (8,) table stops at eight
    # (its tile backend leaves such grids to the neighbour-list backend)
    C, tq, h0 = 1024, 128, 0.002
    rng = np.random.default_rng(5)
    n = 1000
    k = np.arange(n) % 10
    pos = np.zeros((C, 2), np.float32)
    pos[:n] = rng.uniform(-0.9, 0.9, (n, 2))
    h = np.zeros(C, np.float32)
    h[:n] = h0 * 2.0 ** k
    mass = (h * h).astype(np.float32)
    alive = np.arange(C) < n
    tg = t_grid.make_grid_config((-1, -1), (1, 1), 2.0, h0, h0 * 2**9, C)
    jg = j_grid.make_grid_config((-1, -1), (1, 1), 2.0, h0, h0 * 2**9, C)
    assert tg.levels == 10 and tg.populated == tuple(range(10))
    tcfg = t_tiles.TileConfig.from_grid(tg, 2.0, tq=tq)
    jcfg = j_tiles.TileConfig.from_grid(jg, 2.0, tq=tq)
    tb = t_tiles.build_tiles(torch.from_numpy(pos), torch.from_numpy(h) * 2.0,
                             torch.from_numpy(h), torch.from_numpy(alive), tcfg)
    jb = j_tiles.build_tiles(jnp.asarray(pos), jnp.asarray(h * 2.0), jnp.asarray(h),
                             jnp.asarray(alive), jcfg)
    for name in ("perm", "pp", "cell_starts", "level_overflow"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert int(tb.level_overflow) == 0
    np.testing.assert_array_equal(tb.h_max_lvl.numpy(), (h0 * 2.0 ** np.arange(10)).astype(np.float32))
    np.testing.assert_array_equal(tb.h_max_lvl.numpy()[:8], np.asarray(jb.h_max_lvl))
    tst = t_tiles.sort_fields(tb, [torch.from_numpy(pos), torch.from_numpy(h),
                                   torch.from_numpy(mass)])
    twm, tcol = t_tiles.window_ranges(tcfg, tb, tst)
    assert twm.numel() == (C // tq) * 10 * t_tiles.WM_STRIDE and int(tcol) > 0



def test_ten_level_steps_match_jax_neighbour_lists(monkeypatch):
    # three steps of a scene on ten populated grid levels: configs/media/
    # motivation-images.yaml entry 1's physics without resampling (which breaks
    # ties by slot index, and the backends order slots differently) on ten
    # blocks of spacing 0.004 * 2^k, one level each (79 particles). The port's
    # tile step against the JAX package's neighbour-list backend (its tile
    # table stops at eight populated levels): equal census, dt and iteration
    # counts, positions within 2e-5 (matched by nearest neighbour)
    from scipy.spatial import cKDTree

    from adaptive_sph_torch import convert
    from adaptive_sph_torch.models import scene as t_scene
    from adaptive_sph_torch.models import tile_step
    from adaptive_sph_torch.runner import create_simulation as t_create
    from adaptive_sph_torch.stress import media_run
    from adaptive_sph_tpu.models import scene as j_scene
    from adaptive_sph_tpu.runner import create_simulation as j_create
    from adaptive_sph_tpu.utils import params as j_params

    params, _ = media_run("configs/media/motivation-images.yaml", 0)
    params = params.replace(merging=False, splitting=False, sharing=False)
    blocks, x = [], -3.95
    for k in range(10):
        s = 0.004 * 2**k
        n = 4 if k < 4 else (2 if k < 7 else 1)
        blocks.append({"pos": [x, -3.95], "size": [s * n, s * n], "spacing": s,
                       "volume_fill_ratio": 0.93, "velocity": [0, 0]})
        x += s * n + 0.05
    scene = {"boundary": {"type": "box", "width": 8, "height": 8}, "blocks": blocks}
    tables = []
    build = tile_step.build_tiles

    def build_and_keep(*a, **k):
        bins = build(*a, **k)
        tables.append(bins.h_max_lvl.clone())
        return bins

    monkeypatch.setattr(tile_step, "build_tiles", build_and_keep)
    ts = t_create(params, t_scene.scene_from_dict(scene), capacity=1024, device="cpu",
                  counters_enabled=False)
    js = j_create(j_params.params_from_dict(convert.params_to_dict(params)),
                  j_scene.scene_from_dict(scene), capacity=1024, counters_enabled=False,
                  backend="lists")
    assert ts.tile_cfg.populated == tuple(range(10))
    for step in range(3):
        dt_, dj = ts.step(), js.step()
        for k in ("dt", "div_iterations", "density_iterations"):
            assert dt_[k] == float(dj[k]), (step, k, dt_[k], dj[k])
        assert ts.num_fluid_particles == js.num_fluid_particles == 79
        tp = ts.state.position[ts.state.alive].numpy()
        jp = np.asarray(js.state.position)[np.asarray(js.state.alive)]
        dist, idx = cKDTree(jp).query(tp)
        assert len(set(idx.tolist())) == len(tp)
        assert dist.max() <= 2e-5, (step, dist.max())
    # every level's entry of the per-level h table is in use
    assert len(tables[0]) == 10 and bool((tables[0] > 0.0).all())
