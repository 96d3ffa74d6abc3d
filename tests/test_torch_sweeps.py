"""PyTorch port, generic pair sweeps: the nine SweepOps of the default dam break
(level estimation, smoothing, the four partner-matching passes), the
classic branch's DENSITY sweep, the viscosity sweep (ApproxLaplace and WCSPH),
IISPH2's Omega sum and the sweep-only step's sweeps (prep with the
ApproxLaplace, WCSPH and XSPH viscosities, aii_sums, accel, div in both
discretizations) through the
port's plain walk against the JAX package's `run_sweep` in interpret mode (as
tests/test_tile_engine.py runs it), on one layout built by the JAX package.
The JAX side's partner-matching ops are the ones its find_partners_tiles
builds, captured from its calls to run_sweep.

Clouds: two levels (C = 1024, the reference's sweep-parity cloud) and eight
levels. Tolerances: counts and maxima EXACTLY equal; sums within 1e-5 of each
column's max |value| (the two walks add in different orders). The merge/share
distance mask is inclusive: pairs placed exactly at max_dist * h_ij count in
both packages.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sph_torch.ops import sweeps as t_sweeps
from adaptive_sph_tpu.models import adaptivity as j_adapt
from adaptive_sph_tpu.models import state as j_state
from adaptive_sph_tpu.models import tile_physics as j_tp
from adaptive_sph_tpu.ops import grid as j_grid
from adaptive_sph_tpu.ops import tiles as j_tiles
from adaptive_sph_tpu.ops.pallas_sweeps import run_sweep
from adaptive_sph_tpu.utils.params import SimulationParams, ViscosityType
from test_torch_kernels import (EXT_SCALE, N_FINE, VISC, assert_sweep_close, multi_level_cloud,
                                port_sweep_ops, sweep_dyn, two_level_cloud)

torch.set_num_threads(2)


def jax_adapt_ops(params, mode):
    """The partner-matching SweepOps and the scale exactly as the JAX
    package's find_partners_tiles builds them: its calls to run_sweep are
    captured while it is traced (jax.eval_shape) on a small state."""
    from adaptive_sph_tpu.ops import pallas_sweeps

    C = 256
    pos, h, mass, alive = two_level_cloud(C, N_FINE[C], seed=3)
    cfg, *_ = jax_layout(pos, h, mass, alive, C, 64, EXT_SCALE)
    state = j_state.init_state(pos[alive], np.zeros_like(pos[alive]), mass[alive], C,
                               uniform_sizes=False)
    captured = {}

    def spy(tcfg, bins, st, dyn, op, scale, **kw):
        captured[op.name] = (op, scale)
        return jnp.zeros((st.shape[0], op.n_out), jnp.float32)

    real = pallas_sweeps.run_sweep
    pallas_sweeps.run_sweep = spy
    try:
        jax.eval_shape(lambda s: j_adapt.find_partners_tiles(
            s, cfg, j_adapt.classify(s, params), jnp.float32(1e-3), params, mode), state)
    finally:
        pallas_sweeps.run_sweep = real
    assert sorted(captured) == ["adapt_claim", "adapt_cnt0", "adapt_cnt1", "adapt_partner"]
    scales = {sc for _, sc in captured.values()}
    assert len(scales) == 1
    return {k[len("adapt_"):]: op for k, (op, _) in captured.items()}, scales.pop()


@functools.lru_cache(maxsize=None)
def jax_sweep_ops():
    """name -> (JAX SweepOp, scale), the counterparts of port_sweep_ops()."""
    p = SimulationParams()
    visc = dataclasses.replace(p, viscosity=VISC)
    wcsph = dataclasses.replace(visc, viscosity_type=ViscosityType.WCSPH)
    xsph = dataclasses.replace(p, viscosity_type=ViscosityType.XSPH, viscosity=0.0)
    share, s_scale = jax_adapt_ops(p, "share")
    merge, m_scale = jax_adapt_ops(p, "merge")
    return {
        "count": (j_tp.COUNT_OP, EXT_SCALE), "normal": (j_tp.normal_op(p), EXT_SCALE),
        "cone": (j_tp.cone_op(p), EXT_SCALE), "wavefront": (j_tp.wavefront_op(p), EXT_SCALE),
        "smooth": (j_tp.smooth_op(), 2.0), "density": (j_tp.DENSITY_OP, 2.0),
        "adapt_cnt0": (share["cnt0"], s_scale), "adapt_cnt1": (share["cnt1"], s_scale),
        "adapt_claim": (merge["claim"], m_scale), "adapt_partner": (merge["partner"], m_scale),
        "visc_laplace": (j_tp.visc_op(visc), 2.0),
        "visc_wcsph": (j_tp.visc_op(wcsph), 2.0),
        "omega": (j_tp.omega_op(), 2.0),
        "prep_laplace": (j_tp.prep_op(visc), 2.0), "prep_wcsph": (j_tp.prep_op(wcsph), 2.0),
        "prep_xsph": (j_tp.prep_op(xsph), 2.0), "aii_sums": (j_tp.aii_sums_op(), 2.0),
        "accel": (j_tp.accel_op(), 2.0), "div": (j_tp.div_op(False), 2.0),
        "div_w2020": (j_tp.div_op(True), 2.0),
    }


def jax_layout(pos, h, mass, alive, C, tq, mscale):
    """The JAX package's config, layout, sorted statics and window meta."""
    live = h[alive]
    g = j_grid.make_grid_config((-1, -1), (1, 1), mscale, float(live.min()), float(live.max()), C)
    lv = np.clip(np.ceil(np.log2(np.maximum(np.unique(live) * mscale / g.cell0, 1.0))
                         - 1e-6).astype(int), 0, g.levels - 1)
    cfg = j_tiles.TileConfig.from_grid(
        dataclasses.replace(g, populated=tuple(sorted(set(int(x) for x in lv)))), mscale, tq=tq)
    bins = j_tiles.build_tiles(jnp.asarray(pos), jnp.asarray(h * np.float32(mscale)),
                               jnp.asarray(h), jnp.asarray(alive), cfg)
    st = j_tiles.sort_fields(bins, [jnp.asarray(pos), jnp.asarray(h), jnp.asarray(mass)])
    wm = jax.jit(lambda b, s: j_tiles.window_meta(cfg, b, s))(bins, st)
    return cfg, bins, st, wm


def run_both(name, cloud, dyn_seed=5):
    C, tq = 1024, 128
    if cloud == "two":
        pos, h, mass, alive = two_level_cloud(C, N_FINE[C], seed=3)
    else:
        pos, h, mass, alive = multi_level_cloud(C, seed=3)
    cfg, bins, st, wm = jax_layout(pos, h, mass, alive, C, tq, EXT_SCALE)
    tst = torch.from_numpy(np.asarray(st))
    dyn = sweep_dyn(name, tst, dyn_seed)
    jop, scale = jax_sweep_ops()[name]
    top, tscale = port_sweep_ops()[name]
    assert tscale == scale
    want = run_sweep(cfg, bins, st, None if dyn is None else jnp.asarray(dyn), jop, scale,
                     interpret=True, wmeta=wm)
    got = t_sweeps.pair_sweep(torch.from_numpy(np.asarray(bins.cell_starts)),
                              torch.from_numpy(np.asarray(wm)), tst,
                              None if dyn is None else torch.from_numpy(dyn), top, scale, tq)
    live = np.asarray(st[:, 2]) > 0
    return got[torch.from_numpy(live)], torch.from_numpy(np.asarray(want)[live]), top


@pytest.mark.parametrize("cloud", ["two", "multi"])
@pytest.mark.parametrize("name", list(port_sweep_ops()))
def test_sweep_matches_jax(name, cloud):
    got, want, top = run_both(name, cloud)
    assert got.shape == want.shape
    assert_sweep_close(got, want, top, name)
    if top.reduce == "sum":
        assert float(want.abs().max()) > 0, "the op found no pairs"


def test_distance_mask_is_inclusive_at_max_dist():
    # pairs exactly at max_dist * h_ij (along x and along y, the other
    # coordinate equal, so the distance is exactly md) and pairs one float32
    # step beyond: cnt0 counts the first kind only, in both packages
    C, tq = 256, 64
    p = SimulationParams()
    h = np.float32(0.0625)
    md = np.float32(np.float32(p.max_share_distance) * h)
    beyond = np.nextafter(md, np.float32(1.0))
    off = np.float32([-0.9, -0.6, -0.3, 0.3, 0.6, 0.9])
    gap = np.where(np.arange(6) % 2 == 0, md, beyond).astype(np.float32)
    zero = np.zeros(6, np.float32)
    pos = np.zeros((C, 2), np.float32)
    pos[0:24] = np.concatenate([
        np.stack([zero, off], 1), np.stack([gap, off], 1),   # pairs along x
        np.stack([off, zero], 1), np.stack([off, gap], 1)])  # pairs along y
    hh = np.zeros(C, np.float32)
    hh[:24] = h
    mass = np.where(hh > 0, np.float32(1e-3), np.float32(0)).astype(np.float32)
    cfg, bins, st, wm = jax_layout(pos, hh, mass, hh > 0, C, tq, EXT_SCALE)
    live = np.asarray(st[:, 2]) > 0
    # every live particle a donor, every one an eligible (SMALL) receiver
    dyn = np.zeros((C, 5), np.float32)
    dyn[:, 0] = 1.0
    dyn[:, 3] = np.arange(C)
    dyn[:, 4] = live
    jops, scale = jax_adapt_ops(p, "share")
    want = np.asarray(run_sweep(cfg, bins, st, jnp.asarray(dyn), jops["cnt0"], scale,
                                interpret=True, wmeta=wm))[:, 0]
    got = t_sweeps.pair_sweep(torch.from_numpy(np.asarray(bins.cell_starts)),
                              torch.from_numpy(np.asarray(wm)), torch.from_numpy(np.asarray(st)),
                              torch.from_numpy(dyn), port_sweep_ops()["adapt_cnt0"][0], scale,
                              tq)[:, 0].numpy()
    np.testing.assert_array_equal(got, want)
    # the 6 pairs at exactly md count each other; the 6 beyond it count nothing
    assert got[live].sum() == 2 * 6 and got.max() == 1.0
