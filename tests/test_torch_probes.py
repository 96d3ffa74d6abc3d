"""PyTorch port, the probe kernels (ops/probes.py) and the probe entry point
(adaptive_sph_torch/probe.py) against the TPU probe scripts' Pallas kernels.

The same numpy-seeded inputs go through each script's kernel in interpret
mode on the CPU and through the port's plain version:

- #10 scripts/proto_pallas.py::kernel (its PrefetchScalarGridSpec rebuilt
  with interpret=True; the script passes none) against block_sweep at E =
  32, NT = 8, NC = 16, every tile given items as the script's qt does, and
  on a skewed list (E = 96, NT = 16: a tile of 48 items, five tiles with
  none, empty and whole-chunk ranges): within 1e-5 of max |JAX| (exp and
  the order of the 64-candidate sums differ), tiles with no item 0.
- #11 scripts/proto_v8.py::_kernel with the script's grid spec, at the
  script's size, against window_sum: equal bit for bit (both add the windows
  one after another in anchor order).
- #12 scripts/matvec_probe.py::dma_variant with its timing loop replaced by
  one eager call and its pallas_call spied on, at the script's (grp, nbuf)
  pairs: the kernel's whole (8, 128) output and pair_stream's are zeros.
  pair_stream's folds (the XOR of the words each block landed) are held
  against numpy on the same bytes.
- #13 scripts/matvec_probe.py::make_kernel at base, divbase, accvpu and
  divvpu on build_weight_cache's blocks of a two-level cloud, against
  pair_matvec_probe_ref("base") on pair_weights_ref of the same sorted
  table: per slot within 1e-5 of max (summation order only).
- #14 scripts/matvec_probe2.py::scalar_matvec at WH = 128 on
  build_weight_cache_prep(..., scalar=True) blocks of the impact scene
  (capacity 1,024, tq = 128), against pair_matvec_scalar_probe_ref at every
  wh: per slot within 1e-5 of max.

Also the ablation twins against dense numpy sums, the wrappers' input
checks, and the entry point's variants run through their plain versions on
the full-width stress lists (the slice as a whole on the CPU; the entry
point itself exits without CUDA).
"""

import dataclasses
import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from adaptive_sph_torch import probe
from adaptive_sph_torch.models.tile_step import physics_scale, step_geometry
from adaptive_sph_torch.ops import pair_ops, probes
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.stress import IMPACT_CAPACITY, IMPACT_SCENE, impact_params, impact_scene
from adaptive_sph_torch.utils.params import PressureSolverMethod as M
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.ops import tiles as j_tiles
from adaptive_sph_tpu.ops.pallas_matvec import build_weight_cache, build_weight_cache_prep
from adaptive_sph_tpu.runner import create_simulation as j_create
from adaptive_sph_tpu.utils import params as j_params
from adaptive_sph_torch import convert
from test_torch_pair_ops import SCALE, inputs
from test_torch_tiles import jax_window_meta

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_script(name):
    """scripts/<name>.py as a module (scripts/ is no package)."""
    spec = importlib.util.spec_from_file_location(f"_probe_script_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-30)


# ---------------------------------------------------------------------------
# #10 block sweep


def skewed_work_list(NT=16, NC=16, E=96, long_items=48, seed=13):
    """(qt, ck, lo, hi) int32, sorted by tile: tile 3 holds long_items items
    (the kernel splits a tile of more than 32 over its block's warps), tiles
    0, 6, 7, 11 and 12 none, and a fifth of the items each have an empty
    column range, the whole chunk, a range past both ends of the chunk, one
    outside it, or a part of it."""
    rng = np.random.default_rng(seed)
    others = [t for t in range(NT) if t not in (0, 3, 6, 7, 11, 12)]
    tiles = np.sort(np.concatenate([np.full(long_items, 3), rng.choice(others, E - long_items)]))
    ck = rng.integers(0, NC, E)
    c0 = ck * 64
    kind = rng.permutation(np.arange(E) % 5)
    lo = c0 + rng.integers(0, 64, E)
    hi = lo + rng.integers(0, 64, E)
    for k, (a, b) in {1: (9, 9), 2: (0, 64), 3: (-100, 200), 4: (64, 128)}.items():
        lo[kind == k], hi[kind == k] = c0[kind == k] + a, c0[kind == k] + b
    return tuple(torch.from_numpy(x.astype(np.int32)) for x in (tiles, ck, lo, hi))


@pytest.mark.parametrize("skewed", [False, True])
def test_block_sweep_matches_jax(skewed):
    # skewed: a long tile, tiles with no item (their JAX output block is never
    # written; the port writes 0) and items with empty or whole-chunk ranges
    mod = load_script("proto_pallas")
    E, NT, NC = (96, 16, 16) if skewed else (32, 8, 16)
    q, c, qt, ck, lo, hi, scale = probe.sweep_inputs(E, NT, C=NC * 64, seed=3, device="cpu")
    if skewed:
        qt, ck, lo, hi = skewed_work_list(NT, NC, E)
    else:
        assert np.array_equal(qt.numpy(), np.repeat(np.arange(NT), E // NT))  # the script's qt
    # the script's channels-first blocks of the same rows
    qtbl = jnp.asarray(q.numpy().reshape(NT, mod.TQ, 4).transpose(0, 2, 1))
    ctbl = jnp.asarray(c.numpy().reshape(NC, mod.WK, 4).transpose(0, 2, 1))
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=5, grid=(E,),
        in_specs=[pl.BlockSpec((1, 4, mod.TQ), lambda b, qt, ck, lo, hi, s: (qt[b], 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec((1, 4, mod.WK), lambda b, qt, ck, lo, hi, s: (ck[b], 0, 0),
                               memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, 8, mod.TQ), lambda b, qt, ck, lo, hi, s: (qt[b], 0, 0),
                               memory_space=pltpu.VMEM))
    f = pl.pallas_call(mod.kernel, grid_spec=grid_spec,
                       out_shape=jax.ShapeDtypeStruct((NT, 8, mod.TQ), jnp.float32),
                       interpret=True)
    J = [jnp.asarray(a.numpy()) for a in (qt, ck, lo, hi)]
    want = np.asarray(f(*J, jnp.full((1,), scale, jnp.float32), qtbl, ctbl))[:, 0, :]
    pair_ops.reset_launches()
    got = probes.block_sweep(q, c, qt, ck, lo, hi, scale)
    have = np.bincount(qt.numpy(), minlength=NT) > 0
    assert got.shape == (NT * 8,) and float(np.abs(want[have]).max()) > 0
    assert rel_err(got.numpy().reshape(NT, 8)[have], want[have]) < 1e-5
    assert not got.numpy().reshape(NT, 8)[~have].any()
    assert have.all() != skewed
    assert pair_ops.launches["block_sweep"] == 0  # CPU tensors take the twin


@pytest.mark.parametrize("kind", ["regular", "skewed", "one tile", "empty"])
def test_tile_item_ptr_is_the_csr_of_the_tile_list(kind):
    # the item ranges the kernel reads: tile t's items [ptr[t], ptr[t + 1])
    NT = 16
    qt = {"regular": lambda: probe.sweep_inputs(40, NT, C=1024, device="cpu")[2],
          "skewed": lambda: skewed_work_list(NT)[0],
          "one tile": lambda: torch.full((50,), 7, dtype=torch.int32),
          "empty": lambda: torch.zeros(0, dtype=torch.int32)}[kind]()
    ptr = probes.tile_item_ptr(qt, NT)
    want = np.concatenate([[0], np.cumsum(np.bincount(qt.numpy(), minlength=NT))])
    assert ptr.dtype == torch.int32
    np.testing.assert_array_equal(ptr.numpy(), want)


def test_block_sweep_twin_against_a_loop():
    # the script's own numpy loop (proto_pallas.py:126-139), with a tile that
    # has no item: the port writes 0 there
    E, NT, NC = 24, 8, 16
    q, c, qt, ck, lo, hi, scale = probe.sweep_inputs(E, NT, C=NC * 64, seed=5, device="cpu")
    qt = torch.where(qt == 2, torch.full_like(qt, 1), qt)  # tile 2 loses its items
    got = probes.block_sweep(q, c, qt, ck, lo, hi, scale).numpy().reshape(NT, 8)
    qn, cn = q.numpy().reshape(NT, 8, 4), c.numpy().reshape(NC, 64, 4)
    want = np.zeros((NT, 8), np.float32)
    for e in range(E):
        t, cb = int(qt[e]), int(ck[e])
        cols = np.arange(cb * 64, cb * 64 + 64)
        m = (cols >= int(lo[e])) & (cols < int(hi[e]))
        for k in range(8):
            dx, dy = qn[t, k, 0] - cn[cb, :, 0], qn[t, k, 1] - cn[cb, :, 1]
            r2 = dx * dx + dy * dy
            h_ij = np.maximum(np.float32(0.5) * (qn[t, k, 2] + cn[cb, :, 2]), np.float32(1e-6))
            v = m & (r2 < (np.float32(scale) * h_ij) ** 2)
            want[t, k] += np.sum(np.where(v, cn[cb, :, 3] * np.exp(-r2 / (h_ij * h_ij)), 0.0))
    assert np.all(got[2] == 0.0)
    assert rel_err(got, want) < 1e-5


@pytest.mark.parametrize("NT,tpb", [(3072, 8), (2048, 8), (1024, 4), (128, 1), (1, 1), (0, 1)])
def test_sweep_tiles_per_block_keeps_a_block_per_sm(NT, tpb):
    # the kernel's grid on an H100 (132 SMs) at the probe's sizes: one warp
    # per tile down to NT = 2,048 (256 blocks), tiles shared by 2-8 warps
    # where fewer tiles would leave an SM without a block
    assert probes.sweep_tiles_per_block(NT, 132) == tpb
    assert probes.SWEEP_WARPS % tpb == 0
    assert tpb == 1 or -(-NT // tpb) >= probes.SWEEP_MIN_BLOCKS_PER_SM * 132


# ---------------------------------------------------------------------------
# #11 window sum


def test_window_sum_matches_jax_bit_for_bit():
    mod = load_script("proto_v8")
    v, anchors = probe.window_inputs(device="cpu")  # the script's size and draw
    C = v.shape[0]
    vp = jnp.concatenate([jnp.asarray(v.numpy()).reshape(C // 128, 128),
                          jnp.zeros((8, 128), jnp.float32)], axis=0)
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1, grid=(1,), in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((256, 1), jnp.float32)])
    call = pl.pallas_call(functools.partial(mod._kernel, nb=anchors.numel()), grid_spec=grid_spec,
                          out_shape=jax.ShapeDtypeStruct((128, 1), jnp.float32), interpret=True)
    want = np.asarray(call(jnp.asarray(anchors.numpy()), vp))[:, 0]
    got = probes.window_sum(v, anchors, 128)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# #12 pair stream


class _SpiedPallas:
    """jax.experimental.pallas with pallas_call recording each call's output."""

    def __init__(self):
        self.outs = []

    def __getattr__(self, name):
        return getattr(pl, name)

    def pallas_call(self, *a, **k):
        f = pl.pallas_call(*a, **k)

        def call(*args):
            out = f(*args)
            self.outs.append(np.asarray(out))
            return out
        return call


@pytest.mark.parametrize("grp,nbuf,bf16", [(8, 4, False), (32, 4, False), (1, 8, False),
                                           (8, 8, False), (8, 4, True)])
def test_pair_stream_zeros_match_jax(monkeypatch, grp, nbuf, bf16):
    mod = load_script("matvec_probe")
    spy = _SpiedPallas()
    monkeypatch.setattr(mod, "pl", spy)
    # one eager evaluation instead of the timing scan, so the spy sees arrays
    monkeypatch.setattr(mod, "scan_time", lambda fn, x, *extra, **kw: (fn(x, *extra), 1e-3)[1])
    rng = np.random.default_rng(grp + nbuf)
    w = rng.normal(0, 1, (96, 64, 128)).astype(np.float32)  # b_max >= (nbuf - 1) grp
    nb = 40
    jw = jnp.asarray(w, jnp.bfloat16 if bf16 else jnp.float32)
    mod.dma_variant("test", jw, jnp.asarray([nb, 0], jnp.int32), jnp.ones((1024, 1), jnp.float32),
                    grp=grp, nbuf=nbuf)
    (want,) = spy.outs
    x = torch.from_numpy(w.reshape(-1))
    x = x.to(torch.bfloat16) if bf16 else x
    n = nb * 64 * 128
    got, nbytes, folds = probes.pair_stream(x, n, grp, nbuf)
    assert want.shape == (8, 128) and not want.any()
    assert got.shape == (8, 128) and not got.any() and got.dtype == torch.float32
    assert nbytes == n * (2 if bf16 else 4)
    np.testing.assert_array_equal(folds.numpy(), numpy_folds(x, n, grp, 1))


def numpy_folds(x, n, grp, grid):
    """stream_folds by a loop over the stages: the XOR of each stage's
    little-endian 32-bit words (zero-padded) into its block, stage s % grid."""
    x = x.reshape(-1)[:n]
    raw = (x.view(torch.int16) if x.dtype == torch.bfloat16 else x).numpy().tobytes()
    stage = grp * 1024
    folds = np.zeros(grid, np.int32)
    for s in range(-(-len(raw) // stage)):
        chunk = raw[s * stage:(s + 1) * stage]
        chunk += bytes(-len(chunk) % 4)
        folds[s % grid] ^= np.bitwise_xor.reduce(np.frombuffer(chunk, "<i4"))
    return folds


@pytest.mark.parametrize("grp,grid,n,bf16", [
    (8, 1, 302818, False), (8, 132, 302818, False), (1, 264, 302818, True),
    (32, 5, 1001, True), (3, 7, 77777, False), (8, 3, 0, False), (1, 4, 3, True),
    (8, 132, 302815, True), (32, 132, 302817, False), (1, 132, 302815, False),
    (8, 132, 5, True), (56, 132, 302815, True)])
def test_stream_folds_twin_against_numpy(grp, grid, n, bf16):
    # the per-block folds the card's pair_stream is held to: ragged tails,
    # more blocks than stages, nothing streamed; at the card's persistent
    # grid (132 blocks, one per SM of an H100) with byte counts that are no
    # multiple of 16: fewer stages than blocks, a ring that turns (grp 1:
    # 1,183 stages), a tail shorter than 16 bytes
    x = torch.from_numpy(np.random.default_rng(n + grid).normal(0, 1, 302818).astype(np.float32))
    x = x.to(torch.bfloat16) if bf16 else x
    got = probes.stream_folds(x, n, grp, grid)
    assert got.dtype == torch.int32 and got.shape == (grid,)
    np.testing.assert_array_equal(got.numpy(), numpy_folds(x, n, grp, grid))
    if n > 1000:
        assert got.any()


# ---------------------------------------------------------------------------
# #13 K2 probe


def run_make_kernel(mod, w, meta, cnt, t, tq, **kw):
    """matvec_probe.run_variant's pallas_call (:222-245), interpreted, whole
    output (NT, 8, tq)."""
    b_max, _, lw = w.shape
    grp, nbuf = 8, 4
    NT = t.shape[0] // tq
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=2, grid=(1,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY), pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        scratch_shapes=[pltpu.VMEM((nbuf, grp, mod.TILE, lw), jnp.float32),
                        pltpu.SemaphoreType.DMA((nbuf,))])
    return np.asarray(pl.pallas_call(
        mod.make_kernel(tq, lw, grp, nbuf, **kw), grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((NT, 8, tq), jnp.float32), interpret=True)(
            cnt, meta, w, t))


@pytest.mark.parametrize("C,tq", [(1024, 128), (512, 64)])
def test_matvec_probe_matches_jax(C, tq):
    mod = load_script("matvec_probe")
    jcfg, tcfg, jb, tb, jst, flat, wm, vel, ops = inputs(C, tq, seed=61 + C + tq)
    jwm, _ = jax_window_meta(jcfg, jb, jst)
    w, meta, cnt = build_weight_cache(jcfg, jb, jst, SCALE, jcfg.b_max, wmeta=jwm)
    assert int(cnt[1]) == 0 and w.shape[0] >= 24  # the DMA prologue's 3 groups of 8
    wl = pair_ops.pair_weights_ref(tb.cell_starts, wm, flat[:, 0:4].contiguous(), tq, SCALE)
    u, tx, ty = (torch.from_numpy(ops[k]) for k in ("u", "tx", "ty"))
    t_acc = jnp.asarray(ops["u"])[:, None]
    t_div = jnp.stack([jnp.asarray(ops["tx"]), jnp.asarray(ops["ty"])], axis=1)
    acc = probes.pair_matvec_probe_ref(wl, u, 2, "base")
    div = probes.pair_matvec_probe_ref(wl, (tx, ty), 1, "base")
    for name, t, kw in (("base", t_acc, {}), ("divbase", t_div, dict(k_in=2, k_out=1)),
                        ("accvpu", t_acc, dict(vpu=True)),
                        ("divvpu", t_div, dict(k_in=2, k_out=1, vpu=True))):
        out = run_make_kernel(mod, w, meta, cnt, t, tq, **kw)
        if "div" in name:
            assert rel_err(div.numpy(), out[:, 0, :].reshape(C)) < 1e-5, name
        else:
            for row in range(2):
                assert rel_err(acc[row].numpy(), out[:, row, :].reshape(C)) < 1e-5, (name, row)


def test_matvec_probe_ablation_twins():
    # nogather: t at the row's own slot; nomul: the weight row sums (dense numpy)
    jcfg, tcfg, jb, tb, jst, flat, wm, vel, ops = inputs(512, 64, seed=7)
    wl = pair_ops.pair_weights_ref(tb.cell_starts, wm, flat[:, 0:4].contiguous(), 64, SCALE)
    rp, col, w = wl.row_ptr.numpy(), wl.col.numpy(), wl.w.numpy().astype(np.float64)
    rows = np.repeat(np.arange(512), np.diff(rp))
    sx = np.bincount(rows, w[0], minlength=512)
    sy = np.bincount(rows, w[1], minlength=512)
    u, tx, ty = (torch.from_numpy(ops[k]) for k in ("u", "tx", "ty"))
    ng = probes.pair_matvec_probe(wl, u, 2, "nogather")
    assert rel_err(ng[0].numpy(), sx * ops["u"]) < 1e-5 and rel_err(ng[1].numpy(), sy * ops["u"]) < 1e-5
    ngd = probes.pair_matvec_probe(wl, (tx, ty), 1, "nogather")
    assert rel_err(ngd.numpy(), sx * ops["tx"] + sy * ops["ty"]) < 1e-5
    nm = probes.pair_matvec_probe(wl, u, 2, "nomul")
    assert rel_err(nm[0].numpy(), sx) < 1e-5 and rel_err(nm[1].numpy(), sy) < 1e-5
    assert rel_err(probes.pair_matvec_probe(wl, (tx, ty), 1, "nomul").numpy(), sx + sy) < 1e-5
    base = probes.pair_matvec_probe(wl, u, 2, "base")
    for g, k2 in zip(base, pair_ops.pair_matvec(wl, u, 2)):
        assert torch.equal(g, k2)
    assert len(np.unique(col)) > 1


# ---------------------------------------------------------------------------
# #14 K2s probe


def impact_layouts():
    """The impact scene's first-step layout in both packages: (port list
    inputs (cell_starts, wm, flat), tq, scale, visc, JAX (cfg, bins, sorted
    statics, window meta))."""
    params = impact_params(M.HybridDFSPH, resident=False)
    ts = t_create(params, impact_scene(), capacity=IMPACT_CAPACITY, device="cpu")
    js = j_create(j_params.params_from_dict(convert.params_to_dict(params)),
                  j_scene.scene_from_dict(IMPACT_SCENE), capacity=IMPACT_CAPACITY,
                  backend="tiles", counters_enabled=False)
    tcfg, jcfg = ts.tile_cfg, js.tile_cfg
    assert tcfg.tq == jcfg.tq == 128 and tcfg.populated == jcfg.populated
    h_eff, bins, cols, wm = step_geometry(ts.state, ts.params, tcfg)
    st = ts.state
    pos, h, mass, alive = (jnp.asarray(a.numpy()) for a in (st.position, h_eff, st.mass, st.alive))
    jb = j_tiles.build_tiles(pos, h * jcfg.mscale, h, alive, jcfg)
    jst = j_tiles.sort_fields(jb, [pos, h, mass])
    flat = cols["flat"].contiguous()
    np.testing.assert_array_equal(np.asarray(jst), flat[:, 0:4].numpy())
    jwm, _ = jax_window_meta(jcfg, jb, jst)
    return ((bins.cell_starts, wm, flat), tcfg.tq, float(physics_scale(params)),
            float(params.viscosity), (jcfg, jb, jst, jwm))


def test_scalar_probe_matches_jax_at_every_wh():
    mod = load_script("matvec_probe2")
    (cs, wm, flat), tq, scale, visc, (jcfg, jb, jst, jwm) = impact_layouts()
    C = flat.shape[0]
    rng = np.random.default_rng(11)
    vel = rng.normal(0, 0.4, (C, 2)).astype(np.float32) * (flat[:, 2:3].numpy() > 0)
    wc, _, meta, cnt, _ = build_weight_cache_prep(
        jcfg, jb, jst, jnp.asarray(vel), scale, jcfg.b_max, "laplace", visc, wmeta=jwm,
        wdtype=jnp.float32, want_s2=False, fuse_density=True, visc_stream=True, scalar=True)
    assert int(cnt[0]) > 0 and int(cnt[1]) == 0 and wc.shape[1:] == (128, 128)
    sq = jnp.swapaxes(jst.reshape(C // tq, tq, -1), 1, 2)
    u, tx, ty = (rng.normal(0, 1, C).astype(np.float32) for _ in range(3))
    ax, ay = mod.scalar_matvec(wc, meta, cnt, jst, sq, jnp.asarray(u)[:, None], tq, 128, "accel")
    dv = mod.scalar_matvec(wc, meta, cnt, jst, sq, (jnp.asarray(tx)[:, None],
                                                    jnp.asarray(ty)[:, None]), tq, 128, "div")
    csr = pair_ops.pair_build(cs, wm, flat, tq, scale, visc, True, torch.float32, scalar=True)
    T = torch.from_numpy
    for wh in probes.WINDOW_HEIGHTS:
        gx, gy = probes.pair_matvec_scalar_probe(csr, T(u), 2, wh)
        assert rel_err(gx.numpy(), ax) < 1e-5 and rel_err(gy.numpy(), ay) < 1e-5, wh
        assert rel_err(probes.pair_matvec_scalar_probe(csr, (T(tx), T(ty)), 1, wh).numpy(),
                       dv) < 1e-5, wh


# ---------------------------------------------------------------------------
# input checks, routing, the entry point


def test_probe_wrappers_reject_bad_inputs():
    q, c, qt, ck, lo, hi, s = probe.sweep_inputs(32, 8, C=1024, device="cpu")
    with pytest.raises(ValueError, match="sorted"):
        probes.block_sweep(q, c, qt.flip(0).contiguous(), ck, lo, hi, s)
    with pytest.raises(ValueError):  # a tile past the table
        probes.block_sweep(q, c, torch.where(qt == 7, 8, qt).int(), ck, lo, hi, s)
    with pytest.raises(ValueError):  # q not a whole number of tiles
        probes.block_sweep(q[:60].contiguous(), c, qt, ck, lo, hi, s)
    v, an = probe.window_inputs(C=1024, n=4, device="cpu")
    last = torch.tensor([1024 - 128], dtype=torch.int32)
    assert probes.window_sum(v, last).shape == (128,)
    for a in (1024 - 127, -8):
        with pytest.raises(ValueError, match="leaves v"):
            probes.window_sum(v, torch.tensor([0, a], dtype=torch.int32))
    x = torch.zeros(1000)
    for n, grp, nbuf in ((1001, 8, 4), (10, 8, 3), (10, 8, 2), (10, 0, 4), (10, 32, 8)):
        with pytest.raises(ValueError):
            probes.pair_stream(x, n, grp, nbuf)
    (cs, wm, flat), _ = _small_list()
    two = pair_ops.pair_build(cs, wm, flat, 64, SCALE, 0.0, False)
    sc = pair_ops.pair_build(cs, wm, flat, 64, SCALE, 0.0, False, scalar=True)
    u = torch.ones(512)
    with pytest.raises(ValueError):
        probes.pair_matvec_probe(two, u, 2, "noslice")
    with pytest.raises(ValueError):
        probes.pair_matvec_probe(sc, u, 2, "base")
    with pytest.raises(ValueError):
        probes.pair_matvec_scalar_probe(sc, u, 2, 48)
    with pytest.raises(ValueError):
        probes.pair_matvec_scalar_probe(two, u, 2, 32)


def _small_list():
    from test_torch_kernels import walk_inputs
    return walk_inputs(512, 64, seed=9)


def test_probe_variants_run_their_plain_versions_at_full_width():
    # every variant of the entry point through its plain version on the
    # stress lists (n = 11,835, 151,409 pairs, bf16 storage): the K2 probe
    # base equals K2, every wh equals K2s, the streams give zeros and their
    # bytes; no kernel launch is counted on the CPU
    d = probe.stress_lists(device="cpu")
    two, sc = d["two"], d["scalar"]
    assert d["n"] == 11835 and two.num_pairs == sc.num_pairs == 151409
    assert two.w.dtype == sc.g.dtype == torch.bfloat16
    k2 = pair_ops.pair_matvec(two, d["u"], 2)
    k2s = pair_ops.pair_matvec_scalar(sc, d["u"], 2)
    pair_ops.reset_launches()
    seen = set()
    for name in probe.DEFAULT:
        for label, fn, count, unit, nbytes, kernel in probe._lines(name, lambda: d, device="cpu"):
            out = fn()
            seen.add(name)
            assert count > 0 and nbytes > 0, label
            if name == "base":
                assert all(torch.equal(a, b) for a, b in zip(out, k2))
            elif name in ("s32", "s64", "s128", "s256"):
                assert all(torch.equal(a, b) for a, b in zip(out, k2s))
            elif name in ("o32", "o64", "o128", "o256", "obase"):
                assert not out[0].any() and not out[1].any()
            elif name in probe.STREAMS:
                assert not out[0].any() and out[1] + 4096 + 4 * out[2].numel() == nbytes
    assert seen == set(probe.DEFAULT)
    assert all(v == 0 for v in pair_ops.launches.values())


def test_probe_names():
    assert probe._names(["s128", "base", "s128"]) == ["s128", "base"]
    assert probe._names([]) == list(probe.DEFAULT)
    with pytest.raises(SystemExit):
        probe._names(["nostore"])  # no counterpart on the card (module docstring)


def test_probe_entry_point_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(SystemExit, match="CUDA"):
        probe.main(["base"])
