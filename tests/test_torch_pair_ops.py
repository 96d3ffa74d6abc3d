"""PyTorch port, the step's pair operator (ops/pair_ops.py).

The plain PyTorch twins are held against the JAX package's Pallas kernels
(interpret mode on the CPU): build_weight_cache_prep (mega mode, f32, legacy
[wx|wy] blocks via scalar=False), weight_matvec in both modes and visc_matvec,
on the same sorted inputs over the reference's (capacity, tq) grid. Criterion:
max |port - jax| / max |jax| < 1e-5, as in the reference's own small-shape
differential: only the summation order differs. bf16 storage: 4e-3 of max
(one bf16 half-ulp where an f32 weight differs in its last bit before rounding).
Also the scalar-g storage (K1's scalar mode, K2s, K3s) against the
reference's v7 scalar blocks and their matvecs at tq = 128, and the
weights-only walk against build_weight_cache over the grid.

The kernels themselves are held against the twins in test_torch_kernels.py
(no JAX there, so it also runs on the GPU machine).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sph_torch.ops import pair_ops
from adaptive_sph_torch.ops import tiles as t_tiles
from adaptive_sph_tpu.ops.pallas_matvec import (build_weight_cache, build_weight_cache_prep,
                                                visc_matvec, weight_matvec)
from adaptive_sph_tpu.ops.tiles import to_chunks
from test_torch_tiles import GRID, jax_window_meta, layouts

torch.set_num_threads(2)

SCALE, VISC = 2.0, 0.02


def inputs(C, tq, seed):
    """Both packages' sorted inputs plus seeded velocities and operands."""
    jcfg, tcfg, jb, tb, jst, tst = layouts(C, tq, seed=seed)
    rng = np.random.default_rng(17 + seed)
    live = tst[:, 2].numpy() > 0
    vel = (rng.normal(0, 0.4, (C, 2)) * live[:, None]).astype(np.float32)
    ops = {"u": rng.uniform(0, 10, C), "tx": rng.normal(0, 1, C), "ty": rng.normal(0, 1, C),
           "rho": rng.uniform(0.8, 1.2, C)}
    ops = {k: v.astype(np.float32) for k, v in ops.items()}
    flat = torch.cat([tst, torch.from_numpy(vel)], dim=1).contiguous()
    wm = t_tiles.window_meta(tcfg, tb, tst)
    return jcfg, tcfg, jb, tb, jst, flat, wm, vel, ops


def check(got, want, tol, name):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    s = np.max(np.abs(want)) + 1e-6
    err = np.max(np.abs(got - want)) / s
    assert err < tol, (name, err)


def brute_force_pairs(flat):
    """Pair count of the exact mask, dense, in float32 numpy (r2 as one FMA,
    as XLA's CPU backend rounds the reference's dx * dx + dy * dy)."""
    x, y, h = flat[:, 0], flat[:, 1], flat[:, 2]
    h_ij = np.maximum(np.float32(0.5) * (h[:, None] + h[None, :]), np.float32(1e-6))
    dx = x[:, None] - x[None, :]
    dy = y[:, None] - y[None, :]
    r2 = (dx.astype(np.float64) * dx + (dy * dy)).astype(np.float32)
    rad = np.float32(SCALE) * h_ij
    return int(np.sum((r2 < rad * rad) & (h[None, :] > 0) & (h[:, None] > 0)))


def run_both(C, tq, seed, bf16):
    jcfg, tcfg, jb, tb, jst, flat, wm, vel, ops = inputs(C, tq, seed)
    wdtype_j = jnp.bfloat16 if bf16 else jnp.float32
    wdtype_t = torch.bfloat16 if bf16 else torch.float32
    jwm, _ = jax_window_meta(jcfg, jb, jst)
    wc, vc, meta, cnt, prep = build_weight_cache_prep(
        jcfg, jb, jst, jnp.asarray(vel), SCALE, jcfg.b_max, "laplace", VISC, wmeta=jwm,
        wdtype=wdtype_j, want_s2=False, fuse_density=True, visc_stream=True, scalar=False)
    assert int(cnt[1]) == 0
    csr = pair_ops.pair_build(tb.cell_starts, wm, flat, tq, SCALE, VISC, True, wdtype_t)
    J = {k: jnp.asarray(v) for k, v in ops.items()}
    Tt = {k: torch.from_numpy(v) for k, v in ops.items()}
    out = {"prep": ([csr.prep[k] for k in range(4)],
                    [prep[:, k, :].reshape(C) for k in range(4)])}
    out["accel"] = (pair_ops.pair_matvec(csr, Tt["u"], 2),
                    weight_matvec(wc, meta, cnt, J["u"][:, None], tq, k_out=2))
    out["div"] = ((pair_ops.pair_matvec(csr, (Tt["tx"], Tt["ty"]), 1),),
                  (weight_matvec(wc, meta, cnt, (J["tx"], J["ty"]), tq, k_out=1),))
    out["visc"] = (pair_ops.pair_visc(csr, Tt["rho"]), visc_matvec(vc, meta, cnt, J["rho"], tq))
    return csr, flat, out


@pytest.mark.parametrize("C,tq", GRID)
def test_twins_match_jax_f32(C, tq):
    pair_ops.reset_launches()
    csr, flat, out = run_both(C, tq, seed=13 + C + tq, bf16=False)
    assert csr.num_pairs == brute_force_pairs(flat.numpy())
    rp = csr.row_ptr.numpy()
    assert rp[0] == 0 and np.all(np.diff(rp) >= 0) and rp[-1] == csr.num_pairs
    col = csr.col.numpy()
    for i in range(C):  # ascending candidate slots within each row
        assert np.all(np.diff(col[rp[i]:rp[i + 1]]) > 0)
    for name, (got, want) in out.items():
        for k, (g, w) in enumerate(zip(got, want)):
            check(g, w, 1e-5, (name, k, C, tq))
    # CPU tensors take the twins: no kernel launch is counted
    assert all(v == 0 for v in pair_ops.launches.values())


@pytest.mark.parametrize("C,tq", [(512, 64), (1024, 128), (1024, 16)])
def test_twins_match_jax_bf16_storage(C, tq):
    csr, _, out = run_both(C, tq, seed=5 + C + tq, bf16=True)
    assert csr.w.dtype == torch.bfloat16 and csr.s.dtype == torch.bfloat16
    for name, (got, want) in out.items():
        tol = 1e-5 if name == "prep" else 4e-3  # prep sums stay f32 in both
        for k, (g, w) in enumerate(zip(got, want)):
            check(g, w, tol, (name, k, C, tq))


def run_both_scalar(C, tq, seed, bf16):
    """K1's scalar-g mode, K2s and K3s against the reference's v7 scalar blocks
    (build_weight_cache_prep(scalar=True)) and their matvecs with the statics."""
    jcfg, tcfg, jb, tb, jst, flat, wm, vel, ops = inputs(C, tq, seed)
    jwm, _ = jax_window_meta(jcfg, jb, jst)
    wc, vc, meta, cnt, prep = build_weight_cache_prep(
        jcfg, jb, jst, jnp.asarray(vel), SCALE, jcfg.b_max, "laplace", VISC, wmeta=jwm,
        wdtype=jnp.bfloat16 if bf16 else jnp.float32, want_s2=False, fuse_density=True,
        visc_stream=True, scalar=True)
    assert int(cnt[1]) == 0 and wc.shape[1] == 2 * 64  # scalar blocks: 128-candidate windows
    kw = dict(statics=jst, sq=jnp.swapaxes(to_chunks(jst, tq), 1, 2))
    csr = pair_ops.pair_build(tb.cell_starts, wm, flat, tq, SCALE, VISC, True,
                              torch.bfloat16 if bf16 else torch.float32, scalar=True)
    J = {k: jnp.asarray(v) for k, v in ops.items()}
    Tt = {k: torch.from_numpy(v) for k, v in ops.items()}
    out = {"prep": ([csr.prep[k] for k in range(4)],
                    [prep[:, k, :].reshape(C) for k in range(4)])}
    out["accel"] = (pair_ops.pair_matvec_scalar(csr, Tt["u"], 2),
                    weight_matvec(wc, meta, cnt, J["u"][:, None], tq, k_out=2, **kw))
    out["div"] = ((pair_ops.pair_matvec_scalar(csr, (Tt["tx"], Tt["ty"]), 1),),
                  (weight_matvec(wc, meta, cnt, (J["tx"], J["ty"]), tq, k_out=1, **kw),))
    out["visc"] = (pair_ops.pair_visc_scalar(csr, Tt["rho"]),
                   visc_matvec(vc, meta, cnt, J["rho"], tq, **kw))
    return csr, out


@pytest.mark.parametrize("C,tq", [g for g in GRID if g[1] == 128])
@pytest.mark.parametrize("bf16", [False, True])
def test_scalar_storage_matches_jax(C, tq, bf16):
    csr, out = run_both_scalar(C, tq, seed=41 + C + tq, bf16=bf16)
    assert csr.scalar and csr.g.dtype == (torch.bfloat16 if bf16 else torch.float32)
    for name, (got, want) in out.items():
        tol = 4e-3 if bf16 and name != "prep" else 1e-5  # prep sums stay f32 in both
        for k, (g, w) in enumerate(zip(got, want)):
            check(g, w, tol, (name, k, C, tq, bf16))


@pytest.mark.parametrize("C,tq", GRID)
def test_weights_only_walk_matches_jax(C, tq):
    # the weights-only walk (the reference's build_weight_cache) and K2 on its
    # list; its w is mega mode's w bit for bit
    jcfg, tcfg, jb, tb, jst, flat, wm, vel, ops = inputs(C, tq, seed=53 + C + tq)
    jwm, _ = jax_window_meta(jcfg, jb, jst)
    wc, meta, cnt = build_weight_cache(jcfg, jb, jst, SCALE, jcfg.b_max, wmeta=jwm)
    assert int(cnt[1]) == 0
    wl = pair_ops.pair_weights(tb.cell_starts, wm, flat[:, 0:4].contiguous(), tq, SCALE)
    assert wl.prep is None and wl.num_pairs == brute_force_pairs(flat.numpy())
    mega = pair_ops.pair_build(tb.cell_starts, wm, flat, tq, SCALE, VISC, True)
    assert torch.equal(wl.col, mega.col) and torch.equal(wl.w, mega.w)
    J = {k: jnp.asarray(v) for k, v in ops.items()}
    Tt = {k: torch.from_numpy(v) for k, v in ops.items()}
    for g, w in zip(pair_ops.pair_matvec(wl, Tt["u"], 2),
                    weight_matvec(wc, meta, cnt, J["u"][:, None], tq, k_out=2)):
        check(g, w, 1e-5, ("accel", C, tq))
    check(pair_ops.pair_matvec(wl, (Tt["tx"], Tt["ty"]), 1),
          weight_matvec(wc, meta, cnt, (J["tx"], J["ty"]), tq, k_out=1), 1e-5, ("div", C, tq))


def run_both_classic(C, tq, seed):
    """K1's classic mode (the resident solver's branch) in both packages: the
    candidate table carries rho, the prep has 8 rows (s1, s2 = the same sums
    over w / rho_j, the inline ApproxLaplace viscosity), no viscosity stream."""
    jcfg, tcfg, jb, tb, jst, flat, wm, vel, ops = inputs(C, tq, seed)
    rho = np.random.default_rng(29 + seed).uniform(800.0, 1200.0, C).astype(np.float32)
    jwm, _ = jax_window_meta(jcfg, jb, jst)
    dyn = np.concatenate([rho[:, None], vel], axis=1)
    wc, meta, cnt, prep = build_weight_cache_prep(
        jcfg, jb, jst, jnp.asarray(dyn), SCALE, jcfg.b_max, "laplace", VISC, wmeta=jwm,
        wdtype=jnp.float32, want_s2=True, fuse_density=False, visc_stream=False, scalar=False)
    assert int(cnt[1]) == 0
    cand = torch.cat([flat[:, 0:4], torch.from_numpy(rho)[:, None], flat[:, 4:6]], 1).contiguous()
    csr = pair_ops.pair_build(tb.cell_starts, wm, cand, tq, SCALE, VISC, False, torch.float32,
                              classic=True)
    J = {k: jnp.asarray(v) for k, v in ops.items()}
    Tt = {k: torch.from_numpy(v) for k, v in ops.items()}
    out = {"prep": ([csr.prep[k] for k in range(8)],
                    [prep[:, k, :].reshape(C) for k in range(8)])}
    out["accel"] = (pair_ops.pair_matvec(csr, Tt["u"], 2),
                    weight_matvec(wc, meta, cnt, J["u"][:, None], tq, k_out=2))
    out["div"] = ((pair_ops.pair_matvec(csr, (Tt["tx"], Tt["ty"]), 1),),
                  (weight_matvec(wc, meta, cnt, (J["tx"], J["ty"]), tq, k_out=1),))
    return csr, cand, out


@pytest.mark.parametrize("C,tq", GRID)
def test_classic_mode_matches_jax(C, tq):
    csr, cand, out = run_both_classic(C, tq, seed=31 + C + tq)
    assert csr.s is None and csr.prep.shape == (8, C)
    assert csr.num_pairs == brute_force_pairs(cand[:, [0, 1, 2]].numpy())
    for name, (got, want) in out.items():
        for k, (g, w) in enumerate(zip(got, want)):
            check(g, w, 1e-5, (name, k, C, tq))
    # every row carries signal: s2 and the viscosity rows are not zero
    assert all(float(csr.prep[k].abs().max()) > 0 for k in range(8))


@pytest.mark.parametrize("name", ["cubic_kernel_unnormalized", "cubic_kernel_unnormalized_deriv"])
def test_spline_pieces_round_as_the_reference(name):
    # the spline and its derivative bit for bit the JAX package's, jitted on
    # the CPU (XLA contracts their inner pieces into fused multiply-adds), on
    # 200,000 seeded q in [0, 1.2); K1 and the sweeps build on them
    import jax

    from adaptive_sph_torch.ops import kernels as t_kernels
    from adaptive_sph_tpu.ops import kernels as j_kernels

    q = np.random.default_rng(7).uniform(0.0, 1.2, 200_000).astype(np.float32)
    want = np.asarray(jax.jit(getattr(j_kernels, name))(jnp.asarray(q)))
    got = getattr(t_kernels, name)(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)

