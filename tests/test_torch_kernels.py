"""PyTorch port: the hand-written CUDA kernels against their plain twins
(K1-K3 of csrc/pair_ops.cu, pair_sweep of csrc/pair_sweep.cu).

This file imports no JAX, so it runs on the GPU machine too:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

(tests/conftest.py configures JAX, which that machine does not have). On the
CPU the `cuda`-marked tests skip; the rest check how the wrappers route CPU
tensors and what the twins guarantee (exact pair set, ascending rows).
Tolerances: 1e-5 of max for f32 (summation order only), 4e-3 of max for
entries stored in bf16. pair_sweep: counts and maxima exactly equal, sums
within 1e-5 of each column's max |value| (the kernel adds in the plain
version's order without fused multiply-adds, so they agree to the bit in
practice).
"""

import dataclasses

import numpy as np
import pytest
import torch

from adaptive_sph_torch.models import adaptivity as t_adapt
from adaptive_sph_torch.models import tile_physics as t_tp
from adaptive_sph_torch.ops import grid as t_grid
from adaptive_sph_torch.ops import pair_ops, sweeps
from adaptive_sph_torch.ops import tiles as t_tiles
from adaptive_sph_torch.utils.params import SimulationParams

torch.set_num_threads(2)

# the reference's small-shape (capacity, tq) grid
GRID = [(256, 16), (256, 64), (256, 128),
        (512, 16), (512, 64), (512, 128),
        (1024, 16), (1024, 64), (1024, 128)]
N_FINE = {256: 80, 512: 160, 1024: 300, 2048: 700}
SCALE, VISC = 2.0, 0.02


def two_level_cloud(C, n_fine, n_coarse=3, seed=0):
    """Clustered jittered fine particles plus a few coarse ones, scattered
    over the capacity (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((C, 2), np.float32)
    nside = int(np.ceil(np.sqrt(n_fine)))
    ii = np.arange(n_fine)
    pos[:n_fine] = np.stack([-0.9 + (ii % nside) * 0.012, -0.9 + (ii // nside) * 0.012], -1) \
        + rng.normal(0, 0.002, (n_fine, 2))
    pos[n_fine:n_fine + n_coarse] = rng.uniform(0.0, 0.9, (n_coarse, 2))
    h = np.zeros(C, np.float32)
    h[:n_fine] = 0.009
    h[n_fine:n_fine + n_coarse] = 0.35
    mass = np.zeros(C, np.float32)
    mass[:n_fine] = 6e-5
    mass[n_fine:n_fine + n_coarse] = 0.15
    alive = np.zeros(C, bool)
    alive[:n_fine + n_coarse] = True
    perm = rng.permutation(C)
    return pos[perm], h[perm], mass[perm], alive[perm]


def walk_inputs(C, tq, seed, device="cpu"):
    """(cell_starts, wm, flat (C, 6)) of a sorted two-level cloud, plus operands."""
    pos, h, mass, alive = two_level_cloud(C, N_FINE[C], seed=seed)
    g = t_grid.make_grid_config((-1, -1), (1, 1), 2.0, 0.009, 0.35, C)
    cfg = t_tiles.TileConfig.from_grid(dataclasses.replace(g, populated=(0, g.levels - 1)),
                                       2.0, tq=tq)
    T = torch.from_numpy
    bins = t_tiles.build_tiles(T(pos), T(h) * 2.0, T(h), T(alive), cfg)
    rng = np.random.default_rng(17 + seed)
    vel = rng.normal(0, 0.4, (C, 2)).astype(np.float32)
    table = t_tiles.sort_fields(bins, [T(pos), T(h), T(mass), T(vel)])
    wm = t_tiles.window_meta(cfg, bins, table[:, 0:4])
    ops = {"u": rng.uniform(0, 10, C), "tx": rng.normal(0, 1, C), "ty": rng.normal(0, 1, C),
           "rho": rng.uniform(0.8, 1.2, C)}
    ops = {k: T(v.astype(np.float32)).to(device) for k, v in ops.items()}
    return (bins.cell_starts.to(device), wm.to(device), table.contiguous().to(device)), ops


EXT_SCALE = 5.5 / 1.9  # the level-estimation range of the default config


def multi_level_cloud(C, seed=0):
    """Particles of 8 sizes (h = 0.004 * 2^k), fewer of the larger ones,
    scattered over the capacity; ~3/4 of the slots live (numpy, seeded)."""
    rng = np.random.default_rng(seed)
    counts = [int(0.75 * C * 0.5 ** (k + 1)) + 1 for k in range(8)]
    n = sum(counts)
    h = np.concatenate([np.full(c, 0.004 * 2.0 ** k, np.float32) for k, c in enumerate(counts)])
    pos = np.zeros((C, 2), np.float32)
    # the fine half in a block (a surface to detect), the coarse ones scattered
    nf = counts[0]
    side = int(np.ceil(np.sqrt(nf)))
    ii = np.arange(nf)
    pos[:nf] = np.stack([-0.6 + (ii % side) * 0.005, -0.6 + (ii // side) * 0.005], -1) \
        + rng.normal(0, 0.0005, (nf, 2))
    pos[nf:n] = rng.uniform(-0.9, 0.9, (n - nf, 2))
    hh = np.zeros(C, np.float32)
    hh[:n] = h
    mass = np.zeros(C, np.float32)
    mass[:n] = np.pi * (hh[:n] / 1.9) ** 2
    alive = np.zeros(C, bool)
    alive[:n] = True
    perm = rng.permutation(C)
    return pos[perm], hh[perm], mass[perm], alive[perm]


def sweep_inputs(C, tq, cloud, seed):
    """A sorted cloud ("two" or "multi" levels) as (cfg, bins, statics (C, 4)),
    with window ranges at the extended level-estimation range."""
    if cloud == "two":
        pos, h, mass, alive = two_level_cloud(C, N_FINE[C], seed=seed)
    else:
        pos, h, mass, alive = multi_level_cloud(C, seed=seed)
    live = h[alive]
    g = t_grid.make_grid_config((-1, -1), (1, 1), EXT_SCALE, float(live.min()),
                                float(live.max()), C)
    lv = np.clip(np.ceil(np.log2(np.maximum(np.unique(live) * EXT_SCALE / g.cell0, 1.0))
                         - 1e-6).astype(int), 0, g.levels - 1)
    cfg = t_tiles.TileConfig.from_grid(
        dataclasses.replace(g, populated=tuple(sorted(set(int(x) for x in lv)))), EXT_SCALE,
        tq=tq)
    T = torch.from_numpy
    bins = t_tiles.build_tiles(T(pos), T(h) * EXT_SCALE, T(h), T(alive), cfg)
    statics = t_tiles.sort_fields(bins, [T(pos), T(h), T(mass)]).contiguous()
    return cfg, bins, statics


def sweep_dyn(name, statics, seed):
    """Seeded dyn channels (C, D) float32 numpy for sweep op `name`, or None."""
    rng = np.random.default_rng(seed)
    C = statics.shape[0]
    st = statics.numpy()
    if name in ("count", "normal"):
        return None
    if name == "cone":
        ang = rng.uniform(0, 2 * np.pi, C)
        return np.stack([np.cos(ang), np.sin(ang)], 1).astype(np.float32)
    if name == "wavefront":
        return np.stack([-rng.uniform(0, 0.2, C), rng.uniform(size=C) < 0.3], 1).astype(np.float32)
    if name == "smooth":
        return np.stack([rng.uniform(0.8, 1.2, C), -rng.uniform(0, 8, C),
                         st[:, 0] + rng.normal(0, 1e-3, C), st[:, 1] + rng.normal(0, 1e-3, C)],
                        1).astype(np.float32)
    m = st[:, 3]
    cols = [rng.integers(0, 5, C), m * rng.uniform(0.6, 1.6, C), m * rng.uniform(0, 0.6, C),
            rng.permutation(C), rng.uniform(size=C) < 0.4, rng.integers(1, 6, C),
            rng.uniform(size=C) < 0.5]
    width = {"adapt_cnt0": 5, "adapt_cnt1": 6}.get(name, 7)
    return np.stack(cols[:width], 1).astype(np.float32)


def port_sweep_ops():
    """name -> (port SweepOp, scale) for the nine sweeps of the default dam
    break: share rules for the counting passes, merge rules for the claims."""
    p = SimulationParams()
    share, s_scale = t_adapt._adapt_ops(p, "share")
    merge, m_scale = t_adapt._adapt_ops(p, "merge")
    return {
        "count": (t_tp.COUNT_OP, EXT_SCALE), "normal": (t_tp.normal_op(p), EXT_SCALE),
        "cone": (t_tp.CONE_OP, EXT_SCALE), "wavefront": (t_tp.WAVEFRONT_OP, EXT_SCALE),
        "smooth": (t_tp.SMOOTH_OP, 2.0),
        "adapt_cnt0": (share["cnt0"], s_scale), "adapt_cnt1": (share["cnt1"], s_scale),
        "adapt_claim": (merge["claim"], m_scale), "adapt_partner": (merge["partner"], m_scale),
    }


SWEEP_OPS = list(port_sweep_ops())


def assert_sweep_close(got, want, op, name):
    """Counts and maxima exactly; sums within 1e-5 of the column max."""
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    if op.reduce == "max" or op.name in ("count", "adapt_cnt0", "adapt_cnt1"):
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        scale = np.abs(want).max(0, keepdims=True) + 1e-30
        assert np.max(np.abs(got - want) / scale) < 1e-5, name


def rel_err(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()) / (float(want.abs().max()) + 1e-30)


# ---------------------------------------------------------------------------
# CPU: routing and the twins' guarantees


@pytest.mark.parametrize("C,tq", GRID)
def test_cpu_wrappers_run_the_twins(C, tq):
    (cs, wm, flat), ops = walk_inputs(C, tq, seed=C + tq)
    pair_ops.reset_launches()
    csr = pair_ops.pair_build(cs, wm, flat, tq, SCALE, VISC, True)
    ref = pair_ops.pair_build_ref(cs, wm, flat, tq, SCALE, VISC, True)
    for name in ("row_ptr", "col", "w", "s", "prep"):
        assert torch.equal(getattr(csr, name), getattr(ref, name)), name
    # exact pair set: the dense mask in float32 numpy, self pairs included
    f = flat.numpy()
    x, y, h = f[:, 0], f[:, 1], f[:, 2]
    h_ij = np.maximum(np.float32(0.5) * (h[:, None] + h[None, :]), np.float32(1e-6))
    dx, dy = x[:, None] - x[None, :], y[:, None] - y[None, :]
    rad = np.float32(SCALE) * h_ij
    mask = (dx * dx + dy * dy < rad * rad) & (h[None, :] > 0) & (h[:, None] > 0)
    rp = csr.row_ptr.numpy()
    np.testing.assert_array_equal(np.diff(rp), mask.sum(1))
    rows = np.repeat(np.arange(C), np.diff(rp))
    assert mask[rows, csr.col.numpy()].all()
    assert all(np.all(np.diff(csr.col.numpy()[rp[i]:rp[i + 1]]) > 0) for i in range(C))
    assert torch.equal(pair_ops.pair_matvec(csr, ops["u"], 2)[0],
                       pair_ops.pair_matvec_ref(csr, ops["u"], 2)[0])
    assert torch.equal(pair_ops.pair_visc(csr, ops["rho"])[1],
                       pair_ops.pair_visc_ref(csr, ops["rho"])[1])
    assert all(v == 0 for v in pair_ops.launches.values())


def test_build_without_viscosity_and_unsupported_device():
    (cs, wm, flat), _ = walk_inputs(512, 64, 3)
    csr = pair_ops.pair_build(cs, wm, flat, 64, SCALE, 0.0, False)
    assert csr.s is None
    with pytest.raises(ValueError):
        pair_ops.pair_visc(csr, torch.ones(512))
    with pytest.raises(ValueError):
        pair_ops.pair_matvec(csr, torch.ones(512), 3)
    with pytest.raises(RuntimeError):
        pair_ops.pair_build(cs.to("meta"), wm.to("meta"), flat.to("meta"), 64, SCALE, VISC, True)


@pytest.mark.parametrize("cloud", ["two", "multi"])
def test_cpu_pair_sweep_runs_the_plain_walk(cloud):
    # every op routes CPU tensors to the plain walk (no launch), and the walk
    # sees exactly the dense pair set of the radius test
    cfg, bins, st = sweep_inputs(1024, 128, cloud, 3)
    wm = t_tiles.window_meta(cfg, bins, st)
    pair_ops.reset_launches()
    for name, (op, scale) in port_sweep_ops().items():
        d = sweep_dyn(name, st, 5)
        dyn = torch.from_numpy(d) if d is not None else None
        got = sweeps.pair_sweep(bins.cell_starts, wm, st, dyn, op, scale, cfg.tq)
        assert got.shape == (1024, op.n_out)
        assert torch.equal(got, sweeps.pair_sweep_ref(bins.cell_starts, wm, st, dyn, op, scale,
                                                      cfg.tq))
    assert pair_ops.launches["pair_sweep"] == 0
    f = st.numpy()
    x, y, h = f[:, 0], f[:, 1], f[:, 2]
    h_ij = np.maximum(np.float32(0.5) * (h[:, None] + h[None, :]), np.float32(1e-6))
    dx, dy = x[:, None] - x[None, :], y[:, None] - y[None, :]
    rad = np.float32(EXT_SCALE) * h_ij
    dense = ((dx * dx + dy * dy < rad * rad) & (h[None, :] > 0) & (h[:, None] > 0)).sum(1)
    count = sweeps.pair_sweep(bins.cell_starts, wm, st, None, t_tp.COUNT_OP, EXT_SCALE, cfg.tq)
    np.testing.assert_array_equal(count[:, 0].numpy(), dense)


# ---------------------------------------------------------------------------
# GPU: each kernel against its twin on the same CUDA tensors


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("C,tq", [(1024, 128), (1024, 16), (2048, 64)])
@pytest.mark.parametrize("bf16", [False, True])
def test_kernels_match_twins_on_gpu(cuda_device, C, tq, bf16):
    inputs, D = walk_inputs(C, tq, seed=C + tq, device=cuda_device)
    wdtype = torch.bfloat16 if bf16 else torch.float32
    args = (*inputs, tq, SCALE, VISC, True, wdtype)
    pair_ops.reset_launches()
    k = pair_ops.pair_build(*args)
    r = pair_ops.pair_build_ref(*args)
    torch.cuda.synchronize()
    assert pair_ops.launches["pair_build"] == 1
    assert torch.equal(k.row_ptr, r.row_ptr) and torch.equal(k.col, r.col)
    tol = 4e-3 if bf16 else 1e-5
    for a, b in ((k.w, r.w), (k.s, r.s)):
        for row in range(2):
            assert rel_err(a[row], b[row]) < tol
    for row in range(4):
        assert rel_err(k.prep[row], r.prep[row]) < 1e-5
    pairs = ((pair_ops.pair_matvec(k, D["u"], 2), pair_ops.pair_matvec_ref(k, D["u"], 2)),
             ((pair_ops.pair_matvec(k, (D["tx"], D["ty"]), 1),),
              (pair_ops.pair_matvec_ref(k, (D["tx"], D["ty"]), 1),)),
             (pair_ops.pair_visc(k, D["rho"]), pair_ops.pair_visc_ref(k, D["rho"])))
    for got, want in pairs:
        for g, w in zip(got, want):
            assert rel_err(g, w) < 1e-5
    assert pair_ops.launches["pair_matvec"] == 2 and pair_ops.launches["pair_visc"] == 1


@pytest.mark.cuda
def test_wrappers_reject_bad_inputs_on_gpu(cuda_device):
    (cs, wm, flat), _ = walk_inputs(512, 64, 1, device=cuda_device)
    with pytest.raises(ValueError):
        pair_ops.pair_build(cs, wm, flat[:, :5].contiguous(), 64, SCALE, VISC, True)
    with pytest.raises(TypeError):
        pair_ops.pair_build(cs, wm, flat.double(), 64, SCALE, VISC, True)
    k = pair_ops.pair_build(cs, wm, flat, 64, SCALE, VISC, True)
    with pytest.raises(ValueError):
        pair_ops.pair_matvec(k, torch.zeros(511, device=cuda_device), 2)
    # pair storage the kernels cannot read (they take float32 or bfloat16 only)
    k16 = dataclasses.replace(k, w=k.w.half(), s=k.s.half())
    with pytest.raises(TypeError):
        pair_ops.pair_matvec(k16, torch.zeros(512, device=cuda_device), 2)
    with pytest.raises(TypeError):
        pair_ops.pair_visc(k16, torch.ones(512, device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("cloud,C,tq", [("two", 1024, 128), ("multi", 1024, 128),
                                        ("multi", 2048, 64), ("two", 512, 16)])
def test_pair_sweep_matches_plain_on_gpu(cuda_device, cloud, C, tq):
    cfg, bins, st = sweep_inputs(C, tq, cloud, C + tq)
    wm = t_tiles.window_meta(cfg, bins, st)
    cs, wm, st = bins.cell_starts.to(cuda_device), wm.to(cuda_device), st.to(cuda_device)
    ops = port_sweep_ops()
    pair_ops.reset_launches()
    for name, (op, scale) in ops.items():
        d = sweep_dyn(name, st.cpu(), 11)
        dyn = torch.from_numpy(d).to(cuda_device) if d is not None else None
        got = sweeps.pair_sweep(cs, wm, st, dyn, op, scale, tq)
        want = sweeps.pair_sweep_ref(cs, wm, st, dyn, op, scale, tq)
        torch.cuda.synchronize()
        assert_sweep_close(got, want, op, name)
    assert pair_ops.launches["pair_sweep"] == len(ops)


@pytest.mark.cuda
def test_pair_sweep_rejects_bad_inputs_on_gpu(cuda_device):
    cfg, bins, st = sweep_inputs(512, 64, "two", 1)
    wm = t_tiles.window_meta(cfg, bins, st).to(cuda_device)
    cs, st = bins.cell_starts.to(cuda_device), st.to(cuda_device)
    cone, _ = port_sweep_ops()["cone"]
    with pytest.raises(ValueError):  # cone reads two dyn channels
        sweeps.pair_sweep(cs, wm, st, torch.zeros(512, 3, device=cuda_device), cone, 2.0, 64)
    with pytest.raises(ValueError):
        sweeps.pair_sweep(cs, wm, st[:, :3].contiguous(), None, t_tp.COUNT_OP, 2.0, 64)
    with pytest.raises(TypeError):
        sweeps.pair_sweep(cs, wm, st.double(), None, t_tp.COUNT_OP, 2.0, 64)
