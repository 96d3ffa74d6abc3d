"""PyTorch port: the hand-written CUDA kernels against their plain twins.

This file imports no JAX, so it runs on the GPU machine too:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

(tests/conftest.py configures JAX, which that machine does not have). On the
CPU the `cuda`-marked tests skip; the rest check how the wrappers route CPU
tensors and what the twins guarantee (exact pair set, ascending rows).
Tolerances: 1e-5 of max for f32 (summation order only), 4e-3 of max for
entries stored in bf16.
"""

import dataclasses

import numpy as np
import pytest
import torch

from adaptive_sph_torch.ops import grid as t_grid
from adaptive_sph_torch.ops import pair_ops
from adaptive_sph_torch.ops import tiles as t_tiles

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
