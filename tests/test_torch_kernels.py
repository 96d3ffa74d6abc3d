"""PyTorch port: the hand-written CUDA kernels against their plain twins
(K1-K3 of csrc/pair_ops.cu, pair_sweep of csrc/pair_sweep.cu, the whole-solve
kernels pair_jacobi and pair_hybrid of csrc/pair_jacobi.cu, the probe kernels
of csrc/pair_probe.cu and the probe instances of K2 / K2s).

This file imports no JAX, so it runs on the GPU machine too:

    python -m pytest --noconftest tests/test_torch_kernels.py -m cuda

(tests/conftest.py configures JAX, which that machine does not have). On the
CPU the `cuda`-marked tests skip; the rest check how the wrappers route CPU
tensors and what the twins guarantee (exact pair set, ascending rows).
Tolerances: 1e-5 of max for f32 (summation order only), 4e-3 of max for
entries stored in bf16; the whole-solve kernels: equal iteration counts and
1e-5 of max after up to 60 sweeps, on the impact scene's solves and on
synthetic lists (rows of 0-300 pairs; C of 1, 7 and 1,000 rows; the largest
capacity the resident gate admits), a second launch bit-identical. K2, K3,
K2s and K3s also on synthetic lists (rows of 0-300 pairs; C of 1, 7 and
1,000; an all-empty list, exact zeros): within 1e-5 of the largest row sum
of |term| (a long row's terms cancel), a second launch bit-identical. The probes: block_sweep 1e-5 of max,
window_sum and every K2 / K2s probe instance that computes K2's or K2s's
function equal to it bit for bit. pair_sweep: counts and maxima exactly equal, sums
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
from adaptive_sph_torch import probe
from adaptive_sph_torch.ops import jacobi, pair_ops, probes, sweeps
from adaptive_sph_torch.ops import tiles as t_tiles
from adaptive_sph_torch.runner import create_simulation
from adaptive_sph_torch.stress import IMPACT_CAPACITY, impact_params, impact_scene
from adaptive_sph_torch.utils.params import (OperatorDiscretization, PressureSolverMethod,
                                             SimulationParams, SupportLengthEstimation,
                                             ViscosityType)

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


def walk_inputs(C, tq, seed, device="cpu", cloud=None):
    """(cell_starts, wm, flat (C, 6)) of a sorted two-level cloud (or of the
    given (pos, h, mass, alive)), plus operands."""
    pos, h, mass, alive = two_level_cloud(C, N_FINE[C], seed=seed) if cloud is None else cloud
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


def stress_inputs(device="cpu", seed=7):
    """(cell_starts, wm, flat (C, 6)) of the stress scene's first step at
    full width (C = 14,336, tq = 128; the tile holding its coarse particles
    walks the whole scene), with seeded velocities on the live slots, plus
    operands."""
    from adaptive_sph_torch.models.tile_step import step_geometry
    from adaptive_sph_torch.stress import stress_params, stress_scene

    sim = create_simulation(stress_params(), stress_scene(), device=device,
                            counters_enabled=False)
    _, bins, cols, wm = step_geometry(sim.state, sim.params, sim.tile_cfg)
    C = sim.tile_cfg.capacity
    rng = np.random.default_rng(seed)
    flat = cols["flat"].clone()
    live = (flat[:, 2] > 0).float()[:, None]
    flat[:, 4:6] = torch.from_numpy(rng.normal(0, 0.4, (C, 2)).astype(np.float32)).to(
        flat.device) * live
    ops = {"u": rng.uniform(0, 10, C), "tx": rng.normal(0, 1, C), "ty": rng.normal(0, 1, C),
           "rho": rng.uniform(0.8, 1.2, C)}
    ops = {k: torch.from_numpy(v.astype(np.float32)).to(flat.device) for k, v in ops.items()}
    return (bins.cell_starts, wm, flat.contiguous()), ops, sim.tile_cfg.tq


def layout_inputs(layout, C, tq, seed, device="cpu"):
    """((cell_starts, wm, flat), operands, tq) of a walk layout: "cloud" (the
    two-level cloud of walk_inputs), "skewed" (one coarse particle among the
    fine ones: its tile's windows hold every particle) or "stress" (the
    stress scene's first step; C and tq are its own)."""
    if layout == "stress":
        return stress_inputs(device)
    if layout == "skewed":
        pos, h, mass, alive = two_level_cloud(C, N_FINE[C], n_coarse=1, seed=seed)
        inputs, ops = walk_inputs(C, tq, seed, device, cloud=(pos, h, mass, alive))
        return inputs, ops, tq
    inputs, ops = walk_inputs(C, tq, seed, device)
    return inputs, ops, tq


def tile_sequences(cell_starts, wm, NT):
    """Each query tile's candidate slots in walk order: its window ranges,
    level by level, concatenated (numpy, list of NT arrays)."""
    cs = cell_starts.cpu().numpy().astype(np.int64)
    w = wm.cpu().numpy().reshape(NT, -1, t_tiles.WM_STRIDE).astype(np.int64)
    out = []
    for t in range(NT):
        parts = [np.arange(cs[e[1 + 2 * r]], cs[e[2 + 2 * r]]) for e in w[t]
                 for r in range(e[0])]
        out.append(np.concatenate(parts) if parts else np.zeros(0, np.int64))
    return out


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
    """A sorted cloud ("two" or "multi" levels, or "skewed": one coarse
    particle) as (cfg, bins, statics (C, 4)), with window ranges at the
    extended level-estimation range."""
    if cloud == "two":
        pos, h, mass, alive = two_level_cloud(C, N_FINE[C], seed=seed)
    elif cloud == "skewed":
        pos, h, mass, alive = two_level_cloud(C, N_FINE[C], n_coarse=1, seed=seed)
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
    if name in ("count", "normal", "density", "omega"):
        return None
    if name.startswith(("visc", "prep", "div")):  # rho, vx, vy or rho, qx, qy
        return np.stack([rng.uniform(900.0, 1100.0, C), rng.normal(0, 0.4, C),
                         rng.normal(0, 0.4, C)], 1).astype(np.float32)
    if name == "aii_sums":  # rho
        return rng.uniform(900.0, 1100.0, (C, 1)).astype(np.float32)
    if name == "accel":  # rho, p
        return np.stack([rng.uniform(900.0, 1100.0, C), rng.uniform(0.0, 2e3, C)],
                        1).astype(np.float32)
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
    break (share rules for the counting passes, merge rules for the claims),
    the classic branch's DENSITY sweep, the viscosity sweep after the
    divergence solve in both variants (viscosity 0.02), IISPH2's Omega
    sum, and the sweep-only step's sweeps (prep with each viscosity,
    aii_sums, accel, div in both discretizations)."""
    p = SimulationParams()
    visc = dataclasses.replace(p, viscosity=VISC)
    wcsph = dataclasses.replace(visc, viscosity_type=ViscosityType.WCSPH)
    xsph = dataclasses.replace(p, viscosity_type=ViscosityType.XSPH, viscosity=0.0)
    share, s_scale = t_adapt._adapt_ops(p, "share")
    merge, m_scale = t_adapt._adapt_ops(p, "merge")
    return {
        "count": (t_tp.COUNT_OP, EXT_SCALE), "normal": (t_tp.normal_op(p), EXT_SCALE),
        "cone": (t_tp.CONE_OP, EXT_SCALE), "wavefront": (t_tp.WAVEFRONT_OP, EXT_SCALE),
        "smooth": (t_tp.SMOOTH_OP, 2.0), "density": (t_tp.DENSITY_OP, 2.0),
        "adapt_cnt0": (share["cnt0"], s_scale), "adapt_cnt1": (share["cnt1"], s_scale),
        "adapt_claim": (merge["claim"], m_scale), "adapt_partner": (merge["partner"], m_scale),
        "visc_laplace": (t_tp.visc_op(visc), 2.0),
        "visc_wcsph": (t_tp.visc_op(wcsph), 2.0),
        "omega": (t_tp.OMEGA_OP, 2.0),
        "prep_laplace": (t_tp.prep_op(visc), 2.0), "prep_wcsph": (t_tp.prep_op(wcsph), 2.0),
        "prep_xsph": (t_tp.prep_op(xsph), 2.0), "aii_sums": (t_tp.AII_SUMS_OP, 2.0),
        "accel": (t_tp.ACCEL_OP, 2.0), "div": (t_tp.div_op(False), 2.0),
        "div_w2020": (t_tp.div_op(True), 2.0),
    }


SWEEP_OPS = list(port_sweep_ops())


def mode_sweep_ops():
    """name -> (port SweepOp, scale) for the last modes of the sweep: the
    distribution h estimators' sums, the constant field, the range-limited
    cone and wavefront (FromDistribution), CenterDiff's sums, the
    neighbourhood constraint's fringe count and check_aii in both
    discretizations."""
    p = SimulationParams()
    dist = dataclasses.replace(
        p, support_length_estimation=SupportLengthEstimation.FromDistribution)
    return {
        "h_w_sum": (t_tp.H_W_SUM_OP, 2.0), "h_vw_sum": (t_tp.h_vw_sum_op(p), 2.0),
        "constant_field": (t_tp.CONSTANT_FIELD_OP, 2.0),
        "cone_range": (t_tp.cone_op(dist), EXT_SCALE),
        "wavefront_range": (t_tp.wavefront_op(dist), EXT_SCALE),
        "centerdiff": (t_tp.centerdiff_op(p), EXT_SCALE),
        "fringe_count": (t_tp.FRINGE_COUNT_OP, 2.0),
        "check_aii": (t_tp.check_aii_op(False), 2.0),
        "check_aii_w2020": (t_tp.check_aii_op(True), 2.0),
    }


def mode_sweep_dyn(name, statics, seed):
    """Seeded dyn channels (C, D) float32 numpy for mode_sweep_ops()[name],
    or None."""
    rng = np.random.default_rng(seed)
    C = statics.shape[0]
    if name in ("h_w_sum", "h_vw_sum", "centerdiff"):
        return None
    if name == "constant_field":
        return rng.uniform(0.8, 1.2, (C, 1)).astype(np.float32)
    if name in ("cone_range", "wavefront_range"):
        return sweep_dyn(name.split("_")[0], statics, seed)
    if name == "fringe_count":  # thresholds across the fringes 2 r - 2 h_j of the pairs
        h = statics[:, 2].cpu().numpy()
        return (rng.uniform(-2.0, 2.0, (C, 1)) * h[:, None]).astype(np.float32)
    return np.stack([rng.uniform(0.8, 1.2, C), rng.normal(0, 1e3, C), rng.normal(0, 1e3, C)],
                    1).astype(np.float32)  # check_aii: rho, ax, ay


def assert_sweep_close(got, want, op, name):
    """Counts and maxima exactly; sums within 1e-5 of the column max."""
    got, want = got.double().cpu().numpy(), want.double().cpu().numpy()
    if op.reduce == "max" or op.name in ("count", "adapt_cnt0", "adapt_cnt1", "fringe_count"):
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


@pytest.mark.parametrize("C,tq", [(1024, 128), (512, 64)])
def test_cpu_scalar_and_weights_only_twins(C, tq):
    # scalar-g storage: the same pair list with g and B g per pair; K2s equals
    # K2 bit for bit in float32 (the rebuilt wx, wy are K1's stored ones).
    # The weights-only walk gives mega mode's list and w exactly.
    (cs, wm, flat), ops = walk_inputs(C, tq, seed=3 + C + tq)
    pair_ops.reset_launches()
    two = pair_ops.pair_build(cs, wm, flat, tq, SCALE, VISC, True)
    k = pair_ops.pair_build(cs, wm, flat, tq, SCALE, VISC, True, scalar=True)
    assert k.scalar and k.w is None and k.s is None and k.g.shape == (k.num_pairs,)
    assert k.table is flat and torch.equal(k.prep, two.prep)
    assert torch.equal(k.row_ptr, two.row_ptr) and torch.equal(k.col, two.col)
    for got, want in ((pair_ops.pair_matvec_scalar(k, ops["u"], 2),
                       pair_ops.pair_matvec(two, ops["u"], 2)),
                      ((pair_ops.pair_matvec_scalar(k, (ops["tx"], ops["ty"]), 1),),
                       (pair_ops.pair_matvec(two, (ops["tx"], ops["ty"]), 1),))):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    for g, w in zip(pair_ops.pair_visc_scalar(k, ops["rho"]), pair_ops.pair_visc(two, ops["rho"])):
        assert rel_err(g, w) < 1e-5  # (B g) dx, not B (g dx): a rounding apart
    wl = pair_ops.pair_weights(cs, wm, flat[:, 0:4].contiguous(), tq, SCALE)
    assert wl.prep is None and wl.s is None and wl.w.dtype == torch.float32
    for name in ("row_ptr", "col", "w"):
        assert torch.equal(getattr(wl, name), getattr(two, name)), name
    assert all(v == 0 for v in pair_ops.launches.values())


def test_scalar_storage_rejections():
    (cs, wm, flat), _ = walk_inputs(512, 64, 4)
    k = pair_ops.pair_build(cs, wm, flat, 64, SCALE, 0.0, False, scalar=True)
    assert k.sg is None
    two = pair_ops.pair_build(cs, wm, flat, 64, SCALE, VISC, True)
    with pytest.raises(ValueError):  # no two-row weights on a scalar list
        pair_ops.pair_matvec(k, torch.ones(512), 2)
    with pytest.raises(ValueError):
        pair_ops.pair_matvec_scalar(two, torch.ones(512), 2)
    with pytest.raises(ValueError):  # no viscosity factors stored
        pair_ops.pair_visc_scalar(k, torch.ones(512))
    cand = torch.cat([flat[:, 0:4], torch.ones(512, 1), flat[:, 4:6]], 1).contiguous()
    with pytest.raises(ValueError):  # the classic mode stores two rows only
        pair_ops.pair_build(cs, wm, cand, 64, SCALE, VISC, False, classic=True, scalar=True)
    with pytest.raises(ValueError):  # the weights-only walk takes [x, y, h, m]
        pair_ops.pair_weights(cs, wm, flat, 64, SCALE)
    assert pair_ops.scalar_blocks_supported(128) and not pair_ops.scalar_blocks_supported(64)


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


@pytest.mark.parametrize("layout,C,tq,ratio", [("skewed", 2048, 128, 4.0),
                                               ("stress", 14336, 128, 20.0)])
def test_skewed_layouts(layout, C, tq, ratio):
    # the layouts the GPU tests add: one query tile's windows hold many times
    # the candidates of the median tile (the stress scene's coarse tile: the
    # whole scene, 11,835 live particles, against ~440), and its rows are
    # live; the plain twin's rows are the dense mask's, ascending
    (cs, wm, flat), _, tq = layout_inputs(layout, C, tq, seed=C)
    NT = flat.shape[0] // tq
    cand = pair_ops.tile_candidates(cs, wm, NT).numpy()
    top = int(np.argmax(cand))
    assert cand[top] > ratio * np.median(cand)
    assert bool((flat[top * tq:(top + 1) * tq, 2] > 0).any())
    if layout == "stress":
        assert (flat.shape[0], NT, int(cand[top])) == (14336, 112, int((flat[:, 2] > 0).sum()))
        return
    csr = pair_ops.pair_build(cs, wm, flat, tq, SCALE, VISC, True)
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


@pytest.mark.parametrize("layout,C,tq", [("cloud", 1024, 16), ("skewed", 2048, 128),
                                         ("stress", 14336, 128), ("multi", 2048, 64)])
def test_walk_plan_covers_every_candidate_once(layout, C, tq):
    # the kernels' split of long rows (pair_ops.walk_plan mirrors
    # csrc/tile_walk.cuh): every candidate of every tile's sequence lies in
    # exactly one piece, the pieces follow each other in slot order, and
    # only tiles of more than WALK_SPLIT_MIN candidates are split (the
    # stress scene's coarse tile; no row of the extended-range multi-level
    # cloud, the dam break's kind of layout)
    if layout == "multi":
        cfg, bins, st = sweep_inputs(C, tq, "multi", 5)
        cs, wm = bins.cell_starts, t_tiles.window_meta(cfg, bins, st)
    else:
        (cs, wm, st), _, tq = layout_inputs(layout, C, tq, seed=C)
    NT = st.shape[0] // tq
    plan = pair_ops.walk_plan(cs, wm, NT).numpy()
    seqs = tile_sequences(cs, wm, NT)
    split = 0
    for t, seq in enumerate(seqs):
        b = plan[t]
        assert b[0] == 0 and b[-1] == len(seq) and np.all(np.diff(b) >= 0)
        assert np.all(np.diff(seq) > 0)  # the walk order is ascending slot order
        pieces = [seq[b[k]:b[k + 1]] for k in range(pair_ops.WALK_PIECES)]
        assert np.array_equal(np.concatenate(pieces), seq)
        if len(seq) > pair_ops.WALK_SPLIT_MIN:
            split += 1
            assert all(len(p) > 0 for p in pieces)
        else:
            assert len(pieces[0]) == len(seq)
    assert split == {"cloud": 0, "skewed": 0, "stress": 1, "multi": 0}[layout]


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


# the GPU tests' walk layouts: the two-level clouds, a skewed cloud (one
# tile's windows hold every particle) and the stress scene's first step
LAYOUTS = [("cloud", 1024, 128), ("skewed", 2048, 128), ("stress", 14336, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout,C,tq", [("cloud", 1024, 128), ("cloud", 1024, 16),
                                         ("cloud", 2048, 64), *LAYOUTS[1:]])
@pytest.mark.parametrize("bf16", [False, True])
def test_kernels_match_twins_on_gpu(cuda_device, layout, C, tq, bf16):
    inputs, D, tq = layout_inputs(layout, C, tq, seed=C + tq, device=cuda_device)
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
@pytest.mark.parametrize("C,tq", [(1024, 128), (2048, 64)])
@pytest.mark.parametrize("bf16", [False, True])
def test_scalar_kernels_match_plain_on_gpu(cuda_device, C, tq, bf16):
    # K1's scalar-g mode, K2s and K3s against their plain versions; in
    # float32 K2s equals K2 on the two-row list bit for bit
    inputs, D = walk_inputs(C, tq, seed=5 + C + tq, device=cuda_device)
    wdtype = torch.bfloat16 if bf16 else torch.float32
    args = (*inputs, tq, SCALE, VISC, True, wdtype)
    pair_ops.reset_launches()
    k = pair_ops.pair_build(*args, scalar=True)
    r = pair_ops.pair_build_ref(*args, scalar=True)
    torch.cuda.synchronize()
    assert pair_ops.launches["pair_build"] == 1 and k.w is None and k.g.dtype == wdtype
    assert torch.equal(k.row_ptr, r.row_ptr) and torch.equal(k.col, r.col)
    tol = 4e-3 if bf16 else 1e-5
    assert rel_err(k.g, r.g) < tol and rel_err(k.sg, r.sg) < tol
    for row in range(4):
        assert rel_err(k.prep[row], r.prep[row]) < 1e-5
    pairs = ((pair_ops.pair_matvec_scalar(k, D["u"], 2), pair_ops.pair_matvec_scalar_ref(k, D["u"], 2)),
             ((pair_ops.pair_matvec_scalar(k, (D["tx"], D["ty"]), 1),),
              (pair_ops.pair_matvec_scalar_ref(k, (D["tx"], D["ty"]), 1),)),
             (pair_ops.pair_visc_scalar(k, D["rho"]), pair_ops.pair_visc_scalar_ref(k, D["rho"])))
    for got, want in pairs:
        for g, w in zip(got, want):
            assert rel_err(g, w) < 1e-5
    assert pair_ops.launches["pair_matvec_scalar"] == 2
    assert pair_ops.launches["pair_visc_scalar"] == 1
    if not bf16:
        two = pair_ops.pair_build(*args)
        assert torch.equal(pair_ops.pair_matvec_scalar(k, D["u"], 2)[1],
                           pair_ops.pair_matvec(two, D["u"], 2)[1])
        assert torch.equal(pair_ops.pair_matvec_scalar(k, (D["tx"], D["ty"]), 1),
                           pair_ops.pair_matvec(two, (D["tx"], D["ty"]), 1))


@pytest.mark.cuda
@pytest.mark.parametrize("layout,C,tq", [("cloud", 1024, 128), ("cloud", 2048, 64),
                                         *LAYOUTS[1:]])
def test_weights_only_walk_matches_plain_on_gpu(cuda_device, layout, C, tq):
    (cs, wm, flat), _, tq = layout_inputs(layout, C, tq, seed=7 + C + tq, device=cuda_device)
    st = flat[:, 0:4].contiguous()
    pair_ops.reset_launches()
    k = pair_ops.pair_weights(cs, wm, st, tq, SCALE)
    r = pair_ops.pair_weights_ref(cs, wm, st, tq, SCALE)
    mega = pair_ops.pair_build(cs, wm, flat, tq, SCALE, VISC, True)
    torch.cuda.synchronize()
    assert pair_ops.launches["pair_weights"] == 1 and pair_ops.launches["pair_build"] == 1
    assert torch.equal(k.row_ptr, r.row_ptr) and torch.equal(k.col, r.col)
    assert rel_err(k.w, r.w) < 1e-5 and k.prep is None
    for name in ("row_ptr", "col", "w"):  # mega mode's list, bit for bit
        assert torch.equal(getattr(k, name), getattr(mega, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("cloud,C,tq", [("two", 1024, 128), ("multi", 1024, 128),
                                        ("multi", 2048, 64), ("two", 512, 16),
                                        ("skewed", 2048, 128), ("stress", 14336, 128)])
def test_pair_sweep_matches_plain_on_gpu(cuda_device, cloud, C, tq):
    if cloud == "stress":  # its own windows, at the physics range
        (cs, wm, flat), _, tq = stress_inputs(cuda_device)
        st = flat[:, 0:4].contiguous()
    else:
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
@pytest.mark.parametrize("cloud,C,tq", [("two", 1024, 128), ("multi", 1024, 128),
                                        ("multi", 2048, 64), ("skewed", 2048, 128),
                                        ("stress", 14336, 128)])
def test_mode_sweeps_match_plain_on_gpu(cuda_device, cloud, C, tq):
    # the last modes of the sweep, each launch counted under its mode key
    if cloud == "stress":
        (cs, wm, flat), _, tq = stress_inputs(cuda_device)
        st = flat[:, 0:4].contiguous()
    else:
        cfg, bins, st = sweep_inputs(C, tq, cloud, C + tq)
        wm = t_tiles.window_meta(cfg, bins, st)
        cs, wm, st = bins.cell_starts.to(cuda_device), wm.to(cuda_device), st.to(cuda_device)
    ops = mode_sweep_ops()
    pair_ops.reset_launches()
    for name, (op, scale) in ops.items():
        d = mode_sweep_dyn(name, st.cpu(), 11)
        dyn = torch.from_numpy(d).to(cuda_device) if d is not None else None
        got = sweeps.pair_sweep(cs, wm, st, dyn, op, scale, tq)
        want = sweeps.pair_sweep_ref(cs, wm, st, dyn, op, scale, tq)
        torch.cuda.synchronize()
        assert_sweep_close(got, want, op, name)
        assert pair_ops.launches["pair_sweep:" + name] == 1, name
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


@pytest.mark.cuda
@pytest.mark.parametrize("layout,C,tq", [("cloud", 1024, 128), ("cloud", 2048, 64),
                                         *LAYOUTS[1:]])
def test_classic_build_matches_twin_on_gpu(cuda_device, layout, C, tq):
    (cs, wm, flat), D, tq = layout_inputs(layout, C, tq, seed=C + tq, device=cuda_device)
    cand = torch.cat([flat[:, 0:4], D["rho"][:, None] * 1000.0, flat[:, 4:6]], 1).contiguous()
    args = (cs, wm, cand, tq, SCALE, VISC, False, torch.float32)
    pair_ops.reset_launches()
    k = pair_ops.pair_build(*args, classic=True)
    r = pair_ops.pair_build_ref(*args, classic=True)
    torch.cuda.synchronize()
    assert pair_ops.launches["pair_build"] == 1 and k.s is None
    assert torch.equal(k.row_ptr, r.row_ptr) and torch.equal(k.col, r.col)
    assert rel_err(k.w, r.w) < 1e-5
    for row in range(8):
        assert rel_err(k.prep[row], r.prep[row]) < 1e-5, row


@pytest.mark.cuda
@pytest.mark.parametrize("layout,C,tq", [("cloud", 1024, 128), ("cloud", 2048, 64),
                                         *LAYOUTS[1:]])
@pytest.mark.parametrize("mode", ["mega", "scalar", "classic"])
@pytest.mark.parametrize("bf16", [False, True])
def test_wcsph_build_matches_twin_on_gpu(cuda_device, layout, C, tq, mode, bf16):
    # K1 with the WCSPH viscosity: the mega walk's stream factors (two rows,
    # or B g on scalar-g storage) and the classic walk's inline rows; the
    # pair structure bit for bit, values within 1e-5 (4e-3 stored in bf16)
    (cs, wm, flat), D, tq = layout_inputs(layout, C, tq, seed=C + tq, device=cuda_device)
    wdtype = torch.bfloat16 if bf16 else torch.float32
    if mode == "classic":
        flat = torch.cat([flat[:, 0:4], D["rho"][:, None] * 1000.0, flat[:, 4:6]], 1).contiguous()
    if mode == "scalar" and tq != 128:
        pytest.skip("scalar-g storage exists at tq = 128 only")
    kw = dict(classic=mode == "classic", scalar=mode == "scalar", wcsph=True)
    args = (cs, wm, flat, tq, SCALE, VISC, mode != "classic", wdtype)
    pair_ops.reset_launches()
    k = pair_ops.pair_build(*args, **kw)
    r = pair_ops.pair_build_ref(*args, **kw)
    torch.cuda.synchronize()
    assert pair_ops.launches["pair_build"] == 1
    assert torch.equal(k.row_ptr, r.row_ptr) and torch.equal(k.col, r.col)
    tol = 4e-3 if bf16 else 1e-5
    stored = {"mega": ("w", "s"), "scalar": ("g", "sg"), "classic": ("w",)}[mode]
    for name in stored:
        assert rel_err(getattr(k, name), getattr(r, name)) < tol, name
    assert float(getattr(r, stored[-1]).float().abs().max()) > 0
    for row in range(k.prep.shape[0]):
        assert rel_err(k.prep[row], r.prep[row]) < 1e-5, row
    if mode == "mega":  # K3 over the WCSPH factors
        got, want = pair_ops.pair_visc(k, D["rho"]), pair_ops.pair_visc_ref(k, D["rho"])
        for g, w in zip(got, want):
            assert rel_err(g, w) < 1e-5


def capture_whole_solve(method, step, device, **params):
    """(wrapper name, args, kwargs) of the whole-solve call on the impact
    scene's `step`-th step (1-based), run on `device`."""
    sim = create_simulation(impact_params(method, **params), impact_scene(),
                            capacity=IMPACT_CAPACITY, device=device, counters_enabled=False)
    for _ in range(step - 1):
        sim.step()
    seen = []
    real = {n: getattr(jacobi, n) for n in ("jacobi_solve", "hybrid_solve")}

    def spy(name):
        def f(*a, **k):
            seen.append((name, a, k))
            return real[name](*a, **k)
        return f

    try:
        for n in real:
            setattr(jacobi, n, spy(n))
        sim.step()
    finally:
        for n, f in real.items():
            setattr(jacobi, n, f)
    assert len(seen) == 1
    return seen[0]


def assert_whole_solve_matches_plain(name, a, kw):
    """Launch the kernel once and its plain version on the same inputs:
    iteration counts and row counts equal, outputs within 1e-5 of their max,
    a second launch bit-identical. Returns the iteration counts."""
    pair_ops.reset_launches()
    m, stats = getattr(jacobi, name)(*a, **kw)
    m_ref, stats_ref = getattr(jacobi, name + "_ref")(*a, **kw)
    torch.cuda.synchronize()
    kernel = "pair_hybrid" if name == "hybrid_solve" else "pair_jacobi"
    assert pair_ops.launches[kernel] == 1
    offs = (0, 8) if name == "hybrid_solve" else (0,)
    got_iters = [int(stats[o + jacobi.S_ITERS]) for o in offs]
    assert got_iters == [int(stats_ref[o + jacobi.S_ITERS]) for o in offs]
    for o in offs:
        for k in (jacobi.S_NORMAL, jacobi.S_NEG):
            assert float(stats[o + k]) == float(stats_ref[o + k])
    rows = [jacobi.M_P, jacobi.M_AX, jacobi.M_AY, jacobi.M_PERR, jacobi.M_SRC]
    if kw.get("w2020"):
        rows += [jacobi.M_TX, jacobi.M_TY]
    if name == "hybrid_solve":
        rows += [jacobi.M_VX, jacobi.M_VY, jacobi.M_PDIV]
    for row in rows:
        assert rel_err(m[row], m_ref[row]) < 1e-5, row
    # the same launch again gives the same bits: no atomics in the exit test
    # (avg is NaN where no row is normal)
    m2, stats2 = getattr(jacobi, name)(*a, **kw)
    torch.testing.assert_close(m2, m, rtol=0, atol=0, equal_nan=True)
    torch.testing.assert_close(stats2, stats, rtol=0, atol=0, equal_nan=True)
    return got_iters


W2020 = dict(operator_discretization=OperatorDiscretization.Winchenbach2020)


@pytest.mark.cuda
@pytest.mark.parametrize("method,step,iters,params", [
    (PressureSolverMethod.HybridDFSPH, 4, 60, {}), (PressureSolverMethod.OnlyDivergence, 4, 60, {}),
    (PressureSolverMethod.IISPH, 5, 23, {}),
    (PressureSolverMethod.HybridDFSPH, 4, 54, W2020), (PressureSolverMethod.IISPH, 5, 24, W2020),
    (PressureSolverMethod.IISPH2, 5, 31, dict(viscosity_type=ViscosityType.WCSPH,
                                              viscosity=0.003))])
def test_whole_solve_kernels_match_plain_on_gpu(cuda_device, method, step, iters, params):
    # the impact scene's iterating solves, the Winchenbach2020 mode's among
    # them (pair_hybrid, pair_jacobi with the source in the kernel) and
    # IISPH2's 1 / Omega source
    name, a, kw = capture_whole_solve(method, step, cuda_device, **params)
    assert kw.get("w2020", False) == bool(params.get("operator_discretization"))
    assert iters in assert_whole_solve_matches_plain(name, a, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("method,step", [
    (PressureSolverMethod.HybridDFSPH, 4), (PressureSolverMethod.IISPH, 5)])
def test_whole_solve_bf16_kernels_match_plain_on_gpu(cuda_device, method, step):
    # the bf16-weight instances: kernel and plain read the same stored bf16
    # entries and sum in float32, so the f32 tolerance holds
    name, a, kw = capture_whole_solve(method, step, cuda_device, weight_cache_bf16=True)
    assert a[0].w.dtype == torch.bfloat16
    assert max(assert_whole_solve_matches_plain(name, a, kw)) > 2


@pytest.mark.cuda
def test_whole_solve_wrappers_reject_bad_inputs_on_gpu(cuda_device):
    name, a, kw = capture_whole_solve(PressureSolverMethod.IISPH, 2, cuda_device)
    csr, table, scal = a
    with pytest.raises(ValueError):
        jacobi.jacobi_solve(csr, table[:-1].contiguous(), scal, **kw)
    with pytest.raises(TypeError):
        jacobi.jacobi_solve(csr, table.double(), scal, **kw)
    with pytest.raises(ValueError):
        jacobi.jacobi_solve(csr, table, scal.cpu(), **kw)


# row lengths of the synthetic whole-solve lists, repeated over the rows:
# empty rows, one pair, the stress scene's longest row (13) and rows longer
# than a row's segment of lanes (40, 300), among rows of the stress scene's
# typical 9-12 pairs
LONG_ROWS = (0, 1, 13, 40, 300, 9, 11, 12, 10, 13)
SOLVE_CAP = 20  # sweeps of the synthetic solves (their tolerances are 0)
# the whole-solve variants: (wrapper, its keyword arguments)
SOLVE_KINDS = {
    "jacobi_density_src_from_div": ("jacobi_solve", dict(density_type=True, write_perr=True,
                                                         src_from_div=True)),
    "jacobi_divergence": ("jacobi_solve", dict(density_type=False, write_perr=False,
                                               src_from_div=False)),
    "hybrid_den_with_div": ("hybrid_solve", dict(den_with_div=True)),
    "hybrid_only_density": ("hybrid_solve", dict(den_with_div=False)),
    # the Winchenbach2020 divergence, with the mirrored boundary pressure
    "jacobi_density_src_from_div_w2020": ("jacobi_solve", dict(
        density_type=True, write_perr=True, src_from_div=True, w2020=True, mp=1e-6)),
    "hybrid_den_with_div_w2020": ("hybrid_solve", dict(den_with_div=True, w2020=True, mp=1e-6)),
}


def gate_capacity(wdtype, tq=128):
    """The largest capacity (a multiple of tq) that `resident_supported`
    admits at tq."""
    C = tq
    while jacobi.resident_supported(C + tq, tq, wdtype):
        C += tq
    return C


def synthetic_solve(kind, lengths, seed, wdtype, device):
    name, kw = SOLVE_KINDS[kind]
    csr, table, scal = jacobi.synthetic_inputs(lengths, seed, wdtype, device,
                                               hybrid=name == "hybrid_solve")
    return name, (csr, table, scal), dict({"mp": 0.0, **kw}, max_iters=SOLVE_CAP)


@pytest.mark.parametrize("C,sms", [(1, 132), (7, 132), (131, 132), (133, 132), (1000, 132),
                                   (14336, 132), (54272, 132), (89600, 132), (92416, 132),
                                   (14336, 114)])
def test_solve_row_ranges_cover_every_row_once(C, sms):
    # the blocks' row ranges tile [0, C) in order, every block owns at least
    # one row and at most the rows its shared memory holds
    grid = jacobi.solve_grid(C, sms)
    assert grid == min(sms * jacobi.SOLVE_BLOCKS_PER_SM, C)
    r = jacobi.row_ranges(C, grid)
    assert len(r) == grid + 1 and r[0] == 0 and r[-1] == C
    sizes = np.diff(r)
    assert (sizes >= 1).all() and sizes.max() <= -(-C // grid)
    assert sizes.max() - sizes.min() <= 1


@pytest.mark.parametrize("wdtype,capacity", [(torch.float32, 89600), (torch.bfloat16, 92416)])
def test_solve_shared_memory_fits_at_the_gates_largest_capacity(wdtype, capacity):
    # the largest capacity the reference's gate admits (tq 128) over the
    # H100's 132 SMs needs less than the 227 KB a block may take
    assert gate_capacity(wdtype) == capacity
    grid = jacobi.solve_grid(capacity, 132)
    rows = -(-capacity // grid)
    for w2020, cols in ((False, jacobi.SOLVE_COLS), (True, jacobi.SOLVE_COLS_W2020)):
        need = jacobi.solve_smem_bytes(capacity, grid, w2020)
        assert need % 16 == 0 and need >= 4 * (cols + 1) * rows
        assert need <= 227 * 1024
    # the default instances keep no S2 columns
    assert jacobi.solve_smem_bytes(capacity, grid) < jacobi.solve_smem_bytes(capacity, grid, True)


def test_synthetic_solve_inputs():
    # the synthetic lists the GPU tests and chip_smoke.py hold the kernels on:
    # the asked row lengths, in-range columns, |sum_j w_ij| <= 0.5, the same
    # from the same seed; on CPU tensors the wrappers run the plain versions
    lengths = np.resize(LONG_ROWS, 97)
    csr, table, scal = jacobi.synthetic_inputs(lengths, 5, torch.bfloat16)
    assert np.array_equal(np.diff(csr.row_ptr.numpy()), lengths)
    assert csr.w.dtype == torch.bfloat16 and csr.w.shape == (2, lengths.sum())
    assert int(csr.col.min()) >= 0 and int(csr.col.max()) < 97
    assert table.shape == (jacobi.T_ROWS, 97) and float(scal[1]) == 0.0
    rows = np.repeat(np.arange(97), lengths)
    for k in range(2):
        sums = np.bincount(rows, np.abs(csr.w[k].float().numpy()), minlength=97)
        assert sums.max() <= 0.5 + 1e-3
    again = jacobi.synthetic_inputs(lengths, 5, torch.bfloat16)
    assert torch.equal(again[0].col, csr.col) and torch.equal(again[1], table)
    name, a, kw = synthetic_solve("hybrid_den_with_div", lengths, 5, torch.float32, "cpu")
    pair_ops.reset_launches()
    m, stats = jacobi.hybrid_solve(*a, **kw)
    assert pair_ops.launches["pair_hybrid"] == 0
    assert int(stats[jacobi.S_ITERS]) == int(stats[8 + jacobi.S_ITERS]) == SOLVE_CAP
    assert bool(torch.isfinite(m).all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(SOLVE_KINDS))
@pytest.mark.parametrize("C,bf16", [(1000, False), (1000, True), (1, False), (7, False)])
def test_whole_solve_kernels_match_plain_on_long_rows_on_gpu(cuda_device, kind, C, bf16):
    # rows of 0-300 pairs, C not a multiple of a block's rows (1,000 over
    # 132 blocks) and C below the grid (1 and 7 rows: one block per row)
    wdtype = torch.bfloat16 if bf16 else torch.float32
    name, a, kw = synthetic_solve(kind, np.resize(LONG_ROWS, C), C, wdtype, cuda_device)
    its = assert_whole_solve_matches_plain(name, a, kw)
    assert its == [SOLVE_CAP] * len(its)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(SOLVE_KINDS))
@pytest.mark.parametrize("wdtype", [torch.float32, torch.bfloat16])
def test_whole_solve_kernels_match_plain_at_the_gates_capacity_on_gpu(cuda_device, kind, wdtype):
    # the largest capacity the resident gate admits (89,600 rows in f32,
    # 92,416 in bf16), rows of 8-13 pairs, capped at SOLVE_CAP sweeps
    C = gate_capacity(wdtype)
    lengths = np.random.default_rng(C).integers(8, 14, C)
    name, a, kw = synthetic_solve(kind, lengths, C, wdtype, cuda_device)
    its = assert_whole_solve_matches_plain(name, a, kw)
    assert its == [SOLVE_CAP] * len(its)
    sms, _ = jacobi.solve_device(a[1].device)
    _, stats = getattr(jacobi, name)(*a, **kw)
    assert int(stats[jacobi.S_GRID]) == jacobi.solve_grid(C, sms)


@pytest.mark.cuda
def test_whole_solve_refuses_a_launch_beyond_the_shared_memory_limit(cuda_device, monkeypatch):
    # a device that gives a block less shared memory than the launch needs:
    # the wrapper raises and launches nothing (no fallback to the plain version)
    name, a, kw = synthetic_solve("jacobi_divergence", np.resize(LONG_ROWS, 1000), 3,
                                  torch.float32, cuda_device)
    sms, _ = jacobi.solve_device(a[1].device)
    idx = a[1].device.index if a[1].device.index is not None else torch.cuda.current_device()
    monkeypatch.setitem(jacobi._devices, idx, (sms, 512))
    pair_ops.reset_launches()
    with pytest.raises(RuntimeError, match="shared memory"):
        jacobi.jacobi_solve(*a, **kw)
    assert pair_ops.launches["pair_jacobi"] == 0


# row lengths of the synthetic lists for K2 / K3 / K2s / K3s, repeated over
# the rows: a row of 300 pairs first (C = 1 holds it alone), empty rows, a
# row shorter than a segment of lanes (1, 3), the stress scene's longest row
# (13), the dam break's (23), rows longer than a segment's lanes times its
# pairs in flight (40, 300) and typical rows of 11-13 pairs
STREAM_ROWS = (300, 0, 1, 3, 13, 23, 40, 12, 13, 11)


@pytest.mark.parametrize("C", [1, 7, 1024, 14336, 54272])
@pytest.mark.parametrize("sms", [132, 114])
def test_stream_row_groups_cover_every_row_once(C, sms):
    # K2 / K3: the small-list shape while one wave of it covers the list,
    # else the large-list one; at most one wave of blocks, each walking its
    # row groups in order; together the groups tile [0, C) once, in order
    shape, grid = pair_ops.stream_launch(C, sms)
    G0, threads0, bps0 = pair_ops.STREAM_SHAPES[0]
    assert (shape == 0) == (-(-C // (threads0 // G0)) <= sms * bps0)
    G, threads, bps = pair_ops.STREAM_SHAPES[shape]
    assert threads % 32 == 0 and 32 % G == 0
    rows = threads // G
    assert grid == max(1, min(-(-C // rows), sms * bps))
    walks = pair_ops.stream_row_groups(C, shape, grid)
    assert len(walks) == grid and all(walks)
    for walk in walks:
        assert all(a[1] <= b[0] for a, b in zip(walk, walk[1:]))
    ranges = sorted(r for walk in walks for r in walk)
    assert ranges[0][0] == 0 and ranges[-1][1] == C
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert all(0 < hi - lo <= rows for lo, hi in ranges)
    if sms == 132:  # the stress scene's x1 list takes the small-list shape, x4's the large one
        assert shape == (1 if C == 54272 else 0)


def stream_operands(C, seed, device):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.normal(0, 1, C).astype(np.float32)).to(device)
            for k in ("u", "tx", "ty")}


def stream_calls(two, sc, rho, D, ref):
    """{name: outputs} of K2 accel / div, K3, K2s accel / div and K3s (ref:
    their plain versions)."""
    f = {name: getattr(pair_ops, name + ("_ref" if ref else ""))
         for name in ("pair_matvec", "pair_visc", "pair_matvec_scalar", "pair_visc_scalar")}
    return {
        "K2 accel": f["pair_matvec"](two, D["u"], 2),
        "K2 div": (f["pair_matvec"](two, (D["tx"], D["ty"]), 1),),
        "K3": f["pair_visc"](two, rho),
        "K2s accel": f["pair_matvec_scalar"](sc, D["u"], 2),
        "K2s div": (f["pair_matvec_scalar"](sc, (D["tx"], D["ty"]), 1),),
        "K3s": f["pair_visc_scalar"](sc, rho),
    }


def test_synthetic_stream_inputs():
    # the synthetic lists of the K2 / K3 tests: the asked row lengths, the
    # scalar list on the same structure; CPU tensors run the plain versions
    lengths = np.resize(STREAM_ROWS, 23)
    two, sc, rho = jacobi.synthetic_streams(lengths, 3, torch.bfloat16)
    assert np.array_equal(np.diff(two.row_ptr.numpy()), lengths)
    assert torch.equal(two.s, two.w.flip(0)) and two.w.dtype == torch.bfloat16
    assert sc.scalar and torch.equal(sc.g, two.w[0]) and torch.equal(sc.sg, two.w[1])
    assert sc.table.shape == (23, 2) and rho.shape == (23,) and float(rho.min()) >= 900.0
    pair_ops.reset_launches()
    out = stream_calls(two, sc, rho, stream_operands(23, 3, "cpu"), ref=False)
    want = stream_calls(two, sc, rho, stream_operands(23, 3, "cpu"), ref=True)
    assert not any(pair_ops.launches.values())
    D = stream_operands(23, 3, "cpu")
    for name in out:
        scale = stream_scale(name, two, sc, rho, D)
        for g, w in zip(out[name], want[name]):
            assert torch.equal(g, w), name
            assert bool((g[lengths == 0] == 0).all()), name
            assert 0.0 < float(w.abs().max()) <= scale * (1 + 1e-6), name


def stream_scale(name, two, sc, rho, D):
    """The largest sum over a row of |term| of output `name` (stream_calls):
    what the order of its float32 sum can change is 1e-5 of it at most."""
    sc_ = jacobi.stream_scales(sc if name.startswith(("K2s", "K3s")) else two, D["u"], D["tx"],
                               D["ty"], rho)
    return sc_["visc" if name.startswith("K3") else name.split()[1]]


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 7, 1000])
@pytest.mark.parametrize("bf16", [False, True])
def test_stream_kernels_match_plain_on_long_rows_on_gpu(cuda_device, C, bf16):
    # K2, K3, K2s and K3s on rows of 0-300 pairs, with C below a block's rows
    # and not a multiple of them: within 1e-5 of the largest row sum of
    # |term| (the plain versions read the same stored entries; only the
    # summation order differs, and a 300-pair row's terms cancel), a second
    # launch bit-identical
    wdtype = torch.bfloat16 if bf16 else torch.float32
    two, sc, rho = jacobi.synthetic_streams(np.resize(STREAM_ROWS, C), C, wdtype, cuda_device)
    D = stream_operands(C, C, cuda_device)
    pair_ops.reset_launches()
    got = stream_calls(two, sc, rho, D, ref=False)
    again = stream_calls(two, sc, rho, D, ref=False)
    want = stream_calls(two, sc, rho, D, ref=True)
    torch.cuda.synchronize()
    for name in got:
        scale = stream_scale(name, two, sc, rho, D)
        for g, a, w in zip(got[name], again[name], want[name]):
            assert float((g - w).abs().max()) <= 1e-5 * scale, name
            assert torch.equal(g, a), name
    assert pair_ops.launches["pair_matvec"] == 4 and pair_ops.launches["pair_visc"] == 2
    assert pair_ops.launches["pair_matvec_scalar"] == 4
    assert pair_ops.launches["pair_visc_scalar"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1000, 14336])
def test_stream_kernels_write_zeros_on_an_empty_list_on_gpu(cuda_device, C):
    # every output slot is written (the outputs are torch.empty): an
    # all-empty list gives exact zeros
    two, sc, rho = jacobi.synthetic_streams(np.zeros(C, np.int64), 1, torch.float32,
                                            cuda_device)
    for name, outs in stream_calls(two, sc, rho, stream_operands(C, 1, cuda_device),
                                   ref=False).items():
        for g in outs:
            assert g.shape == (C,) and bool((g == 0).all()), name


@pytest.mark.cuda
@pytest.mark.parametrize("E,NT", [(512, 128), (4096, 1024), (200, 64)])
def test_block_sweep_and_window_sum_match_plain_on_gpu(cuda_device, E, NT):
    a = probe.sweep_inputs(E, NT, C=4096, seed=E, device=cuda_device)
    q, c, qt, ck, lo, hi, s = a
    if E == 200:  # tiles 3 and 5 without items: the kernel writes 0 there
        qt = torch.where((qt == 3) | (qt == 5), qt - 1, qt)
    pair_ops.reset_launches()
    got = probes.block_sweep(q, c, qt, ck, lo, hi, s)
    want = probes.block_sweep_ref(q, c, qt, ck, lo, hi, s)
    torch.cuda.synchronize()
    assert rel_err(got, want) < 1e-5
    if E == 200:
        assert not got.view(NT, 8)[[3, 5]].any()
    v, an = probe.window_inputs(C=4096 + 17, n=E // 8, seed=E, device=cuda_device)
    # the probe's aligned windows, misaligned ones (4-byte copies), and more
    # anchors than one stage of the kernel's ring at a ragged width
    ring = probe.window_inputs(C=4096 + 17, n=200, seed=E + 1, device=cuda_device)[1]
    cases = [(an, 128), (an, 200), (an + 1, 128), (ring, 253), (ring + 3, 250)]
    for a, width in cases:
        assert torch.equal(probes.window_sum(v, a, width), probes.window_sum_ref(v, a, width))
    assert pair_ops.launches["block_sweep"] == 1
    assert pair_ops.launches["window_sum"] == len(cases)


@pytest.mark.cuda
@pytest.mark.parametrize("grp,nbuf", [(8, 4), (32, 4), (1, 8), (8, 8), (3, 4)])
@pytest.mark.parametrize("bf16", [False, True])
def test_pair_stream_gives_zeros_on_gpu(cuda_device, grp, nbuf, bf16):
    # zeros out, and every block's XOR fold of the words it landed equals
    # the fold of the same bytes computed from x
    dtype = torch.bfloat16 if bf16 else torch.float32
    x = torch.randn(2, 151409, device=cuda_device).to(dtype)
    pair_ops.reset_launches()
    for n in (x.numel(), 1001, 7, 0):  # whole, ragged tails, nothing
        out, nbytes, folds = probes.pair_stream(x, n, grp, nbuf)
        torch.cuda.synchronize()
        assert out.shape == (8, 128) and not out.any() and nbytes == n * x.element_size()
        assert folds.numel() == probes.stream_grid(x, n, grp, nbuf)
        assert torch.equal(folds, probes.stream_folds(x, n, grp, folds.numel()))
        if n == x.numel():
            assert folds.numel() > 1 and folds.any()
    assert pair_ops.launches["pair_stream"] == 4


@pytest.mark.cuda
@pytest.mark.parametrize("C,tq", [(1024, 128), (2048, 64)])
@pytest.mark.parametrize("bf16", [False, True])
def test_matvec_probes_match_plain_on_gpu(cuda_device, C, tq, bf16):
    # every ablation against its plain version; base is K2 and every wh is
    # K2s, bit for bit
    inputs, D = walk_inputs(C, tq, seed=11 + C + tq, device=cuda_device)
    wdtype = torch.bfloat16 if bf16 else torch.float32
    two = pair_ops.pair_build(*inputs, tq, SCALE, VISC, True, wdtype)
    sc = pair_ops.pair_build(*inputs, tq, SCALE, VISC, True, wdtype, scalar=True)
    pair_ops.reset_launches()
    for k_out, t in ((2, D["u"]), (1, (D["tx"], D["ty"]))):
        for variant in probes.VARIANTS:
            got = probes.pair_matvec_probe(two, t, k_out, variant)
            want = probes.pair_matvec_probe_ref(two, t, k_out, variant)
            torch.cuda.synchronize()
            for g, w in zip(*(x if k_out == 2 else (x,) for x in (got, want))):
                assert rel_err(g, w) < 1e-5, (variant, k_out)
            if variant == "base":
                k2 = pair_ops.pair_matvec(two, t, k_out)
                assert all(torch.equal(g, k) for g, k in zip(*(x if k_out == 2 else (x,)
                                                              for x in (got, k2))))
        k2s = pair_ops.pair_matvec_scalar(sc, t, k_out)
        for wh in probes.WINDOW_HEIGHTS:
            got = probes.pair_matvec_scalar_probe(sc, t, k_out, wh)
            want = probes.pair_matvec_scalar_probe_ref(sc, t, k_out, wh)
            torch.cuda.synchronize()
            for g, w, k in zip(*(x if k_out == 2 else (x,) for x in (got, want, k2s))):
                assert rel_err(g, w) < 1e-5 and torch.equal(g, k), (wh, k_out)
    assert pair_ops.launches["pair_matvec_probe"] == 6
    assert pair_ops.launches["pair_matvec_scalar_probe"] == 8


@pytest.mark.cuda
def test_probe_wrappers_reject_bad_inputs_on_gpu(cuda_device):
    q, c, qt, ck, lo, hi, s = probe.sweep_inputs(64, 8, C=1024, device=cuda_device)
    with pytest.raises(ValueError):
        probes.block_sweep(q, c, qt.flip(0).contiguous(), ck, lo, hi, s)
    with pytest.raises(ValueError):
        probes.block_sweep(q, c.cpu(), qt, ck, lo, hi, s)
    v, an = probe.window_inputs(C=1024, n=4, device=cuda_device)
    with pytest.raises(ValueError):
        probes.window_sum(v, an + 1024)
    x = torch.zeros(1000, device=cuda_device)
    with pytest.raises(ValueError):  # not on a 16-byte boundary
        probes.pair_stream(x[1:], 100)
    with pytest.raises(ValueError):
        probes.pair_stream(x, 100, 64, 8)  # a 512 KB ring


@pytest.mark.cuda
def test_split_optimiser_graph_matches_the_eager_steps_on_gpu(cuda_device):
    # the optimiser's captured chunks on the card against the eager steps on
    # the CPU from the same start, with tensors allocated and freed between
    # attempts (the graph reads its inputs by address: they must stay alive)
    import numpy as np

    from adaptive_sph_torch.ops import kernels as tk
    from adaptive_sph_torch.utils import split_patterns as sp

    bound = 2.0 * 2.0 * float(tk.smoothing_length_from_volume(
        tk.radius_to_sphere_volume(1.0, 2), 2))
    pos = sp.generate_tetrahedral_point_set(1.0, bound)
    r = float(tk.sphere_volume_to_radius(sp.find_optimal_mass(1.0, 1.0, pos), 2))
    pos = pos / r
    mass = float(tk.radius_to_sphere_volume(1.0, 2))
    h = float(tk.smoothing_length_from_mass(mass, 1.0, 2))
    pos_n = np.delete(pos, int(np.argmin(np.linalg.norm(pos, axis=-1))), axis=0)
    for s in (2, 3):
        ps0 = np.random.default_rng(s).uniform(-0.4, 0.4, (s, 2)).astype(np.float32)
        gpu = sp.make_pattern_optimizer(s, pos_n, mass, h, 1.0, 1.0 / r, max_iters=2000,
                                        device=cuda_device)
        junk = [torch.full((4096,), float("nan"), device=cuda_device) for _ in range(64)]
        del junk
        got, status = gpu.attempt(torch.as_tensor(ps0, device=cuda_device))
        cpu = sp.make_pattern_optimizer(s, pos_n, mass, h, 1.0, 1.0 / r, max_iters=2000,
                                        device="cpu")
        want, status_cpu = cpu.attempt(torch.as_tensor(ps0))
        assert status == status_cpu and bool(torch.isfinite(got).all())
        assert float((got.cpu() - want).abs().max()) < 1e-4
