"""PyTorch port, the dense grid engine's building blocks against the JAX package.

- `build_bins` (level, slot, rank, overflow counts): bit-equal to JAX's on
  seeded clouds with three populated levels, a cell forced to overflow
  (small mpc) and particles above the top populated level.
- The slot-layout helpers (`scatter_field`, `gather_result`, `level_view`,
  `shift2d`, `upsample2d`, `downsample_sum2d`, `downsample_max2d`): equal to
  JAX's.
- `pair_apply`: sum and max reductions, same-level and cross-level, with the
  stale-position mask (`mask_pos_key="pos_old"`), against JAX's
  `pair_apply` on the same bins (within 1e-6 of each column's max) and
  against a brute-force pair loop, as tests/test_grid_engine.py holds JAX's.
- The slot sweeps of models/grid_physics.py and the level estimation
  (EmptyAngle and CenterDiff, which the step refuses before advection but
  the function keeps) against JAX's on the same bins.
- The runner: `resolve_backend("grid")`, the grid configuration the runner
  sizes (mpc from the initial occupancy, the populated levels) equal to
  JAX's, and the settings the grid backend refuses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sph_torch import convert
from adaptive_sph_torch.models import grid_pairs as t_pairs
from adaptive_sph_torch.models import grid_physics as t_gp
from adaptive_sph_torch.models import grid_step as t_gs
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.ops import grid as t_grid
from adaptive_sph_torch.runner import check_supported, resolve_backend
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.stress import STRESS_SCENE, grid_runs, stress_params
from adaptive_sph_torch.utils.params import (
    LevelEstimationMethod,
    OperatorDiscretization,
    ParticleSizes,
    SimulationParams,
    SupportLengthEstimation,
    ViscosityType,
)
from adaptive_sph_tpu.models import grid_pairs as j_pairs
from adaptive_sph_tpu.models import grid_physics as j_gp
from adaptive_sph_tpu.models import grid_step as j_gs
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.ops import grid as j_grid
from adaptive_sph_tpu.runner import grid_config_for as j_grid_config_for
from adaptive_sph_tpu.utils import params as j_params

torch.set_num_threads(2)

BINS = ("slot_of", "level_of", "slot_idx", "slot_mask", "overflow", "level_overflow")


def cloud(seed, n, C, h_range, extent=1.1):
    rng = np.random.default_rng(seed)
    pos = np.zeros((C, 2), np.float32)
    pos[:n] = rng.uniform(-extent / 2, extent / 2, size=(n, 2))
    h = np.full(C, h_range[0], np.float32)
    h[:n] = np.exp(rng.uniform(np.log(h_range[0]), np.log(h_range[1]), size=n))
    alive = np.zeros(C, bool)
    alive[:n] = True
    mass = rng.uniform(0.5, 2.0, size=C).astype(np.float32)
    return pos, h, alive, mass


def configs(scale, h_range, C, mpc, populated=None):
    cfg = j_grid.make_grid_config((-0.7, -0.7), (0.7, 0.7), scale, h_range[0], h_range[1], C,
                                  mpc=mpc)
    if populated is not None:
        cfg = dataclasses.replace(cfg, populated=populated)
    return cfg, convert.grid_config_from_dict(dataclasses.asdict(cfg))


def both_bins(pos, sr, alive, jcfg, tcfg):
    jb = j_grid.build_bins(jnp.asarray(pos), jnp.asarray(sr), jnp.asarray(alive), jcfg)
    tb = t_grid.build_bins(torch.from_numpy(pos), torch.from_numpy(sr), torch.from_numpy(alive),
                           tcfg)
    return jb, tb


# seed, n, h range, scale, mpc, populated (None: all)
BIN_CASES = {
    "three_levels": (0, 400, (0.02, 0.3), 2.0, 48, (1, 2, 4)),
    "cell_overflow": (1, 450, (0.02, 0.1), 2.0, 3, None),
    "above_top": (2, 300, (0.02, 0.5), 2.894736, 24, (0, 1)),
    "uniform": (3, 350, (0.05, 0.05), 2.0, 16, None),
}


@pytest.mark.parametrize("case", list(BIN_CASES))
def test_build_bins_is_bit_equal(case):
    seed, n, hr, scale, mpc, pop = BIN_CASES[case]
    pos, h, alive, _ = cloud(seed, n, 512, hr)
    jcfg, tcfg = configs(scale, hr, 512, mpc, pop)
    sr = (h * np.float32(scale)).astype(np.float32)
    jb, tb = both_bins(pos, sr, alive, jcfg, tcfg)
    for k in BINS:
        np.testing.assert_array_equal(getattr(tb, k).numpy(), np.asarray(getattr(jb, k)),
                                      err_msg=k)
    assert (len(set(pop)) if pop else jcfg.levels) >= (3 if case == "three_levels" else 1)
    if case == "cell_overflow":
        assert int(tb.overflow) > 0
    if case == "above_top":
        assert int(tb.level_overflow) > 0
    if case == "three_levels":
        assert len(np.unique(tb.level_of.numpy()[alive])) == 3


def test_slot_helpers_equal_jax():
    pos, h, alive, mass = cloud(4, 300, 512, (0.02, 0.3))
    jcfg, tcfg = configs(2.0, (0.02, 0.3), 512, 24)
    jb, tb = both_bins(pos, (h * 2.0).astype(np.float32), alive, jcfg, tcfg)
    rng = np.random.default_rng(5)
    for field in (pos, mass, rng.normal(size=(512, 3)).astype(np.float32)):
        js = j_grid.scatter_field(jb, jcfg, jnp.asarray(field))
        ts = t_grid.scatter_field(tb, tcfg, torch.from_numpy(field))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(t_grid.gather_result(tb, tcfg, ts, -7.0).numpy(),
                                      np.asarray(j_grid.gather_result(jb, jcfg, js, -7.0)))
        for lvl in range(jcfg.levels):
            np.testing.assert_array_equal(t_grid.level_view(tcfg, ts, lvl).numpy(),
                                          np.asarray(j_grid.level_view(jcfg, js, lvl)))
    a = rng.normal(size=(8, 12, 5, 2)).astype(np.float32)
    m = rng.uniform(size=(8, 12, 5)) < 0.5
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            np.testing.assert_array_equal(
                t_grid.shift2d(torch.from_numpy(a), dy, dx, 0.5).numpy(),
                np.asarray(j_grid.shift2d(jnp.asarray(a), dy, dx, 0.5)))
            np.testing.assert_array_equal(
                t_grid.shift2d(torch.from_numpy(m), dy, dx, False).numpy(),
                np.asarray(j_grid.shift2d(jnp.asarray(m), dy, dx, False)))
    for f in (1, 2, 4):
        np.testing.assert_array_equal(t_grid.upsample2d(torch.from_numpy(a), f).numpy(),
                                      np.asarray(j_grid.upsample2d(jnp.asarray(a), f)))
        np.testing.assert_array_equal(t_grid.downsample_max2d(torch.from_numpy(a), f).numpy(),
                                      np.asarray(j_grid.downsample_max2d(jnp.asarray(a), f)))
        np.testing.assert_array_equal(t_grid.downsample_sum2d(torch.from_numpy(a), f).numpy(),
                                      np.asarray(j_grid.downsample_sum2d(jnp.asarray(a), f)))
    assert t_grid.OFFSETS == j_grid.OFFSETS
    assert tcfg.level_offsets == jcfg.level_offsets
    assert tcfg.slots_per_level == jcfg.slots_per_level


def slot_fields(jb, tb, jcfg, tcfg, **fields):
    js = {k: j_grid.scatter_field(jb, jcfg, jnp.asarray(v)) for k, v in fields.items()}
    ts = {k: t_grid.scatter_field(tb, tcfg, torch.from_numpy(v)) for k, v in fields.items()}
    return js, ts


def assert_columns_close(got, want, rel=1e-6):
    """Each column within rel x its max |want| (sums of O(100) terms round
    apart in their last bits)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    got, want = got.reshape(len(got), -1), want.reshape(len(want), -1)
    top = np.maximum(np.abs(want).max(axis=0), 1e-30)
    err = (np.abs(got - want) / top).max()
    assert err <= rel, err


def brute(pos, h, alive, scale, pos_mask=None):
    pm = pos if pos_mask is None else pos_mask
    diff = pos[:, None, :] - pos[None, :, :]
    r = np.sqrt((diff.astype(np.float64) ** 2).sum(-1))
    dm = pm[:, None, :] - pm[None, :, :]
    rm = np.sqrt((dm.astype(np.float64) ** 2).sum(-1))
    adj = (rm < scale * 0.5 * (h[:, None] + h[None, :])) & alive[:, None] & alive[None, :]
    return diff, r, adj


# seed, n, h range, scale, mask key, mpc
PAIR_CASES = {
    "same_level": (0, 200, (0.05, 0.05), 2.0, "pos", 16),
    "cross_level": (1, 240, (0.03, 0.12), 2.0, "pos", 16),
    "wide_span": (2, 150, (0.05, 0.6), 2.0, "pos", 40),
    "extended_stale": (3, 200, (0.04, 0.2), 2.894736, "pos_old", 24),
}


@pytest.mark.parametrize("case", list(PAIR_CASES))
def test_pair_apply_matches_jax_and_bruteforce(case):
    seed, n, hr, scale, key, mpc = PAIR_CASES[case]
    C = 512
    pos, h, alive, mass = cloud(seed, n, C, hr)
    jcfg, tcfg = configs(scale, hr, C, mpc)
    jb, tb = both_bins(pos, (h * np.float32(scale)).astype(np.float32), alive, jcfg, tcfg)
    assert int(tb.overflow) == 0 and int(tb.level_overflow) == 0
    old = (pos + np.random.default_rng(seed + 7).normal(scale=0.01, size=pos.shape)).astype(
        np.float32)
    js, ts = slot_fields(jb, tb, jcfg, tcfg, pos=pos, h=h, mass=mass, pos_old=old)

    def edge(xp):
        def fn(vi, vj, g):
            return {"s": vj["mass"] * xp.exp(-g.r * g.r),
                    "v": (vj["mass"] * g.r)[..., None] * g.diff}
        return fn

    def edge_max(vi, vj, g):
        return {"m": vj["h"] - g.r}

    mask = None if key == "pos" else old
    diff, r, adj = brute(pos, h, alive, scale, mask)
    for reduce, fn_j, fn_t, fill in (("sum", edge(jnp), edge(torch), 0.0),
                                     ("max", edge_max, edge_max, -3.0e38)):
        want = jax.jit(lambda sf: j_pairs.pair_apply(jcfg, jb, sf, jnp.float32(scale), fn_j,
                                                     reduce=reduce, fill=fill,
                                                     mask_pos_key=key))(js)
        got = t_pairs.pair_apply(tcfg, tb, ts, scale, fn_t, reduce=reduce, fill=fill,
                                 mask_pos_key=key)
        for k in want:
            g = t_grid.gather_result(tb, tcfg, got[k], fill).numpy()[alive]
            w = np.asarray(j_grid.gather_result(jb, jcfg, want[k], fill))[alive]
            assert_columns_close(g, w)
            if reduce == "max":
                np.testing.assert_allclose(g, np.where(adj, h[None, :] - r, -np.inf).max(1)[alive],
                                           rtol=1e-5, atol=1e-6)
            elif k == "s":
                np.testing.assert_allclose(g, (mass[None, :] * np.exp(-r * r) * adj).sum(1)[alive],
                                           rtol=3e-5, atol=1e-6)
            else:
                np.testing.assert_allclose(
                    g, ((mass[None, :] * r * adj)[..., None] * diff).sum(1)[alive],
                    rtol=3e-5, atol=1e-6)
    assert adj.sum() > n  # pairs beyond the self pairs


def sweep_inputs(seed=6, n=260, C=512, hr=(0.04, 0.08)):
    pos, h, alive, mass = cloud(seed, n, C, hr, extent=0.9)
    rng = np.random.default_rng(seed + 1)
    rho = rng.uniform(0.8, 1.2, C).astype(np.float32)
    vel = rng.normal(scale=0.3, size=(C, 2)).astype(np.float32)
    q = rng.normal(size=(C, 2)).astype(np.float32)
    p = rng.uniform(0.0, 50.0, C).astype(np.float32)
    G = rng.normal(scale=0.5, size=(C, 2)).astype(np.float32)
    size_class = rng.integers(0, 5, C).astype(np.int32)
    jcfg, tcfg = configs(2.0, hr, C, 16)
    jb, tb = both_bins(pos, (h * 2.0).astype(np.float32), alive, jcfg, tcfg)
    assert int(tb.overflow) == 0 and int(tb.level_overflow) == 0 and jcfg.levels == 2
    js, ts = slot_fields(jb, tb, jcfg, tcfg, pos=pos, h=h, h_raw=h, mass=mass, rho=rho)
    extra = {k: slot_fields(jb, tb, jcfg, tcfg, x=v)
             for k, v in (("vel", vel), ("q", q), ("p", p), ("G", G), ("sc", size_class))}
    return (jcfg, tcfg, jb, tb, js, ts, {k: (v[0]["x"], v[1]["x"]) for k, v in extra.items()},
            alive)


SWEEP_PARAMS = {
    "laplace_simple": SimulationParams(),
    "wcsph_w2020": SimulationParams(viscosity_type=ViscosityType.WCSPH, viscosity=0.003,
                                    operator_discretization=OperatorDiscretization.Winchenbach2020),
    "symmetric": SimulationParams(
        operator_discretization=OperatorDiscretization.ConsistentSymmetricGradient),
}


@pytest.mark.parametrize("case", list(SWEEP_PARAMS))
def test_slot_sweeps_match_jax(case):
    jcfg, tcfg, jb, tb, js, ts, x, alive = sweep_inputs()
    params = SWEEP_PARAMS[case]
    jp = j_params.params_from_dict(convert.params_to_dict(params))
    s = jnp.float32(2.0)
    zero = jnp.zeros(2, jnp.float32)

    def cmp(got, want, rel=1e-6):
        if isinstance(want, dict):
            assert set(got) == set(want)
            for k in want:
                cmp(got[k], want[k], rel)
            return
        g = t_grid.gather_result(tb, tcfg, got).numpy()[alive]
        w = np.asarray(j_grid.gather_result(jb, jcfg, want))[alive]
        assert_columns_close(g, w, rel)

    def jit(fn, *args):
        return jax.jit(fn)(*args)

    cmp(t_gp.density_slots(tcfg, tb, ts, 2.0),
        jit(lambda sf: j_gp.density_slots(jcfg, jb, sf, s), js))
    cmp(t_gp.constant_field_slots(tcfg, tb, ts, 2.0),
        jit(lambda sf: j_gp.constant_field_slots(jcfg, jb, sf, s), js))
    sums_t, visc_t = t_gp.fused_prep_sweep(tcfg, tb, ts, 2.0, x["vel"][1], params)
    sums_j, visc_j = jit(lambda sf, v: j_gp.fused_prep_sweep(jcfg, jb, sf, s, v, jp), js,
                         x["vel"][0])
    cmp(sums_t, sums_j)
    cmp(visc_t, visc_j)
    for kind in ("sdf", "particles", "none"):
        cmp(t_gp.assemble_aii(sums_t, ts, x["G"][1], kind, params),
            jit(lambda sm, sf, G: j_gp.assemble_aii(sm, sf, G, kind, jp), sums_j, js, x["G"][0]))
    cmp(t_gp.pressure_accel_slots(tcfg, tb, ts, 2.0, x["p"][1], x["G"][1], "sdf", params),
        jit(lambda sf, p, G: j_gp.pressure_accel_slots(jcfg, jb, sf, s, p, G, "sdf", jp), js,
            x["p"][0], x["G"][0]))
    cmp(t_gp.divergence_slots(tcfg, tb, ts, 2.0, x["q"][1], torch.zeros(2), x["G"][1], "sdf",
                              params),
        jit(lambda sf, q, G: j_gp.divergence_slots(jcfg, jb, sf, s, q, zero, G, "sdf", jp), js,
            x["q"][0], x["G"][0]))
    cmp(t_gp.non_pressure_accel_slots(tcfg, tb, ts, 2.0, x["vel"][1], params),
        jit(lambda sf, v: j_gp.non_pressure_accel_slots(jcfg, jb, sf, s, v, jp), js,
            x["vel"][0]))
    # Omega = 1 + H / (3 rho) sum_j m_j dW/dH: the sum cancels to 1e-4 of its
    # column's largest terms on these seeded densities, so a last-bit
    # difference of the terms moves Omega by ~1e-5 of its range
    cmp(t_gp.omega_iisph2_slots(tcfg, tb, ts, 2.0, x["sc"][1], params),
        jit(lambda sf, sc: j_gp.omega_iisph2_slots(jcfg, jb, sf, s, sc, jp), js, x["sc"][0]),
        rel=1e-5)


@pytest.mark.parametrize("method", ["EmptyAngle", "CenterDiff"])
def test_level_estimation_slots_match_jax(method):
    jcfg, tcfg, jb, tb, js, ts, x, alive = sweep_inputs(seed=8, n=240)
    params = SimulationParams(level_estimation_method=LevelEstimationMethod(method),
                              support_length_estimation=SupportLengthEstimation.FromDistribution,
                              maximum_surface_distance=0.3)
    jp = j_params.params_from_dict(convert.params_to_dict(params))
    scale = float(np.float32(params.level_estimation_range / 1.9))
    dist = x["G"]
    got = t_gs.level_estimation_slots(tcfg, tb, ts, scale, dist[1][:, 0], params)
    want = jax.jit(lambda sf, d: j_gs.level_estimation_slots(jcfg, jb, sf, jnp.float32(scale), d,
                                                             jp))(js, dist[0][:, 0])
    names = ("level", "has", "surface", "insufficient", "count", "stash")
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        g = t_grid.gather_result(tb, tcfg, g).numpy()[alive]
        w = np.asarray(j_grid.gather_result(jb, jcfg, w))[alive]
        if name == "level":
            np.testing.assert_allclose(g, w, atol=2e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    assert got[2].any() and (~got[2][tb.slot_mask]).any()


def test_runner_sizes_the_grid_as_jax():
    for name, (params, scene, capacity, _) in grid_runs().items():
        sim = t_create(params, t_scene.scene_from_dict(scene), capacity=capacity, device="cpu",
                       backend="grid")
        jparams = j_params.init_h_for_uniform(
            j_params.params_from_dict(convert.params_to_dict(params)),
            sim.scene.blocks[0].spacing, sim.scene.blocks[0].volume_fill_ratio)
        jscene = j_scene.scene_from_dict(scene)
        from adaptive_sph_tpu.models.scene import init_fluid_state

        jstate = init_fluid_state(jscene, jparams, capacity)
        want = j_grid_config_for(jparams, jscene, jstate, jstate.capacity)
        assert dataclasses.asdict(sim.grid_cfg) == dataclasses.asdict(
            convert.grid_config_from_dict(dataclasses.asdict(want))), name
        assert sim.backend == "grid" and sim.tile_cfg is None and sim.ncfg is not None


REFUSED = {
    "constrain_neighborhood_count": dict(constrain_neighborhood_count=True),
    "check_aii": dict(check_aii=True),
    "check_neighborhood": dict(check_neighborhood=True),
    "level_estimation_after_advection": dict(level_estimation_after_advection=True),
}


@pytest.mark.parametrize("setting", list(REFUSED))
def test_grid_refuses_the_settings_the_reference_drops(setting):
    params = stress_params().replace(**REFUSED[setting])
    if setting == "level_estimation_after_advection":
        params = params.replace(force_level_estimation=True)
    with pytest.raises(NotImplementedError, match=setting):
        t_create(params, t_scene.scene_from_dict(STRESS_SCENE), device="cpu", backend="grid")
    check_supported(params, resolve_backend(params, "auto"))  # tiles / lists run it
    # the reference's own gate names all but check_neighborhood
    dropped = setting == "check_neighborhood"
    jp = j_params.params_from_dict(convert.params_to_dict(params))
    assert j_gs.supports_grid_backend(jp) == dropped == t_gs.supports_grid_backend(params)


def test_grid_backend_resolves_and_auto_never_takes_it():
    base = stress_params()
    assert resolve_backend(base, "grid") == "grid"
    for after in (False, True):
        for sizes in ParticleSizes:
            p = base.replace(level_estimation_after_advection=after, particle_sizes=sizes,
                             force_level_estimation=True)
            assert resolve_backend(p, "auto") != "grid"
    # CenterDiff before advection stays refused (the reference asserts)
    with pytest.raises(NotImplementedError, match="CenterDiff"):
        check_supported(base.replace(level_estimation_method=LevelEstimationMethod.CenterDiff,
                                     force_level_estimation=True), "grid")
    # XSPH runs on the grid engine (with no viscosity, as in the reference)
    check_supported(base.replace(viscosity_type=ViscosityType.XSPH, viscosity=0.01), "grid")
    assert t_gs.supports_grid_backend(base)


def test_fused_multiply_add_on_the_cpu():
    """numerics.fma_tensors (torch.addcmul on the CPU) rounds once, as fma."""
    from adaptive_sph_torch.ops.numerics import fma, fma_tensors

    rng = np.random.default_rng(9)
    a, b, c = (torch.from_numpy(rng.normal(size=(501, 3)).astype(np.float32)) for _ in range(3))
    for x, y, z in ((a, b, c), (a[:, :1], b, c), (a.t(), b.t(), c.t())):
        np.testing.assert_array_equal(fma_tensors(x, y, z).numpy(), fma(x, y, z).numpy())
    assert not torch.equal(fma_tensors(a, b, c), a * b + c)

