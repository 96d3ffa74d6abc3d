"""PyTorch port, the last modes of the pair sweep: h from the particle
distribution, the diagnostic fields and the stash, CenterDiff and EmptyAngle
levels after advection, the neighbourhood-count constraint and the debug
checks (check_aii, check_neighborhood), against the JAX package on the CPU.

- Each new SweepOp's plain walk against the JAX package's `run_sweep` in
  interpret mode (as tests/test_torch_sweeps.py runs the others), on the
  two-level and the eight-level cloud: counts and maxima exactly equal, sums
  within 1e-5 of the column max.
- Whole steps of small scenes (capacity <= 2,048) through both packages,
  with the gate of tests/test_torch_step.py (positions atol 2e-5, density
  rtol 2e-5, velocity atol 2e-4, iteration counts and dt equal at every
  step) and, for the fields these modes write: h and h_next rtol 2e-5,
  levels and the stash atol 2e-5, the constant field atol 2e-5, neighbour
  counts and the three flags exactly equal; check_neighborhood's mismatch
  0 in both; check_aii's deviation under the reference's 0.01 gate in both
  and within 2e-3 of each other (it is a maximum of float32 differences of
  a_ii ~ 1e2-1e3, a few ulps apart).
- tests/data/torch_port_sweep_modes_ref.npz (written by
  scripts/torch_port_sweep_modes_ref.py, which chip_smoke.py holds the GPU
  runs against): its small run against the JAX package and the port.
"""

import dataclasses
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from adaptive_sph_torch import convert
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.ops import sweeps as t_sweeps
from adaptive_sph_torch.runner import SimulationFailed, create_simulation as t_create
from adaptive_sph_torch.stress import TWO_SIZE_SCENE, sweep_mode_runs
from adaptive_sph_torch.utils import params as t_params
from adaptive_sph_tpu.models import tile_physics as j_tp
from adaptive_sph_tpu.ops.pallas_sweeps import run_sweep
from adaptive_sph_tpu.utils import params as j_params
from adaptive_sph_tpu.utils.params import (FillStashWith, LevelEstimationMethod,
                                           OperatorDiscretization, PressureSolverMethod,
                                           SimulationParams, SupportLengthEstimation)
from test_torch_kernels import (EXT_SCALE, assert_sweep_close, mode_sweep_dyn, mode_sweep_ops,
                                multi_level_cloud, N_FINE, two_level_cloud)
from test_torch_step import assert_states_match, dam_scene, run_pair
from test_torch_sweeps import jax_layout

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_sweep_modes_ref.npz")
S = SupportLengthEstimation


@functools.lru_cache(maxsize=None)
def jax_mode_ops():
    """name -> (JAX SweepOp, scale), the counterparts of mode_sweep_ops()."""
    p = SimulationParams()
    dist = dataclasses.replace(p, support_length_estimation=S.FromDistribution)
    return {
        "h_w_sum": (j_tp.h_w_sum_op(), 2.0), "h_vw_sum": (j_tp.h_vw_sum_op(p), 2.0),
        "constant_field": (j_tp.constant_field_op(), 2.0),
        "cone_range": (j_tp.cone_op(dist), EXT_SCALE),
        "wavefront_range": (j_tp.wavefront_op(dist), EXT_SCALE),
        "centerdiff": (j_tp.centerdiff_op(p), EXT_SCALE),
        "fringe_count": (j_tp.fringe_count_op(), 2.0),
        "check_aii": (j_tp.check_aii_op(False), 2.0),
        "check_aii_w2020": (j_tp.check_aii_op(True), 2.0),
    }


@pytest.mark.parametrize("cloud", ["two", "multi"])
@pytest.mark.parametrize("name", list(mode_sweep_ops()))
def test_mode_sweep_matches_jax(name, cloud):
    C, tq = 1024, 128
    if cloud == "two":
        pos, h, mass, alive = two_level_cloud(C, N_FINE[C], seed=3)
    else:
        pos, h, mass, alive = multi_level_cloud(C, seed=3)
    cfg, bins, st, wm = jax_layout(pos, h, mass, alive, C, tq, EXT_SCALE)
    tst = torch.from_numpy(np.asarray(st))
    dyn = mode_sweep_dyn(name, tst, 5)
    jop, scale = jax_mode_ops()[name]
    top, tscale = mode_sweep_ops()[name]
    assert tscale == scale and top.n_out == jop.n_out and top.reduce == jop.reduce
    want = run_sweep(cfg, bins, st, None if dyn is None else jnp.asarray(dyn), jop, scale,
                     interpret=True, wmeta=wm)
    cs, twm = torch.from_numpy(np.asarray(bins.cell_starts)), torch.from_numpy(np.asarray(wm))
    tdyn = None if dyn is None else torch.from_numpy(dyn)
    got = t_sweeps.pair_sweep(cs, twm, tst, tdyn, top, scale, tq)
    live = torch.from_numpy(np.asarray(st[:, 2]) > 0)
    want = torch.from_numpy(np.asarray(want))[live]
    assert_sweep_close(got[live], want, top, name)
    if top.reduce == "sum":
        assert float(want.abs().max()) > 0, "the op found no pairs"
    if name.endswith("_range"):
        # the range limit cuts pairs that the unlimited op takes
        base = {"cone_range": j_tp.cone_op(SimulationParams()),
                "wavefront_range": j_tp.wavefront_op(SimulationParams())}[name]
        full = run_sweep(cfg, bins, st, jnp.asarray(dyn), base, scale, interpret=True, wmeta=wm)
        assert (np.asarray(full)[live.numpy()] != want.numpy()).any()


# ---------------------------------------------------------------------------
# whole steps against the JAX package

def two_size_dam(coarse=0.06, width=0.45, height=0.6):
    """A fine block (spacing 0.03) beside a coarse one (`coarse`), touching."""
    return {"boundary": {"type": "box", "width": 2, "height": 2},
            "blocks": [{"pos": [-0.95, -0.95], "size": [width, height], "spacing": 0.03,
                        "volume_fill_ratio": 0.93, "velocity": [0, 0]},
                       {"pos": [-0.95 + width, -0.95], "size": [width, height],
                        "spacing": coarse, "volume_fill_ratio": 0.93, "velocity": [0, 0]}]}


# the resampling cases' smaller dam (~170 particles before the splits)
SMALL = two_size_dam(width=0.3, height=0.4)


# resampling with the surface-distance export's particle radii
RESAMPLE = dict(particle_radius_base=0.035, particle_radius_fine=0.01,
                maximum_surface_distance=0.45)
STILL = dict(merging=False, sharing=False, splitting=False)

# case -> (params, scene, capacity, steps)
CASES = {
    "from_distribution_resampling": (
        dict(support_length_estimation=S.FromDistribution, **RESAMPLE), SMALL, None, 3),
    "from_distribution2_resampling": (
        dict(support_length_estimation=S.FromDistribution2, **RESAMPLE), SMALL, None, 3),
    "clamped1_resampling_stash_first": (
        dict(support_length_estimation=S.FromDistributionClamped1, **RESAMPLE,
             fill_stash_with=FillStashWith.SurfaceDistanceFirstIteration),
        SMALL, None, 3),
    "diagnostic_fields": (
        dict(support_length_estimation=S.FromDistributionClamped1, **STILL,
             force_diagnostic_fields=True), two_size_dam(), None, 4),
    "centerdiff_after_advection": (
        dict(level_estimation_method=LevelEstimationMethod.CenterDiff,
             level_estimation_after_advection=True, boundary_is_fluid_surface=True,
             force_level_estimation=True, **STILL), two_size_dam(), None, 4),
    "clamped2_emptyangle_after_advection_stash_middle": (
        dict(support_length_estimation=S.FromDistributionClamped2,
             level_estimation_after_advection=True, **RESAMPLE,
             fill_stash_with=FillStashWith.SurfaceDistanceMiddle), SMALL, None, 3),
    "constrained_checked": (
        dict(constrain_neighborhood_count=True, check_neighborhood=True, check_aii=True, **STILL),
        TWO_SIZE_SCENE, None, 4),
}


def assert_fields_match(js, ts, j):
    a, b = js.state, ts.state
    aa, ba = np.asarray(a.alive), b.alive.numpy()

    def f(state, name, alive):
        return np.asarray(getattr(state, name) if state is a else getattr(state, name).numpy())[
            alive].astype(np.float64)

    for name, tol in (("h", 2e-5), ("h_next", 2e-5)):
        np.testing.assert_allclose(f(b, name, ba)[j], f(a, name, aa), rtol=tol, err_msg=name)
    for name in ("level", "stash", "constant_field"):
        np.testing.assert_allclose(f(b, name, ba)[j], f(a, name, aa), atol=2e-5, err_msg=name)
    for name in ("neighbor_count", "flag_is_fluid_surface", "flag_insufficient_neighs",
                 "flag_neighborhood_reduced"):
        np.testing.assert_array_equal(f(b, name, ba)[j], f(a, name, aa), err_msg=name)


def assert_debug_diag_match(dj, d):
    if "neighborhood_check_mismatch" in dj:
        assert int(dj["neighborhood_check_mismatch"]) == d["neighborhood_check_mismatch"] == 0
    if "aii_deviation" in dj:
        ref = float(dj["aii_deviation"])
        assert ref < 0.01 and d["aii_deviation"] < 0.01
        assert abs(d["aii_deviation"] - ref) <= 2e-3, (d["aii_deviation"], ref)
    else:
        assert "aii_deviation" not in d


def check_pair(params, scene, capacity, steps):
    """Both packages `steps` steps; returns (jax sim, port sim, diags)."""
    js, ts, diags = run_pair(params, scene, capacity, steps)
    for k, (dj, d) in enumerate(diags):
        for name in ("div_iterations", "density_iterations"):
            # each solver sets only the counts of the solves it runs
            assert (name in d) == (name in dj), (name, k)
            if name in d:
                assert d[name] == int(dj[name]), (name, k)
        assert d["dt"] == pytest.approx(float(dj["dt"]), rel=1e-6), k
        assert d["negative_aii"] == int(dj["negative_aii"]) == 0
        assert_debug_diag_match(dj, d)
    j = assert_states_match(js, ts)
    assert_fields_match(js, ts, j)
    return js, ts, diags


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax(case):
    kw, scene, capacity, steps = CASES[case]
    js, ts, _ = check_pair(SimulationParams(**kw), scene, capacity, steps)
    st = ts.state
    alive = st.alive
    # what each case exists to exercise happened
    if kw.get("fill_stash_with") is not None:
        assert float(st.stash[alive].abs().max()) > 0
    if kw.get("force_diagnostic_fields"):
        assert int(st.neighbor_count[alive].min()) > 0
        assert float(st.constant_field[alive].min()) > 0
    if kw.get("level_estimation_after_advection"):
        assert bool(st.flag_is_fluid_surface[alive].any())
    if kw.get("constrain_neighborhood_count"):
        assert bool(st.flag_neighborhood_reduced[alive].any())
    if kw.get("support_length_estimation", S.FromMass) != S.FromMass:
        assert not torch.equal(st.h[alive], st.h_next[alive])


# ---------------------------------------------------------------------------
# the fixture of the GPU runs

def ref_script():
    """scripts/torch_port_sweep_modes_ref.py as a module."""
    import importlib.util

    path = os.path.join(ROOT, "scripts", "torch_port_sweep_modes_ref.py")
    spec = importlib.util.spec_from_file_location("torch_port_sweep_modes_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PER_STEP = ("dt", "div_iterations", "density_iterations", "neighborhood_check_mismatch",
            "aii_deviation")
STATE = ("position", "velocity", "density", "h", "h_next", "level", "flag_is_fluid_surface",
         "flag_insufficient_neighs", "flag_neighborhood_reduced", "stash", "constant_field",
         "neighbor_count")


def test_fixture_holds_every_run():
    ref = np.load(FIXTURE)
    for run, (_, _, _, steps) in sweep_mode_runs().items():
        for k in PER_STEP:
            assert ref[f"{run}__{k}"].shape == (steps,), (run, k)
        n = ref[f"{run}__position"].shape[0]
        assert n > 0 and all(ref[f"{run}__{k}"].shape[0] == n for k in STATE), run
        assert np.isfinite(ref[f"{run}__position"]).all()


@pytest.mark.parametrize("run", ["impact_w2020_check_aii", "two_size_constrained"])
def test_fixture_small_run_is_the_jax_package_and_the_port_matches_it(run):
    # the fixture's small runs (the impact scene's resident Winchenbach2020
    # run with check_aii; the two-size dam whose constraint reduces h): the
    # fixture holds the JAX package's run, and the port on the CPU matches it
    params, scene, capacity, steps = sweep_mode_runs()[run]
    ref = np.load(FIXTURE)
    state, per_step = ref_script().reference_run(params, scene, capacity, steps)
    for k, v in {**state, **per_step}.items():
        np.testing.assert_array_equal(v, ref[f"{run}__{k}"], err_msg=k)
    ts = t_create(params, t_scene.scene_from_dict(scene), capacity=capacity, device="cpu")
    for k in range(steps):
        d = ts.step()
        for name in ("div_iterations", "density_iterations", "neighborhood_check_mismatch"):
            assert d.get(name, -1) == ref[f"{run}__{name}"][k], (name, k)
        assert d["aii_deviation"] < 0.01
        assert abs(d["aii_deviation"] - ref[f"{run}__aii_deviation"][k]) <= 2e-3
    st = ts.state
    a = st.alive.numpy()
    _, j = cKDTree(st.position.numpy()[a]).query(ref[f"{run}__position"], k=1)
    assert (np.sort(j) == np.arange(a.sum())).all()

    def got(name):
        return getattr(st, name).numpy()[a][j].astype(np.float32)

    np.testing.assert_allclose(got("position"), ref[f"{run}__position"], atol=2e-5)
    np.testing.assert_allclose(got("velocity"), ref[f"{run}__velocity"], atol=2e-4)
    for name in ("density", "h", "h_next"):
        np.testing.assert_allclose(got(name), ref[f"{run}__{name}"], rtol=2e-5, err_msg=name)
    for name in ("neighbor_count", "flag_neighborhood_reduced", "flag_is_fluid_surface"):
        np.testing.assert_array_equal(got(name), ref[f"{run}__{name}"], err_msg=name)
    if run == "two_size_constrained":
        assert ref[f"{run}__flag_neighborhood_reduced"].sum() > 0


# ---------------------------------------------------------------------------
# the runner's debug-check failures

@pytest.mark.parametrize("key,value,match", [
    ("aii_deviation", 0.02, "a_ii check failed"),
    ("neighborhood_check_mismatch", 3, "check_neighborhood"),
])
def test_debug_check_failures_raise(key, value, match):
    # as the JAX runner: a_ii deviating by 0.01 or more, or any pair-count
    # mismatch, fails the step and leaves the state where it was
    p = t_params.params_from_dict({**STILL, "check_aii": True, "check_neighborhood": True})
    sim = t_create(p, t_scene.scene_from_dict(dam_scene()), capacity=1024, device="cpu")
    inner = sim.step_fn

    def corrupted(state, step_number):
        s, d = inner(state, step_number)
        assert key in d
        d[key] = torch.tensor(value)
        return s, d

    sim.step_fn = corrupted
    before = sim.state
    with pytest.raises(SimulationFailed, match=match):
        sim.step()
    assert sim.state is before and sim.step_number == 0
