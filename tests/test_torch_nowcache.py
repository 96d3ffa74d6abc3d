"""PyTorch port, the sweep-only tile step (ASPH_NO_WCACHE=1): the tile step
without a pair list, every pair sum a pair_sweep (DENSITY, prep or aii_sums,
accel, div, visc, omega), against the JAX package's step under the same
variable on the CPU (its Pallas sweeps in interpret mode).

The JAX package reads the variable when it first traces a simulation's
step, the port at every step, so each test sets it (monkeypatch) before it
creates either simulation and leaves it set for the whole run.

- One small run per row of `stress.nowcache_runs()`: the impact scene (144
  particles thrown at the floor, solves of up to 60 sweeps) with each
  family (HybridDFSPH with ApproxLaplace, Winchenbach2020 with
  resident_solver, WCSPH viscosity after the divergence solve, IISPH2 with
  WCSPH, XSPH with a zero viscosity), 6 steps; the default dam break's
  first 3 steps (levels, share / merge / split). The gate of PERF.md
  section 2: positions atol 2e-5, density rtol 2e-5, velocity atol 2e-4,
  iteration and negative-a_ii counts equal at every step.
- The branch builds no pair list and runs no whole-solve kernel, also with
  resident_solver and ASPH_SCALAR_BLOCKS=1 set.
- tests/data/torch_port_nowcache_ref.npz (scripts/torch_port_nowcache_ref.py,
  which chip_smoke.py's phase N2 holds the GPU runs against): every run in
  it, and its small run against the JAX package and the port.
- The slab step (parallel/tile_sharding.py) under the variable on 2 gloo
  ranks against the port's one-device run, on tests/test_multichip.py's
  800-particle scene.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from adaptive_sph_torch import convert
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.models import tile_physics as t_tp
from adaptive_sph_torch.multichip import SlabJob, run_ranks
from adaptive_sph_torch.ops import jacobi, pair_ops
from adaptive_sph_torch.parallel import tile_sharding as tts
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.stress import IMPACT_CAPACITY, impact_params, impact_scene, nowcache_runs
from adaptive_sph_torch.utils.params import (OperatorDiscretization as OD,
                                             PressureSolverMethod as M, ViscosityType as VT)
from adaptive_sph_tpu.utils import params as j_params
from test_torch_resident import assert_impact_run_matches
from test_torch_slab_step import SCENE as SLAB_SCENE
from test_torch_slab_step import CAPACITY as SLAB_CAPACITY, PARAMS as SLAB_PARAMS
from test_torch_step import assert_states_match, run_pair

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_nowcache_ref.npz")
WCSPH = dict(viscosity_type=VT.WCSPH, viscosity=0.003)

# the impact scene's families, one per run of stress.nowcache_runs (and XSPH)
IMPACT_CASES = {
    "hybrid": dict(method=M.HybridDFSPH, resident=False),
    "w2020_resident": dict(method=M.HybridDFSPH, operator_discretization=OD.Winchenbach2020),
    "wcsph_after_div": dict(method=M.HybridDFSPH, resident=False,
                            hybrid_dfsph_non_pressure_accel_before_divergence_free=False,
                            **WCSPH),
    "iisph2_wcsph": dict(method=M.IISPH2, resident=False, **WCSPH),
    "xsph": dict(method=M.HybridDFSPH, resident=False, viscosity_type=VT.XSPH, viscosity=0.0),
}
DAM_STEPS = 3


@pytest.fixture
def sweep_only(monkeypatch):
    monkeypatch.setenv("ASPH_NO_WCACHE", "1")


@pytest.mark.parametrize("case", list(IMPACT_CASES))
def test_impact_steps_match_jax(sweep_only, case):
    kw = dict(IMPACT_CASES[case])
    js, diags = assert_impact_run_matches(case, impact_params(kw.pop("method"), **kw))
    for dj, d in diags:
        assert int(d["negative_aii"]) == int(dj["negative_aii"])
        assert d["num_pairs"] == 0  # no pair list


def test_dambreak_steps_match_jax(sweep_only):
    params, scene, _, _ = nowcache_runs()["dambreak_nowcache"]
    js, ts, diags = run_pair(j_params.params_from_dict(convert.params_to_dict(params)), scene,
                             None, DAM_STEPS)
    for k, (dj, d) in enumerate(diags):
        for name in ("div_iterations", "density_iterations", "negative_aii"):
            assert int(d[name]) == int(dj[name]), (name, k)
        assert d["dt"] == pytest.approx(float(dj["dt"]), rel=1e-6)
    assert ts.num_fluid_particles == js.num_fluid_particles
    assert ts.state.capacity == js.state.capacity
    assert_states_match(js, ts)
    a, b = js.state, ts.state
    np.testing.assert_allclose(b.mass.numpy()[b.alive.numpy()].sum(),
                               np.asarray(a.mass)[np.asarray(a.alive)].sum(), rtol=1e-5)


@pytest.mark.parametrize("resident", [False, True])
def test_branch_builds_no_list_and_runs_no_whole_solve(sweep_only, monkeypatch, resident):
    # K1 (every mode), K2 / K3 and the whole-solve kernels are never called,
    # whatever resident_solver and ASPH_SCALAR_BLOCKS say; the sweeps are
    def refuse(name):
        def f(*a, **k):
            raise AssertionError(f"{name} called on the sweep-only branch")
        return f

    for mod, name in ((pair_ops, "pair_build"), (pair_ops, "pair_matvec"),
                      (pair_ops, "pair_visc"), (pair_ops, "pair_matvec_scalar"),
                      (pair_ops, "pair_visc_scalar"), (jacobi, "jacobi_solve"),
                      (jacobi, "hybrid_solve"), (t_tp, "tile_jacobi_resident"),
                      (t_tp, "tile_hybrid_resident")):
        monkeypatch.setattr(mod, name, refuse(name))
    monkeypatch.setenv("ASPH_SCALAR_BLOCKS", "1")
    sim = t_create(impact_params(M.HybridDFSPH, resident=resident), impact_scene(),
                   capacity=IMPACT_CAPACITY, device="cpu")
    seen = set()
    real = t_tp.tile_jacobi

    def jacobi_spy(accel_fn, div_fn, *a, **k):
        seen.add(getattr(accel_fn, "__name__", ""))
        seen.add(getattr(div_fn, "__name__", ""))
        return real(accel_fn, div_fn, *a, **k)

    monkeypatch.setattr(t_tp, "tile_jacobi", jacobi_spy)
    for _ in range(2):
        d = sim.step()
        assert d["num_pairs"] == 0 and d["div_iterations"] >= 2
    assert seen == {"accel_fn_sweep", "div_fn_sweep"}


def test_variable_is_read_at_every_step(monkeypatch):
    # the same simulation takes the list branch without the variable and the
    # sweep-only branch with it
    sim = t_create(impact_params(M.HybridDFSPH, resident=False), impact_scene(),
                   capacity=IMPACT_CAPACITY, device="cpu")
    assert sim.step()["num_pairs"] > 0
    monkeypatch.setenv("ASPH_NO_WCACHE", "1")
    assert sim.step()["num_pairs"] == 0
    monkeypatch.delenv("ASPH_NO_WCACHE")
    assert sim.step()["num_pairs"] > 0


# ---------------------------------------------------------------------------
# the fixture of the GPU runs

def ref_script():
    """scripts/torch_port_nowcache_ref.py as a module."""
    import importlib.util

    path = os.path.join(ROOT, "scripts", "torch_port_nowcache_ref.py")
    spec = importlib.util.spec_from_file_location("torch_port_nowcache_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


PER_STEP = ("dt", "div_iterations", "density_iterations", "negative_aii", "n", "capacity")
STATE = ("position", "velocity", "density", "pressure", "mass")


def test_fixture_holds_every_run():
    ref = np.load(FIXTURE)
    for run, (_, _, _, steps) in nowcache_runs().items():
        for k in PER_STEP:
            assert ref[f"{run}__{k}"].shape == (steps,), (run, k)
        n = ref[f"{run}__position"].shape[0]
        assert n > 0 and n == ref[f"{run}__n"][-1], run
        assert all(ref[f"{run}__{k}"].shape[0] == n for k in STATE), run
        assert np.isfinite(ref[f"{run}__position"]).all()
    # the dam break grows its capacity, the impact run's solves iterate
    params, scene, _, _ = nowcache_runs()["dambreak_nowcache"]
    start = t_create(params, t_scene.scene_from_dict(scene), device="cpu").state.capacity
    assert ref["dambreak_nowcache__capacity"].max() > start
    assert ref["impact_nowcache_resident__div_iterations"].max() >= 13


def test_fixture_small_run_is_the_jax_package_and_the_port_matches_it(monkeypatch):
    run = "impact_nowcache_resident"
    params, scene, capacity, steps = nowcache_runs()[run]
    ref = np.load(FIXTURE)
    state, per_step = ref_script().reference_run(params, scene, capacity, steps)
    assert "ASPH_NO_WCACHE" not in os.environ  # the script restores the environment
    for k, v in {**state, **per_step}.items():
        np.testing.assert_array_equal(v, ref[f"{run}__{k}"], err_msg=k)
    monkeypatch.setenv("ASPH_NO_WCACHE", "1")
    ts = t_create(params, t_scene.scene_from_dict(scene), capacity=capacity, device="cpu")
    for k in range(steps):
        d = ts.step()
        for name in ("div_iterations", "density_iterations", "negative_aii"):
            assert int(d.get(name, -1)) == ref[f"{run}__{name}"][k], (name, k)
    st = ts.state
    a = st.alive.numpy()
    from scipy.spatial import cKDTree

    _, j = cKDTree(st.position.numpy()[a]).query(ref[f"{run}__position"], k=1)
    assert (np.sort(j) == np.arange(a.sum())).all()

    def got(name):
        return getattr(st, name).numpy()[a][j]

    np.testing.assert_allclose(got("position"), ref[f"{run}__position"], atol=2e-5)
    np.testing.assert_allclose(got("velocity"), ref[f"{run}__velocity"], atol=2e-4)
    np.testing.assert_allclose(got("density"), ref[f"{run}__density"], rtol=2e-5)


# ---------------------------------------------------------------------------
# the slab step

def test_slab_step_equals_the_one_device_run(sweep_only):
    # 2 gloo ranks (spawned: they inherit the variable) against one device,
    # with the tolerances of tests/test_multichip.py and equal iterations
    steps = 4
    pd = convert.params_to_dict(convert.params_from_dict(dataclasses.asdict(SLAB_PARAMS)))
    params = convert.params_from_dict(pd)
    one = t_create(params, t_scene.scene_from_dict(SLAB_SCENE), capacity=SLAB_CAPACITY,
                   device="cpu")
    ref_diags = [one.step() for _ in range(steps)]
    assert all(d["num_pairs"] == 0 for d in ref_diags)
    res = run_ranks(SlabJob(params=pd, scene=SLAB_SCENE, steps=steps, capacity=SLAB_CAPACITY),
                    2, "gloo", "cpu")
    x = tts.gather_alive(res["final"])["position"][:, 0]
    assert (x < res["scfg"].edges[1]).any() and (x >= res["scfg"].edges[1]).any()
    for k, (d1, ds) in enumerate(zip(ref_diags, res["diags"])):
        for key in ("div_iterations", "density_iterations"):
            assert ds.get(key) == d1.get(key), (k, key)
    got, want = tts.gather_alive(res["final"]), tts.gather_alive(one.state)
    assert got["position"].shape == want["position"].shape
    np.testing.assert_allclose(got["position"], want["position"], atol=5e-5)
    np.testing.assert_allclose(got["velocity"], want["velocity"], atol=5e-4)
    np.testing.assert_allclose(got["density"], want["density"], rtol=1e-4)
