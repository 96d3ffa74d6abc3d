"""PyTorch port, the whole step: N steps of the port against the JAX package's
tile backend on the same scene and parameters.

Particles are matched by position (both packages return their state in the
step's sorted order; the match must be a bijection). Tolerances, those of the
reference's own backend differential: positions atol 2e-5, density rtol 2e-5,
velocity atol 2e-4. The divergence and density iteration counts must be EQUAL
at every step, in the parity options and with warm start + momentum 0.9.
bf16 pair storage is judged by convergence, as the reference judges it.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from adaptive_sph_torch import convert
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.runner import SimulationFailed, create_simulation as t_create
from adaptive_sph_torch.stress import IMPACT_CAPACITY, IMPACT_SCENE, impact_params
from adaptive_sph_torch.utils import params as t_params
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.runner import create_simulation as j_create
from adaptive_sph_tpu.utils import params as j_params
from adaptive_sph_tpu.utils.params import (
    HybridDfsphDensitySourceTerm,
    InitBoundaryHandlerType,
    ParticleSizes,
    SimulationParams,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def dam_scene(spacing2=None):
    blocks = [{"pos": [0.4, -0.5], "size": [0.55, 1.4], "spacing": 0.06,
               "volume_fill_ratio": 0.93, "velocity": [0, 0]}]
    if spacing2:
        blocks.append({"pos": [-0.95, -0.5], "size": [0.55, 1.4], "spacing": spacing2,
                       "volume_fill_ratio": 0.93, "velocity": [0, 0]})
    return {"boundary": {"type": "box", "width": 2, "height": 2}, "blocks": blocks}


UNIFORM = dict(particle_sizes=ParticleSizes.Uniform, merging=False, sharing=False,
               splitting=False, max_iters=60)
CROSS = dict(merging=False, sharing=False, splitting=False, max_iters=60,
             hybrid_dfsph_max_avg_density_error=0.001,
             hybrid_dfsph_max_avg_divergence_error=0.0001,
             hybrid_dfsph_factor=1000000.0, cfl_factor=0.3, max_dt=0.003)
WARM = dict(warm_start_pressure=True, jacobi_momentum=0.9, max_iters=120)

CASES = {
    "cross_level": (CROSS, dam_scene(0.05), None, 3),
    "uniform_dam": (UNIFORM, dam_scene(), 1024, 5),
    "cross_level_warm_momentum": ({**CROSS, **WARM}, dam_scene(0.05), None, 3),
    "uniform_dam_warm_momentum": ({**UNIFORM, **WARM}, dam_scene(), 1024, 5),
    "uniform_polygon_only_density": (
        {**UNIFORM, "init_boundary_handler": InitBoundaryHandlerType.AnalyticUnderestimate,
         "hybrid_dfsph_density_source_term": HybridDfsphDensitySourceTerm.OnlyDensity},
        dam_scene(), 1024, 3),
}


def run_pair(params, scene, capacity, steps):
    """Both packages from the same parameters and scene; per-step diagnostics."""
    js = j_create(params, j_scene.scene_from_dict(scene), capacity=capacity, backend="tiles")
    ts = t_create(convert.params_from_dict(dataclasses.asdict(params)),
                  t_scene.scene_from_dict(scene), capacity=capacity, device="cpu")
    assert ts.tile_cfg.populated == js.tile_cfg.populated and ts.tile_cfg.tq == js.tile_cfg.tq
    diags = []
    for _ in range(steps):
        dj, dt_ = js.step(), ts.step()
        diags.append((dj, dt_))
    return js, ts, diags


def assert_states_match(js, ts):
    a, b = js.state, ts.state
    aa, ba = np.asarray(a.alive), b.alive.numpy()
    assert int(a.n) == int(b.n) and aa.sum() == ba.sum()
    pa, pb = np.asarray(a.position)[aa], b.position.numpy()[ba]
    _, j = cKDTree(pb).query(pa, k=1)
    assert (np.sort(j) == np.arange(len(pb))).all(), "position match not a bijection"
    np.testing.assert_allclose(pb[j], pa, atol=2e-5)
    np.testing.assert_allclose(b.density.numpy()[ba][j], np.asarray(a.density)[aa], rtol=2e-5)
    np.testing.assert_allclose(b.velocity.numpy()[ba][j], np.asarray(a.velocity)[aa], atol=2e-4)
    return j


@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax(case):
    kw, scene, capacity, steps = CASES[case]
    js, ts, diags = run_pair(SimulationParams(**kw), scene, capacity, steps)
    for k, (dj, dt_) in enumerate(diags):
        assert dt_["div_iterations"] == int(dj["div_iterations"]), (case, k)
        assert dt_["density_iterations"] == int(dj["density_iterations"]), (case, k)
        assert dt_["dt"] == pytest.approx(float(dj["dt"]), rel=1e-6)
        assert dt_["negative_aii"] == 0 and dt_["wcache_overflow"] == 0
    j = assert_states_match(js, ts)
    # the returned order is the step's sorted layout, the same in both packages
    assert (j == np.arange(len(j))).all()


def test_bf16_storage_converges():
    # bf16 pair storage: every solve still reaches its tolerance against the
    # rounded operator, and the trajectory stays close to the f32 one
    base = SimulationParams(**{**UNIFORM, "max_iters": 120})
    out = {}
    for bf16 in (False, True):
        sim = t_create(convert.params_from_dict(dataclasses.asdict(
            base.replace(weight_cache_bf16=bf16))), t_scene.scene_from_dict(dam_scene()),
            capacity=1024, device="cpu")
        tol = sim.params.hybrid_dfsph_max_avg_density_error * sim.params.rest_density
        for _ in range(4):
            d = sim.step()
            err = d["density_avg_error"]
            assert not err == err or abs(err) < tol
        out[bf16] = sim.state
    pa = out[False].position.numpy()[out[False].alive.numpy()]
    pb = out[True].position.numpy()[out[True].alive.numpy()]
    _, j = cKDTree(pb).query(pa, k=1)
    assert (np.sort(j) == np.arange(len(pb))).all()
    np.testing.assert_allclose(pb[j], pa, atol=2e-3)


def test_simulation_api():
    p = convert.params_from_dict(dataclasses.asdict(SimulationParams(**UNIFORM)))
    sim = t_create(p, t_scene.scene_from_dict(dam_scene()), capacity=1024, device="cpu")
    assert sim.num_fluid_particles == int(sim.state.alive.sum()) and sim.device.type == "cpu"
    diags = sim.step_chunk(2)
    assert len(diags["dt"]) == 2 and all(v > 0 for v in diags["div_iterations"])
    steps = sim.run_until(sim.time + 0.01)
    assert steps >= 1 and int(sim.state.step_number) == 2 + steps
    assert sim.counters.values["particle-count"][-1] == sim.num_fluid_particles
    assert len(sim.counters.times["simulation-step"]) == 2 + steps


def test_simulation_failed_on_negative_aii(monkeypatch):
    p = convert.params_from_dict(dataclasses.asdict(SimulationParams(**UNIFORM)))
    sim = t_create(p, t_scene.scene_from_dict(dam_scene()), capacity=1024, device="cpu")
    inner = sim.step_fn

    def bad_step(state, step_number):
        s, d = inner(state, step_number)
        d["negative_aii"] = torch.tensor(3)
        return s, d

    sim.step_fn = bad_step
    before = sim.state
    with pytest.raises(SimulationFailed):
        sim.step()
    assert sim.state is before and sim.step_number == 0


def test_overflow_grows_capacity_and_retries():
    # a row overflow below the top level: the state has not advanced, so the
    # runner grows the capacity and runs the step again at the new size
    p = convert.params_from_dict(dataclasses.asdict(SimulationParams(**UNIFORM)))
    sim = t_create(p, t_scene.scene_from_dict(dam_scene()), capacity=1024, device="cpu")
    n0 = sim.num_fluid_particles
    calls = []

    def wrap(inner):
        def step(state, step_number):
            s, d = inner(state, step_number)
            calls.append(state.capacity)
            if len(calls) == 1:
                ro, co, lo = d["neighbor_overflow"]
                d["neighbor_overflow"] = (torch.ones_like(ro), co, lo)
            return s, d
        return step

    sim.step_fn = wrap(sim.step_fn)
    build = sim.grow_capacity

    def grow(factor=2):
        build(factor)
        sim.step_fn = wrap(sim.step_fn)

    sim.grow_capacity = grow
    sim.step()
    assert calls == [1024, 2048] and sim.state.capacity == 2048
    assert sim.num_fluid_particles == n0 and int(sim.state.step_number) == 1
    assert sim.step_number == 1


def test_simulation_failed_on_mass_loss():
    p = convert.params_from_dict(dataclasses.asdict(SimulationParams(**UNIFORM)))
    sim = t_create(p, t_scene.scene_from_dict(dam_scene()), capacity=1024, device="cpu")
    inner = sim.step_fn

    def lossy(state, step_number):
        s, d = inner(state, step_number)
        d["mass_conservation_error"] = torch.tensor(0.01)
        return s, d

    sim.step_fn = lossy
    before = sim.state
    with pytest.raises(SimulationFailed, match="mass not conserved"):
        sim.step()
    assert sim.state is before


def test_asph_tq_override_matches_jax(monkeypatch):
    # ASPH_TQ picks the query-tile width in both packages (the reference's
    # experiment knob): the impact scene (capacity 1,024, whose default tq is
    # 128) at tq = 64, two streamed HybridDFSPH steps held to the impact
    # scene's tolerances (tests/test_torch_resident.py)
    monkeypatch.setenv("ASPH_TQ", "64")
    params = impact_params(t_params.PressureSolverMethod.HybridDFSPH, resident=False)
    js = j_create(j_params.params_from_dict(convert.params_to_dict(params)),
                  j_scene.scene_from_dict(IMPACT_SCENE), capacity=IMPACT_CAPACITY,
                  backend="tiles", counters_enabled=False)
    ts = t_create(params, t_scene.scene_from_dict(IMPACT_SCENE), capacity=IMPACT_CAPACITY,
                  device="cpu")
    assert ts.tile_cfg.tq == js.tile_cfg.tq == 64
    for k in range(2):
        dj, d = js.step(), ts.step()
        for name in ("div_iterations", "density_iterations"):
            assert d[name] == int(dj[name]), (name, k)
        assert np.float32(d["dt"]) == pytest.approx(float(dj["dt"]), rel=1e-4)
    assert_states_match(js, ts)


@pytest.mark.parametrize("tq,capacity", [("24", 1024), ("12", 1536), ("0", 1024)])
def test_asph_tq_rejects_widths_the_layout_does_not_take(monkeypatch, tq, capacity):
    # 24 does not divide 1,024; 12 divides 1,536 but is no multiple of the
    # layout's 8-lane hull groups; 0 is no width
    monkeypatch.setenv("ASPH_TQ", tq)
    p = t_params.params_from_dict({"merging": False, "sharing": False, "splitting": False})
    with pytest.raises(NotImplementedError, match="ASPH_TQ"):
        t_create(p, t_scene.scene_from_dict(dam_scene()), capacity=capacity, device="cpu")


@pytest.mark.parametrize("change", [
    {"level_estimation_method": "CenterDiff", "splitting": True},
    {"support_length_estimation": "FromDistribution", "merging": False, "sharing": False,
     "splitting": False},
    {"support_length_estimation": "FromDistributionClamped1"},
    {"init_boundary_handler": "Particles", "particle_sizes": "Uniform"},
    {"constrain_neighborhood_count": True},
    # the XSPH viscosity (the reference's tile path has no first-kick XSPH
    # but treats it as ApproxLaplace after the divergence solve)
    {"viscosity_type": "XSPH"},
    {"level_estimation_after_advection": True, "splitting": True},
    {"fill_stash_with": "SurfaceDistanceMiddle"},
    {"check_aii": True},
])
def test_unsupported_settings_raise(change):
    base = {"merging": False, "sharing": False, "splitting": False}
    p = t_params.params_from_dict({**base, **change})
    with pytest.raises(NotImplementedError):
        t_create(p, t_scene.scene_from_dict(dam_scene()), capacity=1024, device="cpu")


def test_entry_points_need_cuda_unless_asked_for_the_cpu():
    # the entry points run on the card by default and never fall back quietly
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    p = convert.params_from_dict(dataclasses.asdict(SimulationParams(**UNIFORM)))
    scene = t_scene.scene_from_dict(dam_scene())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_create(p, scene, capacity=1024)
    with pytest.raises(RuntimeError):
        t_scene.init_fluid_state(scene, p, 1024)
    sim = t_create(p, scene, capacity=1024, device="cpu")
    with pytest.raises(RuntimeError):
        convert.state_from_numpy(convert.state_to_numpy(sim.state))


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import adaptive_sph_torch.runner, adaptive_sph_torch.convert\n"
            "import adaptive_sph_torch.ops.pair_ops, adaptive_sph_torch.ops._native\n"
            "import adaptive_sph_torch.ops.jacobi, adaptive_sph_torch.stress\n"
            "import adaptive_sph_torch.ops.sweeps, adaptive_sph_torch.models.adaptivity\n"
            "import adaptive_sph_torch.utils.split_patterns, adaptive_sph_torch.cli\n"
            "import adaptive_sph_torch.timing, adaptive_sph_torch.probe\n"
            "import adaptive_sph_torch.ops.probes\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax',"
            " 'adaptive_sph_tpu')]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
