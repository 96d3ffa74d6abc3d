"""PyTorch port, the dense grid engine's whole step (`backend="grid"`) against
the JAX package's grid step.

Each case runs both packages' `create_simulation(..., backend="grid")` (JAX
on the CPU, the port with device="cpu") on the same scene for its steps:
at every step the iteration counts equal and dt within 1e-6 (the pair sums
add in another order than XLA's, so velocities and the CFL minimum may sit
an ulp apart); at the end,
row by row (both keep the particle order), positions atol 2e-5, density
rtol 2e-5, velocity atol 2e-4 (PERF.md section 2), and where the case
exercises them levels atol 2e-5, the surface and insufficient flags,
has_level and the stash equal, h / h_next rtol 2e-5, the neighbour count
equal and the constant field atol 2e-5.

- tests/test_grid_engine.py's uniform scene under IISPH and HybridDFSPH, and
  with EmptyAngle levels before advection (force_level_estimation);
- the same block thrown at the floor (velocity (1.5, -3)), so that the
  solves iterate: OnlyDivergence with warm_start_pressure, and IISPH2 with
  Winchenbach2020 and the WCSPH viscosity;
- stress.GRID_ADAPTIVE_SCENE without resampling, h from FromDistribution2
  with the diagnostic fields, one step; at the second, h has outgrown the
  populated levels and both packages stop with the same level overflow;
- the default dam break without resampling (stress.grid_runs()
  "dambreak_grid"), 3 steps.

The runs of `stress.grid_runs()` at their full length are held to
tests/data/torch_port_grid_ref.npz on the card (chip_smoke.py G1-G2): the
port's CPU step of the resampling run takes minutes here (4 populated levels
of 40-slot cells), so it is not repeated on the CPU.
"""

import numpy as np
import pytest
import torch

from adaptive_sph_torch import convert
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.runner import SimulationFailed
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.stress import GRID_ADAPTIVE_SCENE, grid_runs
from adaptive_sph_torch.utils.params import (
    InitBoundaryHandlerType,
    LevelEstimationMethod,
    OperatorDiscretization,
    ParticleSizes,
    PressureSolverMethod,
    SimulationParams,
    SupportLengthEstimation,
    ViscosityType,
)
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.runner import SimulationFailed as JFailed
from adaptive_sph_tpu.runner import create_simulation as j_create
from adaptive_sph_tpu.utils import params as j_params

torch.set_num_threads(2)


def block_scene(velocity=(0.0, 0.0)):
    return {"boundary": {"type": "box", "width": 1.0, "height": 1.0},
            "blocks": [{"pos": [-0.45, -0.45], "size": [0.5, 0.7], "spacing": 0.05,
                        "volume_fill_ratio": 0.93, "velocity": list(velocity)}]}


UNIFORM = dict(particle_sizes=ParticleSizes.Uniform,
               init_boundary_handler=InitBoundaryHandlerType.AnalyticOverestimate,
               level_estimation_method=LevelEstimationMethod.NoneMethod,
               merging=False, sharing=False, splitting=False, max_iters=60)
M = PressureSolverMethod
THROWN = block_scene((1.5, -3.0))

# case -> (params, scene, capacity, steps)
CASES = {
    "uniform_iisph": (SimulationParams(pressure_solver_method=M.IISPH, **UNIFORM),
                      block_scene(), 1024, 3),
    "uniform_hybrid": (SimulationParams(pressure_solver_method=M.HybridDFSPH, **UNIFORM),
                       block_scene(), 1024, 3),
    "uniform_levels_emptyangle": (
        SimulationParams(pressure_solver_method=M.IISPH, **{
            **UNIFORM, "level_estimation_method": LevelEstimationMethod.EmptyAngle},
            force_level_estimation=True, maximum_surface_distance=0.3),
        block_scene(), 1024, 3),
    "thrown_only_divergence_warm": (
        SimulationParams(pressure_solver_method=M.OnlyDivergence, warm_start_pressure=True,
                         **UNIFORM), THROWN, 1024, 3),
    "thrown_iisph2_w2020_wcsph": (
        SimulationParams(pressure_solver_method=M.IISPH2,
                         operator_discretization=OperatorDiscretization.Winchenbach2020,
                         viscosity_type=ViscosityType.WCSPH, viscosity=0.003, **UNIFORM),
        THROWN, 1024, 3),
    "adaptive_from_distribution2": (
        SimulationParams(merging=False, sharing=False, splitting=False,
                         support_length_estimation=SupportLengthEstimation.FromDistribution2,
                         force_diagnostic_fields=True, particle_radius_base=0.02,
                         particle_radius_fine=0.01),
        GRID_ADAPTIVE_SCENE, None, 1),
    # the default dam break without resampling: 2 populated levels, capacity 2,048
    "dambreak": grid_runs()["dambreak_grid"][:3] + (3,),
}
# h from the distribution outgrows the populated levels of a run without
# resampling: both packages stop at its second step with the same level overflow
THEN_LEVEL_OVERFLOW = {"adaptive_from_distribution2": 26}
ITERS = ("div_iterations", "density_iterations")


@pytest.mark.parametrize("case", list(CASES))
def test_grid_step_matches_jax(case):
    params, scene, capacity, steps = CASES[case]
    js = j_create(j_params.params_from_dict(convert.params_to_dict(params)),
                  j_scene.scene_from_dict(scene), capacity=capacity, backend="grid")
    ts = t_create(params, t_scene.scene_from_dict(scene), capacity=capacity, device="cpu",
                  backend="grid")
    assert ts.backend == "grid" and ts.state.position.device.type == "cpu"
    assert ts.grid_cfg.mpc == js.grid_cfg.mpc and ts.grid_cfg.populated == js.grid_cfg.populated
    iters = []
    for k in range(steps):
        dj, dt_ = js.step(), ts.step()
        for name in ITERS + ("negative_aii",):
            if name in dj:
                assert dt_[name] == int(dj[name]), (name, k)
        # dt = min_i (...|v_i|...): velocities an ulp apart move it by an ulp
        np.testing.assert_allclose(dt_["dt"], float(dj["dt"]), rtol=1e-6, err_msg=str(k))
        iters.append(tuple(dt_.get(n, 0) for n in ITERS))
    a = np.asarray(js.state.alive)
    assert np.array_equal(ts.state.alive.numpy(), a)
    want = {k: np.asarray(getattr(js.state, k))[a] for k in (
        "position", "velocity", "density", "level", "stash", "has_level", "h", "h_next",
        "flag_is_fluid_surface", "flag_insufficient_neighs", "neighbor_count",
        "constant_field", "pressure")}
    got = {k: getattr(ts.state, k).numpy()[a] for k in want}
    np.testing.assert_allclose(got["position"], want["position"], atol=2e-5)
    np.testing.assert_allclose(got["density"], want["density"], rtol=2e-5)
    np.testing.assert_allclose(got["velocity"], want["velocity"], atol=2e-4)
    np.testing.assert_allclose(got["level"], want["level"], atol=2e-5)
    np.testing.assert_allclose(got["constant_field"], want["constant_field"], atol=2e-5)
    np.testing.assert_allclose(got["h"], want["h"], rtol=2e-5)
    np.testing.assert_allclose(got["h_next"], want["h_next"], rtol=2e-5)
    for k in ("stash", "has_level", "flag_is_fluid_surface", "flag_insufficient_neighs",
              "neighbor_count"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if case.startswith("thrown"):
        assert max(max(i) for i in iters) > 2, iters  # the solves iterate
    if case == "uniform_levels_emptyangle":
        assert want["flag_is_fluid_surface"].any() and want["has_level"].all()
    if case in THEN_LEVEL_OVERFLOW:
        assert (want["neighbor_count"] > 0).all() and len(np.unique(want["h_next"])) > 2
        with pytest.raises(JFailed, match=f"level={THEN_LEVEL_OVERFLOW[case]} "):
            js.step()
        with pytest.raises(SimulationFailed, match=f"level={THEN_LEVEL_OVERFLOW[case]}$"):
            ts.step()
        assert ts.step_number == steps
