"""PyTorch port, the list backend's physics, solve, levels and boundary terms
against the JAX package, function by function.

Both packages build their own list structure from the same seeded state
(scene-ratio2to1 as surface-detection.yaml runs it, positions jittered by a
tenth of h and velocities drawn from a seeded normal, so cross-level pairs
and the SDF boundary take part; the particle (Akinci) boundary on the
default dam scene under uniform sizes). Every function of
models/physics.py, models/solver.py, models/level.py, the boundary's
element-wise and factored terms and check_aii then take the same inputs
(densities and fields from numpy) on both sides:

- sums within rtol 2e-5 of the JAX package's, with an absolute floor of 2e-5
  times the largest magnitude of the array (the fields cross zero);
- the solve: equal iteration counts, pressure within the same bound;
- levels: atol 2e-5; surface, insufficient and has_level flags and the
  stash equal.

Then the particle (Akinci) boundary's whole list step (the default dam scene
under uniform sizes, as tests/test_e2e_uniform.py runs it on the reference's
lists): 3 steps of both packages, equal iteration counts and dt, positions
atol 2e-5, density rtol 2e-5, velocity atol 2e-4, row by row.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sph_torch import convert
from adaptive_sph_torch.models import boundary as t_bnd
from adaptive_sph_torch.models import debug_checks as t_dc
from adaptive_sph_torch.models import level as t_level
from adaptive_sph_torch.models import physics as t_phys
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.models import simulation as t_sim
from adaptive_sph_torch.models import solver as t_solver
from adaptive_sph_torch.ops import edge_cache as t_ec
from adaptive_sph_torch.ops import neighbors as t_nbr
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.stress import akinci_dam_scene, list_runs
from adaptive_sph_torch.utils.params import (
    FillStashWith,
    InitBoundaryHandlerType,
    LevelEstimationMethod,
    OperatorDiscretization,
    ParticleSizes,
    PressureSolverMethod,
    SupportLengthEstimation,
    ViscosityType,
)
from adaptive_sph_tpu.models import boundary as j_bnd
from adaptive_sph_tpu.models import debug_checks as j_dc
from adaptive_sph_tpu.models import level as j_level
from adaptive_sph_tpu.models import physics as j_phys
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.models import simulation as j_sim
from adaptive_sph_tpu.models import solver as j_solver
from adaptive_sph_tpu.ops import edge_cache as j_ec
from adaptive_sph_tpu.ops import neighbors as j_nbr
from adaptive_sph_tpu.runner import create_simulation as j_create
from adaptive_sph_tpu.utils import params as j_params

torch.set_num_threads(2)
RTOL = 2e-5


def close(got, want, name="", rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if want.size else 0.0
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale, err_msg=name)


@dataclasses.dataclass
class Side:
    """One package's inputs: params, state arrays, structure, cache, boundary."""

    params: object
    pos: object
    vel: object
    mass: object
    h: object
    alive: object
    nb: object
    cache: object
    bt: object
    bst: object
    rho: object = None
    handler: object = None
    size_class: object = None


def build(params_t, scene: dict, seed: int = 0):
    """(torch Side, JAX Side, numpy state) of the scene's seeded state."""
    ts = t_create(params_t, t_scene.scene_from_dict(scene), device="cpu", backend="lists")
    js = j_create(j_params.params_from_dict(convert.params_to_dict(params_t)),
                  j_scene.scene_from_dict(scene), backend="lists")
    arr = convert.state_to_numpy(ts.state)
    alive = arr["alive"]
    rng = np.random.default_rng(seed)
    adaptive = ts.params.particle_sizes == ParticleSizes.Adaptive
    h = (np.asarray(j_sim.kernels.smoothing_length_from_mass(jnp.asarray(arr["mass"]), 1.0, 2))
         if adaptive else np.full(len(alive), ts.params.h, np.float32))
    arr["position"][alive] += (rng.normal(size=(alive.sum(), 2)) * 0.1 * h[alive, None]
                               ).astype(np.float32)
    arr["velocity"][alive] = rng.normal(0.0, 0.3, size=(alive.sum(), 2)).astype(np.float32)
    h = h.astype(np.float32)
    ncfg = js.ncfg
    sides = []
    for pkg, sim in (("t", ts), ("j", js)):
        if pkg == "t":
            T = torch.from_numpy
            nb = t_nbr.build_neighborhood(T(arr["position"]), T(h), T(alive), 2.0,
                                          t_nbr.NeighborConfig(ncfg.capacity, ncfg.row_width,
                                                               ncfg.levels, ncfg.max_per_cell))
            cache = t_ec.build_edge_cache(nb, T(arr["position"]), T(h), T(arr["mass"]))
            bmod = t_bnd
        else:
            T = jnp.asarray
            nb = j_nbr.build_neighborhood(T(arr["position"]), T(h), T(alive), jnp.float32(2.0),
                                          ncfg)
            # compiled, as the step compiles it (XLA contracts r^2 into an FMA)
            cache = jax.jit(j_ec.build_edge_cache)(nb, T(arr["position"]), T(h), T(arr["mass"]))
            bmod = j_bnd
        bt = sim.boundary_handler.update_after_advect(T(arr["position"]), T(h), sim.params)
        sides.append(Side(params=sim.params, pos=T(arr["position"]), vel=T(arr["velocity"]),
                          mass=T(arr["mass"]), h=T(h), alive=T(alive), nb=nb, cache=cache, bt=bt,
                          bst=bmod.solver_terms(bt, T(arr["position"]), T(h), sim.params),
                          handler=sim.boundary_handler, size_class=T(arr["size_class"])))
    t, j = sides
    for f in ("idx", "mask", "cross", "count"):
        np.testing.assert_array_equal(getattr(t.nb, f).numpy(), np.asarray(getattr(j.nb, f)))
    # densities: each side's own, then the JAX package's on both sides
    rho_t = t_phys.compute_density(t.nb, t.cache, t.bt, t.pos, t.h, t.params, t.mass)
    rho_j = j_phys.compute_density(j.nb, j.cache, j.bt, j.pos, j.h, j.params, j.mass)
    close(rho_t, rho_j, "density")
    rho = np.where(alive, np.asarray(rho_j), 1.0).astype(np.float32)
    t.rho, j.rho = torch.from_numpy(rho), jnp.asarray(rho)
    t.cache = t_ec.with_density(t.cache, t.nb, t.rho)
    j.cache = j_ec.with_density(j.cache, j.nb, j.rho)
    return t, j, arr


def surface_params(**kw):
    params, _, _, _ = list_runs()["surface_emptyangle"]
    return dataclasses.replace(params, **kw)


SURFACE_SCENE = list_runs()["surface_emptyangle"][1]


@pytest.fixture(scope="module")
def sdf():
    return build(surface_params(), SURFACE_SCENE)


@pytest.fixture(scope="module")
def particles():
    params = surface_params(particle_sizes=ParticleSizes.Uniform,
                            init_boundary_handler=InitBoundaryHandlerType.Particles)
    return build(params, akinci_dam_scene(), seed=1)


def with_params(side, **kw):
    return dataclasses.replace(side, params=side.params.replace(**kw))


def test_density_constant_field_and_h_estimates(sdf):
    t, j, _ = sdf
    close(t_phys.compute_constant_field(t.nb, t.cache, t.bt, t.pos, t.h, t.params, t.mass, t.rho),
          j_phys.compute_constant_field(j.nb, j.cache, j.bt, j.pos, j.h, j.params, j.mass, j.rho),
          "constant field")
    for clamp in (None, 1.0, 2.0):
        close(t_sim.estimate_h_next_from_distribution(t.nb, t.cache, t.bt, t.mass, t.h, t.params,
                                                      clamp),
              j_sim.estimate_h_next_from_distribution(j.nb, j.cache, j.bt, j.mass, j.h, j.params,
                                                      clamp), f"h_next clamp {clamp}")
    close(t_sim.estimate_h_next_from_distribution2(t.nb, t.cache, t.bt, t.mass, t.h, t.params),
          j_sim.estimate_h_next_from_distribution2(j.nb, j.cache, j.bt, j.mass, j.h, j.params),
          "h_next 2")
    close(t_phys.cfl_dt(t.vel, t.h, t.alive, t.params),
          j_phys.cfl_dt(j.vel, j.h, j.alive, j.params))
    close(t_phys.effective_h(t.h, t.params), j_phys.effective_h(j.h, j.params))


@pytest.mark.parametrize("mode", ["ApproxLaplace", "WCSPH", "pull", "XSPH"])
def test_non_pressure_accel(sdf, mode):
    t, j, _ = sdf
    kw = {"viscosity_type": ViscosityType(mode)} if mode != "pull" else {
        "pull_fluid_to": (0.3, -0.2)}
    if mode == "XSPH":
        kw["viscosity"] = 0.0
    t = with_params(t, **kw)
    j = dataclasses.replace(j, params=jparams(t))
    close(t_phys.non_pressure_accel(t.nb, t.cache, t.pos, t.vel, t.rho, t.mass, t.params),
          j_phys.non_pressure_accel(j.nb, j.cache, j.pos, j.vel, j.rho, j.mass, j.params), mode)


def jparams(t):
    return j_params.params_from_dict(convert.params_to_dict(t.params))


@pytest.mark.parametrize("od", ["ConsistentSimpleGradient", "ConsistentSymmetricGradient",
                                "Winchenbach2020"])
def test_operators_aii_and_sources(sdf, od):
    t, j, arr = sdf
    t = with_params(t, operator_discretization=OperatorDiscretization(od))
    j = dataclasses.replace(j, params=jparams(t))
    rng = np.random.default_rng(7)
    p = np.abs(rng.normal(size=len(arr["mass"]))).astype(np.float32)
    tp, jp = torch.from_numpy(p), jnp.asarray(p)
    dt = 0.004
    close(t_phys.pressure_accel(t.nb, t.cache, t.bst, tp, t.mass, t.rho, t.params),
          j_phys.pressure_accel(j.nb, j.cache, j.bst, jp, j.mass, j.rho, j.params), "accel")
    zq_t, zq_j = torch.zeros(2), jnp.zeros(2, jnp.float32)
    close(t_phys.divergence(t.nb, t.cache, t.bst, t.vel, zq_t, t.mass, t.rho, t.params),
          j_phys.divergence(j.nb, j.cache, j.bst, j.vel, zq_j, j.mass, j.rho, j.params), "div")
    close(t_phys.compute_aii(t.nb, t.cache, t.bt, t.bst, t.mass, t.rho, t.params),
          j_phys.compute_aii(j.nb, j.cache, j.bt, j.bst, j.mass, j.rho, j.params), "aii")
    for name in ("source_term_divergence", "source_term_full"):
        close(getattr(t_phys, name)(t.nb, t.cache, t.bst, t.vel, t.mass, t.rho, t.params, dt),
              getattr(j_phys, name)(j.nb, j.cache, j.bst, j.vel, j.mass, j.rho, j.params, dt),
              name)
    close(t_phys.source_term_only_density(t.rho, t.params, dt),
          j_phys.source_term_only_density(j.rho, j.params, dt))
    omega_t = t_solver.compute_omega_iisph2(t.nb, t.cache, t.mass, t.rho, t.h, t.size_class,
                                            t.params)
    omega_j = j_solver.compute_omega_iisph2(j.nb, j.cache, j.mass, j.rho, j.h, j.size_class,
                                            j.params)
    close(omega_t, omega_j, "omega")
    close(t_phys.source_term_full_with_omega(t.nb, t.cache, t.bst, t.vel, t.mass, t.rho, omega_t,
                                             t.params, dt),
          j_phys.source_term_full_with_omega(j.nb, j.cache, j.bst, j.vel, j.mass, j.rho,
                                             omega_j, j.params, dt), "source omega")


@pytest.mark.parametrize("od", ["ConsistentSimpleGradient", "Winchenbach2020"])
def test_particle_boundary_terms_and_aii(particles, od):
    t, j, arr = particles
    assert t.bt.kind == "particles" and int(t.bt.bmask.sum()) > 0
    t = with_params(t, operator_discretization=OperatorDiscretization(od))
    j = dataclasses.replace(j, params=jparams(t))
    p = np.abs(np.random.default_rng(3).normal(size=len(arr["mass"]))).astype(np.float32)
    tp, jp = torch.from_numpy(p), jnp.asarray(p)
    close(t_bnd.boundary_pressure_accel(t.bt, t.pos, t.h, tp, t.rho, t.params),
          j_bnd.boundary_pressure_accel(j.bt, j.pos, j.h, jp, j.rho, j.params), "bacc")
    close(t_bnd.boundary_pressure_accel_fast(t.bst, tp, t.rho, t.params),
          j_bnd.boundary_pressure_accel_fast(j.bst, jp, j.rho, j.params), "bacc fast")
    qb_t, qb_j = torch.tensor([0.1, -0.2]), jnp.asarray([0.1, -0.2], jnp.float32)
    close(t_bnd.boundary_divergence(t.bt, t.vel, qb_t, t.pos, t.h, t.rho, t.params),
          j_bnd.boundary_divergence(j.bt, j.vel, qb_j, j.pos, j.h, j.rho, j.params), "bdiv")
    close(t_bnd.boundary_divergence_fast(t.bst, t.vel, qb_t, t.rho, t.params),
          j_bnd.boundary_divergence_fast(j.bst, j.vel, qb_j, j.rho, j.params), "bdiv fast")
    close(t_phys.compute_aii(t.nb, t.cache, t.bt, t.bst, t.mass, t.rho, t.params),
          j_phys.compute_aii(j.nb, j.cache, j.bt, j.bst, j.mass, j.rho, j.params), "aii")


def test_sdf_boundary_terms(sdf):
    t, j, arr = sdf
    p = np.abs(np.random.default_rng(4).normal(size=len(arr["mass"]))).astype(np.float32)
    tp, jp = torch.from_numpy(p), jnp.asarray(p)
    for od in OperatorDiscretization:
        t2 = with_params(t, operator_discretization=od)
        jpar = jparams(t2)
        close(t_bnd.boundary_pressure_accel(t.bt, t.pos, t.h, tp, t.rho, t2.params),
              j_bnd.boundary_pressure_accel(j.bt, j.pos, j.h, jp, j.rho, jpar), od.value)
        close(t_bnd.boundary_divergence(t.bt, t.vel, torch.zeros(2), t.pos, t.h, t.rho, t2.params),
              j_bnd.boundary_divergence(j.bt, j.vel, jnp.zeros(2, jnp.float32), j.pos, j.h, j.rho,
                                        jpar), od.value)


@pytest.mark.parametrize("case", ["density", "divergence", "momentum", "warm"])
def test_one_solve(sdf, case):
    t, j, arr = sdf
    kw = {"jacobi_momentum": 0.5} if case == "momentum" else {}
    t = with_params(t, **kw)
    j = dataclasses.replace(j, params=jparams(t))
    dt = 0.004
    aii_t = t_phys.compute_aii(t.nb, t.cache, t.bt, t.bst, t.mass, t.rho, t.params)
    aii = np.where(arr["alive"], np.asarray(
        j_phys.compute_aii(j.nb, j.cache, j.bt, j.bst, j.mass, j.rho, j.params)), 0.0)
    close(aii_t.numpy()[arr["alive"]], aii[arr["alive"]], "aii")
    aii = aii.astype(np.float32)
    if case == "divergence":
        src_j = j_phys.source_term_divergence(j.nb, j.cache, j.bst, j.vel, j.mass, j.rho,
                                              j.params, dt)
        tol, residual = 1e-3, j_solver.DIVERGENCE_ERROR
    else:
        src_j = j_phys.source_term_full(j.nb, j.cache, j.bst, j.vel, j.mass, j.rho, j.params, dt)
        tol, residual = 2e-3, j_solver.DENSITY_ERROR
    src = np.asarray(src_j).astype(np.float32)
    p0 = np.abs(np.random.default_rng(5).normal(size=len(aii))).astype(np.float32) * 10.0
    args = dict(max_avg_error=tol, residual_type=residual, clamp_negative_pressures=True)
    rt = t_solver.iisph_pressure_iterations(
        t.nb, t.cache, t.bst, t.mass, t.rho, torch.from_numpy(aii), torch.from_numpy(src),
        t.alive, params=t.params, dt=torch.tensor(dt), p0=torch.from_numpy(p0)
        if case == "warm" else None, **args)
    rj = j_solver.iisph_pressure_iterations(
        j.nb, j.cache, j.bst, j.mass, j.rho, jnp.asarray(aii), jnp.asarray(src), j.alive,
        params=j.params, dt=jnp.float32(dt), p0=jnp.asarray(p0) if case == "warm" else None,
        **args)
    assert rt.iterations == int(rj.iterations) and rt.iterations >= 2, (rt.iterations,
                                                                        int(rj.iterations))
    close(rt.pressure, rj.pressure, "pressure")
    close(rt.pressure_accel, rj.pressure_accel, "accel")
    close(rt.avg_error, rj.avg_error, "avg")
    for k in ("normal_count", "singular_count", "negative_count"):
        assert int(getattr(rt, k)) == int(getattr(rj, k)), k


LEVEL_CASES = {
    "empty_angle": dict(),
    "center_diff": dict(level_estimation_method=LevelEstimationMethod.CenterDiff),
    "range_first_stash": dict(support_length_estimation=SupportLengthEstimation.FromDistribution,
                              fill_stash_with=FillStashWith.SurfaceDistanceFirstIteration),
    "middle_stash_fluid_boundary": dict(fill_stash_with=FillStashWith.SurfaceDistanceMiddle,
                                        boundary_is_fluid_surface=False),
}


@pytest.mark.parametrize("case", list(LEVEL_CASES))
def test_levels_flags_and_stash(sdf, case):
    t, j, arr = sdf
    t = with_params(t, **LEVEL_CASES[case])
    j = dataclasses.replace(j, params=jparams(t))
    stash = np.random.default_rng(6).normal(size=len(arr["mass"])).astype(np.float32)
    got = t_level.perform_level_estimation(t.nb, t.cache, t.bt, t.pos, t.mass, t.h, t.alive,
                                           torch.from_numpy(stash), t.params)
    want = j_level.perform_level_estimation(j.nb, j.cache, j.bt, j.pos, j.mass, j.h, j.alive,
                                            jnp.asarray(stash), j.params)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=2e-5)
    for k, name in ((1, "has_level"), (2, "surface"), (3, "insufficient"), (4, "stash")):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=name)
    assert 0 < int(got[2].sum()) < int(arr["alive"].sum())
    lvl = np.asarray(want[0]).astype(np.float32)
    has = np.asarray(want[1])
    sm_t = t_level.smooth_level_field(t.nb, t.cache, t.mass, t.rho, torch.from_numpy(lvl.copy()),
                                      torch.from_numpy(has.copy()), t.params)
    sm_j = j_level.smooth_level_field(j.nb, j.cache, j.mass, j.rho, jnp.asarray(lvl),
                                      jnp.asarray(has), j.params)
    np.testing.assert_allclose(sm_t[0].numpy(), np.asarray(sm_j[0]), atol=2e-5)


@pytest.mark.parametrize("od", ["ConsistentSimpleGradient", "Winchenbach2020"])
def test_check_aii_deviation(sdf, od):
    t, j, _ = sdf
    t = with_params(t, operator_discretization=OperatorDiscretization(od))
    j = dataclasses.replace(j, params=jparams(t))
    aii_t = t_phys.compute_aii(t.nb, t.cache, t.bt, t.bst, t.mass, t.rho, t.params)
    aii_j = j_phys.compute_aii(j.nb, j.cache, j.bt, j.bst, j.mass, j.rho, j.params)
    dev_t = t_dc.check_aii_deviation(t.nb, t.bt, t.pos, t.mass, t.rho, t.h, aii_t, t.alive,
                                     t.params)
    dev_j = j_dc.check_aii_deviation(j.nb, j.bt, j.pos, j.mass, j.rho, j.h, aii_j, j.alive,
                                     j.params)
    # the deviation is a difference of near-equal sums: both stay under the
    # reference's gate and within a float32 step of a_ii's scale of each other
    scale = float(np.abs(np.asarray(aii_j)).max())
    assert float(dev_t) < 0.01 and float(dev_j) < 0.01
    assert abs(float(dev_t) - float(dev_j)) <= 2e-5 * scale
    cnt = t_dc.list_neighbor_count(t.nb, t.pos, t.h)
    ref = t_dc.bruteforce_neighbor_count(t.pos, t.h, t.alive, 2.0)
    np.testing.assert_array_equal(cnt.numpy()[t.alive.numpy()], ref.numpy()[t.alive.numpy()])


def test_solve_and_integrate_each_method(sdf):
    t, j, arr = sdf
    dt = 0.004
    for method in PressureSolverMethod:
        t2 = with_params(t, pressure_solver_method=method)
        jp = jparams(t2)
        aii = np.where(arr["alive"], np.asarray(
            j_phys.compute_aii(j.nb, j.cache, j.bt, j.bst, j.mass, j.rho, jp)), 0.0)
        aii = aii.astype(np.float32)
        tst = convert.state_from_numpy({**arr, "density": t.rho.numpy(), "aii": aii}, "cpu")
        jst = j_sim.FluidState(**{k: jnp.asarray(v) for k, v in
                                  convert.state_to_numpy(tst).items()})
        new_t, d_t = t_solver.solve_and_integrate(t.nb, t.cache, t.bst, tst, t.h,
                                                  torch.tensor(dt), t2.params)
        new_j, d_j = j_solver.solve_and_integrate(j.nb, j.cache, j.bst, jst, j.h,
                                                  jnp.float32(dt), jp)
        for k in ("div_iterations", "density_iterations"):
            if k in d_j:
                assert d_t[k] == int(d_j[k]), (method, k)
        for k in ("position", "velocity", "pressure"):
            close(new_t[k], new_j[k], f"{method.value} {k}")


def test_akinci_step_matches_jax():
    params = surface_params(particle_sizes=ParticleSizes.Uniform,
                            init_boundary_handler=InitBoundaryHandlerType.Particles)
    scene = akinci_dam_scene()
    js = j_create(j_params.params_from_dict(convert.params_to_dict(params)),
                  j_scene.scene_from_dict(scene), backend="lists")
    ts = t_create(params, t_scene.scene_from_dict(scene), device="cpu", backend="lists")
    for k in range(3):
        dj, dt_ = js.step(), ts.step()
        for name in ("div_iterations", "density_iterations"):
            assert dt_[name] == int(dj[name]), (name, k)
        assert np.float32(dt_["dt"]) == np.float32(dj["dt"]), k
    a = np.asarray(js.state.alive)
    assert np.array_equal(ts.state.alive.numpy(), a)
    np.testing.assert_allclose(ts.state.position.numpy()[a], np.asarray(js.state.position)[a],
                               atol=2e-5)
    np.testing.assert_allclose(ts.state.density.numpy()[a], np.asarray(js.state.density)[a],
                               rtol=2e-5)
    np.testing.assert_allclose(ts.state.velocity.numpy()[a], np.asarray(js.state.velocity)[a],
                               atol=2e-4)
