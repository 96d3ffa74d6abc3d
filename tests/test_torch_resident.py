"""PyTorch port, the resident whole-solve path (`resident_solver=True`): the
port's steps against the JAX package's resident steps (its whole-solve Pallas
kernels in interpret mode), and the port's whole-solve plain versions against
its own streamed Jacobi loop. IISPH and OnlyDivergence with `resident_solver`
off (the streamed path) are held against the JAX package's streamed steps.

Scene: the impact scene of adaptive_sph_torch/stress.py (144 particles
thrown at the floor, uniform sizes, max_iters 60, capacity 1024), whose
solves iterate: 13-60 sweeps including the 60 cap, so the exit test and the
cap are held against the reference (the stress scene's first steps never
leave the 2-iteration floor). 6 steps per case, particles matched by position.
Tolerances, those of the reference's own resident-vs-streamed test
(tests/test_resident_solver.py): positions atol 2e-5, density rtol 2e-5,
velocity atol 2e-4, pressure rtol 5e-3 / atol 1e-2; iteration counts EQUAL at
every step. The three resident impact runs are also held against the
committed fixture tests/data/torch_port_resident_ref.npz that the GPU smoke
run compares with. `resident_solver` with momentum 0.9 runs the reference's
classic branch with streamed solves, held against JAX the same way.
"""

import os

import numpy as np
import pytest
import torch

from adaptive_sph_torch import convert
from adaptive_sph_torch.models import grid_physics as gp
from adaptive_sph_torch.models import tile_physics as t_tp
from adaptive_sph_torch.models import tile_step as t_step
from adaptive_sph_torch.models.solver import DENSITY_ERROR, DIVERGENCE_ERROR
from adaptive_sph_torch.ops import jacobi, pair_ops
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.stress import IMPACT_CAPACITY, IMPACT_SCENE, impact_params, impact_scene
from adaptive_sph_torch.utils.params import (HybridDfsphDensitySourceTerm,
                                             PressureSolverMethod as M)
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.runner import create_simulation as j_create
from adaptive_sph_tpu.utils import params as j_params
from test_torch_step import assert_states_match

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_port_resident_ref.npz")
STEPS = 6

CASES = {
    "hybrid": (dict(method=M.HybridDFSPH), "impact_hybrid"),
    "hybrid_only_density": (dict(
        method=M.HybridDFSPH,
        hybrid_dfsph_density_source_term=HybridDfsphDensitySourceTerm.OnlyDensity), None),
    "iisph": (dict(method=M.IISPH), "impact_iisph"),
    "only_divergence": (dict(method=M.OnlyDivergence), "impact_only_divergence"),
    "hybrid_warm_start": (dict(method=M.HybridDFSPH, warm_start_pressure=True), None),
    # resident_solver off (the default): the mega branch and the streamed
    # tile_jacobi, against the JAX package's streamed path
    "iisph_streamed": (dict(method=M.IISPH, resident=False), None),
    "only_divergence_streamed": (dict(method=M.OnlyDivergence, resident=False), None),
}


def run_pair(params, steps):
    js = j_create(j_params.params_from_dict(convert.params_to_dict(params)),
                  j_scene.scene_from_dict(IMPACT_SCENE), capacity=IMPACT_CAPACITY,
                  backend="tiles", counters_enabled=False)
    ts = t_create(params, impact_scene(), capacity=IMPACT_CAPACITY, device="cpu")
    assert ts.tile_cfg.populated == js.tile_cfg.populated and ts.tile_cfg.tq == js.tile_cfg.tq
    return js, ts, [(js.step(), ts.step()) for _ in range(steps)]


def assert_impact_run_matches(case, params, steps=STEPS):
    """Both packages' impact runs: iteration counts equal at every step, dt,
    then the matched state and pressure. Returns (js, diags)."""
    js, ts, diags = run_pair(params, steps)
    iters = []
    for k, (dj, d) in enumerate(diags):
        for name in ("div_iterations", "density_iterations"):
            assert (name in d) == (name in dj), (name, k)
            if name in d:
                assert d[name] == int(dj[name]), (case, name, k)
        # the CFL dt follows the velocities, held at atol 2e-4 below (|v| ~ 3)
        assert np.float32(d["dt"]) == pytest.approx(float(dj["dt"]), rel=1e-4)
        iters.append(max(d.get("div_iterations", 0), d.get("density_iterations", 0)))
    assert max(iters) >= 13, "the scene must leave the 2-iteration floor"
    j = assert_states_match(js, ts)
    a, b = js.state, ts.state
    np.testing.assert_allclose(b.pressure.numpy()[b.alive.numpy()][j],
                               np.asarray(a.pressure)[np.asarray(a.alive)], rtol=5e-3, atol=1e-2)
    return js, diags


@pytest.mark.parametrize("case", list(CASES))
def test_resident_steps_match_jax(case):
    kw, fixture_run = CASES[case]
    kw = dict(kw)
    params = impact_params(kw.pop("method"), **kw)
    js, diags = assert_impact_run_matches(case, params)
    a = js.state
    if fixture_run is None:
        return
    ref = np.load(FIXTURE)
    for name in ("div_iterations", "density_iterations"):
        want = ref[f"{fixture_run}__{name}"].tolist()
        assert [int(dj.get(name, -1)) for dj, _ in diags] == want, (fixture_run, name)
    assert np.array_equal(np.asarray([float(dj["dt"]) for dj, _ in diags], np.float32),
                          ref[f"{fixture_run}__dt"])
    np.testing.assert_allclose(np.asarray(a.position)[np.asarray(a.alive)],
                               ref[f"{fixture_run}__position"], atol=1e-6)


def test_momentum_takes_the_streamed_path(monkeypatch):
    # the reference's whole-solve kernels have no momentum: with
    # resident_solver and jacobi_momentum 0.9 it keeps the classic branch
    # (the DENSITY sweep, K1 in classic mode with the inline viscosity) and
    # solves it streamed. The port against the JAX package on that branch,
    # and the branch the port took.
    calls = {"density_sweep": 0, "classic_build": 0, "pair_visc": 0, "resident_solve": 0}

    def spy(mod, name, key, when=lambda a, k: True):
        real = getattr(mod, name)

        def f(*a, **k):
            calls[key] += int(when(a, k))
            return real(*a, **k)
        monkeypatch.setattr(mod, name, f)

    spy(t_step, "pair_sweep", "density_sweep", lambda a, k: a[4].name == "density")
    spy(pair_ops, "pair_build", "classic_build", lambda a, k: k.get("classic", False))
    spy(pair_ops, "pair_visc", "pair_visc")
    spy(jacobi, "jacobi_solve", "resident_solve")
    spy(jacobi, "hybrid_solve", "resident_solve")
    params = impact_params(M.HybridDFSPH, resident=True, jacobi_momentum=0.9)
    assert_impact_run_matches("hybrid_momentum", params)
    assert calls == {"density_sweep": STEPS, "classic_build": STEPS, "pair_visc": 0,
                     "resident_solve": 0}


@pytest.mark.parametrize("env", ["1", None])
def test_resident_solver_variable_takes_the_classic_branch(monkeypatch, env):
    # ASPH_RESIDENT_SOLVER=1 acts as resident_solver: true in both packages
    # (the reference's need_s2 and resident gates read it beside the
    # parameter): the DENSITY sweep, K1 in classic mode and, at momentum 0,
    # one whole-solve launch per step. Without it the same parameters keep
    # the mega branch (K1 mega mode, the viscosity stream, streamed solves).
    if env is None:
        monkeypatch.delenv("ASPH_RESIDENT_SOLVER", raising=False)
    else:
        monkeypatch.setenv("ASPH_RESIDENT_SOLVER", env)
    calls = {"density_sweep": 0, "classic_build": 0, "pair_visc": 0, "resident_solve": 0}

    def spy(mod, name, key, when=lambda a, k: True):
        real = getattr(mod, name)

        def f(*a, **k):
            calls[key] += int(when(a, k))
            return real(*a, **k)
        monkeypatch.setattr(mod, name, f)

    spy(t_step, "pair_sweep", "density_sweep", lambda a, k: a[4].name == "density")
    spy(pair_ops, "pair_build", "classic_build", lambda a, k: k.get("classic", False))
    spy(pair_ops, "pair_visc", "pair_visc")
    spy(jacobi, "jacobi_solve", "resident_solve")
    spy(jacobi, "hybrid_solve", "resident_solve")
    params = impact_params(M.HybridDFSPH, resident=False)
    assert_impact_run_matches(f"resident_solver_variable_{env}", params)
    on = STEPS if env == "1" else 0
    assert calls == {"density_sweep": on, "classic_build": on, "pair_visc": STEPS - on,
                     "resident_solve": on}


def capture_solve(method, step):
    """The port's inputs to its resident solve on the impact scene's `step`-th
    step (1-based), with the streamed operators of that step."""
    sim = t_create(impact_params(method), impact_scene(), capacity=IMPACT_CAPACITY,
                   device="cpu")
    for _ in range(step - 1):
        sim.step()
    seen = {}
    real = {n: getattr(t_tp, n) for n in ("tile_jacobi_resident", "tile_hybrid_resident")}

    def spy(name):
        def f(*a, **k):
            seen[name] = (a, k)
            return real[name](*a, **k)
        return f

    for n in real:
        setattr(t_step.tp, n, spy(n))
    try:
        d = sim.step()
    finally:
        for n, f in real.items():
            setattr(t_step.tp, n, f)
    return seen, d


def streamed_ops(csr, rho, rho_inv, s1x, s1y, Gx, Gy, kind, params):
    """accel_fn / div_fn of the streamed path (models/tile_step.py)."""
    def accel_fn(p):
        u = p * rho_inv * rho_inv
        mvx, mvy = pair_ops.pair_matvec(csr, u, k_out=2)
        bx, by = gp.boundary_accel_slots_1d(Gx, Gy, p, rho, kind, params)
        return -u * s1x - mvx + bx, -u * s1y - mvy + by

    def div_fn(qx, qy):
        s = (pair_ops.pair_matvec(csr, (qx, qy), k_out=1) - (qx * s1x + qy * s1y)) * rho_inv
        return s + gp.boundary_div_slots_1d(Gx, Gy, qx, qy, rho, kind, params)

    return accel_fn, div_fn


def close(got, want, tol=1e-5):
    got, want = got.double(), want.double()
    assert float((got - want).abs().max()) <= tol * (float(want.abs().max()) + 1e-30)


@pytest.mark.parametrize("method,step,iters", [(M.OnlyDivergence, 4, 60), (M.IISPH, 5, 23)])
def test_jacobi_plain_matches_streamed_loop(method, step, iters):
    # the whole-solve plain version (models/tile_physics.tile_jacobi_resident
    # -> ops/jacobi.jacobi_solve_ref) against tile_jacobi over K2's plain
    # version on the same inputs: the same math, other operation order
    seen, d = capture_solve(method, step)
    (csr, aii, src, alive, tol, rtype, params, dt, rho, rho_inv, s1x, s1y, Gx, Gy, kind), kw = \
        seen["tile_jacobi_resident"]
    res, full_src = t_tp.tile_jacobi_resident(
        csr, aii, src, alive, tol, rtype, params, dt, rho, rho_inv, s1x, s1y, Gx, Gy, kind, **kw)
    accel_fn, div_fn = streamed_ops(csr, rho, rho_inv, s1x, s1y, Gx, Gy, kind, params)
    vx, vy = kw["vel"]
    want_src = src - div_fn(vx, vy) / dt
    want = t_tp.tile_jacobi(accel_fn, div_fn, aii, want_src, alive, tol, rtype, params, dt, rho,
                            p0=kw["p0"])
    assert int(res.iterations) == want.iterations == iters
    close(full_src, want_src)
    close(res.pressure, want.pressure)
    for g, w in zip(res.pressure_accel, want.pressure_accel):
        close(g, w)
    if rtype == DENSITY_ERROR:
        close(res.density_error, want.density_error)
        close(res.max_error, want.max_error)
    close(res.avg_error, want.avg_error, 1e-4)
    assert int(res.normal_count) == int(want.normal_count)
    assert int(res.negative_count) == int(want.negative_count)


def test_hybrid_plain_matches_streamed_loop():
    # hybrid_solve_ref against the streamed HybridDFSPH section on the impact
    # scene's 4th step (the divergence solve runs to the 60 cap)
    seen, d = capture_solve(M.HybridDFSPH, 4)
    a, kw = seen["tile_hybrid_resident"]
    csr, aii, alive, params, dt, rho, rho_inv, s1x, s1y, Gx, Gy, kind, vx, vy, den_with_div = a
    res_div, res_den, v2x, v2y, src2 = t_tp.tile_hybrid_resident(*a, **kw)
    accel_fn, div_fn = streamed_ops(csr, rho, rho_inv, s1x, s1y, Gx, Gy, kind, params)
    want_div = t_tp.tile_jacobi(accel_fn, div_fn, aii, -div_fn(vx, vy) / dt, alive,
                                params.hybrid_dfsph_max_avg_divergence_error, DIVERGENCE_ERROR,
                                params, dt, rho)
    wx = vx + dt * want_div.pressure_accel[0]
    wy = vy + dt * want_div.pressure_accel[1]
    want_src2 = -(params.rest_density - rho) / (rho * dt * dt) - div_fn(wx, wy) / dt
    want_den = t_tp.tile_jacobi(accel_fn, div_fn, aii, want_src2, alive,
                                params.hybrid_dfsph_max_avg_density_error, DENSITY_ERROR,
                                params, dt, rho)
    assert den_with_div
    assert int(res_div.iterations) == want_div.iterations == 60
    assert int(res_den.iterations) == want_den.iterations == d["density_iterations"]
    close(res_div.pressure, want_div.pressure)
    close(v2x, wx)
    close(v2y, wy)
    close(src2, want_src2)
    close(res_den.pressure, want_den.pressure)
    for g, w in zip(res_den.pressure_accel, want_den.pressure_accel):
        close(g, w)
    close(res_den.density_error, want_den.density_error)


def test_resident_wrappers_run_the_plain_versions_on_cpu():
    # CPU tensors take the plain versions (no launch counted); the
    # Winchenbach2020 variant of the reference kernels is not ported
    seen, _ = capture_solve(M.IISPH, 2)
    pair_ops.reset_launches()
    a, kw = seen["tile_jacobi_resident"]
    res, _ = t_tp.tile_jacobi_resident(*a, **kw)
    assert int(res.iterations) == 2
    assert pair_ops.launches["pair_jacobi"] == 0 and pair_ops.launches["pair_hybrid"] == 0
    csr = a[0]
    C = csr.row_ptr.shape[0] - 1
    table = torch.zeros(jacobi.T_ROWS, C)
    scal = torch.tensor([1e-3, 1e-3, 1000.0, 0.0])
    with pytest.raises(NotImplementedError):
        jacobi.jacobi_solve(csr, table, scal, density_type=True, max_iters=10, mp=0.0,
                            w2020=True)
    with pytest.raises(NotImplementedError):
        jacobi.hybrid_solve(csr, table, scal, max_iters=10, mp=0.0, den_with_div=True,
                            w2020=True)


def test_resident_supported_matches_reference():
    from adaptive_sph_tpu.ops.pallas_jacobi import resident_supported as j_supported
    import jax.numpy as jnp

    for C, tq in ((1024, 64), (14336, 128), (65536, 128), (131072, 128), (200704, 128)):
        for tdt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
            assert jacobi.resident_supported(C, tq, tdt) == j_supported(C, tq, jdt), (C, tq, tdt)
    assert jacobi.resident_supported(14336, 128, torch.float32)
    assert not jacobi.resident_supported(200704, 128, torch.float32)
