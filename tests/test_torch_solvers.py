"""PyTorch port, the rest of the solver surface: the Winchenbach2020 and
ConsistentSymmetricGradient discretizations, IISPH2, the WCSPH viscosity, the
non-pressure step after the divergence solve and `pull_fluid_to`, against
the JAX package on the CPU (its Pallas kernels in interpret mode).

- the `visc` (ApproxLaplace, WCSPH) and `omega` sweeps' plain walk against
  the JAX package's run_sweep on the default dam break's first-step layout
  (its initial particles, seeded densities and velocities): sums within 1e-5
  of each column's max |value|;
- K1 with the WCSPH viscosity, mega (the stream factors B w, summed per row
  by K3 at rho = 1/2) and classic (the inline rows), against
  build_weight_cache_prep: the prep rows and B w within 1e-5 of max;
- the whole-solve plain versions in the Winchenbach2020 mode against the JAX
  package's whole-solve kernels: the JAX step's own solve inputs (its
  constants table, captured by a debug callback) go through the port's
  jacobi_solve_ref / hybrid_solve_ref over the port's pair list of the same
  step of the impact scene; iteration counts equal, outputs within 1e-5 of
  max (pressure) and 1e-4 (accelerations, sources);
- whole steps of the stress scene's run families at small size (a
  two-level dam, 3 steps) against JAX with PERF.md's gate: positions atol
  2e-5, density rtol 2e-5, velocity atol 2e-4, iteration counts equal at
  every step (the impact scene's families and the media configuration:
  test_torch_solver_steps.py);
- the impact runs of tests/data/torch_port_solvers_ref.npz against the JAX
  package (the stress and media runs: test_solver_fixture_stress_runs, slow).
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sph_torch import convert
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.models import tile_physics as t_tp
from adaptive_sph_torch.ops import jacobi, pair_ops
from adaptive_sph_torch.ops import sweeps as t_sweeps
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.stress import (IMPACT_CAPACITY, IMPACT_SCENE, impact_params, impact_scene,
                                       solver_runs)
from adaptive_sph_torch.utils.params import (OperatorDiscretization as OD,
                                             PressureSolverMethod as M, ViscosityType as VT,
                                             load_params)
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.models import tile_physics as j_tp
from adaptive_sph_tpu.ops import pallas_jacobi
from adaptive_sph_tpu.ops.pallas_matvec import build_weight_cache_prep, visc_matvec
from adaptive_sph_tpu.ops.pallas_sweeps import run_sweep
from adaptive_sph_tpu.runner import create_simulation as j_create
from adaptive_sph_tpu.utils import params as j_params
from test_torch_kernels import assert_sweep_close
from test_torch_pair_ops import SCALE, VISC, check, inputs
from test_torch_step import CROSS, assert_states_match, dam_scene, run_pair
from test_torch_sweeps import jax_layout

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_solvers_ref.npz")
W2020 = dict(operator_discretization=OD.Winchenbach2020)
WCSPH = dict(viscosity_type=VT.WCSPH, viscosity=0.003)
AFTER_DIV = dict(hybrid_dfsph_non_pressure_accel_before_divergence_free=False)


# ---------------------------------------------------------------------------
# the visc and omega sweeps


@functools.lru_cache(maxsize=None)
def dam_break_layout():
    """The default dam break's initial particles (port init, capacity 2,048)
    in the JAX package's layout at the physics range, with seeded densities
    and velocities."""
    p = load_params(os.path.join(ROOT, "configs", "default-config.yaml"))
    scene = t_scene.load_scene(os.path.join(ROOT, "configs", "default-scene.yaml"))
    sim = t_create(p, scene, capacity=2048, device="cpu")
    st = sim.state
    alive = st.alive.numpy()
    h = np.where(alive, st.h.numpy(), 0.0).astype(np.float32)
    cfg, bins, jst, wm = jax_layout(st.position.numpy(), h, st.mass.numpy(), alive, 2048, 128,
                                    2.0)
    rng = np.random.default_rng(3)
    dyn = np.stack([rng.uniform(950.0, 1050.0, 2048), rng.normal(0, 0.5, 2048),
                    rng.normal(0, 0.5, 2048)], 1).astype(np.float32)
    return p, cfg, bins, jst, wm, dyn


@pytest.mark.parametrize("name", ["visc_laplace", "visc_wcsph", "omega"])
def test_visc_and_omega_sweeps_match_jax_on_the_dam_break(name):
    p, cfg, bins, jst, wm, dyn = dam_break_layout()
    wcsph = dataclasses.replace(p, viscosity_type=VT.WCSPH)
    jp = j_params.params_from_dict(convert.params_to_dict(wcsph if name == "visc_wcsph" else p))
    top = {"visc_laplace": t_tp.visc_op(p), "visc_wcsph": t_tp.visc_op(wcsph),
           "omega": t_tp.OMEGA_OP}[name]
    jop = j_tp.omega_op() if name == "omega" else j_tp.visc_op(jp)
    d = None if name == "omega" else dyn
    want = np.asarray(run_sweep(cfg, bins, jst, None if d is None else jnp.asarray(d), jop, 2.0,
                                interpret=True, wmeta=wm))
    tst = torch.from_numpy(np.array(jst))
    got = t_sweeps.pair_sweep(torch.from_numpy(np.array(bins.cell_starts)),
                              torch.from_numpy(np.array(wm)), tst,
                              None if d is None else torch.from_numpy(d), top, 2.0, cfg.tq)
    live = tst[:, 2].numpy() > 0
    assert live.sum() > 1000
    assert_sweep_close(got[torch.from_numpy(live)], torch.from_numpy(want[live]), top, name)
    assert float(np.abs(want[live]).max()) > 0


# ---------------------------------------------------------------------------
# K1 with the WCSPH viscosity


@pytest.mark.parametrize("C,tq", [(512, 64), (1024, 128), (1024, 16)])
@pytest.mark.parametrize("classic", [False, True])
def test_wcsph_build_matches_jax(C, tq, classic):
    jcfg, tcfg, jb, tb, jst, flat, wm, vel, ops = inputs(C, tq, seed=41 + C + tq)
    from test_torch_tiles import jax_window_meta

    jwm, _ = jax_window_meta(jcfg, jb, jst)
    half = np.full(C, 0.5, np.float32)  # K3 at rho_i + rho_j = 1: B w summed per row
    if classic:
        rho = np.random.default_rng(29 + C).uniform(800.0, 1200.0, C).astype(np.float32)
        dyn = np.concatenate([rho[:, None], vel], axis=1)
        wc, meta, cnt, prep = build_weight_cache_prep(
            jcfg, jb, jst, jnp.asarray(dyn), SCALE, jcfg.b_max, "wcsph", VISC, wmeta=jwm,
            wdtype=jnp.float32, want_s2=True, fuse_density=False, visc_stream=False,
            scalar=False)
        cand = torch.cat([flat[:, 0:4], torch.from_numpy(rho)[:, None], flat[:, 4:6]],
                         1).contiguous()
        csr = pair_ops.pair_build(tb.cell_starts, wm, cand, tq, SCALE, VISC, False,
                                  classic=True, wcsph=True)
        rows = 8
    else:
        wc, vc, meta, cnt, prep = build_weight_cache_prep(
            jcfg, jb, jst, jnp.asarray(vel), SCALE, jcfg.b_max, "wcsph", VISC, wmeta=jwm,
            wdtype=jnp.float32, want_s2=False, fuse_density=True, visc_stream=True, scalar=False)
        csr = pair_ops.pair_build(tb.cell_starts, wm, flat, tq, SCALE, VISC, True, wcsph=True)
        rows = 4
        for k, (g, w) in enumerate(zip(pair_ops.pair_visc(csr, torch.from_numpy(half)),
                                       visc_matvec(vc, meta, cnt, jnp.asarray(half), tq))):
            check(g, w, 1e-5, ("B w", k, C, tq))
            assert float(np.abs(np.asarray(w)).max()) > 0
    assert int(cnt[1]) == 0
    for k in range(rows):
        check(csr.prep[k], prep[:, k, :].reshape(C), 1e-5, ("prep", k, C, tq))
    if classic:  # the inline WCSPH rows carry signal
        assert float(csr.prep[6].abs().max()) > 0 and float(csr.prep[7].abs().max()) > 0


# ---------------------------------------------------------------------------
# the whole-solve plain versions in the Winchenbach2020 mode


# the JAX table's lanes (pallas_jacobi.py) -> the port's table rows
_LANES = {jacobi.T_SRC: 0, jacobi.T_WAII: 1, jacobi.T_NSING: 2, jacobi.T_RINV: 3,
          jacobi.T_GXP: 4, jacobi.T_GYP: 5, jacobi.T_S1X: 6, jacobi.T_S1Y: 7, jacobi.T_BDX: 8,
          jacobi.T_BDY: 9, jacobi.T_ALIVE: 10, jacobi.T_P0: 11, jacobi.T_RHO: 12,
          jacobi.T_S2X: 13, jacobi.T_S2Y: 14, jacobi.T_P0DIV: 15, jacobi.T_VX0: 16,
          jacobi.T_VY0: 17, jacobi.T_OMGI: 18}
# the output rows compared: port row -> JAX lane
_OUT = {jacobi.M_P: 0, jacobi.M_AX: 2, jacobi.M_AY: 3, jacobi.M_PERR: 7, jacobi.M_SRC: 11,
        jacobi.M_VX: 8, jacobi.M_VY: 9, jacobi.M_PDIV: 10}


def captured_solves(method, steps, monkeypatch):
    """Both packages' whole-solve calls of `steps` steps of the impact scene
    (resident, Winchenbach2020): per step, the JAX kernel's (table, scal, M,
    stats) by a debug callback and the port's (csr, kwargs)."""
    got = {"jax": [], "port": []}
    for name in ("jacobi_solve", "hybrid_solve"):
        real_j = getattr(pallas_jacobi, name)

        def spy_j(*a, _real=real_j, **k):
            m, stats = _real(*a, **k)
            jax.debug.callback(lambda *v: got["jax"].append([np.asarray(x) for x in v]),
                               a[3], a[4], m, stats)
            return m, stats

        monkeypatch.setattr(pallas_jacobi, name, spy_j)
        real_t = getattr(jacobi, name)

        def spy_t(*a, _real=real_t, _name=name, **k):
            got["port"].append((_name, a[0], k))
            return _real(*a, **k)

        monkeypatch.setattr(jacobi, name, spy_t)
    params = impact_params(method, **W2020)
    js = j_create(j_params.params_from_dict(convert.params_to_dict(params)),
                  j_scene.scene_from_dict(IMPACT_SCENE), capacity=IMPACT_CAPACITY,
                  backend="tiles", counters_enabled=False)
    ts = t_create(params, impact_scene(), capacity=IMPACT_CAPACITY, device="cpu")
    for _ in range(steps):
        js.step()
        ts.step()
    jax.effects_barrier()
    assert len(got["jax"]) == len(got["port"]) == steps
    return got


@pytest.mark.parametrize("method,steps,iters", [(M.HybridDFSPH, 4, 54), (M.IISPH, 5, 24),
                                                (M.OnlyDivergence, 4, 54)])
def test_w2020_whole_solves_match_jax_kernels(method, steps, iters, monkeypatch):
    got = captured_solves(method, steps, monkeypatch)
    table_j, scal, m_j, stats_j = got["jax"][-1]
    name, csr, kw = got["port"][-1]
    assert kw["w2020"]
    C = table_j.shape[0]
    table = torch.zeros(jacobi.T_ROWS, C)
    for row, lane in _LANES.items():
        if lane < table_j.shape[1]:
            table[row] = torch.from_numpy(table_j[:, lane].copy())
    m, stats = getattr(jacobi, name + "_ref")(csr, table, torch.from_numpy(scal.copy()), **kw)
    offs = (0, 8) if name == "hybrid_solve" else (0,)
    its = [int(stats[o + jacobi.S_ITERS]) for o in offs]
    assert its == [int(stats_j[o + jacobi.S_ITERS]) for o in offs]
    assert iters in its
    for o in offs:
        assert float(stats[o + jacobi.S_NORMAL]) == float(stats_j[o + jacobi.S_NORMAL])
    rows = [jacobi.M_P, jacobi.M_AX, jacobi.M_AY, jacobi.M_SRC]
    if name == "hybrid_solve":
        rows += [jacobi.M_VX, jacobi.M_VY, jacobi.M_PDIV, jacobi.M_PERR]
    elif kw["density_type"]:
        rows.append(jacobi.M_PERR)
    for row in rows:
        tol = 1e-5 if row in (jacobi.M_P, jacobi.M_PDIV, jacobi.M_VX, jacobi.M_VY) else 1e-4
        check(m[row], m_j[:, _OUT[row]], tol, (name, row))


# ---------------------------------------------------------------------------
# whole steps against JAX

# the two-level dam (the stress scene's families at small size), 3 steps
DAM_CASES = {
    "w2020_hybrid": dict(**W2020),
    "w2020_hybrid_resident": dict(resident_solver=True, **W2020),
    "iisph2_wcsph_resident": dict(resident_solver=True, pressure_solver_method=M.IISPH2,
                                  iisph_max_avg_density_error=0.001, **WCSPH),
    "wcsph_visc_after_div": dict(**WCSPH, **AFTER_DIV),
}


@pytest.mark.parametrize("case", list(DAM_CASES))
def test_two_level_dam_steps_match_jax(case):
    from adaptive_sph_tpu.utils.params import SimulationParams

    params = convert.params_from_dict(dataclasses.asdict(SimulationParams(**CROSS)))
    params = dataclasses.replace(params, **DAM_CASES[case])
    jp = j_params.params_from_dict(convert.params_to_dict(params))
    js, ts, diags = run_pair(jp, dam_scene(0.05), None, 3)
    for k, (dj, d) in enumerate(diags):
        for name in ("div_iterations", "density_iterations"):
            assert (name in d) == (name in dj), (case, name, k)
            if name in d:
                assert d[name] == int(dj[name]), (case, name, k)
        assert int(d["negative_aii"]) == int(dj["negative_aii"])
    assert_states_match(js, ts)


# ---------------------------------------------------------------------------
# the fixture the GPU run compares with


def check_fixture_runs(names):
    """Each run's JAX trajectory against the committed fixture: per-step
    arrays equal, the alive state within 1e-6 (the same package and inputs)."""
    import sys

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_port_solvers_ref import reference_run

    ref = np.load(FIXTURE)
    runs = solver_runs()
    for name in names:
        params, scene, capacity, steps = runs[name]
        state, per_step = reference_run(params, scene, capacity, steps)
        for k, v in per_step.items():
            assert np.array_equal(v, ref[f"{name}__{k}"]), (name, k)
        for k, v in state.items():
            np.testing.assert_allclose(v, ref[f"{name}__{k}"], rtol=1e-6, atol=1e-6,
                                       err_msg=f"{name} {k}")


def test_solver_fixture_impact_runs():
    check_fixture_runs([n for n in solver_runs() if n.startswith("impact_")])


@pytest.mark.slow
def test_solver_fixture_stress_runs():
    check_fixture_runs([n for n in solver_runs() if not n.startswith("impact_")])


def test_solver_runs_run_on_the_port():
    # every run family starts on the port (the first step of each, CPU) and
    # takes the branch the reference takes: the classic walk under
    # Winchenbach2020 and resident_solver, the visc sweep after the
    # divergence solve, the omega sweep under IISPH2
    from adaptive_sph_torch.models import tile_step as t_step

    seen = []
    real = t_step.pair_sweep

    def spy(*a, **k):
        seen.append(a[4].name)
        return real(*a, **k)

    t_step.pair_sweep = spy
    try:
        for name, (params, scene, capacity, _) in solver_runs().items():
            if name.startswith("stress"):
                continue
            seen.clear()
            sim = t_create(params, t_scene.scene_from_dict(scene), capacity=capacity,
                           device="cpu")
            d = sim.step()
            assert np.isfinite(sim.state.position.numpy()).all(), name
            assert "density" in seen, (name, seen)  # the classic branch
            assert d["negative_aii"] == 0
    finally:
        t_step.pair_sweep = real
