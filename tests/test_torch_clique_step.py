"""PyTorch port, the tile step on the clique / patch-major layout
(ASPH_CLIQUE=1) against the JAX package's.

- The touching two-size scene (stress.TOUCHING_SCENE: two populated levels
  whose particles meet, so K1's cross-level list is not empty), 3 steps
  against JAX's clique run: at every step equal iteration counts, dt within
  1e-6, the same patch side and capacity, no clique overflow; at the end,
  row by row (both keep the patch-major order), positions atol 2e-5, density
  rtol 2e-5, velocity atol 2e-4 (PERF.md section 2). With bf16 weights,
  judged as tests/test_tile_engine.py's bf16 test does: every density solve
  inside its tolerance, positions within 2e-3 of JAX's bf16 run.
- The runs of `stress.clique_runs()` against tests/data/torch_port_clique_ref.npz
  (scripts/torch_port_clique_ref.py): the stress scene (5 steps, no
  cross-level pair), the touching scene (10) and the touching scene under
  ASPH_NX_CAP=1, where the reference overflows its cross-block budget and
  falls back to the packed layout while the port (no such budget: K1 sizes
  its list exactly) stays on the clique layout; matched by position there.
- The runner: ASPH_CLIQUE unset leaves the packed layout and the capacity
  as they were; an injected halo overflow rebuilds the step on the packed
  layout and runs it again with the "clique-fallback" counter raised (the
  port has no check_invariants switch: it always checks), and a step that
  overflows once the retries are spent raises.
"""

import numpy as np
import pytest
import torch

from adaptive_sph_torch import convert, stress
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.models import tile_step
from adaptive_sph_torch.runner import SimulationFailed
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.runner import create_simulation as j_create
from adaptive_sph_tpu.utils import params as j_params

torch.set_num_threads(2)

FIXTURE = "tests/data/torch_port_clique_ref.npz"
STATE = ("position", "velocity", "density")


def run_port(params, scene_d, steps, capacity=None):
    sim = t_create(params, t_scene.scene_from_dict(scene_d), capacity=capacity, device="cpu")
    return sim, [sim.step() for _ in range(steps)]


def run_jax(params, scene_d, steps, capacity=None):
    sim = j_create(j_params.params_from_dict(convert.params_to_dict(params)),
                   j_scene.scene_from_dict(scene_d), capacity=capacity, backend="tiles")
    return sim, [sim.step() for _ in range(steps)]


def alive_state(state):
    a = np.asarray(state.alive)
    return {k: np.asarray(getattr(state, k))[a] for k in STATE}


def hold(got, want, matched=False):
    """Positions atol 2e-5, density rtol 2e-5, velocity atol 2e-4; matched:
    pair the particles by position first (the orders differ)."""
    assert len(got["position"]) == len(want["position"])
    if matched:
        from scipy.spatial import cKDTree

        _, j = cKDTree(got["position"]).query(want["position"], k=1)
        assert (np.sort(j) == np.arange(len(j))).all()
        got = {k: v[j] for k, v in got.items()}
    np.testing.assert_allclose(got["position"], want["position"], rtol=0, atol=2e-5)
    np.testing.assert_allclose(got["density"], want["density"], rtol=2e-5)
    np.testing.assert_allclose(got["velocity"], want["velocity"], rtol=0, atol=2e-4)


@pytest.fixture
def clique(monkeypatch):
    monkeypatch.setenv("ASPH_CLIQUE", "1")
    monkeypatch.delenv("ASPH_NX_CAP", raising=False)


def test_touching_scene_equals_jax(clique):
    params = stress.touching_params()
    tsim, tdiags = run_port(params, stress.TOUCHING_SCENE, 3)
    jsim, jdiags = run_jax(params, stress.TOUCHING_SCENE, 3)
    assert (tsim.tile_cfg.patch, tsim.state.capacity) == (jsim.tile_cfg.patch,
                                                          jsim.state.capacity) == (4, 3072)
    assert tsim.tile_cfg.populated == tuple(jsim.tile_cfg.populated) == (0, 1)
    for td, jd in zip(tdiags, jdiags):
        for k in ("div_iterations", "density_iterations"):
            assert td[k] == int(jd[k]), k
        assert abs(td["dt"] - float(jd["dt"])) <= 1e-6
        assert td["clique_overflow"] == int(jd["clique_overflow"]) == 0
        assert td["num_pairs"] > 0  # the cross-level list
    assert [d["density_iterations"] for d in tdiags] == [8, 3, 2]
    assert not tsim.clique_disabled and not jsim.clique_disabled
    hold(alive_state(tsim.state), alive_state(jsim.state))


def test_touching_scene_bf16_converges(clique):
    params = stress.touching_params(weight_cache_bf16=True)
    tsim, tdiags = run_port(params, stress.TOUCHING_SCENE, 3)
    jsim, _ = run_jax(params, stress.TOUCHING_SCENE, 3)
    assert tsim.tile_cfg.patch == 4
    tol = tsim.params.hybrid_dfsph_max_avg_density_error * tsim.params.rest_density
    for d in tdiags:
        err = d["density_avg_error"]
        assert not err == err or abs(err) < tol
    got, want = alive_state(tsim.state), alive_state(jsim.state)
    np.testing.assert_allclose(got["position"], want["position"], rtol=0, atol=2e-3)


@pytest.mark.parametrize("run", sorted(stress.clique_runs()))
def test_clique_runs_equal_the_fixture(monkeypatch, run):
    params, scene_d, capacity, steps, env = stress.clique_runs()[run]
    monkeypatch.setenv("ASPH_CLIQUE", "1")
    for k, v in env.items():  # read by the reference only; the port ignores it
        monkeypatch.setenv(k, v)
    ref = np.load(FIXTURE)
    sim, diags = run_port(params, scene_d, steps, capacity)
    for k in ("div_iterations", "density_iterations"):
        assert [d[k] for d in diags] == ref[f"{run}/{k}"].tolist(), k
    np.testing.assert_allclose([d["dt"] for d in diags], ref[f"{run}/dt"], rtol=1e-5)
    assert sim.state.capacity == ref[f"{run}/capacity"][-1]
    assert all(d["clique_overflow"] == 0 for d in diags)
    assert not sim.clique_disabled and sim.tile_cfg.patch == 4
    fell_back = bool(ref[f"{run}/clique_disabled"][-1])
    assert fell_back == (run == "touching_nxcap1")  # the reference's budget
    if not fell_back:
        assert ref[f"{run}/patch"].tolist() == [4] * steps
    if run == "stress_clique":
        assert all(d["num_pairs"] == 0 for d in diags)  # no cross-level pair
    want = {k: ref[f"{run}/{k}"] for k in STATE}
    hold(alive_state(sim.state), want, matched=fell_back)


def test_clique_unset_keeps_the_packed_layout(monkeypatch):
    monkeypatch.delenv("ASPH_CLIQUE", raising=False)
    sim = t_create(stress.touching_params(), t_scene.scene_from_dict(stress.TOUCHING_SCENE),
                   device="cpu")
    monkeypatch.setenv("ASPH_CLIQUE", "1")
    grown = t_create(stress.touching_params(), t_scene.scene_from_dict(stress.TOUCHING_SCENE),
                     device="cpu")
    assert sim.tile_cfg.patch == 0 and grown.tile_cfg.patch == 4
    assert sim.state.capacity < grown.state.capacity == 3072
    d = sim.step()
    assert "clique_overflow" not in d


def overflowing_halo(calls):
    """build_halo with one ring particle too many: the halo overflows."""
    real = tile_step.build_halo

    def spy(tcfg, bins, st):
        calls.append(tcfg.patch)
        halo_src, ovf = real(tcfg, bins, st)
        return halo_src, ovf + 1

    return spy


def test_halo_overflow_falls_back_to_the_packed_layout(clique, monkeypatch):
    calls = []
    monkeypatch.setattr(tile_step, "build_halo", overflowing_halo(calls))
    params = stress.touching_params()
    sim = t_create(params, t_scene.scene_from_dict(stress.TOUCHING_SCENE), device="cpu")
    assert sim.tile_cfg.patch == 4
    d = sim.step()
    assert calls == [4]  # the clique step ran once, then the packed one
    assert sim.clique_disabled and sim.tile_cfg.patch == 0
    assert sim.counters.values["clique-fallback"] == [1.0]
    assert "clique_overflow" not in d and sim.step_number == 1
    # the packed step's result: JAX's first step on the packed layout
    monkeypatch.setenv("ASPH_CLIQUE", "0")
    jsim, jdiags = run_jax(params, stress.TOUCHING_SCENE, 1, capacity=sim.state.capacity)
    assert d["density_iterations"] == int(jdiags[0]["density_iterations"])
    hold(alive_state(sim.state), alive_state(jsim.state))
    # the fallback holds through a capacity growth
    sim.grow_capacity()
    assert sim.tile_cfg.patch == 0 and calls == [4]


def test_halo_overflow_raises_once_the_retries_are_spent(clique, monkeypatch):
    monkeypatch.setattr(tile_step, "build_halo", overflowing_halo([]))
    sim = t_create(stress.touching_params(), t_scene.scene_from_dict(stress.TOUCHING_SCENE),
                   device="cpu")
    with pytest.raises(SimulationFailed, match="clique halo overflow"):
        sim._advance(lambda: sim.step_fn(sim.state, sim.step_number + 1), True, _retries=0)
    assert sim.step_number == 0 and not sim.clique_disabled
