"""PyTorch port, the slab-decomposed step over torch.distributed (gloo ranks
on the CPU) against the JAX package's `make_slab_step_fn` on 2 virtual
devices, and against the port's own one-device run.

The scene is tests/test_multichip.py's: a 1.2 x 0.6 block at spacing 0.03
(800 particles), uniform HybridDFSPH with warm start, 6 steps. Both packages
start from one state carried across by `convert`. Particles are matched by
position (`gather_alive`'s lexsort: each rank returns its own sorted order).

Tolerances against JAX: positions atol 2e-5, velocity atol 2e-4, density
rtol 2e-5, equal solver iterations at every step (2 ranks: a psum of two
floats does not depend on the order), shard_overflow 0, equal relay counts.
Against the one-device run, test_multichip.py's: 5e-5, 5e-4 and 1e-4; also
after a forced reshard mid-run on 4 ranks, and on the impact scene
(adaptive_sph_torch.stress), whose solves iterate (up to the 60 cap), with
equal iteration counts at every step.
"""

import dataclasses
import time

import numpy as np
import pytest

import jax
from adaptive_sph_torch import convert
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.models.state import FIELDS
from adaptive_sph_torch.multichip import RunHooks, SlabJob, run_ranks
from adaptive_sph_torch.parallel import tile_sharding as tts
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.parallel import tile_sharding as jts
from adaptive_sph_tpu.runner import create_simulation as j_create
from adaptive_sph_tpu.runner import grid_config_for as j_gcfg
from adaptive_sph_tpu.utils.params import (
    InitBoundaryHandlerType,
    LevelEstimationMethod,
    ParticleSizes,
    PressureSolverMethod,
    SimulationParams,
)

SCENE = {
    "boundary": {"type": "box", "width": 2.0, "height": 2.0},
    "blocks": [{"pos": [-0.95, -0.5], "size": [1.2, 0.6], "spacing": 0.03,
                "volume_fill_ratio": 0.93, "velocity": [0, 0]}],
}
PARAMS = SimulationParams(
    particle_sizes=ParticleSizes.Uniform,
    pressure_solver_method=PressureSolverMethod.HybridDFSPH,
    init_boundary_handler=InitBoundaryHandlerType.AnalyticOverestimate,
    level_estimation_method=LevelEstimationMethod.NoneMethod,
    merging=False, sharing=False, splitting=False, max_iters=50, warm_start_pressure=True,
)
CAPACITY = 2048
STEPS = 6


def job(js, gcfg, scfg=None, **kw):
    return SlabJob(params=convert.params_to_dict(js.params), scene=SCENE, steps=STEPS,
                   capacity=CAPACITY, state={k: np.asarray(getattr(js.state, k)) for k in FIELDS},
                   gcfg=convert.grid_config_from_dict(dataclasses.asdict(gcfg)),
                   scfg=None if scfg is None else convert.slab_config_from_dict(
                       dataclasses.asdict(scfg)), **kw)


@pytest.fixture(scope="module")
def runs():
    """JAX's 2-device slab run, the port's 2-rank slab run from the same
    state and decomposition, and the port's one-device run."""
    from jax.sharding import Mesh

    scene = j_scene.scene_from_dict(SCENE)
    js = j_create(PARAMS, scene, capacity=CAPACITY, backend="tiles")
    gcfg = j_gcfg(js.params, scene, js.state, js.state.capacity)
    scfg = jts.make_slab_config(js.params, gcfg, js.state, 2, tq=16)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("p",))
    sst = jts.shard_spatially(js.state, scfg, mesh)
    step = jts.make_slab_step_fn(js.params, scfg, js.boundary_handler, mesh)
    jdiags = []
    for _ in range(STEPS):
        sst, d = step(sst)
        jdiags.append(jax.device_get(d))
    ref = jts.gather_alive(jax.block_until_ready(sst))

    port = run_ranks(job(js, gcfg, scfg), 2, "gloo", "cpu")

    one = t_create(convert.params_from_dict(dataclasses.asdict(PARAMS)),
                   t_scene.scene_from_dict(SCENE), capacity=CAPACITY, device="cpu")
    for _ in range(STEPS):
        one.step()
    return {"js": js, "gcfg": gcfg, "jax": ref, "jdiags": jdiags, "port": port,
            "one": tts.gather_alive(one.state)}


def test_slab_step_matches_jax_slab_step(runs):
    got, ref = tts.gather_alive(runs["port"]["final"]), runs["jax"]
    assert got["position"].shape == ref["position"].shape
    np.testing.assert_allclose(got["position"], ref["position"], atol=2e-5)
    np.testing.assert_allclose(got["velocity"], ref["velocity"], atol=2e-4)
    np.testing.assert_allclose(got["density"], ref["density"], rtol=2e-5)
    assert len(runs["port"]["diags"]) == STEPS
    for k, (dj, dt_) in enumerate(zip(runs["jdiags"], runs["port"]["diags"])):
        for key in ("div_iterations", "density_iterations", "relay_count"):
            assert dt_[key] == int(dj[key]), (k, key)
        assert dt_["shard_overflow"] == 0 == int(dj["shard_overflow"])
        assert dt_["dt"] == pytest.approx(float(dj["dt"]), rel=1e-6)
    assert runs["port"]["n_reshards"] == 0


def test_slab_step_matches_the_one_device_run(runs):
    got, ref = tts.gather_alive(runs["port"]["final"]), runs["one"]
    assert got["position"].shape == ref["position"].shape
    np.testing.assert_allclose(got["position"], ref["position"], atol=5e-5)
    np.testing.assert_allclose(got["velocity"], ref["velocity"], atol=5e-4)
    np.testing.assert_allclose(got["density"], ref["density"], rtol=1e-4)
    # every rank exchanged strips and reduced; none sent more than its strips
    for rr in runs["port"]["ranks"]:
        assert rr["comm"]["exchanges"] >= STEPS and rr["comm"]["reductions"] > 0


def test_forced_reshard_keeps_the_one_device_trajectory(runs):
    res = run_ranks(job(runs["js"], runs["gcfg"], reshard_at=(3,)), 4, "gloo", "cpu")
    assert res["n_reshards"] >= 1
    got, ref = tts.gather_alive(res["final"]), runs["one"]
    assert got["position"].shape == ref["position"].shape
    np.testing.assert_allclose(got["position"], ref["position"], atol=5e-5)
    np.testing.assert_allclose(got["density"], ref["density"], rtol=1e-4)


@pytest.mark.parametrize("method", ["HybridDFSPH", "IISPH"])
def test_iterating_solves_match_the_one_device_run(method):
    from adaptive_sph_torch.stress import IMPACT_CAPACITY, IMPACT_SCENE, impact_params
    from adaptive_sph_torch.utils.params import PressureSolverMethod

    params = impact_params(PressureSolverMethod(method), resident=False)
    one = t_create(params, t_scene.scene_from_dict(IMPACT_SCENE), capacity=IMPACT_CAPACITY,
                   device="cpu")
    ref_diags = [one.step() for _ in range(8)]
    res = run_ranks(SlabJob(params=convert.params_to_dict(params), scene=IMPACT_SCENE, steps=8,
                            capacity=IMPACT_CAPACITY), 2, "gloo", "cpu")
    # both slabs hold particles, and the solves iterate
    x = tts.gather_alive(res["final"])["position"][:, 0]
    assert (x < res["scfg"].edges[1]).any() and (x >= res["scfg"].edges[1]).any()
    assert max(max(d.get("div_iterations", 0), d["density_iterations"]) for d in ref_diags) > 10
    for k, (d1, ds) in enumerate(zip(ref_diags, res["diags"])):
        for key in ("div_iterations", "density_iterations"):
            assert ds.get(key) == d1.get(key), (k, key)
    got, ref = tts.gather_alive(res["final"]), tts.gather_alive(one.state)
    np.testing.assert_allclose(got["position"], ref["position"], atol=5e-5)
    np.testing.assert_allclose(got["velocity"], ref["velocity"], atol=5e-4)
    np.testing.assert_allclose(got["density"], ref["density"], rtol=1e-4)


def test_a_rank_that_raises_makes_the_launcher_raise(runs):
    t0 = time.perf_counter()
    with pytest.raises(Exception, match="injected failure"):
        run_ranks(job(runs["js"], runs["gcfg"]), 2, "gloo", "cpu", RunHooks(fail_at=(1, 1)))
    assert time.perf_counter() - t0 < tts.GROUP_TIMEOUT_S
