"""PyTorch port, slab-local resampling: tests/test_multichip.py's adaptive
scene (a 1.2 x 0.6 block at spacing 0.03, adaptive HybridDFSPH, EmptyAngle
levels, share / merge / split) on 2 gloo CPU ranks for 2 steps (share and
split, then share and merge) against the JAX package's slab step on 2
virtual devices, from one state.

Held: the mass conservation error of every step < 1e-5 and the total mass
to 1e-5 of the initial; resampling events > 0; after the first step the
census, the resampling counters and the positions (atol 2e-5) and levels
(atol 1e-6) equal JAX's slab run (matched by position). After a merge, a
particle's position is a mass-weighted mean, so two particles can trade
places in the (x, y) order within float32 noise; the second step is held
by its invariants.
"""

import dataclasses

import numpy as np
import pytest

import jax
from adaptive_sph_torch import convert
from adaptive_sph_torch.models.state import FIELDS
from adaptive_sph_torch.multichip import SlabJob, run_ranks
from adaptive_sph_torch.parallel import tile_sharding as tts
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
    particle_sizes=ParticleSizes.Adaptive,
    pressure_solver_method=PressureSolverMethod.HybridDFSPH,
    init_boundary_handler=InitBoundaryHandlerType.AnalyticOverestimate,
    level_estimation_method=LevelEstimationMethod.EmptyAngle,
    merging=True, sharing=True, splitting=True,
    particle_radius_base=0.03, particle_radius_fine=0.008,
    maximum_surface_distance=0.25, warm_start_pressure=True, max_iters=50,
)
CAPACITY = 4096
STEPS = 2


@pytest.fixture(scope="module")
def runs():
    from jax.sharding import Mesh

    scene = j_scene.scene_from_dict(SCENE)
    js = j_create(PARAMS, scene, capacity=CAPACITY, backend="tiles")
    gcfg = j_gcfg(js.params, scene, js.state, js.state.capacity)
    scfg = jts.make_slab_config(js.params, gcfg, js.state, 2, tq=16)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("p",))
    host = {k: np.asarray(getattr(js.state, k)) for k in FIELDS}
    sst = jts.shard_spatially(js.state, scfg, mesh)
    step = jts.make_slab_step_fn(js.params, scfg, js.boundary_handler, mesh,
                                 split_patterns=js.split_patterns)
    jdiags, jsnaps = [], []
    for _ in range(STEPS):
        sst, d = step(sst)
        jdiags.append(jax.device_get(d))
        jsnaps.append(tts.gather_alive({k: np.asarray(getattr(sst, k)) for k in FIELDS}))
    pos, counts = js.split_patterns
    job = SlabJob(params=convert.params_to_dict(js.params), scene=SCENE, steps=STEPS,
                  capacity=CAPACITY, state=host,
                  gcfg=convert.grid_config_from_dict(dataclasses.asdict(gcfg)),
                  scfg=convert.slab_config_from_dict(dataclasses.asdict(scfg)),
                  split_patterns=(np.asarray(pos), np.asarray(counts)), snapshots=(1,))
    port = run_ranks(job, 2, "gloo", "cpu")
    mass0 = float(np.sum(host["mass"][host["alive"]].astype(np.float64)))
    return {"jdiags": jdiags, "jsnaps": jsnaps, "port": port, "mass0": mass0}


def test_slab_resampling_conserves_mass_and_resamples(runs):
    diags = runs["port"]["diags"]
    assert len(diags) == STEPS
    events = 0
    for d in diags:
        assert d["mass_conservation_error"] < 1e-5
        assert d["shard_overflow"] == 0
        events += d["merge_or_split_count"] + d["shares"]
    assert events > 0, "no resampling event: the test would be vacuous"
    fin = runs["port"]["final"]
    mass = float(np.sum(fin["mass"][fin["alive"]].astype(np.float64)))
    assert abs(mass - runs["mass0"]) / runs["mass0"] < 1e-5
    assert int(fin["n"]) == int(fin["alive"].sum())


def test_slab_levels_and_counters_match_jax_after_the_first_step(runs):
    dj, dt_ = runs["jdiags"][0], runs["port"]["diags"][0]
    for key in ("shares", "merge_or_split_count", "split_deferred", "div_iterations",
                "density_iterations"):
        assert dt_[key] == int(dj[key]), key
    got, ref = tts.gather_alive(runs["port"]["snapshots"][1]), runs["jsnaps"][0]
    assert got["position"].shape == ref["position"].shape
    np.testing.assert_allclose(got["position"], ref["position"], atol=2e-5)
    np.testing.assert_allclose(got["level"], ref["level"], atol=1e-6)
    np.testing.assert_allclose(got["mass"], ref["mass"], rtol=1e-6)
    # the second step's census
    fin = runs["port"]["final"]
    assert int(fin["alive"].sum()) == runs["jsnaps"][1]["position"].shape[0]
