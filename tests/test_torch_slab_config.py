"""PyTorch port, the slab decomposition's host side against the JAX package's
(adaptive_sph_tpu/parallel/tile_sharding.py): `make_slab_config` (edges,
c_dev, strip, halo_w and the local tile config, equal), `shard_spatially`,
the strip packer and the payload columns (bit for bit), the modes the slab
step refuses, and the step under one rank's hooks (identity reductions and
refresh) equal to the one-device step, bit for bit.

The scenes: tests/test_multichip.py's (a 1.2 x 0.6 block at spacing 0.03,
uniform sizes) and scripts/multichip_longrun.py's at spacing 0.03 (a 2.4 x
1.2 block, adaptive sizes with resampling), for 2 and 4 slabs.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from adaptive_sph_torch import convert
from adaptive_sph_torch.models.state import FIELDS
from adaptive_sph_torch.models.tile_step import single_step_tiles
from adaptive_sph_torch.multichip import longrun_job
from adaptive_sph_torch.parallel import tile_sharding as tts
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.runner import grid_config_for as t_gcfg
from adaptive_sph_torch.models import scene as t_scene
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

MULTICHIP_SCENE = {
    "boundary": {"type": "box", "width": 2.0, "height": 2.0},
    "blocks": [{"pos": [-0.95, -0.5], "size": [1.2, 0.6], "spacing": 0.03,
                "volume_fill_ratio": 0.93, "velocity": [0, 0]}],
}
UNIFORM = SimulationParams(
    particle_sizes=ParticleSizes.Uniform,
    pressure_solver_method=PressureSolverMethod.HybridDFSPH,
    init_boundary_handler=InitBoundaryHandlerType.AnalyticOverestimate,
    level_estimation_method=LevelEstimationMethod.NoneMethod,
    merging=False, sharing=False, splitting=False, max_iters=50, warm_start_pressure=True,
)


def scenes():
    job = longrun_job(spacing=0.03)
    j_params = SimulationParams(
        particle_sizes=ParticleSizes.Adaptive,
        pressure_solver_method=PressureSolverMethod.HybridDFSPH,
        init_boundary_handler=InitBoundaryHandlerType.AnalyticOverestimate,
        level_estimation_method=LevelEstimationMethod.EmptyAngle,
        merging=True, sharing=True, splitting=True, max_iters=100, max_dt=0.002,
        particle_radius_fine=job.params["particle_radius_fine"],
        particle_radius_base=job.params["particle_radius_base"],
        maximum_surface_distance=2.0, warm_start_pressure=True)
    return {"multichip": (UNIFORM, MULTICHIP_SCENE, 2048), "longrun": (j_params, job.scene, None)}


@pytest.fixture(scope="module", params=["multichip", "longrun"])
def pair(request):
    """Both packages' initial state, parameters and grid on one scene."""
    params, scene_d, capacity = scenes()[request.param]
    scene = j_scene.scene_from_dict(scene_d)
    js = j_create(params, scene, capacity=capacity, backend="tiles")
    gcfg = j_gcfg(js.params, scene, js.state, js.state.capacity)
    host = {k: np.asarray(getattr(js.state, k)) for k in FIELDS}
    t_params = convert.params_from_dict(dataclasses.asdict(js.params))
    return js, gcfg, host, t_params, scene_d


@pytest.mark.parametrize("ndev", [2, 4])
def test_make_slab_config_equals_jax(pair, ndev):
    js, gcfg, host, t_params, scene_d = pair
    want = convert.slab_config_from_dict(dataclasses.asdict(
        jts.make_slab_config(js.params, gcfg, js.state, ndev, tq=16)))
    got = tts.make_slab_config(t_params, convert.grid_config_from_dict(dataclasses.asdict(gcfg)),
                               host, ndev, tq=16)
    assert got == want
    # from the port's own grid config, as its ranks compute it
    own = t_gcfg(t_params, t_scene.scene_from_dict(scene_d), host, len(host["alive"]))
    assert tts.make_slab_config(t_params, own, host, ndev, tq=16) == want
    # a reshard's larger headroom
    j3 = jts.make_slab_config(js.params, gcfg, js.state, ndev, tq=16, headroom=3.0)
    assert tts.make_slab_config(t_params, own, host, ndev, tq=16, headroom=3.0) == \
        convert.slab_config_from_dict(dataclasses.asdict(j3))


@pytest.mark.parametrize("ndev", [2, 4])
def test_shard_spatially_and_local_states_equal_jax(pair, ndev):
    from jax.sharding import Mesh
    import jax

    js, gcfg, host, t_params, _ = pair
    scfg = jts.make_slab_config(js.params, gcfg, js.state, ndev, tq=16)
    sst = jts.shard_spatially(js.state, scfg, Mesh(np.asarray(jax.devices()[:ndev]), ("p",)))
    want = {k: np.asarray(getattr(sst, k)) for k in FIELDS}
    pscfg = convert.slab_config_from_dict(dataclasses.asdict(scfg))
    got = tts.shard_spatially(host, pscfg)
    for k in FIELDS:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    states = convert.slab_states_from_numpy(want, pscfg, device="cpu")
    assert [s.capacity for s in states] == [pscfg.c_dev] * ndev
    ref = jts.gather_alive(sst)
    back = convert.alive_from_slab_states(states)
    for k in ref:
        np.testing.assert_array_equal(back[k], ref[k], err_msg=k)
    # each rank's local grid origin: the reference's traced float32 origin
    for r in range(ndev):
        e = jnp.asarray(scfg.edges, jnp.float32)
        ox = e[r] - jnp.float32(scfg.halo_w + 2 * scfg.tcfg.cell0)
        assert pscfg.rank_tcfg(r).origin == (float(ox), float(jnp.float32(scfg.oy)))


@pytest.mark.parametrize("overflow", [False, True])
def test_pack_strip_and_payload_equal_jax(overflow):
    rng = np.random.default_rng(3 + overflow)
    C, S = 256, 64
    sim = t_create(convert.params_from_dict(dataclasses.asdict(UNIFORM)),
                   t_scene.scene_from_dict(MULTICHIP_SCENE), capacity=1024, device="cpu")
    host = convert.state_to_numpy(sim.state)
    host = {k: (v if v.ndim == 0 else v[:C].copy()) for k, v in host.items()}
    for k in ("velocity", "pressure", "pressure_div", "level", "omega"):
        host[k] = rng.normal(0, 1, host[k].shape).astype(host[k].dtype)
    host["size_class"] = rng.integers(0, 5, C).astype(np.int32)
    host["has_level"] = rng.random(C) < 0.5
    host["alive"] = rng.random(C) < 0.9
    mask = host["alive"] & (rng.random(C) < (0.6 if overflow else 0.2))
    assert (mask.sum() > S) == overflow

    jstate = jts.FluidState(**{k: jnp.asarray(v) for k, v in host.items()})
    jpay = jts._payload_matrix(jstate)
    jbuf, jidx, jov = jts._pack_strip(jnp.asarray(mask), jpay, S)
    tstate = convert.state_from_numpy(host, device="cpu")
    tpay = tts._payload_matrix(tstate)
    np.testing.assert_array_equal(tpay.numpy(), np.asarray(jpay))
    tbuf, tidx, tov = tts._pack_strip(torch.from_numpy(mask), tpay, S)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert int(tov) == int(jov) == max(int(mask.sum()) - S, 0)
    jf, tf = jts._payload_fields(jbuf), tts._payload_fields(tbuf)
    assert list(jf) == list(tf)
    for k in jf:
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]), err_msg=k)


class _OneRankHalo:
    """The hooks of a single rank that owns every particle: the reductions
    and the ghost refresh are the identity."""

    def __init__(self, owned):
        self.owned = owned

    def psum(self, x):
        return x

    pmin = pmax = psum

    def make_refresher(self, bins):
        return self.psum


@pytest.mark.parametrize("mode", ["scalar", "after_advection"])
def test_slab_step_refuses_the_reference_gated_modes(mode, monkeypatch):
    params = convert.params_from_dict(dataclasses.asdict(UNIFORM))
    sim = t_create(params, t_scene.scene_from_dict(MULTICHIP_SCENE), capacity=1024,
                   device="cpu")
    tcfg = sim.tile_cfg
    if mode == "scalar":
        monkeypatch.setenv("ASPH_SCALAR_BLOCKS", "1")
        tcfg = dataclasses.replace(tcfg, tq=128)
    else:
        from adaptive_sph_torch.utils.params import LevelEstimationMethod as LEM

        params = params.replace(level_estimation_method=LEM.EmptyAngle,
                                force_level_estimation=True,
                                level_estimation_after_advection=True,
                                use_extended_range_for_level_estimation=True)
    with pytest.raises(NotImplementedError, match="slab-decomposed step"):
        single_step_tiles(sim.state, params, tcfg, sim.boundary_handler,
                          halo=_OneRankHalo(sim.state.alive))


@pytest.mark.parametrize("name", ["uniform", "levels"])
def test_one_rank_hooks_leave_the_step_unchanged(name):
    """Under hooks whose reductions and refresh are the identity (one rank
    owning every particle) the step is the one-device step, bit for bit:
    every hook only reduces or refreshes, and the owned rows are the alive
    rows."""
    jp = UNIFORM if name == "uniform" else dataclasses.replace(
        UNIFORM, particle_sizes=ParticleSizes.Adaptive,
        level_estimation_method=LevelEstimationMethod.EmptyAngle, force_level_estimation=True,
        particle_radius_base=0.03, particle_radius_fine=0.008, maximum_surface_distance=0.25)
    params = convert.params_from_dict(dataclasses.asdict(jp))
    sim = t_create(params, t_scene.scene_from_dict(MULTICHIP_SCENE), capacity=1024,
                   device="cpu")
    sim.step()  # warm-start pressures and levels from a step
    args = (sim.state, sim.params, sim.tile_cfg, sim.boundary_handler)
    ref, dt_ref, d_ref = single_step_tiles(*args)
    got, dt, d = single_step_tiles(*args, halo=_OneRankHalo(sim.state.alive))
    assert torch.equal(dt, dt_ref)
    assert torch.equal(d.pop("_owned_sorted"), got.alive)
    for k in FIELDS:
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
    for key in ("div_iterations", "density_iterations", "wavefront_sweeps"):
        assert d.get(key) == d_ref.get(key), key
