"""PyTorch port, the slab-decomposed step's classic branch (a density sweep,
then K1 in classic mode, the solves streamed over K2) against the JAX
package's `make_slab_step_fn` on 2 virtual devices, from one state.

Two configurations take that branch: the Winchenbach2020 discretization,
and `resident_solver`, whose whole-solve kernels the slab step gates off
(as the reference does) so that its solves stream with the ghost rows
refreshed. The scene is stress.py's impact scene (144 particles thrown at
the floor across the slab edge, HybridDFSPH, solves of up to 60 sweeps), 6
steps on 2 gloo CPU ranks. Held at the uniform slab test's tolerances:
positions atol 2e-5, velocity atol 2e-4, density rtol 2e-5, equal solver
iterations at every step (2 ranks: a psum of two floats does not depend on
the order), shard_overflow 0, equal relay counts.
"""

import dataclasses

import numpy as np
import pytest

import jax
from adaptive_sph_torch import convert
from adaptive_sph_torch.models.state import FIELDS
from adaptive_sph_torch.multichip import SlabJob, run_ranks
from adaptive_sph_torch.parallel import tile_sharding as tts
from adaptive_sph_torch.stress import IMPACT_CAPACITY, IMPACT_SCENE, impact_params
from adaptive_sph_torch.utils.params import OperatorDiscretization, PressureSolverMethod
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.parallel import tile_sharding as jts
from adaptive_sph_tpu.runner import create_simulation as j_create
from adaptive_sph_tpu.runner import grid_config_for as j_gcfg
from adaptive_sph_tpu.utils import params as j_params

CONFIGS = {
    "winchenbach2020": dict(resident=False,
                            operator_discretization=OperatorDiscretization.Winchenbach2020),
    "resident_solver": dict(resident=True),
}
STEPS = 6


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_classic_slab_step_matches_jax_slab_step(name):
    from jax.sharding import Mesh

    params = impact_params(PressureSolverMethod.HybridDFSPH, **CONFIGS[name])
    scene = j_scene.scene_from_dict(IMPACT_SCENE)
    js = j_create(j_params.params_from_dict(convert.params_to_dict(params)), scene,
                  capacity=IMPACT_CAPACITY, backend="tiles")
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

    port = run_ranks(SlabJob(
        params=convert.params_to_dict(js.params), scene=IMPACT_SCENE, steps=STEPS,
        capacity=IMPACT_CAPACITY, state={k: np.asarray(getattr(js.state, k)) for k in FIELDS},
        gcfg=convert.grid_config_from_dict(dataclasses.asdict(gcfg)),
        scfg=convert.slab_config_from_dict(dataclasses.asdict(scfg))), 2, "gloo", "cpu")
    got = tts.gather_alive(port["final"])
    # both slabs hold particles, and the solves iterate
    assert (got["position"][:, 0] < scfg.edges[1]).any()
    assert (got["position"][:, 0] >= scfg.edges[1]).any()
    assert max(int(d["div_iterations"]) for d in jdiags) > 10
    assert got["position"].shape == ref["position"].shape
    np.testing.assert_allclose(got["position"], ref["position"], atol=2e-5)
    np.testing.assert_allclose(got["velocity"], ref["velocity"], atol=2e-4)
    np.testing.assert_allclose(got["density"], ref["density"], rtol=2e-5)
    for k, (dj, dt_) in enumerate(zip(jdiags, port["diags"])):
        for key in ("div_iterations", "density_iterations", "relay_count"):
            assert dt_[key] == int(dj[key]), (k, key)
        assert dt_["shard_overflow"] == 0 == int(dj["shard_overflow"])
