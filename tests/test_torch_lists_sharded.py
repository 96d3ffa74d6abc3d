"""PyTorch port, the particle-sharded list step (parallel/sharding.py) over
torch.distributed (gloo ranks on the CPU) against the port's one-device list
step and the JAX package's `make_sharded_step_fn` on its 8-device CPU mesh.

- tests/test_multichip.py's scene and parameters (a 0.5 x 0.5 block at
  spacing 0.05, uniform IISPH, capacity 1,024) on 2 ranks for 3 steps: the
  gathered state equal to the one-device list run's, field for field (every
  rank runs the same deterministic step); against JAX's sharded step,
  positions atol 2e-5, density rtol 2e-5, velocity atol 2e-4, equal
  iteration counts, row by row (both keep the particle order).
- A small adaptive dam (default-config.yaml with levels after advection over
  the stale pairs, share / merge / split, 180 particles, capacity 2,048) on
  2 ranks for 2 steps: a split and a merge step, the gathered state equal
  to the one-device run's and the counters equal.
"""

import jax
import numpy as np
import pytest
import torch

from adaptive_sph_torch import convert
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.multichip import RunHooks, run_ranks
from adaptive_sph_torch.parallel.sharding import ShardedListJob, row_block
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.stress import list_runs
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.parallel.sharding import make_mesh, make_sharded_step_fn, shard_state
from adaptive_sph_tpu.runner import create_simulation as j_create
from adaptive_sph_tpu.utils import params as j_params

torch.set_num_threads(2)

SCENE = {"boundary": {"type": "box", "width": 1.2, "height": 1.2},
         "blocks": [{"pos": [-0.25, -0.25], "size": [0.5, 0.5], "spacing": 0.05,
                     "volume_fill_ratio": 0.93, "velocity": [0, 0]}]}
PARAMS = {"particle_sizes": "Uniform", "pressure_solver_method": "IISPH",
          "init_boundary_handler": "AnalyticOverestimate", "level_estimation_method": "None",
          "merging": False, "sharing": False, "splitting": False, "max_iters": 50}
SMALL_DAM = {"boundary": {"type": "box", "width": 2, "height": 2},
             "blocks": [{"pos": [-0.95, -0.95], "size": [0.5, 0.5], "spacing": 0.04,
                         "volume_fill_ratio": 0.93, "velocity": [0, 0]}]}
STATE = ("position", "velocity", "density", "mass", "level", "alive", "has_level",
         "flag_is_fluid_surface", "pressure")


def one_device(params: dict, scene: dict, capacity: int, steps: int):
    sim = t_create(convert.params_from_dict(params), t_scene.scene_from_dict(scene),
                   capacity=capacity, device="cpu", backend="lists")
    diags = [sim.step() for _ in range(steps)]
    return convert.state_to_numpy(sim.state), diags


def test_row_blocks():
    assert [row_block(1024, 4, r) for r in range(4)] == [(0, 256), (256, 512), (512, 768),
                                                          (768, 1024)]
    with pytest.raises(ValueError):
        row_block(1000, 3, 0)


def test_two_ranks_match_one_device_and_jax():
    res = run_ranks(ShardedListJob(params=PARAMS, scene=SCENE, steps=3, capacity=1024), 2,
                    "gloo", "cpu")
    one, one_diags = one_device(PARAMS, SCENE, 1024, 3)
    for k in STATE:
        np.testing.assert_array_equal(res["final"][k], one[k], err_msg=k)
    assert [d["density_iterations"] for d in res["diags"]] == [
        d["density_iterations"] for d in one_diags]
    assert all(r["comm"]["gathers"] == 3 for r in res["ranks"])
    assert not any(res["ranks"][0]["launches"].values())  # no tile kernel, no plain twin

    # the reference's GSPMD particle-sharded step on 8 virtual devices
    if len(jax.devices()) < 8:
        pytest.skip("needs the 8-device virtual mesh")
    params = j_params.params_from_dict(PARAMS)
    js = j_create(params, j_scene.scene_from_dict(SCENE), capacity=1024, backend="lists")
    mesh = make_mesh(8)
    step = make_sharded_step_fn(js.params, js.ncfg, js.boundary_handler, mesh)
    state = shard_state(js.state, mesh)
    iters = []
    for _ in range(3):
        state, d = step(state)
        iters.append(int(d["density_iterations"]))
    assert iters == [d["density_iterations"] for d in res["diags"]]
    a = np.asarray(state.alive)
    np.testing.assert_array_equal(res["final"]["alive"], a)
    got = {k: res["final"][k][a] for k in ("position", "velocity", "density")}
    np.testing.assert_allclose(got["position"], np.asarray(state.position)[a], atol=2e-5)
    np.testing.assert_allclose(got["density"], np.asarray(state.density)[a], rtol=2e-5)
    np.testing.assert_allclose(got["velocity"], np.asarray(state.velocity)[a], atol=2e-4)


def test_two_ranks_resample_as_one_device():
    params = convert.params_to_dict(list_runs()["dambreak"][0])
    res = run_ranks(ShardedListJob(params=params, scene=SMALL_DAM, steps=2, capacity=2048), 2,
                    "gloo", "cpu")
    one, one_diags = one_device(params, SMALL_DAM, 2048, 2)
    for k in STATE:
        np.testing.assert_array_equal(res["final"][k], one[k], err_msg=k)
    for d, o in zip(res["diags"], one_diags):
        for k in ("shares", "merge_or_split_count", "div_iterations", "density_iterations"):
            assert d[k] == o[k], k
    assert sum(d["merge_or_split_count"] for d in res["diags"]) > 0


def test_a_failing_rank_raises():
    with pytest.raises(RuntimeError, match="injected failure"):
        run_ranks(ShardedListJob(params=PARAMS, scene=SCENE, steps=2, capacity=1024), 2,
                  "gloo", "cpu", hooks=RunHooks(fail_at=(1, 1)))
