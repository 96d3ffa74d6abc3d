"""PyTorch port at full width: 3 steps of the ratio-stress-test scene
(n = 11,835, 50:1 radius ratio, bench.py's parameters with the parity options)
against the JAX package, with the step tolerances of test_torch_step.py and
equal iteration counts. The same 3 steps are held against the committed
reference fixture tests/data/torch_port_stress_ref.npz, which the GPU smoke
run (chip_smoke.py) compares with, so the fixture cannot drift from the JAX
package unnoticed.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import bench
from adaptive_sph_torch import convert
from adaptive_sph_torch.models.scene import init_fluid_state
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.stress import stress_params, stress_scene
from test_torch_step import assert_states_match

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_port_stress_ref.npz")
STEPS = 3


def test_stress_scene_three_steps_match_jax_and_fixture():
    js = bench.build_sim(replicas=1, bf16=False, momentum=0.0, cold=True)
    # the GPU smoke run's configuration is bench.py's, field for field
    assert convert.params_to_dict(stress_params(False)) == convert.params_to_dict(
        convert.params_from_dict(dataclasses.asdict(js.params)))
    jb = bench.build_sim(replicas=1, bf16=True, momentum=0.9, cold=False)
    assert convert.params_to_dict(stress_params(True)) == convert.params_to_dict(
        convert.params_from_dict(dataclasses.asdict(jb.params)))
    ts = t_create(stress_params(False), stress_scene(), device="cpu")
    assert ts.num_fluid_particles == 11835 and ts.tile_cfg.capacity == 14336
    assert ts.tile_cfg.populated == js.tile_cfg.populated == (0, 6)
    ref = np.load(FIXTURE)
    for k in range(STEPS):
        dj, dt_ = js.step(), ts.step()
        assert dt_["num_pairs"] == 151409  # the reference's pair census at x1
        for name in ("div_iterations", "density_iterations"):
            assert dt_[name] == int(dj[name]) == int(ref[name][k]), (name, k)
        assert np.float32(dt_["dt"]) == np.float32(dj["dt"]) == ref["dt"][k]
    assert_states_match(js, ts)


@pytest.mark.parametrize("replicas,n", [(1, 11835), (4, 47340)])
def test_stress_scene_replicas_follow_bench_layout(monkeypatch, replicas, n):
    # stress_scene(replicas) is bench.build_sim(replicas)'s scene, block for block
    import adaptive_sph_tpu.runner as j_runner

    seen = []
    monkeypatch.setattr(j_runner, "create_simulation", lambda p, scene, **k: seen.append(scene))
    bench.build_sim(replicas=replicas)
    (js,) = seen
    ts = stress_scene(replicas)
    assert (ts.boundary_type, ts.boundary_width, ts.boundary_height) == (
        js.boundary_type, js.boundary_width, js.boundary_height)
    fields = ("pos", "size", "spacing", "volume_fill_ratio", "velocity")
    assert [tuple(getattr(b, f) for f in fields) for b in ts.blocks] == [
        tuple(getattr(b, f) for f in fields) for b in js.blocks]
    st = init_fluid_state(ts, stress_params(True), device="cpu")
    assert int(st.alive.sum()) == n
