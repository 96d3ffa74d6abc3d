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
import torch

import bench
from adaptive_sph_torch import convert
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
