"""PyTorch port, the resident whole-solve path at full width: 3 steps of the
ratio-stress-test scene (n = 11,835) with `resident_solver=True` and the
parity options (bench.py's build_sim(resident=True, bf16=False,
momentum=0.0, cold=True)) against the JAX package's resident path, with the
step tolerances of test_torch_step.py and equal iteration counts. The same 3
steps are held against the committed fixture
tests/data/torch_port_resident_ref.npz (run "stress_hybrid"), which the GPU
smoke run compares with.
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
                       "torch_port_resident_ref.npz")
STEPS = 3


def test_resident_stress_three_steps_match_jax_and_fixture():
    js = bench.build_sim(replicas=1, resident=True, bf16=False, momentum=0.0, cold=True)
    # the resident option sets are bench.py's, field for field (the bench
    # options with momentum 0: the reference's resident kernels have none)
    assert convert.params_to_dict(stress_params(resident=True)) == convert.params_to_dict(
        convert.params_from_dict(dataclasses.asdict(js.params)))
    jb = bench.build_sim(replicas=1, resident=True, bf16=True, momentum=0.0, cold=False)
    assert convert.params_to_dict(stress_params(bench=True, resident=True)) == \
        convert.params_to_dict(convert.params_from_dict(dataclasses.asdict(jb.params)))
    ts = t_create(stress_params(resident=True), stress_scene(), device="cpu")
    assert ts.tile_cfg.capacity == 14336 and ts.tile_cfg.populated == js.tile_cfg.populated
    ref = np.load(FIXTURE)
    for k in range(STEPS):
        dj, d = js.step(), ts.step()
        assert d["num_pairs"] == 151409
        for name in ("div_iterations", "density_iterations"):
            assert d[name] == int(dj[name]) == int(ref[f"stress_hybrid__{name}"][k]), (name, k)
        assert np.float32(d["dt"]) == np.float32(dj["dt"]) == ref["stress_hybrid__dt"][k]
    assert_states_match(js, ts)
