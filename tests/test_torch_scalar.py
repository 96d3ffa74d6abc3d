"""PyTorch port, the scalar-g pair storage (ASPH_SCALAR_BLOCKS=1): the
reference's opt-in v7 scalar blocks, taken on its mega branch at tq = 128
only. K1 stores g = m_j |grad W_ij| / r per pair (and B g with viscosity);
the streams K2s and K3s rebuild wx, wy from the sorted positions.

- The impact scene (capacity 1,024, tq = 128), HybridDFSPH and IISPH on the
  mega branch, 6 steps with the variable set for both packages, against the
  JAX package: the tolerances and equal iteration counts of
  test_torch_resident.py. The scalar wrappers must have run, the two-row
  ones not.
- The committed fixture tests/data/torch_port_scalar_ref.npz
  (scripts/torch_port_scalar_ref.py: 10 parity steps of the stress scene on
  JAX's scalar path), which the GPU smoke run compares with: its first 3
  steps against a fresh JAX run, and the port's 3 scalar steps against both.
"""

import os

import numpy as np
import pytest
import torch

import bench
from adaptive_sph_torch.ops import pair_ops
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.stress import impact_params, impact_scene, stress_params, stress_scene
from adaptive_sph_torch.utils.params import PressureSolverMethod as M
from test_torch_resident import STEPS, assert_impact_run_matches
from test_torch_step import assert_states_match

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                       "torch_port_scalar_ref.npz")


def count_pair_streams(monkeypatch):
    """Spies counting the calls of the four stream wrappers."""
    calls = {}
    for name in ("pair_matvec", "pair_visc", "pair_matvec_scalar", "pair_visc_scalar"):
        real = getattr(pair_ops, name)

        def f(*a, _real=real, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _real(*a, **k)
        monkeypatch.setattr(pair_ops, name, f)
    return calls


@pytest.mark.parametrize("method", [M.HybridDFSPH, M.IISPH])
def test_scalar_steps_match_jax(monkeypatch, method):
    monkeypatch.setenv("ASPH_SCALAR_BLOCKS", "1")
    calls = count_pair_streams(monkeypatch)
    assert_impact_run_matches(f"scalar_{method.value}", impact_params(method, resident=False))
    # one viscosity stream per step; at least one accel and one div per solve
    assert calls.get("pair_visc_scalar") == STEPS and calls.get("pair_matvec_scalar", 0) >= 4 * STEPS
    assert "pair_matvec" not in calls and "pair_visc" not in calls


def test_scalar_needs_query_tiles_of_128(monkeypatch):
    # the reference's gate: at tq = 64 (capacity 512 + 64) the list keeps two rows
    monkeypatch.setenv("ASPH_SCALAR_BLOCKS", "1")
    calls = count_pair_streams(monkeypatch)
    sim = t_create(impact_params(M.IISPH, resident=False), impact_scene(), capacity=576,
                   device="cpu")
    assert sim.tile_cfg.tq == 64
    sim.step()
    assert calls.get("pair_matvec", 0) > 0 and "pair_matvec_scalar" not in calls


def test_scalar_stress_steps_match_jax_and_fixture(monkeypatch):
    monkeypatch.setenv("ASPH_SCALAR_BLOCKS", "1")
    calls = count_pair_streams(monkeypatch)
    js = bench.build_sim(replicas=1, bf16=False, momentum=0.0, cold=True)
    ts = t_create(stress_params(False), stress_scene(), device="cpu")
    assert ts.tile_cfg.tq == js.tile_cfg.tq == 128
    ref = np.load(FIXTURE)
    for k in range(3):
        dj, dt_ = js.step(), ts.step()
        assert dt_["num_pairs"] == 151409
        for name in ("div_iterations", "density_iterations"):
            assert dt_[name] == int(dj[name]) == int(ref[name][k]), (name, k)
        assert np.float32(dt_["dt"]) == np.float32(dj["dt"]) == ref["dt"][k]
    assert_states_match(js, ts)
    assert calls.get("pair_visc_scalar") == 3 and "pair_matvec" not in calls
