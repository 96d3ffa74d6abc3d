"""PyTorch port, the rest of the solver surface: whole steps against the JAX
package on the CPU (its Pallas kernels in interpret mode) with PERF.md's
gate: positions atol 2e-5, density rtol 2e-5, velocity atol 2e-4, iteration
counts equal at every step, resident pressure rtol 5e-3 / atol 1e-2.

- the impact scene (144 particles thrown at the floor, solves of 13-60
  sweeps), 6 steps, one case per family: Winchenbach2020 streamed and
  resident, IISPH2 (WCSPH viscosity, resident; warm start, streamed), the
  non-pressure step after the divergence solve (WCSPH streamed; resident:
  two pair_jacobi solves), ConsistentSymmetricGradient (the mirrored
  boundary pressure in the resident table), `pull_fluid_to` and the WCSPH
  viscosity stream of the mega branch;
- the Winchenbach IISPH-instabilities export (configs/media/), its first 20
  steps.
"""

import os

import pytest
import torch

from adaptive_sph_torch import convert
from adaptive_sph_torch.stress import impact_params, solver_runs
from adaptive_sph_torch.utils.params import (OperatorDiscretization as OD,
                                             PressureSolverMethod as M, ViscosityType as VT)
from adaptive_sph_tpu.utils import params as j_params
from test_torch_resident import assert_impact_run_matches
from test_torch_step import assert_states_match, run_pair

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W2020 = dict(operator_discretization=OD.Winchenbach2020)
WCSPH = dict(viscosity_type=VT.WCSPH, viscosity=0.003)
AFTER_DIV = dict(hybrid_dfsph_non_pressure_accel_before_divergence_free=False)

# impact-scene families (6 steps, resident unless resident=False)
IMPACT_CASES = {
    "w2020_hybrid_streamed": dict(method=M.HybridDFSPH, resident=False, **W2020),
    "w2020_iisph_streamed": dict(method=M.IISPH, resident=False, **W2020),
    "w2020_only_divergence": dict(method=M.OnlyDivergence, **W2020),
    "iisph2_wcsph": dict(method=M.IISPH2, **WCSPH),
    "iisph2_streamed_warm_start": dict(method=M.IISPH2, resident=False, warm_start_pressure=True),
    "wcsph_after_div_streamed": dict(method=M.HybridDFSPH, resident=False, **WCSPH, **AFTER_DIV),
    "after_div_resident": dict(method=M.HybridDFSPH, **AFTER_DIV),
    "symmetric_gradient": dict(method=M.HybridDFSPH,
                               operator_discretization=OD.ConsistentSymmetricGradient),
    "pull_fluid_to": dict(method=M.HybridDFSPH, resident=False, pull_fluid_to=(0.0, 0.5)),
    "wcsph_mega": dict(method=M.HybridDFSPH, resident=False, **WCSPH),
}


@pytest.mark.parametrize("case", list(IMPACT_CASES))
def test_impact_steps_match_jax(case):
    kw = dict(IMPACT_CASES[case])
    assert_impact_run_matches(case, impact_params(kw.pop("method"), **kw))


def test_media_configuration_first_steps_match_jax():
    # the Winchenbach IISPH-instabilities export (IISPH, Winchenbach2020,
    # adaptive sizes, no resampling): 20 steps at the gate
    params, scene, capacity, _ = solver_runs()["winchenbach_instabilities"]
    jp = j_params.params_from_dict(convert.params_to_dict(params))
    js, ts, diags = run_pair(jp, scene, capacity, 20)
    for dj, d in diags:
        assert d["density_iterations"] == int(dj["density_iterations"])
        assert int(d["negative_aii"]) == int(dj["negative_aii"])
    assert max(d["density_iterations"] for _, d in diags) > 2
    assert_states_match(js, ts)
