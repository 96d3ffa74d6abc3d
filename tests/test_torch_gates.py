"""PyTorch port, the long-horizon scenario gates (adaptive_sph_torch/gates.py).

(a) The gates' rule: the port's `run_scenario` and the reference's
    scripts/scenario_gates.py `run_scenario`, each driven over the same
    scripted simulation (fixed per-step diagnostics and particles, through a
    stand-in for `create_simulation`), give the same record: capped solves
    against violations, NaN averages skipped, the divergence error as
    |avg| x dt, a dt collapse that stops the run, onlydiv's containment
    slack, the mass rule, and the pass rule.
(b) Short runs of dam, stress (momentum 0 and 0.9), onlydiv and motivation
    on the CPU against tests/data/torch_port_gates_ref.json (the JAX
    package's own gates, scripts/torch_port_gates_ref.py): steps, n_final
    and the per-step dt and iteration counts equal; mass drift within 1e-5
    (the dam break's mass rtol, PERF.md section 2) and the maximum errors
    within rtol 2e-5 (its density rtol), the solves' averages also within
    1e-4 of the tolerance they are held to: a solve stopped at the
    2-iteration floor far below its tolerance reports a difference of
    near-equal sums, whose float32 rounding is large relative to it (the
    motivation scene's divergence residual, 1e-3 of its tolerance, differs
    by 0.6% between the packages with every iteration count equal).
(c) The committed PARITY_RUNS_TORCH.json (taken on the GPU) shows passing
    gates, as tests/test_long_horizon.py asks of PARITY_RUNS.json.
(d) With ASPH_LONG_E2E=1 and a CUDA device, the gates' dam and stress
    scenarios through the CLI (ASPH_LONG_T_SCALE, default 0.25).
"""

import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

import adaptive_sph_tpu.runner as j_runner
from adaptive_sph_tpu.ops import kernels as j_kernels
from adaptive_sph_tpu.utils.params import load_params as j_load_params
from adaptive_sph_torch import gates
from adaptive_sph_torch import runner as t_runner
from adaptive_sph_torch.tally import SolveTally, gate_ok

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_gates_ref.json")
RECORD = os.path.join(ROOT, "PARITY_RUNS_TORCH.json")
LONG = os.environ.get("ASPH_LONG_E2E") == "1"
RECORD_KEYS = ("dam", "stress", "stress_plain", "resampling", "onlydiv", "onlydiv_momentum",
               "motivation", "slab_soak")
NOT_COMPARED = ("wall_s", "ms_per_step", "platform")


def _reference_gates():
    spec = importlib.util.spec_from_file_location(
        "scenario_gates", os.path.join(ROOT, "scripts", "scenario_gates.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def step_diag(dt, den=None, den_it=2, div=0.0, div_it=2, den_all=None):
    d = {"dt": dt, "div_avg_error": div, "div_iterations": div_it}
    if den is not None:
        d.update(density_avg_error=den, density_iterations=den_it)
    if den_all is not None:
        d.update(density_avg_error_all=den_all, density_max_error_all=4 * den_all)
    return d


# scripted runs: (scenario, per-step diagnostics, x positions of the
# particles (y = 0), factor on every mass after the first step)
IN_BOX = [0.0, 0.5, -0.9, 0.95]
SCRIPTS = {
    # dam: density tolerance 0.01 (rest density 1), cap 1000
    "capped_vs_violation": ("dam", [step_diag(0.004, den=0.005),
                                    step_diag(0.004, den=0.02, den_it=7),
                                    step_diag(0.004, den=0.02, den_it=1000),
                                    step_diag(0.004, den=0.010001, den_it=3)], IN_BOX, 1.0),
    "nan_averages": ("dam", [step_diag(0.004, den=float("nan"), den_it=2, den_all=0.2),
                             step_diag(0.004, den=0.003, den_all=0.01),
                             step_diag(0.004, den=0.5, div=float("nan"), div_it=9)],
                     IN_BOX, 1.0),
    # stress: divergence tolerance 1e-4 against |avg| x dt, cap 200, chunks of 2
    "div_times_dt": ("stress", [step_diag(0.001, den=0.0005, div=0.05),
                                step_diag(0.003, den=0.0005, div=0.05, div_it=12),
                                step_diag(0.003, den=0.0005, div=0.5, div_it=200),
                                step_diag(0.002, den=0.002, den_it=200, div=0.01)],
                     IN_BOX, 1.0),
    "dt_collapse": ("stress", [step_diag(0.001, den=0.0005), step_diag(0.001, den=0.0005),
                               step_diag(0.001, den=0.5, den_it=3), step_diag(0.0, den=0.0005),
                               step_diag(0.001, den=0.0005), step_diag(0.001, den=0.0005)],
                    IN_BOX, 1.0),
    "dt_nan": ("dam", [step_diag(0.004, den=0.001), step_diag(float("nan"), den=0.001),
                       step_diag(0.004, den=0.001)], IN_BOX, 1.0),
    # onlydiv: no density tolerance; a particle 0.15 past the wall is inside
    # its slack (one coarse support radius) but outside the others' 0.1
    "onlydiv_slack": ("onlydiv", [{"dt": 0.006, "div_avg_error": 0.03, "div_iterations": 1000},
                                  {"dt": 0.006, "div_avg_error": 0.001, "div_iterations": 40},
                                  {"dt": 0.006, "div_avg_error": 0.1, "div_iterations": 3}],
                      IN_BOX + [1.15], 1.0),
    "dam_outside": ("dam", [step_diag(0.004, den=0.001)] * 3, IN_BOX + [1.15], 1.0),
    "nonfinite_position": ("dam", [step_diag(0.004, den=0.001)] * 2, IN_BOX + [float("nan")],
                           1.0),
    "mass_drift": ("dam", [step_diag(0.004, den=0.001)] * 3, IN_BOX, 1.002),
    "mass_kept": ("dam", [step_diag(0.004, den=0.001)] * 3, IN_BOX, 1.0005),
    "passing": ("resampling", [step_diag(0.002, den=0.004, den_it=3, div=0.1, den_all=0.05)] * 4,
                IN_BOX, 1.0),
}


class _ScriptedSim:
    """A simulation that replays scripted diagnostics; `arrays` makes its
    state's arrays (numpy for the reference, torch for the port)."""

    def __init__(self, params, scene, script, arrays, chunk_of):
        _, diags, xs, mass_scale = script
        self.params, self.scene = params, scene
        self._diags = iter(diags)
        self._mass_scale = mass_scale
        self._first = True
        self._arrays = arrays
        self._chunk_of = chunk_of
        pos = np.zeros((len(xs), 2), np.float32)
        pos[:, 0] = xs
        self.state = types.SimpleNamespace(alive=arrays(np.ones(len(xs), bool)),
                                           position=arrays(pos),
                                           mass=arrays(np.full(len(xs), 0.25, np.float32)),
                                           capacity=len(xs))
        self.num_fluid_particles = len(xs)
        self.time = 0.0
        self.backend = "lists"
        self.device = torch.device("cpu")

    def step(self):
        d = dict(next(self._diags))
        self.time = float(np.float32(self.time) + np.float32(d["dt"]))
        if self._first:  # the masses after resampling
            self.state.mass = self._arrays(np.full(self.num_fluid_particles,
                                                   0.25 * self._mass_scale, np.float32))
            self._first = False
        return d

    def step_chunk(self, n):
        ds = [self.step() for _ in range(n)]
        return self._chunk_of({k: [d[k] for d in ds] for k in ds[0]})


def _script_end(script) -> float:
    """A t_end the scripted steps reach (the reference's loop stops at it)."""
    return 0.999 * sum(d["dt"] for d in script[1] if np.isfinite(d["dt"]))


@pytest.mark.parametrize("case", sorted(SCRIPTS))
def test_gates_rule_matches_the_reference_script(case, monkeypatch):
    script = SCRIPTS[case]
    name = script[0]
    t_end = _script_end(script)
    ref_mod = _reference_gates()

    def j_fake(params, scene, **kw):
        return _ScriptedSim(params, scene, script, np.asarray,
                            lambda d: {k: np.asarray(v) for k, v in d.items()})

    def t_fake(params, scene, **kw):
        return _ScriptedSim(params, scene, script, torch.from_numpy, lambda d: d)

    monkeypatch.setattr(j_runner, "create_simulation", j_fake)
    ref, ref_ok = ref_mod.run_scenario(name, t_end, chunk=2)
    monkeypatch.setattr(t_runner, "create_simulation", t_fake)
    got, ok, tally = gates.run_scenario(name, t_end, chunk=2, device="cpu")
    assert ok == ref_ok, (case, got, ref)
    for k, want in ref.items():
        if k in NOT_COMPARED:
            continue
        have = got[k]
        if isinstance(want, float) and want is not None:
            # mass sums: float32 in the script, float64 here
            rtol = 1e-5 if k == "mass_drift" else 1e-12
            assert have == pytest.approx(want, rel=rtol, abs=1e-12), (case, k, have, want)
        else:
            assert have == want, (case, k, have, want)
    assert got["platform"] == "cpu" and got["device"] == "cpu"
    assert tally.steps == ref["steps"]


@pytest.mark.parametrize("record, ok", [
    ({}, True),
    ({"contained": False}, False),
    ({"mass_drift": 1e-3}, False),
    ({"mass_drift": 9.9e-4}, True),
    ({"density_tol_violations": 1}, False),
    ({"div_tol_violations": 2}, False),
    ({"capped_div_solves": 366, "capped_density_solves": 4}, True),
    ({"dt_collapse_t": 0.0}, False),
])
def test_gate_ok_is_the_reference_pass_rule(record, ok):
    base = {"contained": True, "mass_drift": 0.0, "density_tol_violations": 0,
            "div_tol_violations": 0, "dt_collapse_t": None}
    assert gate_ok({**base, **record}) is ok


@pytest.mark.parametrize("name", sorted(gates.TARGETS))
def test_containment_slack_and_tolerances_match_the_reference(name):
    params, _, tol_den, tol_div = gates.scenario(name)
    slack = gates.containment_slack(name, params)
    if name == "onlydiv":
        jp = j_load_params(os.path.join(ROOT, "configs", "default-config.yaml"),
                           update_attributes={"particle_radius_base": 0.06})
        h_base = float(j_kernels.smoothing_length_from_volume(
            j_kernels.radius_to_sphere_volume(jp.particle_radius_base, 2), 2))
        want = max(0.1, h_base * j_kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH)
        assert slack == pytest.approx(want, rel=1e-6) and slack > 0.2
        assert tol_den is None and tol_div == 0.0001
    else:
        assert slack == 0.1
        assert tol_den == params.hybrid_dfsph_max_avg_density_error
    assert int(params.max_iters) == (200 if name == "stress" else 1000)


def test_dt_collapse_stops_the_tally():
    tally = SolveTally(200, 1.0, 1e-3, 1e-4)
    assert tally.add({"dt": [0.001, 0.001], "density_avg_error": [0.5, 0.5],
                      "density_iterations": [200, 3]}, 0.002)
    assert (tally.viol, tally.capped) == ({"den": 1, "div": 0}, {"den": 1, "div": 0})
    assert not tally.add({"dt": [0.001, 1e-10], "density_avg_error": [0.5, 0.5],
                          "density_iterations": [3, 3]}, 0.0031)
    assert tally.dt_collapse_t == 0.0031 and tally.steps == 4
    assert tally.viol["den"] == 1 and len(tally.dts) == 2


# (b) short runs against the JAX package's own gates

def _fixture():
    with open(FIXTURE) as f:
        return json.load(f)


@pytest.mark.parametrize("run", ["dam", "stress", "stress_momentum", "onlydiv", "motivation"])
def test_short_run_matches_the_jax_gates(run):
    ref = _fixture()[run]
    spec = ref["spec"]
    got, ok, tally = gates.run_scenario(spec["scenario"], spec["t_end"], chunk=spec["chunk"],
                                        momentum=spec["momentum"], device="cpu")
    want = ref["record"]
    assert ok and want["ok"]
    for k in ("steps", "n_initial", "n_final", "density_tol_violations", "div_tol_violations",
              "capped_density_solves", "capped_div_solves", "max_density_iters",
              "max_div_iters", "contained", "nonfinite_positions", "dt_collapse_t"):
        assert got[k] == want[k], (run, k, got[k], want[k])
    per = ref["per_step"]
    assert tally.den_iters == per.get("density_iterations", [])
    assert tally.div_iters == per.get("div_iterations", [])
    np.testing.assert_allclose(tally.dts, per["dt"], rtol=2e-5)
    assert abs(got["mass_drift"] - want["mass_drift"]) < 1e-5
    for k, tol in (("max_avg_density_error_rel", want["tol_density"]),
                   ("max_avg_density_error_all_rel", None), ("max_density_error_all_rel", None),
                   ("max_avg_div_error_times_dt", want["tol_divergence"])):
        if want.get(k) is None:
            assert got[k] is None, (run, k)
        else:
            atol = 1e-4 * tol if tol is not None else 0.0
            assert got[k] == pytest.approx(want[k], rel=2e-5, abs=atol), (run, k)
    assert got["k1_pairs"] > 0 and got["k1_candidates_tested"] >= got["k1_pairs"]
    assert 0 < got["k1_live_rows"] <= got["n_final"]


def test_cli_merges_a_cpu_record(tmp_path):
    out = tmp_path / "runs.json"
    out.write_text(json.dumps({"kept": {"scenario": "kept"}}))
    rc = gates.main(["dam", "--t-scale", "0.006", "--device", "cpu", "--out", str(out),
                     "--record-as", "dam_short"])
    runs = json.loads(out.read_text())
    assert rc == 0 and set(runs) == {"kept", "dam_short"}
    r = runs["dam_short"]
    assert (r["platform"], r["device"], r["steps"]) == ("cpu", "cpu", 1)
    assert r["t_scale"] == pytest.approx(0.006)


def test_cli_refuses_without_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gates.main(["dam", "--t-scale", "0.006", "--out", str(tmp_path / "runs.json")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gates.slab_soak(1)
    assert not (tmp_path / "runs.json").exists()


def test_slab_soak_record_on_cpu_ranks():
    """The soak's record at a small size (2 gloo ranks, 1,800 particles, 3
    steps): the ranks' checks and the tally's counts reach the record."""
    out, ok = gates.slab_soak(3, ranks=2, device="cpu", spacing=0.04)
    assert ok and gate_ok(out)
    assert (out["steps"], out["ranks"], out["n_initial"]) == (3, 2, 1800)
    assert out["census_checks"] == 1 and out["contained"] and out["max_boundary_excess"] == 0.0
    assert out["density_tol_violations"] == out["div_tol_violations"] == 0
    assert out["max_iters_cap"] == 100 and out["max_div_iters"] >= 2
    assert (out["platform"], out["device"]) == ("cpu", "cpu")


def test_gates_import_no_jax():
    code = ("import sys, adaptive_sph_torch.gates, adaptive_sph_torch.multichip; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'adaptive_sph_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, check=True).stdout.strip()
    assert out == "[]"


# (c) the committed GPU record

def test_parity_runs_torch_is_healthy():
    with open(RECORD) as f:
        runs = json.load(f)
    assert set(RECORD_KEYS) <= set(runs), sorted(runs)
    for name, r in runs.items():
        assert r["platform"] == "gpu", name
        assert isinstance(r["device"], str) and "H100" in r["device"], (name, r["device"])
        assert r["contained"], name
        assert r["mass_drift"] < 1e-3, (name, r["mass_drift"])
        assert r["density_tol_violations"] == 0, name
        assert r["div_tol_violations"] == 0, name
        assert r["dt_collapse_t"] is None, name
        # the run reached the horizon it was asked for
        assert 0.0 < r["t_scale"] <= 1.0, (name, r["t_scale"])
        if r["scenario"] == "slab_soak":
            assert r["steps"] == round(gates.SLAB_SOAK_STEPS * r["t_scale"]), name
        else:
            assert r["t_end"] >= gates.TARGETS[r["scenario"]] * r["t_scale"] * (1 - 1e-6), name
        if (r.get("max_avg_density_error_rel") is not None
                and r.get("capped_density_solves", 0) == 0):
            assert r["max_avg_density_error_rel"] <= r["tol_density"] * 1.01, name
    for key, (scenario, momentum) in {"stress": ("stress", 0.9), "stress_plain": ("stress", 0.0),
                                      "onlydiv": ("onlydiv", 0.0),
                                      "onlydiv_momentum": ("onlydiv", 0.9)}.items():
        assert (runs[key]["scenario"], runs[key]["jacobi_momentum"]) == (scenario, momentum), key


# (d) opt-in: the gates on the card

@pytest.mark.cuda
@pytest.mark.skipif(not LONG, reason="set ASPH_LONG_E2E=1 (long; needs a CUDA device)")
@pytest.mark.parametrize("scenario", ["dam", "stress"])
def test_scenario_gate_on_the_card(scenario, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "adaptive_sph_torch.gates", scenario, "--t-scale",
         os.environ.get("ASPH_LONG_T_SCALE", "0.25"), "--out", str(tmp_path / "runs.json")],
        cwd=ROOT, capture_output=True, text=True, timeout=5400)
    sys.stdout.write(proc.stdout[-2000:])
    assert proc.returncode == 0, proc.stdout[-1500:] + proc.stderr[-1500:]
