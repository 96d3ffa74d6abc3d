"""The metric arithmetic: rates over the whole window, the 95th percentile
over all steps, roofline bytes from shapes, the profiler's reading."""

import types

import numpy as np
import pytest

import tiny  # noqa: F401  (puts the benchmark on the path)
from benchlib import contract, roofline, trace
from benchlib.spec import Spec


@pytest.fixture(scope="module")
def read():
    spec = Spec(tiny.ROOT)
    return lambda name, ctx: spec.reader(name)(ctx)


def ctx_of(steps, window_s=2.0, trace_=None, params=None):
    return types.SimpleNamespace(steps=steps, window_s=window_s, setup_s=12.5, trace=trace_,
                                 params=params or {}, cell={}, traffic={})


def test_updates_per_s_counts_completed_steps_over_the_whole_window(read):
    steps = [{"wall_s": 0.1, "failed": False, "particle_count": 1000},
             {"wall_s": 0.3, "failed": False, "particle_count": 900},
             {"wall_s": 0.2, "failed": True}]
    # the failed step's time stays in the window; its particles do not count
    assert read("updates_per_s", ctx_of(steps, window_s=4.0)) == pytest.approx(1900 / 4.0)
    assert read("updates_per_s", ctx_of([], window_s=4.0)) is None
    assert read("particles_mean", ctx_of(steps)) == pytest.approx(950.0)
    assert read("setup_s", ctx_of(steps)) == 12.5


def test_p95_is_over_every_step(read):
    walls = np.linspace(0.01, 0.2, 200)
    steps = [{"wall_s": float(w), "failed": bool(i % 7 == 0)} for i, w in enumerate(walls)]
    want = float(np.percentile(walls, 95)) * 1e3
    assert read("step_ms_p95.host", ctx_of(steps)) == pytest.approx(want)


def test_solver_and_wavefront_means(read):
    steps = [{"failed": False, "particle_count": 5, "density_iterations": 2,
              "div_iterations": 3, "wavefront_sweeps": 4},
             {"failed": False, "particle_count": 5, "density_iterations": 4,
              "div_iterations": 1, "wavefront_sweeps": 6}]
    assert read("solver_iters_per_step", ctx_of(steps)) == pytest.approx(5.0)
    assert read("wavefront_sweeps_per_step", ctx_of(steps)) == pytest.approx(5.0)
    assert read("wavefront_sweeps_per_step", ctx_of([{"failed": False}])) is None


def test_roofline_bytes_from_shapes():
    p = {"viscosity": 0.003}
    C, P = 14336, 151409
    # mega mode with viscosity, f32: table 6 floats in; row_ptr, col, w, s, 4 prep rows out
    want = C * 24 + (C + 1) * 4 + P * 4 + 8 * P + 8 * P + 16 * C
    assert roofline.pair_build_bytes(C, P, p) == want
    assert roofline.least_time(want, roofline.pair_build_ops(P)) == pytest.approx(
        want / 3.35e12)
    # the x1 stress first step's K1 bound of PERF.md's kernel table: 0.0011 ms
    assert 1.0e-6 < want / 3.35e12 < 1.2e-6
    bf = roofline.pair_build_bytes(C, P, {**p, "weight_cache_bf16": True})
    assert want - bf == 8 * P
    assert roofline.pair_build_bytes(C, P, {"viscosity": 0.0}) == want - 8 * P
    classic = roofline.pair_build_bytes(C, P, {"resident_solver": True, "viscosity": 0.003})
    assert classic == C * 28 + (C + 1) * 4 + P * 12 + 32 * C
    assert roofline.pair_matvec_bytes(C, P, p) == (C + 1) * 4 + 12 * P + 12 * C


def test_roofline_share_from_a_trace(read):
    C, P = 1024, 5000
    params = {"viscosity": 0.003}
    rows = [{"pair_build": 1, "pair_matvec": 8, "pair_visc": 1, "capacity": C,
             "num_pairs": P}] * 4
    k1 = 4 * roofline.least_time(roofline.pair_build_bytes(C, P, params), 40 * P)
    k2 = 32 * roofline.least_time(roofline.pair_matvec_bytes(C, P, params), 4 * P)
    t = {"window_s": 0.5, "busy_s": 0.05, "syncs": 40, "kernel_count": 4000, "steps": rows,
         "kernels": {"void pair_build_kernel<false, 1>(...)": (4, 2 * k1),
                     "void pair_build_kernel<true, 1>(...)": (4, 2 * k1),
                     "void pair_matvec_kernel<S, 0>(...)": (32, 10 * k2)}}
    c = ctx_of([], trace_=t, params=params)
    assert read("pair_build_roofline", c) == pytest.approx(25.0)
    assert read("pair_matvec_roofline", c) == pytest.approx(10.0)
    assert read("device_busy_pct", c) == pytest.approx(10.0)
    assert read("device_ms_per_step", c) == pytest.approx(12.5)
    assert read("host_syncs_per_step", c) == pytest.approx(10.0)
    assert read("launches_per_step", c) == pytest.approx(1000.0)
    # a trace with no kernel of the name reads nothing, never 0
    t2 = {**t, "kernels": {}}
    assert read("pair_build_roofline", ctx_of([], trace_=t2, params=params)) is None
    assert read("device_busy_pct", ctx_of([])) is None


def _ev(name, t0, t1, cuda):
    return types.SimpleNamespace(name=name, time_range=types.SimpleNamespace(start=t0, end=t1),
                                 device_type=types.SimpleNamespace(name="CUDA" if cuda
                                                                   else "CPU"))


def test_trace_reading_unions_device_intervals_and_names_gaps():
    evs = [_ev("ProfilerStep#7", 0, 200, True),
           _ev("kA", 0, 10, True), _ev("kB", 5, 20, True), _ev("Memcpy DtoH", 20, 22, True),
           _ev("kA", 100, 110, True), _ev("aten::nonzero", 30, 90, False),
           _ev("cudaStreamSynchronize", 40, 60, False), _ev("step", 0, 200, False),
           _ev("ProfilerStep#7", 1, 199, False)]
    prof = types.SimpleNamespace(events=lambda: evs)
    out = trace.read(prof, window_s=2e-4)
    assert out["busy_s"] == pytest.approx(32e-6)
    assert out["kernels"] == {"kA": (2, pytest.approx(20e-6)), "kB": (1, pytest.approx(15e-6))}
    assert out["kernel_count"] == 3 and out["syncs"] == 1
    # the one gap (22-100 us), named by the innermost host event at its middle
    assert out["idle_gaps"] == [("aten::nonzero", pytest.approx(78e-6))]
    assert trace.device_ops(out["kernels"])[0][0] == "kA"
    # a gap that only the schedule's step span covers is between host ops
    bare = trace.read(types.SimpleNamespace(events=lambda: [
        _ev("kA", 0, 10, True), _ev("kA", 100, 110, True), _ev("ProfilerStep#7", 0, 110, False),
        _ev("cudaLaunchKernel", 95, 97, False)]), window_s=1.1e-4)
    assert bare["idle_gaps"] == [("(no host event)", pytest.approx(90e-6))]


def test_the_traced_steps_are_summed():
    a = trace.read(types.SimpleNamespace(events=lambda: [
        _ev("kA", 0, 10, True), _ev("kA", 30, 40, True), _ev("aten::nonzero", 12, 28, False),
        _ev("cudaStreamSynchronize", 14, 18, False)]), window_s=5e-5)
    b = trace.read(types.SimpleNamespace(events=lambda: [
        _ev("kB", 0, 5, True), _ev("kB", 105, 110, True), _ev("aten::copy_", 6, 104, False)]),
        window_s=1.5e-4)
    m = trace.merge([a, b])
    assert m["window_s"] == pytest.approx(2e-4) and m["busy_s"] == pytest.approx(30e-6)
    assert m["kernels"] == {"kA": (2, pytest.approx(20e-6)), "kB": (2, pytest.approx(10e-6))}
    assert m["syncs"] == 1 and m["kernel_count"] == 4
    # the longest gaps of all the stretches, named by their host events
    assert m["idle_gaps"] == [("aten::copy_", pytest.approx(100e-6)),
                              ("aten::nonzero", pytest.approx(20e-6))]


def test_the_solver_contract():
    p = {"pressure_solver_method": "HybridDFSPH", "hybrid_dfsph_max_avg_density_error": 1e-3,
         "hybrid_dfsph_max_avg_divergence_error": 1e-4, "max_iters": 200, "rest_density": 1}
    ok = {"dt": 1e-3, "density_avg_error": 9e-4, "div_avg_error": 0.05,
          "density_iterations": 3, "div_iterations": 2}
    assert contract.judge(ok, p) == (0, 0)
    over = {**ok, "div_avg_error": 0.2}  # 0.2 x dt = 2e-4 > 1e-4, below the cap
    assert contract.judge(over, p) == (1, 0)
    assert contract.judge({**over, "div_iterations": 200}, p) == (0, 1)
    assert contract.judge({**ok, "density_avg_error": float("nan")}, p) == (0, 0)
    assert contract.judge({**ok, "dt": 1e-12}, p) == (1, 0)
    # a solve whose error the step leaves out is a violation
    assert contract.judge({k: v for k, v in ok.items() if k != "div_avg_error"}, p) == (1, 0)
