"""The readers of the program's spans and counters (adaptive_sph_torch.spans)
over the harness's traced stretch on the tiny cells (CPU): each gives a
finite number where its cell has the layer and nothing where it has not;
records of steps the profiler did not trace are left out."""

import math
import types

import pytest

import tiny
from benchlib import harness
from benchlib.spec import Spec

READERS = ("host_reads_per_step", "diag_wait_ms_per_step", "tile_step_ms_per_step",
           "solve_ms_per_sweep", "wavefront_ms_per_sweep", "adaptivity_ms_per_step",
           "resampled_per_step")
ADAPTIVE_ONLY = ("wavefront_ms_per_sweep", "adaptivity_ms_per_step", "resampled_per_step")


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return Spec(tiny.make_root(tmp_path_factory.mktemp("root"), episode_steps=4, trace_steps=2))


def ctx_of(trace):
    return types.SimpleNamespace(steps=[], window_s=1.0, setup_s=1.0, trace=trace, params={},
                                 cell={}, traffic={})


@pytest.mark.parametrize("cell", ["tiny-stress", "tiny-adaptive"])
def test_the_readers_over_a_traced_stretch(spec, cell):
    from adaptive_sph_torch import spans
    from adaptive_sph_torch.ops import pair_ops

    c = harness.setup(spec, cell, seed=2**32 + 5, device="cpu")
    c.eps.warm_up()
    spans.records.clear()
    traced = harness._traced_stretch(c.sim, c.eps, 2, pair_ops, False)
    rows = traced["steps"]
    # the profiler's active steps turn the spans on, its other steps do not
    assert sorted(r["step"] for r in spans.records) == sorted(r["episode_step"] + 1 for r in rows)
    values = {m: spec.reader(m)(ctx_of(traced)) for m in READERS}
    for m, v in values.items():
        if cell == "tiny-stress" and m in ADAPTIVE_ONLY:
            assert v is None, m
        else:
            assert v is not None and math.isfinite(v) and v > 0, (m, v)
    # one read per sweep of each solve (iterations + 1) and of the wavefront,
    # and the diagnostics (the CPU twin of K1 reads no pair count)
    want = sum(1 + r["density_iterations"] + r["div_iterations"] + 2
               + r.get("wavefront_sweeps", 0) for r in rows) / len(rows)
    assert values["host_reads_per_step"] == pytest.approx(want)
    # records of untraced steps (the episode's others) are left out
    for k in range(1, c.eps.E + 1):
        if k not in {r["episode_step"] + 1 for r in rows}:
            spans.records.append({"step": k, "reads": {"diag": 10**6}, "sweeps": {},
                                  "resampling": {"shares": 10**6},
                                  "spans": [{"name": n, "parent": None, "step": k, "t0": 0,
                                             "t1": 10**15} for n in spans.SPAN_NAMES]})
    assert {m: spec.reader(m)(ctx_of(traced)) for m in READERS} == values
    # nothing without the trace
    assert all(spec.reader(m)(ctx_of(None)) is None for m in READERS)
