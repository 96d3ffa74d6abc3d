"""PyTorch port, adaptive_sph_torch/spans.py: the step's spans, its host-read
counters and its per-step records.

Off by default (no enable(), no profiler), a step keeps no record and enters
no record_function, and its reads are still counted. Under `spans.enable()`
one step of the adaptive dam break (configs/default-config.yaml) gives the
reference's span tree, each child inside its parent, the solves' and the
wavefront's sweeps as the diagnostics count them, one read per sweep at its
exit test and exactly one diagnostics read. Under a CPU torch.profiler the
spans turn on by themselves (a uniform block's step) and sit on the
profiler's clock as user annotations of the same names and nesting; the state a step returns is the
same bit for bit with spans on and off. `idle_by_span` and `device_ops` on
synthetic events: a span's mirror on the device's timeline is not device work.
"""

import os
import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from adaptive_sph_torch import spans
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.models.state import FIELDS
from adaptive_sph_torch.runner import create_simulation
from adaptive_sph_torch.utils import params as t_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOLVERS = ("div-solver", "density-solver")
BLOCK = {"boundary": {"type": "box", "width": 2, "height": 2},
         "blocks": [{"pos": [0.4, -0.5], "size": [0.55, 1.4], "spacing": 0.06,
                     "volume_fill_ratio": 0.93, "velocity": [0, 0]}]}
# (span, parent) of the adaptive dam break's first step
TREE = {("simulation-step", None), ("tile-step", "simulation-step"),
        ("neighborhood", "tile-step"), ("boundary-terms", "tile-step"),
        ("level-estimation", "tile-step"), ("pair-build", "tile-step"),
        ("div-solver", "tile-step"), ("density-solver", "tile-step"),
        ("adaptivity", "simulation-step"), ("diag-read", "simulation-step"),
        ("step-build", "simulation-step")}


def first_step(uniform: bool = False):
    """A fresh simulation of the adaptive dam break (or of a uniform block
    without resampling) and its first step (the dam break's grows the
    capacity once, for deferred splits): (state, diag, read deltas by site)."""
    upd = {"particle_sizes": "Uniform", "merging": False, "sharing": False,
           "splitting": False} if uniform else {}
    params = t_params.load_params(os.path.join(ROOT, "configs", "default-config.yaml"),
                                  update_attributes=upd)
    if uniform:
        scene = t_scene.scene_from_dict(BLOCK)
    else:
        scene = t_scene.load_scene(os.path.join(ROOT, "configs", "default-scene.yaml"))
    sim = create_simulation(params, scene, capacity=1024 if uniform else None, device="cpu")
    before = dict(spans.reads)
    d = sim.step()
    reads = {k: v - before.get(k, 0) for k, v in spans.reads.items() if v != before.get(k, 0)}
    return sim.state, d, reads


def expected_reads(d):
    # one exit read per sweep: a solve of n iterations sweeps n + 1 times
    return {"diag": 1, "wavefront-exit": d["wavefront_sweeps"],
            "solve-exit": d["div_iterations"] + d["density_iterations"] + 2}


@pytest.fixture(scope="module")
def off_and_on():
    """The first step with spans off, then again with spans.enable(): (state,
    diag, reads, records) of each, and the record_functions entered while
    off."""
    spans.records.clear()
    entered = []
    real = torch.profiler.record_function
    torch.profiler.record_function = lambda name: entered.append(name) or real(name)
    try:
        off = first_step() + (list(spans.records), entered)
    finally:
        torch.profiler.record_function = real
    with spans.enable():
        on = first_step() + (list(spans.records),)
    return off, on


def test_off_by_default_counts_reads_and_keeps_nothing(off_and_on):
    (_, d, reads, recs, entered), _ = off_and_on
    assert not spans.on() and spans.span("tile-step") is spans._NOOP
    assert recs == [] and entered == []
    assert reads == expected_reads(d)


def test_enabled_step_gives_the_span_tree_sweeps_and_reads(off_and_on):
    _, (_, d, reads, recs) = off_and_on
    assert len(recs) == 1
    rec = recs[0]
    sp = rec["spans"]
    assert rec["step"] == 1 and all(s["step"] == 1 for s in sp)
    tree = {(s["name"], None if s["parent"] is None else sp[s["parent"]]["name"]) for s in sp}
    assert tree == TREE
    assert sp[0]["name"] == "simulation-step" and sp[0]["parent"] is None
    for s in sp[1:]:
        p = sp[s["parent"]]
        assert p["t0"] <= s["t0"] <= s["t1"] <= p["t1"], (s, p)
    # the host's sweep counts, set on the spans, against the diagnostics
    for name, key in (("div-solver", "div_iterations"), ("density-solver", "density_iterations"),
                      ("level-estimation", "wavefront_sweeps")):
        assert rec["sweeps"][name] == d[key] > 0, name
    assert sum(s.get("sweeps", 0) for s in sp if s["name"] in SOLVERS) == \
        d["div_iterations"] + d["density_iterations"]
    assert rec["reads"] == reads == expected_reads(d)
    assert rec["resampling"] == {k: d[k] for k in spans.RESAMPLING if k in d}
    assert rec["resampling"]["shares"] > 0


def test_spans_leave_the_step_bit_identical(off_and_on):
    (s0, d0, _, _, _), (s1, d1, _, _) = off_and_on
    assert repr(d0) == repr(d1)  # repr: NaN averages compare equal as text
    for f in FIELDS:
        a, b = getattr(s0, f), getattr(s1, f)
        assert a.dtype == b.dtype and a.numpy().tobytes() == b.numpy().tobytes(), f


def test_a_profiler_turns_the_spans_on_and_on_its_clock():
    spans.records.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert spans.on()
        first_step(uniform=True)
    assert not spans.on() and spans.span("tile-step") is spans._NOOP
    (rec,) = spans.records
    sp = rec["spans"]
    kin = sorted((e for e in prof.profiler.kineto_results.events()
                  if e.name() in spans.SPAN_NAMES), key=lambda e: e.start_ns())
    assert all(e.is_user_annotation() for e in kin)
    assert [e.name() for e in kin] == [s["name"] for s in sp]
    for e, s in zip(kin, sp):
        assert abs(e.start_ns() - s["t0"]) < 1_000_000, s["name"]
        if s["parent"] is not None:
            p = kin[s["parent"]]
            assert p.start_ns() <= e.start_ns()
            assert e.start_ns() + e.duration_ns() <= p.start_ns() + p.duration_ns()
    ann = [e.name for e in prof.events() if e.is_user_annotation and e.name in spans.SPAN_NAMES]
    assert sorted(ann) == sorted(s["name"] for s in sp)


def _ev(name, t0, t1, cuda, annotation=False):
    return types.SimpleNamespace(name=name, key=name, time_range=types.SimpleNamespace(start=t0, end=t1),
                                 device_type=types.SimpleNamespace(name="CUDA" if cuda
                                                                   else "CPU"),
                                 is_user_annotation=annotation)


def test_idle_by_span_puts_each_gap_down_to_the_innermost_span():
    evs = [_ev("kA", 0, 10, True), _ev("kB", 5, 20, True), _ev("kC", 100, 110, True),
           _ev("kD", 200, 210, True), _ev("kE", 400, 410, True),
           # the spans on the host, and their mirrors on the device's timeline
           _ev("simulation-step", 0, 300, False, True), _ev("tile-step", 2, 150, False, True),
           _ev("div-solver", 40, 120, False, True), _ev("tile-step", 2, 150, True, True),
           _ev("aten::nonzero", 50, 70, False), _ev("ProfilerStep#3", 0, 410, True, True)]
    out = spans.idle_by_span(evs)
    # 20-100 (mid 60: div-solver), 110-200 (mid 155: simulation-step), 210-400 (none)
    assert out == {"(no span)": pytest.approx(190e-6), "simulation-step": pytest.approx(90e-6),
                   "div-solver": pytest.approx(80e-6)}
    assert list(out) == ["(no span)", "simulation-step", "div-solver"]
    assert spans.idle_by_span([]) == {}


def test_device_ops_leave_the_span_mirrors_out():
    evs = [_ev("kA", 0, 10, True), _ev("Memcpy DtoH", 10, 12, True),
           _ev("tile-step", 0, 20, True, True), _ev("ProfilerStep#3", 0, 20, True, True),
           _ev("aten::add", 0, 1, False)]
    assert [e.name for e in spans.device_ops(evs)] == ["kA", "Memcpy DtoH"]
    # key_averages' entries: a key and no name; a span's average on the device
    avg = [types.SimpleNamespace(key=k, device_type=types.SimpleNamespace(name="CUDA"),
                                 is_user_annotation=a, self_device_time_total=t)
           for k, a, t in (("kA", False, 10.0), ("simulation-step", True, 300.0),
                           ("pair-build", False, 5.0))]
    assert sum(e.self_device_time_total for e in spans.device_ops(avg)) == 10.0

