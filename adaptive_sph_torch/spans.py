"""Spans and host-read counters of the port's step.

Spans are the named stretches of one step, nested as the step runs them:

  simulation-step           runner.Simulation._advance: the whole step, retries included
    diag-read               the step's one diagnostics transfer (waits for the card)
    tile-step               models/tile_step.py single_step_tiles: the physics half
      neighborhood          step_geometry: build_tiles, sort_fields, window_meta
      boundary-terms        the boundary handler's per-particle terms
      level-estimation      detection, the wavefront sweeps, the smoothing
      pair-build            K1 with its count pass and read
      density-solver, div-solver, hybrid-solvers
                            the solves with their sources (hybrid-solvers: the
                            whole-solve HybridDFSPH launch)
    adaptivity              share / merge / split with find_partners_tiles
    step-build              capacity growth and the clique fallback

Names follow the reference's sections where it has one. Spans are on while
`enable()` is in force or while a torch.profiler records
(`torch.autograd._profiler_enabled()`, true in a schedule's active steps
only). Off, `span(name)` returns one shared no-op context after that check.
On, a span is entered as a `torch.profiler.record_function` of its name, so
a profiler's trace shows it on one timeline with the kernels it launched, and
inside a step it records its name, its parent (an index into the step's span
list), its step number and its start and end in `time.time_ns()`, the epoch
nanoseconds of the profiler's own events. Sweeps are counted, not timed: a
span carries `sweeps` where the host counts them (the streamed solves, the
wavefront) and the record fills in the whole-solve kernels' counts from the
diagnostics.

`reads[site]` counts every blocking device-to-host read of the tile step's
path at the line that makes it, always (a plain integer increment):

  diag            runner._read_diag, the step's one diagnostics transfer
  solve-exit      tile_physics.tile_jacobi, the exit test (one per sweep: a
                  solve of n iterations reads n + 1 times)
  wavefront-exit  tile_step._level_estimation, one per wavefront sweep
  pair-count      pair_ops._count, K1's pair total

On the card these are every synchronisation a step of the benchmark's cells
makes (torch.cuda.set_sync_debug_mode over their steps).

While spans are on, `Simulation._advance` closes one record per step into
`records` (the last RECORDS): {"step", "spans", "reads" (the step's deltas by
site), "sweeps" (by span name), "resampling" (shares, merges, splits,
merge_or_split_count from the diagnostics)}.

`idle_by_span(events)` puts a profiler trace's idle device time down to the
innermost span at each gap's midpoint (`python -m adaptive_sph_torch.stress`).
Under a profiler each span also lies on the device's timeline as a user
annotation, the length of the work it launched: `device_ops(events)` leaves
those out, and every sum of a profile's device time takes its events from it.
"""

from __future__ import annotations

import collections
import contextlib
import time

import torch

SPAN_NAMES = ("simulation-step", "diag-read", "tile-step", "neighborhood", "boundary-terms",
              "level-estimation", "pair-build", "density-solver", "div-solver", "hybrid-solvers",
              "adaptivity", "step-build")
# solver spans and the diagnostics that count their sweeps
SOLVER_ITERATIONS = {"density-solver": ("density_iterations",),
                     "div-solver": ("div_iterations",),
                     "hybrid-solvers": ("div_iterations", "density_iterations")}
RESAMPLING = ("shares", "merges", "splits", "merge_or_split_count")
RECORDS = 1024

reads = collections.defaultdict(int)
records = collections.deque(maxlen=RECORDS)

_forced = 0
_open = None  # the record of the step being run, while spans are on
_stack = []  # indices of the open spans in _open["spans"]


def on() -> bool:
    return _forced > 0 or torch.autograd._profiler_enabled()


@contextlib.contextmanager
def enable():
    """Spans on inside the block, with or without a profiler."""
    global _forced
    _forced += 1
    try:
        yield
    finally:
        _forced -= 1


class _Noop:
    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "rf", "entry")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.entry = None
        if _open is not None:
            spans = _open["spans"]
            self.entry = {"name": self.name, "parent": _stack[-1] if _stack else None,
                          "step": _open["step"], "t0": time.time_ns(), "t1": None}
            _stack.append(len(spans))
            spans.append(self.entry)
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        return None

    def __exit__(self, *exc):
        self.rf.__exit__(*exc)
        if self.entry is not None:
            self.entry["t1"] = time.time_ns()
            _stack.pop()
        return False


def span(name: str):
    """The context of span `name`: the shared no-op while spans are off."""
    return _Span(name) if on() else _NOOP


def set_sweeps(n: int):
    """The sweeps of the innermost open span of the step, if any."""
    if _stack:
        _open["spans"][_stack[-1]]["sweeps"] = n


def open_step(number: int):
    """Starts the record of step `number` where spans are on."""
    global _open
    if on():
        _stack.clear()
        _open = {"step": number, "spans": [], "reads": dict(reads)}


def close_step(diag=None):
    """Closes the open record into `records` and returns it (None where no
    record was open): read deltas, sweeps by span name (the diagnostics'
    iteration counts for a solver span the host did not count) and the
    resampling counts. The two-phase step closes two records of one step
    number, the second holding its adaptivity half."""
    global _open
    rec, _open = _open, None
    _stack.clear()
    if rec is None:
        return None
    d = diag or {}
    before = rec["reads"]
    rec["reads"] = {k: v - before.get(k, 0) for k, v in reads.items() if v != before.get(k, 0)}
    sweeps = {}
    for s in rec["spans"]:
        n = s.get("sweeps")
        if n is None and s["name"] in SOLVER_ITERATIONS:
            n = s["sweeps"] = sum(int(d.get(k, 0)) for k in SOLVER_ITERATIONS[s["name"]])
        if n is not None:
            sweeps[s["name"]] = sweeps.get(s["name"], 0) + n
    rec["sweeps"] = sweeps
    rec["resampling"] = {k: int(d[k]) for k in RESAMPLING if k in d}
    records.append(rec)
    return rec


def _on_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)).upper() == "CUDA"


def device_ops(events) -> list:
    """The device's own operations among a profiler's events
    (`prof.key_averages()` or `prof.events()`): kernels, copies and fills on
    the CUDA timeline, without the user annotations there (the spans'
    mirrors, a schedule's "ProfilerStep#n"), which span the work they launched
    and would count it twice."""
    return [e for e in events if _on_device(e) and not (
        getattr(e, "is_user_annotation", False) or e.key in SPAN_NAMES
        or e.key.startswith("ProfilerStep"))]


def idle_by_span(events) -> dict:
    """{span name: idle seconds} of a profiler's events (`prof.events()`):
    the gaps between the device's operations (`device_ops`), each put down
    to the innermost span open on the host at its midpoint, "(no span)"
    where none is."""
    dev = sorted((float(e.time_range.start), float(e.time_range.end)) for e in device_ops(events))
    host = [(float(e.time_range.start), float(e.time_range.end), e.name) for e in events
            if not _on_device(e) and e.name in SPAN_NAMES]
    out = {}
    end = None
    for t0, t1 in dev:
        if end is not None and t0 > end:
            mid = 0.5 * (end + t0)
            inside = [s for s in host if s[0] <= mid <= s[1]]
            name = min(inside, key=lambda s: s[1] - s[0])[2] if inside else "(no span)"
            out[name] = out.get(name, 0.0) + (t0 - end) * 1e-6
        end = t1 if end is None else max(end, t1)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
