"""The profiler's reading of the traced steps.

torch.profiler (CPU and CUDA activities) runs over each traced step
(benchlib/harness.py); `read` takes one such stretch, `merge` sums them.
From the events:

- kernels: device events that are not copies or fills, by name (count,
  device seconds); user annotations (the schedule's step spans) are read
  on neither side;
- busy_s: the union of the device events' intervals (kernels, copies and
  fills), the seconds in which an operation ran on the device;
- syncs: host calls that wait for the device (names holding "Synchronize":
  stream, device and event synchronisations, also those under a blocking
  device-to-host copy);
- idle gaps: the intervals between device events, each named by the
  innermost host event running at its midpoint.
"""

from __future__ import annotations

import numpy as np


def _is_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)).upper() == "CUDA"


def _is_annotation(e) -> bool:
    """A user annotation, on the host or mirrored on the device's timeline:
    the schedule's "ProfilerStep#n" spans the whole step on both, and is
    neither a device operation nor what the host was doing in a gap."""
    return bool(getattr(e, "is_user_annotation", False)) or e.name.startswith("ProfilerStep")


def read(prof, window_s: float, top: int = 10) -> dict:
    dev, host = [], []
    for e in prof.events():
        if _is_annotation(e):
            continue
        (dev if _is_device(e) else host).append(e)
    kernels = {}
    spans = []
    for e in dev:
        t0, t1 = float(e.time_range.start), float(e.time_range.end)
        spans.append((t0, t1))
        name = e.name
        if name.startswith("Memcpy") or name.startswith("Memset"):
            continue
        c, s = kernels.get(name, (0, 0.0))
        kernels[name] = (c + 1, s + (t1 - t0) * 1e-6)
    syncs = sum(1 for e in host if "Synchronize" in e.name)
    busy_s, gaps = 0.0, []
    if spans:
        spans.sort()
        cur0, cur1 = spans[0]
        merged = []
        for t0, t1 in spans[1:]:
            if t0 <= cur1:
                cur1 = max(cur1, t1)
            else:
                merged.append((cur0, cur1))
                cur0, cur1 = t0, t1
        merged.append((cur0, cur1))
        busy_s = sum(b - a for a, b in merged) * 1e-6
        gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    named = _name_gaps(gaps, host)
    return {"window_s": window_s, "busy_s": busy_s, "kernels": kernels, "syncs": syncs,
            "named_gaps": named, "idle_gaps": _sum_by_name(named, top),
            "kernel_count": sum(c for c, _ in kernels.values())}


def merge(parts: list, top: int = 10) -> dict:
    """One reading of several stretches: seconds, kernels and synchronisations
    summed, the idle gaps named over the LONGEST_GAPS longest of them all."""
    kernels = {}
    for p in parts:
        for name, (c, s) in p["kernels"].items():
            c0, s0 = kernels.get(name, (0, 0.0))
            kernels[name] = (c0 + c, s0 + s)
    named = sorted((g for p in parts for g in p["named_gaps"]),
                   key=lambda g: -g[1])[:LONGEST_GAPS]
    return {"window_s": sum(p["window_s"] for p in parts),
            "busy_s": sum(p["busy_s"] for p in parts), "kernels": kernels,
            "syncs": sum(p["syncs"] for p in parts), "named_gaps": named,
            "idle_gaps": _sum_by_name(named, top),
            "kernel_count": sum(p["kernel_count"] for p in parts)}


LONGEST_GAPS = 200


def _name_gaps(gaps, host) -> list:
    """[(host event name, idle seconds)] of the LONGEST_GAPS longest gaps, each
    named by the innermost host event at its midpoint."""
    if not gaps or not host:
        return []
    starts = np.array([float(e.time_range.start) for e in host])
    ends = np.array([float(e.time_range.end) for e in host])
    names = [e.name for e in host]
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:LONGEST_GAPS]:
        mid = 0.5 * (a + b)
        inside = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = "(no host event)" if inside.size == 0 else \
            names[inside[np.argmin(ends[inside] - starts[inside])]]
        out.append((name, (b - a) * 1e-6))
    return out


def _sum_by_name(named: list, top: int) -> list:
    """[(host event name, idle seconds)] summed by name, longest first."""
    by = {}
    for name, secs in named:
        by[name] = by.get(name, 0.0) + secs
    return sorted(by.items(), key=lambda kv: -kv[1])[:top]


def device_ops(kernels: dict, top: int = 10) -> list:
    """[(kernel name, device seconds)] of the kernels that took most time."""
    return [[k, v[1]] for k, v in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:top]]


def kernel_seconds(kernels: dict, fragment: str) -> tuple:
    """(launches, device seconds) of the kernels whose name holds `fragment`."""
    c = s = 0
    for name, (n, secs) in kernels.items():
        if fragment in name:
            c += n
            s += secs
    return c, s
