"""Performance/value counters + write_statistics, with the reference's section names.

Counterpart of adaptive_sph_tpu/utils/stats.py (plain Python). Section names
(simulation-step, div-iterations, density-iterations, ...) stay identical so
.stat dumps of both packages compare line by line.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List


@dataclasses.dataclass
class Counters:
    enabled: bool = True

    def __post_init__(self):
        self.times: Dict[str, List[float]] = defaultdict(list)
        self.values: Dict[str, List[float]] = defaultdict(list)

    def add_time(self, name: str, seconds: float):
        if self.enabled:
            self.times[name].append(seconds)

    def add_value(self, name: str, v: float):
        if self.enabled:
            self.values[name].append(v)


def write_statistics(counters: Counters) -> str:
    """Text dump in the reference's format, LaTeX table row first."""
    lines = []
    step_times = counters.times.get("simulation-step", [])
    simulation_time = sum(step_times)

    def avg(xs):
        return sum(xs) / len(xs) if xs else float("nan")

    avg_particles = avg(counters.values.get("particle-count", []))
    avg_div = avg(counters.values.get("div-iterations", []))
    avg_den = avg(counters.values.get("density-iterations", []))

    lines.append(
        "$%.2f\\si{\\second}$ & %d & %.02f & %.02f & - \\\\"
        % (simulation_time, round(avg_particles) if avg_particles == avg_particles else 0, avg_div, avg_den)
    )
    lines.append("")
    lines.append(f"simulation-time: {simulation_time * 1000.0}ms")
    lines.append("")
    for label in sorted(counters.times):
        lines.append(f"{label}: avg:{avg(counters.times[label]) * 1000.0}ms")
    lines.append("")
    for label in sorted(counters.values):
        xs = counters.values[label]
        lines.append(f"{label}: min:{min(xs)} max:{max(xs)} avg:{avg(xs)}")
    return "\n".join(lines) + "\n"
