"""Discovery: everything of a cell is found by name.

BENCHMARK.json (at the checkout's root) names the cells, configurations and
metrics. Beside it, under benchmark/:

- the configuration's file, as BENCHMARK.json's `configs[].file` names it
  (relative to the root): the published settings, the scene and the cut;
- traffic/<traffic>.json: the parameters of one traffic mix;
- metrics/<metric>.py: one reader per metric, `read(ctx)` -> a number or None;
- limits/<cell>.json: the limits of the numbers that decide `correct`.

A new cell, configuration, traffic mix or metric is new files here and new
entries in BENCHMARK.json; nothing that is already here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


class Spec:
    """The benchmark as one checkout holds it. root: the directory that holds
    BENCHMARK.json and benchmark/."""

    def __init__(self, root=ROOT):
        self.root = Path(root)
        self.dir = self.root / "benchmark"
        with open(self.root / "BENCHMARK.json") as f:
            self.data = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(self.dir / "traffic" / f"{name}.json") as f:
            return json.load(f)

    def limits(self, cell: str) -> dict:
        """{number: limit}; empty where the cell has no limits file yet."""
        path = self.dir / "limits" / f"{cell}.json"
        if not path.exists():
            return {}
        with open(path) as f:
            return json.load(f)["limits"]

    def metrics(self, cell: str, trace: bool) -> list:
        """The metric entries a run of `cell` reports: the end-to-end ones
        without the trace, the per-layer ones with it; an entry with a
        `workloads` key only in the cells it lists."""
        group = self.data["per_layer" if trace else "end_to_end"]
        return [m for m in group if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        """The `read(ctx)` of metrics/<metric>.py."""
        path = self.dir / "metrics" / f"{metric}.py"
        modname = "benchmark_metric_" + "".join(c if c.isalnum() else "_" for c in metric)
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
