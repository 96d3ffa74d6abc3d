"""A throwaway checkout for the CPU tests: BENCHMARK.json and benchmark/
copied into a temporary root, with tiny cells added as new files and new
entries only (the way a later change adds a cell)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))
if str(ROOT) not in sys.path:
    sys.path.append(str(ROOT))

# a quarter-size fine block beside the coarse one (two levels, no resampling),
# and a small block of fine particles that merge (share / merge / split, levels)
TINY_SCENES = {
    "ratio-stress-test": {"boundary": {"type": "box", "width": 2, "height": 2}, "blocks": [
        {"pos": [0.4, -0.5], "size": [0.55, 1.4], "spacing": 0.4, "volume_fill_ratio": 0.93,
         "velocity": [0, 0]},
        {"pos": [-0.95, -0.5], "size": [0.3, 0.4], "spacing": 0.02, "volume_fill_ratio": 0.93,
         "velocity": [0, 0]}]},
    "motivation-scene2": {"boundary": {"type": "box", "width": 2, "height": 2}, "blocks": [
        {"pos": [-0.95, -0.9], "size": [0.2, 0.2], "spacing": 0.02, "volume_fill_ratio": 0.93,
         "velocity": [0, 0]}]},
}
TINY_CELLS = {"tiny-stress": "ratio-stress-test", "tiny-adaptive": "motivation-scene2"}
LIMITS_OF = {"tiny-stress": "stress-x1", "tiny-adaptive": "motivation-adaptive"}


def make_root(tmp: Path, episode_steps: int = 3, trace_steps: int = 2) -> Path:
    root = Path(tmp)
    shutil.copy(ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(BENCH, root / "benchmark", ignore=shutil.ignore_patterns(
        "tests", "__pycache__", "tools"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for cell, base in TINY_CELLS.items():
        cfg = json.loads((BENCH / "configs" / f"{base}.json").read_text())
        cfg["scene"] = TINY_SCENES[base]
        name = f"{cell}-config"
        (root / "benchmark" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test", "file":
                                 f"benchmark/configs/{name}.json", "reduced": ["blocks"],
                                 "why": "test"})
        (root / "benchmark" / "traffic" / f"{cell}-traffic.json").write_text(json.dumps(
            {"replicas": 1, "episode_steps": episode_steps, "trace_steps": trace_steps}))
        bench["workloads"].append({"name": cell, "config": name, "traffic": f"{cell}-traffic",
                                   "chips": 1, "why": "test"})
        # the limits of the configuration's real cell
        shutil.copy(BENCH / "limits" / f"{LIMITS_OF[cell]}.json",
                    root / "benchmark" / "limits" / f"{cell}.json")
    # the tiny cells report every metric of their configuration's real cells
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            for cell, base in TINY_CELLS.items():
                if any(bench_cell_config(bench, c) == base for c in m["workloads"]):
                    m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


def bench_cell_config(bench: dict, cell: str) -> str:
    for w in bench["workloads"]:
        if w["name"] == cell:
            return w["config"]
    return ""
