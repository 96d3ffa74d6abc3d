"""BENCHMARK.json against the files the harness finds by name, the contract's
shape rules, and a throwaway cell added by new files alone."""

import json
import re

import pytest

import tiny
from benchlib.spec import Spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.fixture(scope="module")
def spec():
    return Spec(tiny.ROOT)


def test_every_entry_finds_its_files(spec):
    d = spec.data
    for w in d["workloads"]:
        cfg = spec.config(w["config"])
        assert cfg["config"] and cfg["scene"]["blocks"]
        assert spec.traffic(w["traffic"])["episode_steps"] > 0
        assert w["chips"] == 1
    for m in d["end_to_end"] + d["per_layer"]:
        assert callable(spec.reader(m["name"])), m["name"]


def test_shape_rules(spec):
    d = spec.data
    assert set(d) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert d["paths"] == ["benchmark"] and d["command"] == ["python3", "benchmark/run.py"]
    names = [x["name"] for x in d["configs"] + d["workloads"] + d["end_to_end"]
             + d["per_layer"]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    cells = {w["name"] for w in d["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in d["workloads"]}) == len(cells)
    assert {w["config"] for w in d["workloads"]} == {c["name"] for c in d["configs"]}
    for m in d["end_to_end"] + d["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    assert "setup_s" in {m["name"] for m in d["end_to_end"]}
    for m in d["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in d["end_to_end"]}
    for m in d["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in d["workloads"] + d["configs"]:
        assert 1 <= len(c["why"]) <= 200
    assert len(json.dumps(d)) < 64 * 1024


def test_each_cell_reports_setup_another_end_to_end_and_a_per_layer_metric(spec):
    for w in spec.data["workloads"]:
        e2e = {m["name"] for m in spec.metrics(w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert spec.metrics(w["name"], True)


def test_a_throwaway_cell_is_found_by_name(tmp_path):
    root = tiny.make_root(tmp_path)
    # a new per-layer metric, as a new file and a new entry
    (root / "benchmark" / "metrics" / "steps_per_episode.py").write_text(
        "def read(ctx):\n    return ctx.traffic['episode_steps']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "steps_per_episode", "unit": "steps", "better": "lower",
                               "source": "program_counter", "layer": "runner",
                               "moves": "updates_per_s", "workloads": ["tiny-stress"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    spec = Spec(root)
    assert spec.cell("tiny-stress")["config"] == "tiny-stress-config"
    assert spec.config("tiny-stress-config")["scene"] == tiny.TINY_SCENES["ratio-stress-test"]
    assert spec.traffic("tiny-stress-traffic")["episode_steps"] == 3
    assert "steps_per_episode" in {m["name"] for m in spec.metrics("tiny-stress", True)}
    assert "steps_per_episode" not in {m["name"] for m in spec.metrics("stress-x8", True)}
    ctx = type("C", (), {"traffic": {"episode_steps": 7}})
    assert spec.reader("steps_per_episode")(ctx) == 7
    # the files of the real benchmark are untouched by the addition
    for rel in ("configs/ratio-stress-test.json", "traffic/episodes-256-x8.json",
                "metrics/updates_per_s.py"):
        assert (root / "benchmark" / rel).read_bytes() == (tiny.BENCH / rel).read_bytes()
