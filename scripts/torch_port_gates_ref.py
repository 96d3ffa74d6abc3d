"""Write the JAX package's own scenario gates at their start, for the PyTorch port.

Runs scripts/scenario_gates.py's `run_scenario` on the CPU (interpret-mode
Pallas) for every run of RUNS (the five scenarios, the stress scene at
momentum 0 and 0.9, each a few steps, CHUNK steps per step_chunk), and
writes tests/data/torch_port_gates_ref.json: per run its "spec" (scenario,
t_end, momentum, chunk), the script's record (its timings and TPU block
census dropped) and the per-step dt, density_iterations and div_iterations
the simulation returned, captured by wrapping the simulation's step /
step_chunk.

tests/test_torch_gates.py holds `adaptive_sph_torch.gates.run_scenario` on
the CPU to this file; chip_smoke.py phase H1 does so on the GPU.

    PYTHONPATH= JAX_PLATFORMS=cpu python scripts/torch_port_gates_ref.py [--only RUN ...]
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "data", "torch_port_gates_ref.json")
PER_STEP = ("dt", "density_iterations", "div_iterations")
# run -> (scenario, t_end, momentum)
RUNS = {
    "dam": ("dam", 0.024, 0.0),
    "stress": ("stress", 0.012, 0.0),
    "stress_momentum": ("stress", 0.012, 0.9),
    "onlydiv": ("onlydiv", 0.02, 0.0),
    "motivation": ("motivation", 0.006, 0.0),
    "resampling": ("resampling", 0.006, 0.0),
}
CHUNK = 2
DROPPED = ("wall_s", "ms_per_step", "walk_blocks", "walk_pairs", "walk_pair_validity_pct",
           "walk_collapsed_windows", "walk_stream_mb_bf16", "walk_census_error")


@contextlib.contextmanager
def captured_steps(per_step: dict):
    """Every simulation create_simulation builds inside the context records
    its per-step PER_STEP values into per_step (cleared at each build: the
    stress scenario builds one to read its parameters, then the run's)."""
    from adaptive_sph_tpu import runner

    real = runner.create_simulation

    def record(d):
        for k in PER_STEP:
            if k in d:
                per_step.setdefault(k, []).extend(np.atleast_1d(np.asarray(d[k])).tolist())

    def create(*a, **kw):
        sim = real(*a, **kw)
        per_step.clear()
        step, chunk = sim.step, sim.step_chunk

        def step_rec(*sa, **sk):
            d = step(*sa, **sk)
            record(d)
            return d

        def chunk_rec(*sa, **sk):
            d = chunk(*sa, **sk)
            record(d)
            return d

        sim.step, sim.step_chunk = step_rec, chunk_rec
        return sim

    runner.create_simulation = create
    try:
        yield
    finally:
        runner.create_simulation = real


def reference_run(run: str) -> dict:
    spec = importlib.util.spec_from_file_location(
        "scenario_gates", os.path.join(ROOT, "scripts", "scenario_gates.py"))
    gates = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gates)
    name, t_end, momentum = RUNS[run]
    per_step = {}
    with captured_steps(per_step):
        out, ok = gates.run_scenario(name, t_end, chunk=CHUNK, momentum=momentum)
    rec = {k: v for k, v in out.items() if k not in DROPPED}
    return {"spec": {"scenario": name, "t_end": t_end, "momentum": momentum, "chunk": CHUNK},
            "record": {**rec, "ok": bool(ok)}, "per_step": dict(per_step)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", nargs="*", default=None, help="runs to rewrite (default: all)")
    a = ap.parse_args()
    runs = {}
    if a.only and os.path.exists(OUT):
        with open(OUT) as f:
            runs = json.load(f)
    for run in a.only or RUNS:
        runs[run] = reference_run(run)
        r = runs[run]
        print(f"{run}: {r['record']['steps']} steps, n {r['record']['n_initial']} -> "
              f"{r['record']['n_final']}, iterations {r['per_step']}", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(runs, f, indent=1)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    main()
