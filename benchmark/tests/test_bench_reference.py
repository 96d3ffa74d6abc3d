"""The comparison that decides `correct`, on the CPU at a small size: the
reference (the tile step's plain twins, frozen) against the program's CPU
path, the control (the program's bf16 pair storage) and the planted faults
coming out not correct, and, on the card only, a whole run of run.py."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch

import tiny
from benchlib import harness, verify
from benchlib.spec import Spec

SEED = 2**31 + 4242
CELLS = ["tiny-stress", "tiny-adaptive"]


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return Spec(tiny.make_root(tmp_path_factory.mktemp("root"), episode_steps=3,
                               trace_steps=1))


def run(spec, cell, **kw):
    return harness.run(cell, SEED, 0.5, False, spec=spec, device="cpu", **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_the_reference_agrees_with_the_program_on_the_cpu(spec, cell):
    out = run(spec, cell)
    # on the CPU the program's kernels are their plain twins: every gap is 0
    assert out["correct"], out["checks"]
    assert all(v == 0.0 for v in out["readings"].values()), out["readings"]
    assert out["attempted"] > 0 and out["failed"] == 0
    want = {"start_gap", "census_gap", "pos_gap", "vel_gap", "early_sweeps"} | (
        {"level_gap"} if cell == "tiny-adaptive" else {"mass_gap"})
    assert set(out["checks"]) == want


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(spec, cell):
    out = run(spec, cell, overrides={"weight_cache_bf16": True})
    assert not out["correct"]
    assert out["checks"]["vel_gap"]["value"] > out["checks"]["vel_gap"]["limit"]


def unchanged(step_fn):
    """A step that returns its state unchanged."""
    def step(state, step_number):
        _, diag = step_fn(state, step_number)
        return state, diag
    return step


def half_left_out(step_fn):
    """Half of the particles' new velocities left out (their rows zeroed)."""
    def step(state, step_number):
        new, diag = step_fn(state, step_number)
        v = new.velocity.clone()
        v[::2] = 0.0
        return new.replace(velocity=v), diag
    return step


def half_dropped(step_fn):
    """Half of the alive particles left out of the state (alive cleared)."""
    def step(state, step_number):
        new, diag = step_fn(state, step_number)
        idx = torch.nonzero(new.alive).flatten()[::2]
        alive = new.alive.clone()
        alive[idx] = False
        return new.replace(alive=alive), diag
    return step


def one_altered(step_fn):
    """One answer altered where it is produced: the fastest particle's
    velocity off by 1% of the largest speed."""
    def step(state, step_number):
        new, diag = step_fn(state, step_number)
        speed = torch.where(new.alive, new.velocity.norm(dim=1), torch.zeros(()))
        i = int(torch.argmax(speed))
        v = new.velocity.clone()
        v[i, 0] += 0.01 * float(speed.max())
        return new.replace(velocity=v), diag
    return step


@pytest.mark.parametrize("fault", [unchanged, half_left_out, half_dropped, one_altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_is_not_correct(spec, cell, fault):
    out = run(spec, cell, wrap_step=fault)
    assert not out["correct"], out["checks"]


def test_a_solve_that_stops_early_is_not_correct(spec, monkeypatch):
    """Every solve of the program stops at a tolerance a thousand times the
    stated one and reports its error as it is. At this size only the
    adaptive cell has a solve past the 2-sweep floor in its checked steps."""
    from adaptive_sph_torch.models import tile_physics

    solve = tile_physics.tile_jacobi

    def early(accel_fn, div_fn, aii, src, alive, max_avg_error, *a, **kw):
        return solve(accel_fn, div_fn, aii, src, alive, max_avg_error * 1e3, *a, **kw)

    monkeypatch.setattr(tile_physics, "tile_jacobi", early)
    out = run(spec, "tiny-adaptive")
    assert not out["correct"] and out["checks"]["early_sweeps"]["value"] > 0, out["checks"]


def test_the_matching_goes_both_ways():
    """A particle the program dropped is far from every twin the reference
    looks up among the program's particles."""
    rng = np.random.default_rng(3)
    n = 64
    ref = {"position": rng.uniform(-1, 1, (n, 2)).astype(np.float32),
           "velocity": rng.normal(size=(n, 2)).astype(np.float32),
           "mass": np.full(n, 1e-4, np.float32), "density": np.ones(n, np.float32),
           "level": np.zeros(n, np.float32), "alive": np.ones(n, bool)}
    same = verify.step_gaps(ref, ref, 1e-3, 1e-3, 1.0, False)
    assert same["pos_gap"] == 0.0 and same["census_gap"] == 0.0
    port = {**ref, "alive": ref["alive"].copy()}
    port["alive"][::2] = False
    gaps = verify.step_gaps(port, ref, 1e-3, 1e-3, 1.0, False)
    # every survivor sits on its twin, the dropped ones are radii away
    assert gaps["pos_gap"] > 1.0 and gaps["census_gap"] == n // 2


@pytest.mark.cuda
def test_a_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "stress-x1",
                          "--seed", str(SEED), "--seconds", "2", "--trace", "1"],
                         capture_output=True, text=True, cwd=str(tiny.ROOT), timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks" and line["correct"], line["checks"]
    assert line["device"]["busy_s"] > 0 and line["metrics"]
