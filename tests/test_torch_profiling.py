"""PyTorch port, `profile_stages`: the reference's per-section times into `.stat`.

For each configuration the sections recorded are those the JAX package's
`profile_sections` records under the same conditions (adaptivity when a
resampling switch is on, level-estimation when level estimation is active,
div-solver / density-solver by the pressure solver), each with a positive
time on the CPU's clock; the resident HybridDFSPH launch, which runs both
solves at once, is split between the two by their iteration counts; the
step the profiler ran leaves the simulation's state alone; and `run -p` with
`profile_stages: true` prints the sections in the reference's `.stat` lines.
"""

import os

import pytest
import torch
import yaml

from adaptive_sph_torch import cli
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.runner import create_simulation
from adaptive_sph_torch.utils import params as t_params
from adaptive_sph_torch.utils import stats as t_stats
from adaptive_sph_torch.utils.profiling import profile_sections, section_names
from test_torch_step import dam_scene

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = ["simulation-step(profiled)", "neighborhood"]
NO_RESAMPLING = {"merging": False, "sharing": False, "splitting": False}

CASES = {
    # uniform sizes, HybridDFSPH, no level estimation
    "uniform_hybrid": ({"particle_sizes": "Uniform", **NO_RESAMPLING}, dam_scene(), 1024,
                       BASE + ["div-solver", "density-solver"]),
    # uniform resident HybridDFSPH: one launch for both solves
    "uniform_hybrid_resident": (
        {"particle_sizes": "Uniform", "resident_solver": True, **NO_RESAMPLING}, dam_scene(),
        1024, BASE + ["div-solver", "density-solver"]),
    # the adaptive dam break: levels, share / merge / split
    "adaptive_dam_break": ({}, None, None,
                           BASE + ["adaptivity", "level-estimation", "div-solver",
                                   "density-solver"]),
    "only_divergence": ({"pressure_solver_method": "OnlyDivergence", **NO_RESAMPLING},
                        dam_scene(), 1024, BASE + ["div-solver"]),
}


def default_scene():
    with open(os.path.join(ROOT, "configs", "default-scene.yaml")) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("case", list(CASES))
def test_sections_per_config(case):
    upd, scene, capacity, want = CASES[case]
    params = t_params.load_params(os.path.join(ROOT, "configs", "default-config.yaml"),
                                  update_attributes={**upd, "profile_stages": True})
    assert section_names(params) == want
    sim = create_simulation(params, t_scene.scene_from_dict(scene or default_scene()),
                            capacity=capacity, device="cpu")
    before = sim.state.position.clone()
    out = profile_sections(sim, iters=1)
    assert sorted(out) == sorted(want)
    assert all(t > 0 for t in out.values()), out
    assert out["simulation-step(profiled)"] >= max(out[k] for k in want[1:])
    assert torch.equal(sim.state.position, before) and sim.step_number == 0
    text = t_stats.write_statistics(sim.counters)
    for name in want:
        assert f"{name}: avg:" in text, name


def test_run_with_profile_stages_prints_the_sections(tmp_path, capsys):
    config = yaml.safe_load(open(os.path.join(ROOT, "configs", "default-config.yaml")))
    config.update({"profile_stages": True, "particle_sizes": "Uniform", **NO_RESAMPLING})
    cfg, scn, stat = tmp_path / "config.yaml", tmp_path / "scene.yaml", tmp_path / "run.stat"
    cfg.write_text(yaml.safe_dump(config))
    scn.write_text(yaml.safe_dump(dam_scene()))
    assert cli.main(["run", str(cfg), str(scn), "--device", "cpu", "--max-steps", "2", "-p",
                     "--statistics-path", str(stat)]) == 0
    text = stat.read_text()
    assert text in capsys.readouterr().out
    lines = text.splitlines()
    assert lines[0].startswith("$") and lines[2].startswith("simulation-time: ")
    for name in BASE + ["div-solver", "density-solver", "simulation-step"]:
        assert sum(line.startswith(f"{name}: avg:") for line in lines) == 1, name
    assert "adaptivity: avg:" not in text and "level-estimation: avg:" not in text
