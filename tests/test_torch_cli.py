"""PyTorch port: `python -m adaptive_sph_torch run` under every solver.

The command line prints one line per step with the iteration counts of the
solves the step ran: HybridDFSPH sets both counts, IISPH only the density
count and OnlyDivergence only the divergence count, and each line names only
the counts its step set, as the reference's `run` prints them
(adaptive_sph_tpu/cli.py). Scene and config are the impact scene of
adaptive_sph_torch/stress.py (144 particles, its solves iterate), written
to YAML files; 2 steps on the CPU.
"""

import re

import pytest
import torch
import yaml

from adaptive_sph_torch import cli, convert
from adaptive_sph_torch.stress import IMPACT_SCENE, impact_params
from adaptive_sph_torch.utils.params import PressureSolverMethod as M

torch.set_num_threads(2)

STEP_LINE = re.compile(r"^step (\d{5}) t=\S+s dt=\S+ms n=(\d+)(.*)$")


@pytest.mark.parametrize("method,counts", [
    (M.IISPH, ("density-iters",)),
    (M.OnlyDivergence, ("div-iters",)),
    (M.HybridDFSPH, ("div-iters", "density-iters")),
])
def test_run_prints_the_counts_each_solver_sets(tmp_path, capsys, method, counts):
    cfg = tmp_path / "config.yaml"
    scene = tmp_path / "scene.yaml"
    cfg.write_text(yaml.safe_dump(convert.params_to_dict(impact_params(method, resident=False))))
    scene.write_text(yaml.safe_dump(IMPACT_SCENE))
    rc = cli.main(["run", str(cfg), str(scene), "--max-steps", "2", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 0
    assert out[0] == "INIT 144 FLUID PARTICLES"
    steps = [STEP_LINE.match(line) for line in out[1:]]
    assert len(steps) == 2 and all(steps), out
    for k, m in enumerate(steps, 1):
        assert int(m.group(1)) == k and int(m.group(2)) == 144
        names = re.findall(r" ([a-z-]+)=(\d+)", m.group(3))
        assert tuple(n for n, _ in names) == counts, m.group(0)
        assert all(int(v) >= 1 for _, v in names)
