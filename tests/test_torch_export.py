"""PyTorch port, the export frontends: the two-phase step and `image` against the
JAX package's.

- The two-phase step (physics, then resampling) on a small adaptive dam
  (default-config.yaml, one block of 180 particles, capacity 2,048) against
  JAX's `make_two_phase_step_fns` for 3 steps: pos_prev and positions atol
  2e-5, the census and the resampling counts EQUAL (both packages return
  their state in the step's sorted order, so rows are compared as they
  stand).
- `image` on the reference's own small export list (tests/test_image_export.py:
  a uniform IISPH box, 320 x 320): the PNG and the .stat file present, the
  .stat file with the reference's keys and the port's host-reads, the final
  positions against JAX's tile backend after as many steps, atol 2e-5. Its
  video variant writes one frame per export time (numbered PNGs where
  imageio or its encoder is missing).
- `run --watch-config`'s reload and `Simulation.update_params`.
Every export list is written to a temporary directory: an export writes its
png_file beside its list.
"""

import argparse
import os
import re
import time

import numpy as np
import pytest
import torch
import yaml

from adaptive_sph_torch import cli, convert
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.utils import animation as t_animation
from adaptive_sph_torch.utils import params as t_params
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.models.simulation import make_two_phase_step_fns
from adaptive_sph_tpu.runner import create_simulation as j_create
from adaptive_sph_tpu.utils import params as j_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "default-config.yaml")
SMALL_DAM = {"boundary": {"type": "box", "width": 2, "height": 2},
             "blocks": [{"pos": [-0.95, -0.95], "size": [0.5, 0.5], "spacing": 0.04,
                         "volume_fill_ratio": 0.93, "velocity": [0, 0]}]}
SMALL_DAM_CAPACITY = 2048
# the reference's small export list (tests/test_image_export.py)
BOX_SCENE = {"boundary": {"type": "box", "width": 1.0, "height": 1.0},
             "blocks": [{"pos": [-0.4, -0.4], "size": [0.4, 0.4], "spacing": 0.06,
                         "volume_fill_ratio": 0.93, "velocity": [0, 0]}]}
BOX_CONFIG = {"rest_density": 1, "cfl_factor": 0.4, "max_dt": 0.004, "h": 0.0,
              "viscosity_type": "ApproxLaplace", "viscosity": 0.003, "jacobi_omega": 0.5,
              "gravity": -9.81, "level_estimation_method": "None",
              "init_boundary_handler": "AnalyticOverestimate",
              "support_length_estimation": "FromMass", "merging": False, "sharing": False,
              "splitting": False, "pressure_solver_method": "IISPH",
              "iisph_max_avg_density_error": 0.002, "max_iters": 60,
              "particle_sizes": "Uniform"}


def export_list(tmp_path, **entry):
    (tmp_path / "config.yaml").write_text(yaml.safe_dump(BOX_CONFIG))
    cfg = {"time": 0.02, "config_path": "config.yaml", "scene": BOX_SCENE,
           "visualization_params": {"visualized_attribute": "Velocity"}, "title": "smoke #p",
           "png_file": "out.png", "image_width": 320, "image_height": 320,
           "output_stats": True, **entry}
    path = tmp_path / "export.yaml"
    path.write_text(yaml.safe_dump([cfg]))
    return str(path)


def stat_keys(text: str) -> list:
    return sorted(line.split(":")[0] for line in text.splitlines() if ":" in line)


def test_two_phase_step_matches_jax():
    tp = t_params.load_params(CONFIG)
    js = j_create(j_params.load_params(CONFIG), j_scene.scene_from_dict(SMALL_DAM),
                  capacity=SMALL_DAM_CAPACITY, counters_enabled=False, backend="tiles")
    ts = t_create(tp, t_scene.scene_from_dict(SMALL_DAM), capacity=SMALL_DAM_CAPACITY,
                  device="cpu")
    physics, adaptivity = make_two_phase_step_fns(js.params, js.boundary_handler,
                                                  js.split_patterns, js.tile_cfg)
    jstate = js.state
    resampled = 0
    for step in range(1, 4):
        start = convert.state_to_numpy(ts.state)
        jstate, jd = physics(jstate)
        td = ts.step_physics()
        alive = np.asarray(jstate.alive)
        assert np.array_equal(ts.state.alive.numpy(), alive), step
        prev = td["pos_prev"].numpy()
        np.testing.assert_allclose(prev[alive], np.asarray(jd["pos_prev"])[alive], rtol=0,
                                   atol=2e-5, err_msg=f"pos_prev, step {step}")
        # pos_prev: the start-of-step positions, reordered as the step reordered
        assert np.array_equal(np.sort(prev[alive], axis=0),
                              np.sort(start["position"][start["alive"]], axis=0))
        np.testing.assert_allclose(ts.state.position.numpy()[alive],
                                   np.asarray(jstate.position)[alive], rtol=0, atol=2e-5,
                                   err_msg=f"position, step {step}")
        assert ts.step_number == int(jstate.step_number) == step
        jstate, jad = adaptivity(jstate, jd["dt"])
        tad = ts.step_adaptivity(td["dt"])
        assert ts.num_fluid_particles == int(jstate.n), step
        assert np.array_equal(ts.state.alive.numpy(), np.asarray(jstate.alive)), step
        for k in ("shares", "merge_or_split_count", "split_deferred"):
            assert tad[k] == int(jad[k]), (step, k)
        resampled += tad["shares"] + tad["merge_or_split_count"]
    assert resampled > 0  # the dam resampled between the physics steps
    assert ts.state.capacity == SMALL_DAM_CAPACITY


def test_image_export_matches_the_reference(tmp_path, monkeypatch):
    ours = tmp_path / "port"
    ref = tmp_path / "ref"
    ours.mkdir()
    ref.mkdir()
    (run,) = t_animation.export_simulation_images([export_list(ours)], device="cpu")
    # the reference's export, its rasterizer built into a copy of native/ (the
    # repository's library is never rebuilt)
    from adaptive_sph_tpu.utils.animation import export_simulation_images
    from test_torch_render import use_reference_rasterizer

    (tmp_path / "native").mkdir()
    use_reference_rasterizer(monkeypatch, tmp_path / "native")
    export_simulation_images([export_list(ref)])

    from PIL import Image

    for d in (ours, ref):
        with Image.open(d / "out.png") as im:
            assert im.size == (320, 320)
    assert run.png_file == str(ours / "out.png") and run.frames == 1
    # the reference's keys, and the port's count of blocking device reads
    # (adaptive_sph_torch/spans.py)
    assert stat_keys((ours / "out.png.stat").read_text()) == \
        sorted(stat_keys((ref / "out.png.stat").read_text()) + ["host-reads"])
    assert len(run.counters.values["particle-count"]) == run.steps >= 1
    # the final state against JAX's tile backend after as many steps
    jp = j_params.load_params(str(ours / "config.yaml"))
    js = j_create(jp, j_scene.scene_from_dict(BOX_SCENE), counters_enabled=False,
                  backend="tiles")
    for _ in range(run.steps):
        js.step()
    jpos = np.asarray(js.state.position)[np.asarray(js.state.alive)]
    assert run.n == len(jpos)
    np.testing.assert_allclose(run.position, jpos, rtol=0, atol=2e-5)


def test_image_command_writes_png_and_stats(tmp_path, capsys):
    rc = cli.main(["image", export_list(tmp_path), "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    m = re.search(r"wrote (\S+): (\d+) steps, 1 frames, n=(\d+), ", out)
    assert m and m.group(1) == str(tmp_path / "out.png") and int(m.group(3)) == 36, out
    assert os.path.getsize(tmp_path / "out.png") > 2000
    stats = (tmp_path / "out.png.stat").read_text()
    assert "simulation-time" in stats and "density-iterations" in stats


def test_video_export_writes_a_frame_per_export_time(tmp_path):
    path = export_list(tmp_path, video_start_time=0, video_fps=60, video_speed=0.25,
                       png_file="vid.mp4", output_stats=False)
    (run,) = t_animation.export_simulation_images([path], device="cpu")
    # 0.02 s at 1/240 s per frame: one frame per export time up to the start
    # of the last step (dt 0.004 s, 5 steps), then the one past it
    assert run.steps == 5 and run.adaptivity_steps == 4
    assert run.frames == len(np.arange(0.0, 0.016 + 1e-9, 1.0 / 240.0)) + 1
    if os.path.exists(tmp_path / "vid.mp4"):
        assert run.png_file == str(tmp_path / "vid.mp4")
    else:
        frames = sorted(os.listdir(tmp_path / "vid-frames"))
        assert run.png_file == str(tmp_path / "vid-frames") and len(frames) == run.frames
        from PIL import Image

        with Image.open(tmp_path / "vid-frames" / frames[-1]) as im:
            assert im.size == (320, 320)


@pytest.mark.parametrize("entry", [
    # the older schema's top-level key, and the attributes that force the
    # level estimation and the diagnostic fields on
    {"visualized_attribute": "Distance", "visualization_params": None},
    {"visualization_params": {"visualized_attribute": "NeighborCount"}},
    {"visualization_params": {"visualized_attribute": "ConstantField"}, "no_legend": True},
])
def test_image_export_takes_every_schema(tmp_path, entry):
    (run,) = t_animation.export_simulation_images([export_list(tmp_path, **entry)],
                                                  device="cpu")
    assert run.frames == 1 and os.path.getsize(tmp_path / "out.png") > 2000


def test_panic_on_end_raises(tmp_path):
    path = export_list(tmp_path, panic_on_end=True)
    with pytest.raises(RuntimeError, match="REACHED END BEFORE EXPORT"):
        t_animation.export_simulation_images([path], device="cpu")


def test_watch_config_reloads_params(tmp_path, monkeypatch):
    cfg = tmp_path / "config.yaml"
    cfg.write_text(yaml.safe_dump(BOX_CONFIG))
    watch = tmp_path / "watch.yaml"
    watch.write_text(yaml.safe_dump({"viscosity": 0.01}))
    args = argparse.Namespace(simulation_config=str(cfg), overwrite_config_file=None,
                              watch_config=str(watch))
    mtime = os.path.getmtime(watch)
    assert cli._watched_params(args, mtime) == (None, mtime)
    p, m2 = cli._watched_params(args, 0.0)
    assert p.viscosity == 0.01 and m2 == mtime
    watch.write_text("viscosity: [unclosed\n")
    os.utime(watch, (time.time() + 5, time.time() + 5))
    p, m3 = cli._watched_params(args, mtime)
    assert p is None and m3 != mtime  # a file that does not parse keeps the old params
    sim = t_create(t_params.load_params(str(cfg)), t_scene.scene_from_dict(BOX_SCENE),
                   device="cpu")
    sim.step()
    sim.update_params(t_params.load_params(str(cfg), update_attributes={"viscosity": 0.01}))
    assert sim.params.viscosity == 0.01 and sim.params.h > 0
    d = sim.step()
    assert sim.step_number == 2 and np.isfinite(d["dt"])
    sim.update_params(sim.params.replace(profile_stages=True))
    assert sim.params.profile_stages and sim.params.viscosity == 0.01
    d = sim.step()
    assert sim.step_number == 3 and np.isfinite(d["dt"])
