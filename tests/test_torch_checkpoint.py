"""PyTorch port, the files a run writes: checkpoints, VTK and the web viewer, and
`run` with every option.

- A checkpoint saved by the JAX package loads in the port, and one saved by
  the port loads in the JAX package; each is then stepped once by both
  packages from the same loaded arrays: positions atol 2e-5, the census
  EQUAL. Both packages write the same arrays for the same state.
- The VTK file and the web viewer's files of one snapshot are byte for byte
  the reference's.
- `run` with every option on the impact scene (144 particles, capacity
  1,024), then a straight run against a run resumed from its checkpoint:
  the resumed step's state EQUAL to the straight run's.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import yaml

from adaptive_sph_torch import cli, convert
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.models.state import FIELDS
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.stress import IMPACT_CAPACITY, IMPACT_SCENE, impact_params
from adaptive_sph_torch.utils import checkpoint as t_ckpt
from adaptive_sph_torch.utils import colors as t_colors
from adaptive_sph_torch.utils import render as t_render
from adaptive_sph_torch.utils import snapshot as t_snapshot
from adaptive_sph_torch.utils import vtk as t_vtk
from adaptive_sph_torch.utils import web_export as t_web
from adaptive_sph_torch.utils.params import PressureSolverMethod
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.ops import kernels as j_kernels
from adaptive_sph_tpu.runner import create_simulation as j_create
from adaptive_sph_tpu.utils import checkpoint as j_ckpt
from adaptive_sph_tpu.utils import colors as j_colors
from adaptive_sph_tpu.utils import params as j_params
from adaptive_sph_tpu.utils import render as j_render
from adaptive_sph_tpu.utils import snapshot as j_snapshot
from adaptive_sph_tpu.utils import vtk as j_vtk
from adaptive_sph_tpu.utils import web_export as j_web

torch.set_num_threads(2)

PARAMS = impact_params(PressureSolverMethod.HybridDFSPH, resident=False)


@pytest.fixture(scope="module")
def stepped():
    """(JAX sim, port sim, their states) of the impact scene after two steps
    (the states in the sorted layout, with holes)."""
    js = j_create(j_params.params_from_dict(convert.params_to_dict(PARAMS)),
                  j_scene.scene_from_dict(IMPACT_SCENE), capacity=IMPACT_CAPACITY,
                  counters_enabled=False, backend="tiles")
    ts = t_create(PARAMS, t_scene.scene_from_dict(IMPACT_SCENE), capacity=IMPACT_CAPACITY,
                  device="cpu")
    for _ in range(2):
        js.step()
        ts.step()
    return js, ts, js.state, ts.state


@pytest.fixture
def sims(stepped):
    """The two simulations back at their states after two steps."""
    js, ts, jstate, tstate = stepped
    js.state = jstate
    ts.load_state(tstate)
    return js, ts


def step_both_from(path, js, ts):
    """Load the checkpoint in both packages and step each once; returns the
    (JAX, port) states after the step."""
    js.state = j_ckpt.load_state(path, capacity=js.state.capacity)
    ts.load_state(t_ckpt.load_state(path, device="cpu"))
    assert ts.step_number == int(js.state.step_number) == 2
    js.step()
    ts.step()
    return js.state, ts.state


def assert_same_step(jstate, tstate):
    alive = np.asarray(jstate.alive)
    assert np.array_equal(tstate.alive.numpy(), alive)
    assert int(tstate.n) == int(jstate.n) == 144
    assert int(tstate.step_number) == int(jstate.step_number) == 3
    np.testing.assert_allclose(tstate.position.numpy()[alive], np.asarray(jstate.position)[alive],
                               rtol=0, atol=2e-5)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_round_trip_between_the_packages(tmp_path, sims, writer):
    js, ts = sims
    path = str(tmp_path / f"{writer}.npz")
    if writer == "jax":
        j_ckpt.save_state(path, js.state)
    else:
        t_ckpt.save_state(path, ts.state)
    with np.load(path) as data:
        assert sorted(data.files) == sorted(FIELDS)
        n = int(data["n"])
        assert data["alive"][:n].all() and not data["alive"][n:].any()  # alive rows first
    assert_same_step(*step_both_from(path, js, ts))


def test_both_packages_write_the_same_checkpoint(tmp_path, sims):
    js, _ = sims
    arrays = {k: np.array(getattr(js.state, k)) for k in FIELDS}
    j_ckpt.save_state(str(tmp_path / "j.npz"), js.state)
    t_ckpt.save_state(str(tmp_path / "t.npz"), convert.state_from_numpy(arrays, device="cpu"))
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "t.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_load_state_pads_and_refuses(tmp_path, sims):
    _, ts = sims
    path = str(tmp_path / "t.npz")
    t_ckpt.save_state(path, ts.state)
    big = t_ckpt.load_state(path, capacity=2048, device="cpu")
    assert big.capacity == 2048 and int(big.n) == 144 and not big.alive[1024:].any()
    with pytest.raises(ValueError, match="do not fit"):
        t_ckpt.load_state(path, capacity=64, device="cpu")


def test_vtk_and_web_files_equal_the_reference(tmp_path, sims):
    js, ts = sims
    arrays = {k: np.array(getattr(js.state, k)) for k in FIELDS}
    tstate = convert.state_from_numpy(arrays, device="cpu")
    tsnap = t_snapshot.take_snapshot(tstate, ts.params)
    jsnap = j_snapshot.take_snapshot(js.state, js.params)
    segs_t = t_render.boundary_segments(ts.boundary_handler)
    segs_j = j_render.boundary_segments(js.boundary_handler)
    t_vtk.write_vtk_file(str(tmp_path / "t.vtk"), tsnap, segs_t)
    j_vtk.write_vtk_file(str(tmp_path / "j.vtk"), jsnap, segs_j)
    assert (tmp_path / "t.vtk").read_bytes() == (tmp_path / "j.vtk").read_bytes()

    for tag, web_mod, snap, segs, colors_mod, params, radii in (
            ("t", t_web, tsnap, segs_t, t_colors, ts.params,
             np.sqrt(tsnap["mass"] / ts.params.rest_density / np.pi)),
            ("j", j_web, jsnap, segs_j, j_colors, js.params,
             np.asarray(j_kernels.sphere_volume_to_radius(jsnap["mass"] /
                                                          js.params.rest_density, 2)))):
        web = web_mod.WebExporter(str(tmp_path / f"web_{tag}"), scene_width=2.0)
        web.set_boundary_segments(segs)
        colors = colors_mod.colors_for_particles(snap, params,
                                                 colors_mod.VisualizationParams())
        web.add_frame(float(snap["time"]), snap["position"], radii,
                      (colors * 255).astype("uint8"))
        web.finalize()
    for name in ("frame-000000.bin", "meta.json", "index.html"):
        assert (tmp_path / "web_t" / name).read_bytes() == \
            (tmp_path / "web_j" / name).read_bytes(), name


def test_run_with_every_option_then_resume(tmp_path, capsys):
    cfg, scene = tmp_path / "config.yaml", tmp_path / "scene.yaml"
    cfg.write_text(yaml.safe_dump(convert.params_to_dict(PARAMS)))
    scene.write_text(yaml.safe_dump(IMPACT_SCENE))
    (tmp_path / "watch.yaml").write_text("{}\n")

    def j(*p):
        return str(tmp_path.joinpath(*p))

    base = ["run", str(cfg), str(scene), "--device", "cpu"]
    rc = cli.main(base + ["--max-steps", "4", "-p", "--statistics-path", j("run.stat"),
                          "--vtk-dir", j("vtk"), "--vtk-every", "2", "--snapshot-png",
                          j("final.png"), "--web-dir", j("web"), "--web-every", "2",
                          "--watch-config", j("watch.yaml"), "--checkpoint", j("ck4.npz")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "simulation-step" in out and "simulation-step" in open(j("run.stat")).read()
    series = json.load(open(j("vtk", "adaptive-sph-torch.vtk.series")))["files"]
    assert [e["name"] for e in series] == [f"adaptive-sph-torch-{i:06d}.vtk" for i in range(2)]
    meta = json.load(open(j("web", "meta.json")))
    assert len(meta["frames"]) == 2 and len(meta["boundary"]) == 4
    assert os.path.exists(j("web", "index.html")) and os.path.exists(j("final.png"))
    from PIL import Image

    with Image.open(j("final.png")) as im:
        assert im.size == (2000, 2000)
    # the files of the last snapshot (step 4) against the reference's exporters
    # on the checkpoint's state (its alive rows in the state's order)
    jstate = j_ckpt.load_state(j("ck4.npz"))
    jp = j_params.params_from_dict(convert.params_to_dict(PARAMS))
    jsim = j_create(jp, j_scene.scene_from_dict(IMPACT_SCENE), capacity=IMPACT_CAPACITY,
                    counters_enabled=False, backend="tiles")
    j_vtk.write_vtk_file(j("ref.vtk"), j_snapshot.take_snapshot(jstate),
                         j_render.boundary_segments(jsim.boundary_handler))
    assert open(j("ref.vtk"), "rb").read() == open(j("vtk", series[-1]["name"]), "rb").read()
    snap = j_snapshot.take_snapshot(jstate, jsim.params)
    web = j_web.WebExporter(j("ref_web"))
    colors = j_colors.colors_for_particles(snap, jsim.params, j_colors.VisualizationParams())
    web.add_frame(snap["time"], snap["position"], np.asarray(j_kernels.sphere_volume_to_radius(
        snap["mass"] / jsim.params.rest_density, 2)), (colors * 255).astype("uint8"))
    assert open(j("ref_web", "frame-000000.bin"), "rb").read() == \
        open(j("web", meta["frames"][-1]["file"]), "rb").read()

    assert cli.main(base + ["--max-steps", "5", "--checkpoint", j("ck5.npz")]) == 0
    assert cli.main(base + ["--resume", j("ck4.npz"), "--max-steps", "1", "--checkpoint",
                            j("ck5r.npz")]) == 0
    assert "resumed from" in capsys.readouterr().out
    with np.load(j("ck5.npz")) as a, np.load(j("ck5r.npz")) as b:
        assert int(a["step_number"]) == int(b["step_number"]) == 5
        for k in FIELDS:
            assert np.array_equal(a[k], b[k]), k
