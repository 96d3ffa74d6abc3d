"""PyTorch port, rendering: colours, snapshot, boundary segments and the raster
canvas against the JAX package's on the same inputs.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances: colours within 1e-6 for every visualised attribute (the same
numpy arithmetic on the same stops); the stored viridis / inferno tables
EQUAL to matplotlib's samples; snapshots, boundary segments and the raster
canvas before the legend and the title EQUAL (the same C++ source built with
the same flags). The reference's rasterizer is built from a copy of native/
in a temporary directory, so the repository's library is never rebuilt.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

from adaptive_sph_torch import convert
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.models.state import FIELDS
from adaptive_sph_torch.stress import IMPACT_CAPACITY, IMPACT_SCENE, impact_params
from adaptive_sph_torch.utils import colormap_tables
from adaptive_sph_torch.utils import colors as t_colors
from adaptive_sph_torch.utils import raster as t_raster
from adaptive_sph_torch.utils import render as t_render
from adaptive_sph_torch.utils import snapshot as t_snapshot
from adaptive_sph_torch.utils.params import InitBoundaryHandlerType, PressureSolverMethod
from adaptive_sph_torch.utils.params import SimulationParams as TParams
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.ops import kernels as j_kernels
from adaptive_sph_tpu.runner import create_simulation as j_create
from adaptive_sph_tpu.utils import colors as j_colors
from adaptive_sph_tpu.utils import params as j_params
from adaptive_sph_tpu.utils import render as j_render
from adaptive_sph_tpu.utils import snapshot as j_snapshot

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATTRS = [a.value for a in t_colors.VisualizedAttribute]
W = H = 320
ZOOM = 1.04


def j_params_of(p: TParams):
    return j_params.params_from_dict(convert.params_to_dict(p))


def use_reference_rasterizer(mp, directory):
    """Point the JAX package's rasterizer module at a copy of native/ in
    `directory` (its Makefile builds the library there at first use);
    returns the module."""
    from adaptive_sph_tpu.utils import raster as j_raster

    for name in ("rasterizer.cpp", "Makefile"):
        shutil.copy(os.path.join(ROOT, "native", name), os.path.join(directory, name))
    mp.setattr(j_raster, "_NATIVE_DIR", str(directory))
    mp.setattr(j_raster, "_LIB_PATH", os.path.join(directory, "librasterizer.so"))
    mp.setattr(j_raster, "_lib", None)
    mp.setattr(j_raster, "_lib_failed", False)
    assert j_raster._load() is not None, "the reference's rasterizer did not build"
    return j_raster


@pytest.fixture(scope="module")
def ref_raster(tmp_path_factory):
    """The JAX package's rasterizer module, its library built from a copy of
    native/ in a temporary directory."""
    with pytest.MonkeyPatch.context() as mp:
        yield use_reference_rasterizer(mp, tmp_path_factory.mktemp("native"))


def seeded_snapshot(n=300, seed=3):
    """A snapshot dict of n particles with every field colours read."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return {
        "position": rng.uniform(-0.9, 0.9, (n, 2)).astype(f32),
        "velocity": rng.normal(0, 1.5, (n, 2)).astype(f32),
        "mass": rng.uniform(1e-4, 2e-3, n).astype(f32),
        "density": rng.uniform(0.85, 1.05, n).astype(f32),
        "pressure": rng.uniform(0, 300, n).astype(f32),
        "aii": rng.uniform(-2, 60, n).astype(f32),
        "level": rng.uniform(-0.3, 0, n).astype(f32),
        "has_level": rng.random(n) < 0.7,
        "stash": rng.uniform(-0.3, 0, n).astype(f32),
        "neighbor_count": rng.integers(5, 25, n).astype(np.int32),
        "size_class": rng.integers(-1, 6, n).astype(np.int32),
        "constant_field": rng.uniform(0.9, 1.1, n).astype(f32),
        "ppe_source_term": rng.normal(0, 4000, n).astype(f32),
        "min_dist_to_neighbor": rng.uniform(0, 2, n),
        "flag_is_fluid_surface": rng.random(n) < 0.2,
        "flag_neighborhood_reduced": rng.random(n) < 0.2,
        "flag_insufficient_neighs": rng.random(n) < 0.1,
    }


def test_colormap_tables_are_matplotlibs_samples():
    from matplotlib import colormaps

    for name, table in (("viridis", colormap_tables.VIRIDIS),
                        ("inferno", colormap_tables.INFERNO)):
        want = [tuple(float(c) for c in colormaps[name](float(t))[:3])
                for t in np.linspace(0.0, 1.0, 32)]
        assert list(table) == want, name


@pytest.mark.parametrize("flags", ["none", "stash", "surface", "reduced"])
@pytest.mark.parametrize("attr", ATTRS)
def test_colors_match_the_reference(attr, flags):
    snap = seeded_snapshot()
    tp = TParams()
    viz = dict(visualized_attribute=attr, take_data_from_stash=flags == "stash",
               show_flag_is_fluid_surface=flags == "surface",
               show_flag_neighborhood_reduced=flags == "reduced")
    tv = t_colors.VisualizationParams.from_dict(viz)
    jv = j_colors.VisualizationParams.from_dict(viz)
    for mp in (None, 123.0):
        got = t_colors.colors_for_particles(snap, tp, tv, mp)
        want = j_colors.colors_for_particles(snap, j_params_of(tp), jv, mp)
        assert got.shape == (300, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=f"{attr} {flags}")
    tc, jc = t_colors.get_color_map(tv.visualized_attribute, tp), \
        j_colors.get_color_map(jv.visualized_attribute, j_params_of(tp))
    assert (tc is None) == (jc is None)
    if tc is not None:
        np.testing.assert_allclose(tc.xs, jc.xs, rtol=0, atol=1e-12)
        np.testing.assert_allclose(tc.cols, jc.cols, rtol=0, atol=1e-6)


def impact_states(boundary=InitBoundaryHandlerType.AnalyticOverestimate):
    """(JAX sim, port state, port params) of the impact scene's initial state;
    the params as the simulation normalised them (h from the spacing)."""
    tp = dataclasses.replace(impact_params(PressureSolverMethod.HybridDFSPH, resident=False),
                             init_boundary_handler=boundary)
    js = j_create(j_params_of(tp), j_scene.scene_from_dict(IMPACT_SCENE),
                  capacity=IMPACT_CAPACITY, counters_enabled=False)
    arrays = {k: np.array(getattr(js.state, k)) for k in FIELDS}
    return (js, convert.state_from_numpy(arrays, device="cpu"),
            convert.params_from_dict(dataclasses.asdict(js.params)))


def test_snapshot_matches_the_reference():
    js, ts, tp = impact_states()
    # seeded fields, so that no column is a constant
    rng = np.random.default_rng(5)
    C = ts.capacity
    ts = ts.replace(velocity=torch.from_numpy(rng.normal(size=(C, 2)).astype(np.float32)),
                    level=torch.from_numpy(rng.normal(size=C).astype(np.float32)),
                    neighbor_count=torch.from_numpy(rng.integers(0, 30, C).astype(np.int32)),
                    flag_is_fluid_surface=torch.from_numpy(rng.random(C) < 0.3))
    js_state = js.state.replace(**{k: convert.state_to_numpy(ts)[k] for k in
                                   ("velocity", "level", "neighbor_count",
                                    "flag_is_fluid_surface")})
    got = t_snapshot.take_snapshot(ts, tp)
    want = j_snapshot.take_snapshot(js_state, js.params)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("boundary", [InitBoundaryHandlerType.AnalyticOverestimate,
                                      InitBoundaryHandlerType.AnalyticUnderestimate])
def test_boundary_segments_match_the_reference(boundary):
    js, _, tp = impact_states(boundary)
    th = t_scene.make_boundary_handler(t_scene.scene_from_dict(IMPACT_SCENE), tp)
    got, want = t_render.boundary_segments(th), j_render.boundary_segments(js.boundary_handler)
    assert got.dtype == want.dtype == np.float32 and len(got) == 4
    assert np.array_equal(got, want)


def test_raster_primitives_equal_the_reference(ref_raster):
    rng = np.random.default_rng(7)
    n = 400
    pos = rng.uniform(-1.0, 1.0, (n, 2)).astype(np.float32)
    radius = rng.uniform(0.002, 0.06, n).astype(np.float32)
    rgb = rng.random((n, 3)).astype(np.float32)
    segs = rng.uniform(-1.2, 1.2, (6, 4)).astype(np.float32)
    scale = min(W, H) / (2.0 * ZOOM)
    got = t_raster.new_canvas(W, H)
    want = ref_raster.new_canvas(W, H)
    t_raster.draw_lines(got, segs, scale, 5.0 / 1000.0)
    ref_raster.draw_lines(want, segs, scale, 5.0 / 1000.0)
    t_raster.draw_circles(got, pos, radius, rgb, scale)
    ref_raster.draw_circles(want, pos, radius, rgb, scale)
    assert (got != 1.0).any()
    assert np.array_equal(got, want)
    assert np.array_equal(t_raster.to_uint8(got), ref_raster.to_uint8(want))


@pytest.mark.parametrize("boundary", [InitBoundaryHandlerType.AnalyticOverestimate,
                                      InitBoundaryHandlerType.AnalyticUnderestimate])
def test_render_canvas_equals_the_reference(ref_raster, boundary):
    # the canvas render2d draws before its legend and title: the boundary, then
    # the particles at r(m / rho0), composed from the reference's own functions
    js, ts, tp = impact_states(boundary)
    snap = seeded_snapshot(n=500, seed=11)
    colors = t_colors.colors_for_particles(snap, tp, t_colors.VisualizationParams())
    th = t_scene.make_boundary_handler(t_scene.scene_from_dict(IMPACT_SCENE), tp)
    got = t_render.render_canvas(snap["position"], snap["mass"], tp.rest_density, colors, th, W,
                                 H, ZOOM)
    want = ref_raster.new_canvas(W, H)
    scale = min(W, H) / (j_render.SCENE_WIDTH * ZOOM)
    ref_raster.draw_lines(want, j_render.boundary_segments(js.boundary_handler), scale,
                          width_world=5.0 / 1000.0)
    radii = np.asarray(j_kernels.sphere_volume_to_radius(
        np.asarray(snap["mass"], np.float64) / js.params.rest_density, 2), np.float32)
    ref_raster.draw_circles(want, snap["position"], radii, colors.astype(np.float32), scale)
    assert np.array_equal(got, want)


def test_render2d_draws_legend_and_title_over_the_canvas(tmp_path):
    _, _, tp = impact_states()
    snap = seeded_snapshot(n=200, seed=2)
    viz = t_colors.VisualizationParams()
    colors = t_colors.colors_for_particles(snap, tp, viz)
    th = t_scene.make_boundary_handler(t_scene.scene_from_dict(IMPACT_SCENE), tp)
    canvas = t_raster.to_uint8(t_render.render_canvas(snap["position"], snap["mass"],
                                                      tp.rest_density, colors, th, W, H, ZOOM))
    cm = t_colors.get_color_map(viz.visualized_attribute, tp)
    for right in (False, True):
        img = t_render.render2d(snap["position"], snap["mass"], tp.rest_density, colors, th,
                                W, H, dict(color_map=cm, text_right=right, only_min_max=right),
                                "n = #p", ZOOM)
        assert img.shape == (H, W, 3) and img.dtype == np.uint8
        changed = (img != canvas).any(axis=-1)
        assert changed[:int(0.08 * H), :].any()  # the title
        assert changed[int(0.2 * H):int(0.5 * H), int(0.83 * W):int(0.9 * W)].any()  # gradient
        path = str(tmp_path / f"r{right}.png")
        t_render.save_png(img, path)
        from PIL import Image

        with Image.open(path) as im:
            assert np.array_equal(np.asarray(im), img)


def test_rasterizer_checks_its_inputs():
    with pytest.raises(ValueError, match="canvas"):
        t_raster.draw_lines(np.zeros((4, 4, 3), np.float64), np.zeros((1, 4)), 1.0, 0.01)
    with pytest.raises(ValueError, match="positions"):
        t_raster.draw_circles(t_raster.new_canvas(4, 4), np.zeros((3, 2)), np.ones(2),
                              np.zeros((3, 3)), 1.0)
