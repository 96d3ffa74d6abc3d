"""PyTorch port, the list backend's whole step (`backend="lists"`) against the
JAX package.

- The runs of `stress.list_runs()` (levels after advection over the stale
  pair set: surface-detection.yaml entries 1 and 2, scene-ratio2to1, to t =
  0.05; the default dam break with share / merge / split, 10 steps, its
  capacity growing 3,072 -> 6,144) against tests/data/torch_port_lists_ref.npz
  (scripts/torch_port_lists_ref.py), as chip_smoke.py L1-L2 hold the card:
  per step the census, capacity, resampling counts, dt and iteration counts
  equal; at the end, matched by position, positions atol 2e-5, density rtol
  2e-5, velocity atol 2e-4, mass rtol 1e-6 (1e-5 on the dam break, whose
  sizing function amplifies level noise 25-35x: ROADMAP.md section 3),
  levels atol 2e-5, flags, has_level and stash equal.
- Each solver (HybridDFSPH with check_aii and check_neighborhood, IISPH,
  IISPH2, OnlyDivergence) on scene-ratio2to1: 3 steps of both packages'
  list step, equal iteration counts, then the bounds above row by row (the
  list step keeps the particle order). The particle (Akinci) boundary's
  step: tests/test_torch_lists_physics.py.
- `compact`, the routing of backend="auto" against the reference's
  `supports_tile_backend`, the list overflow's failure, the image export
  (fused step) and profile_stages on the list backend.
"""

import dataclasses
import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from scipy.spatial import cKDTree

from adaptive_sph_torch import convert
from adaptive_sph_torch.models import adaptivity as t_adapt
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.runner import SimulationFailed, resolve_backend
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.stress import (
    LIST_EXPORT_TIME,
    SURFACE_DETECTION,
    list_export_attributes,
    list_runs,
)
from adaptive_sph_torch.utils import animation as t_animation
from adaptive_sph_torch.utils.params import (
    LevelEstimationMethod,
    ParticleSizes,
    PressureSolverMethod,
    ViscosityType,
)
from adaptive_sph_torch.utils.profiling import profile_sections
from adaptive_sph_tpu.models import adaptivity as j_adapt
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.models.state import FluidState as JState
from adaptive_sph_tpu.models.tile_step import supports_tile_backend
from adaptive_sph_tpu.runner import create_simulation as j_create
from adaptive_sph_tpu.utils import params as j_params

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_lists_ref.npz")
COUNTS = ("shares", "merge_or_split_count", "split_deferred")
STATE = ("position", "velocity", "density", "mass", "level", "stash", "has_level",
         "flag_is_fluid_surface", "flag_insufficient_neighs")
RUNS = list_runs()


def hold(got: dict, ref: dict, mass_rtol: float):
    """got / ref: alive arrays of STATE, in the same particle order."""
    np.testing.assert_allclose(got["position"], ref["position"], atol=2e-5)
    np.testing.assert_allclose(got["density"], ref["density"], rtol=2e-5)
    np.testing.assert_allclose(got["velocity"], ref["velocity"], atol=2e-4)
    np.testing.assert_allclose(got["mass"], ref["mass"], rtol=mass_rtol)
    np.testing.assert_allclose(got["level"], ref["level"], atol=2e-5)
    for k in ("stash", "has_level", "flag_is_fluid_surface", "flag_insufficient_neighs"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def alive_state(st) -> dict:
    a = st.alive.numpy()
    return {k: getattr(st, k).numpy()[a] for k in STATE}


def by_position(got: dict, ref_pos):
    _, j = cKDTree(got["position"]).query(ref_pos, k=1)
    assert (np.sort(j) == np.arange(len(j))).all(), "position match not a bijection"
    return {k: v[j] for k, v in got.items()}


@pytest.mark.parametrize("run", list(RUNS))
def test_list_runs_match_the_fixture(run):
    ref = np.load(FIXTURE)
    params, scene, _, _ = RUNS[run]
    sim = t_create(params, t_scene.scene_from_dict(scene), device="cpu")
    assert sim.backend == "lists" and sim.tile_cfg is None
    steps = len(ref[f"{run}/n"])
    for k in range(steps):
        d = sim.step()
        got = {**d, "n": sim.num_fluid_particles, "capacity": sim.state.capacity}
        for name in ("n", "capacity", "div_iterations", "density_iterations") + COUNTS:
            assert int(got.get(name, 0)) == int(ref[f"{run}/{name}"][k]), (name, k)
        assert np.float32(got["dt"]) == ref[f"{run}/dt"][k], k
    if run.startswith("surface"):
        assert sim.time >= LIST_EXPORT_TIME and steps == 9
    want = {k: ref[f"{run}/{k}"] for k in STATE}
    hold(by_position(alive_state(sim.state), want["position"]), want,
         mass_rtol=1e-5 if run == "dambreak" else 1e-6)


def jax_sim(params, scene, capacity=None):
    return j_create(j_params.params_from_dict(convert.params_to_dict(params)),
                    j_scene.scene_from_dict(scene), capacity=capacity, backend="lists")


SOLVER_CASES = {
    "hybrid_checked": dict(check_aii=True, check_neighborhood=True),
    "iisph": dict(pressure_solver_method=PressureSolverMethod.IISPH),
    "iisph2": dict(pressure_solver_method=PressureSolverMethod.IISPH2),
    "only_divergence": dict(pressure_solver_method=PressureSolverMethod.OnlyDivergence),
    # XSPH with a nonzero viscosity: the list physics takes its viscosity as
    # zero, as the reference's does (the tile engine refuses it)
    "xsph": dict(viscosity_type=ViscosityType.XSPH, viscosity=0.01),
}


@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_step_matches_jax(case):
    params, scene, _, _ = RUNS["surface_emptyangle"]
    params = params.replace(**SOLVER_CASES[case])
    js, ts = jax_sim(params, scene), t_create(params, t_scene.scene_from_dict(scene),
                                              device="cpu", backend="lists")
    for k in range(3):
        dj, dt_ = js.step(), ts.step()
        for name in ("div_iterations", "density_iterations", "negative_aii",
                     "neighborhood_check_mismatch"):
            if name in dj:
                assert dt_[name] == int(dj[name]), (name, k)
        assert np.float32(dt_["dt"]) == np.float32(dj["dt"]), k
        if "aii_deviation" in dj:
            assert dt_["aii_deviation"] < 0.01
            np.testing.assert_allclose(dt_["aii_deviation"], float(dj["aii_deviation"]),
                                       atol=5e-4)
    a = np.asarray(js.state.alive)
    assert np.array_equal(ts.state.alive.numpy(), a)
    ref = {k: np.asarray(getattr(js.state, k))[a] for k in STATE}
    hold(alive_state(ts.state), ref, mass_rtol=1e-6)
    if case == "hybrid_checked":
        assert "aii_deviation" in dt_ and dt_["neighborhood_check_mismatch"] == 0


@pytest.mark.parametrize("backend", ["tiles", "auto"])
def test_xsph_is_refused_on_the_tile_engine(backend):
    # XSPH with a nonzero viscosity runs on the list backend only: "tiles",
    # and "auto" where it resolves to tiles, refuse it
    params, scene, _, _ = RUNS["surface_emptyangle"]
    params = params.replace(viscosity_type=ViscosityType.XSPH, viscosity=0.01,
                            use_extended_range_for_level_estimation=True)
    assert resolve_backend(params, "auto") == "tiles"
    with pytest.raises(NotImplementedError, match="XSPH"):
        t_create(params, t_scene.scene_from_dict(scene), device="cpu", backend=backend)
    sim = t_create(params, t_scene.scene_from_dict(scene), device="cpu", backend="lists")
    assert sim.backend == "lists"


def test_compact_equals_jax():
    params, scene, _, _ = RUNS["surface_emptyangle"]
    sim = t_create(params, t_scene.scene_from_dict(scene), device="cpu", backend="lists")
    arr = convert.state_to_numpy(sim.state)
    rng = np.random.default_rng(11)
    arr["alive"] = arr["alive"] & (rng.uniform(size=arr["alive"].shape) < 0.7)
    for k in ("pressure", "density", "level"):
        arr[k] = rng.normal(size=arr[k].shape).astype(np.float32)
    got = t_adapt.compact(convert.state_from_numpy(arr, device="cpu"))
    want = j_adapt.compact(JState(**{k: jnp.asarray(v) for k, v in arr.items()}))
    for k, v in convert.state_to_numpy(got).items():
        np.testing.assert_array_equal(v, np.asarray(getattr(want, k)), err_msg=k)
    assert int(got.n) == int(arr["alive"].sum()) and got.alive.numpy()[:int(got.n)].all()


def test_auto_backend_is_the_references_choice():
    base = RUNS["surface_emptyangle"][0]
    combos = itertools.product(LevelEstimationMethod, (False, True), (False, True), (False, True),
                               (ParticleSizes.Adaptive, ParticleSizes.Uniform))
    seen = set()
    for method, after, extended, force, sizes in combos:
        params = base.replace(level_estimation_method=method,
                              level_estimation_after_advection=after,
                              use_extended_range_for_level_estimation=extended,
                              force_level_estimation=force, particle_sizes=sizes,
                              merging=False, sharing=False, splitting=False)
        want = "tiles" if supports_tile_backend(
            j_params.params_from_dict(convert.params_to_dict(params))) else "lists"
        assert resolve_backend(params, "auto") == want, (method, after, extended, force, sizes)
        seen.add(want)
        if want == "lists":
            with pytest.raises(NotImplementedError, match="backend='lists'"):
                resolve_backend(params, "tiles")
    assert seen == {"tiles", "lists"}
    # the dense grid engine is taken only when asked for, as in the reference
    assert resolve_backend(base, "grid") == "grid"
    extended = base.replace(use_extended_range_for_level_estimation=True)
    sim = t_create(extended, t_scene.scene_from_dict(RUNS["surface_emptyangle"][1]),
                   device="cpu")
    assert sim.backend == "tiles" and sim.ncfg is None


def test_list_overflow_raises_without_growth():
    params, scene, _, _ = RUNS["surface_centerdiff"]
    sim = t_create(params, t_scene.scene_from_dict(scene), device="cpu", row_width=4)
    cap = sim.state.capacity
    with pytest.raises(SimulationFailed, match="rows over by"):
        sim.step()
    assert sim.state.capacity == cap and sim.step_number == 0


def export_copy(tmp_path, entry: int, **changes) -> str:
    src = os.path.join(ROOT, SURFACE_DETECTION)
    with open(src) as f:
        e = dict(yaml.safe_load(f)[entry])
    for k in ("config_path", "scene_file"):
        e[k] = os.path.normpath(os.path.join(os.path.dirname(src), e[k]))
    e["update_attributes"] = {**e["update_attributes"], **list_export_attributes(entry)}
    e.update(time=LIST_EXPORT_TIME, image_width=96, image_height=96, **changes)
    path = str(tmp_path / "list.yaml")
    with open(path, "w") as f:
        yaml.safe_dump([e], f)
    return path


def test_image_export_runs_the_fused_list_step(tmp_path):
    ref = np.load(FIXTURE)
    (run,) = t_animation.export_simulation_images([export_copy(tmp_path, 1)], device="cpu")
    assert run.steps == len(ref["surface_emptyangle/n"]) and run.adaptivity_steps == 0
    got = by_position({"position": run.position}, ref["surface_emptyangle/position"])
    np.testing.assert_allclose(got["position"], ref["surface_emptyangle/position"], atol=2e-5)
    # a video interpolates across the fused steps (the census stays)
    (vid,) = t_animation.export_simulation_images(
        [export_copy(tmp_path, 1, video_start_time=0.0, video_fps=60, video_speed=0.25,
                     png_file="vid.mp4")], device="cpu")
    assert vid.steps == run.steps and vid.frames > vid.steps


def test_profile_stages_on_lists():
    params, scene, _, _ = RUNS["surface_centerdiff"]
    sim = t_create(params, t_scene.scene_from_dict(scene), device="cpu")
    out = profile_sections(sim, iters=1)
    assert list(out) == ["simulation-step(profiled)"] and out["simulation-step(profiled)"] > 0
    assert sim.step_number == 0
    with pytest.raises(NotImplementedError, match="two-phase"):
        sim.step_physics()


def test_runner_reports_the_list_configuration():
    params, scene, _, _ = RUNS["dambreak"]
    js, ts = jax_sim(params, scene), t_create(params, t_scene.scene_from_dict(scene),
                                              device="cpu")
    assert dataclasses.asdict(ts.ncfg) == dataclasses.asdict(js.ncfg)
    assert ts.backend == js.backend == "lists"
