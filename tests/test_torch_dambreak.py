"""PyTorch port, the adaptive path end to end: level estimation (EmptyAngle,
wavefront), smoothing, share every step, merge on even and split on odd
steps, capacity growth.

(a) (slow) A small adaptive scene (the resampling scene of
    test_e2e_adaptive.py, HybridDFSPH, tiny split patterns) for 4 steps in
    both packages.
(b) The default dam break (configs/default-config.yaml + default-scene.yaml,
    n = 1,035 at the start, grows to ~4,000) on the port for 10 steps
    against the committed JAX trajectory tests/data/torch_port_dambreak_ref.npz,
    which chip_smoke.py also holds the GPU run to.
(c) (slow) That fixture against a fresh JAX run.

Per step: the particle count, capacity, resampling counts, dt and the solver
iteration counts equal. After the last step, with particles matched by
position (a bijection): positions atol 2e-5, density rtol 2e-5, velocity
atol 2e-4, level atol 2e-5, and mass rtol 1e-6 in (a). In (b) mass is held
to rtol 1e-5: near the surface the Radius sizing function's target mass
moves 25-35x faster (relative) than the level it is computed from, and the
masses sharing sets follow the target, so float32 noise of ~1e-7 in the
level reaches a few 1e-6 in the mass. The JAX package itself, with every
level moved by one float32 step before each adaptivity step, differs from
its own unperturbed run by 2.1e-6 in mass after the 10 steps, more than
1e-6 (scripts/torch_port_dambreak_spread.py).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from adaptive_sph_torch import convert
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.utils import params as t_params
from adaptive_sph_tpu.runner import create_simulation as j_create
from test_e2e_adaptive import PARAMS, SCENE, tiny_patterns

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_dambreak_ref.npz")
CONFIG = os.path.join(ROOT, "configs", "default-config.yaml")
SCENE_YAML = os.path.join(ROOT, "configs", "default-scene.yaml")
COUNTS = ("shares", "merge_or_split_count", "split_deferred")


def match_states(ref: dict, st, mass_rtol):
    """Hold the port's alive particles to reference arrays (position,
    velocity, density, mass, level), matched by position."""
    a = st.alive.numpy()
    got = {k: getattr(st, k).numpy()[a] for k in ("position", "velocity", "density", "mass",
                                                  "level")}
    assert len(got["position"]) == len(ref["position"])
    _, j = cKDTree(got["position"]).query(ref["position"], k=1)
    assert (np.sort(j) == np.arange(len(j))).all(), "position match not a bijection"
    np.testing.assert_allclose(got["position"][j], ref["position"], atol=2e-5)
    np.testing.assert_allclose(got["density"][j], ref["density"], rtol=2e-5)
    np.testing.assert_allclose(got["velocity"][j], ref["velocity"], atol=2e-4)
    np.testing.assert_allclose(got["mass"][j], ref["mass"], rtol=mass_rtol)
    np.testing.assert_allclose(got["level"][j], ref["level"], atol=2e-5)


def check_step(k, got: dict, ref: dict):
    """One step's diagnostics of the port (got) against the reference's."""
    for name in ("n", "capacity", "div_iterations", "density_iterations") + COUNTS:
        assert int(got[name]) == int(ref[name]), (name, k)
    assert np.float32(got["dt"]) == np.float32(ref["dt"]), k
    assert got["mass_conservation_error"] < 0.005


@pytest.mark.slow  # ~45 s: the JAX side compiles the adaptive step; (b) keeps the tier-1 coverage
def test_small_adaptive_scene_matches_jax():
    js = j_create(PARAMS, SCENE, capacity=2048, split_patterns=tiny_patterns())
    ts = t_create(convert.params_from_dict(dataclasses.asdict(PARAMS)), t_scene.scene_from_dict({
        "boundary": {"type": "box", "width": 1.0, "height": 1.0},
        "blocks": [{"pos": [-0.24, -0.24], "size": [0.5, 0.5], "spacing": 0.06,
                    "volume_fill_ratio": 0.93, "velocity": [0, 0]}]}),
        capacity=2048, device="cpu", split_patterns=tiny_patterns())
    assert ts.tile_cfg.populated == js.tile_cfg.populated and ts.tile_cfg.tq == js.tile_cfg.tq
    counts = []
    for k in range(4):
        dj, dt_ = js.step(), ts.step()
        ref = {**{n: np.asarray(v) for n, v in dj.items() if n in COUNTS + (
            "dt", "div_iterations", "density_iterations")},
            "n": js.num_fluid_particles, "capacity": js.state.capacity}
        check_step(k, {**dt_, "n": ts.num_fluid_particles, "capacity": ts.state.capacity}, ref)
        counts.append((dt_["shares"], dt_["merge_or_split_count"]))
    # steps 1 and 3 split, 2 and 4 merge; shares every step
    assert sum(c[0] for c in counts) > 0 and counts[0][1] + counts[2][1] > 0
    a = np.asarray(js.state.alive)
    ref = {k: np.asarray(getattr(js.state, k))[a] for k in ("position", "velocity", "density",
                                                            "mass", "level")}
    match_states(ref, ts.state, mass_rtol=1e-6)


def test_default_dam_break_matches_fixture():
    ref = np.load(FIXTURE)
    sim = t_create(t_params.load_params(CONFIG), t_scene.load_scene(SCENE_YAML), device="cpu")
    assert sim.num_fluid_particles == 1035 and sim.state.capacity == 3072
    assert sim.tile_cfg.populated == tuple(range(8)) and sim.tile_cfg.tq == 128
    for k in range(len(ref["n"])):
        d = sim.step()
        check_step(k, {**d, "n": sim.num_fluid_particles, "capacity": sim.state.capacity},
                   {name: ref[name][k] for name in ref.files if ref[name].ndim == 1
                    and len(ref[name]) == len(ref["n"])})
    match_states({k: ref[k] for k in ("position", "velocity", "density", "mass", "level")},
                 sim.state, mass_rtol=1e-5)


@pytest.mark.slow
def test_fixture_matches_a_fresh_jax_run():
    import sys

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    from torch_port_dambreak_ref import reference_run

    state, per_step = reference_run()
    ref = np.load(FIXTURE)
    for k, v in per_step.items():
        if k in ("dt", "mass_conservation_error"):
            np.testing.assert_allclose(v, ref[k], rtol=1e-6, atol=1e-7, err_msg=k)
        else:
            np.testing.assert_array_equal(v, ref[k], err_msg=k)
    for k, v in state.items():
        np.testing.assert_allclose(v, ref[k], rtol=1e-6, atol=1e-7, err_msg=k)
