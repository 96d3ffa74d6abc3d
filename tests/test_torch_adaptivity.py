"""PyTorch port, adaptivity: classification, partner matching, transfer, split and
capacity growth against the JAX package on one state carried across by
`convert`.

The state is the default dam break's initial state (n = 1,035, capacity
3,072) with seeded mass factors and a seeded surface-distance field, so that
all five size classes, donors and receivers occur. Tolerances: classes,
partners, receiver counts, active donors, alive masks and split slots EXACTLY
equal; transferred and split fields within 1e-6 relative.
"""

import dataclasses
import filecmp
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sph_torch import convert
from adaptive_sph_torch.models import adaptivity as t_adapt
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.models.state import FIELDS, h_from_mass_np
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.utils import params as t_params
from adaptive_sph_torch.utils import split_patterns as t_split
from adaptive_sph_tpu.models import adaptivity as j_adapt
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.runner import create_simulation as j_create
from adaptive_sph_tpu.utils import params as j_params
from adaptive_sph_tpu.utils import split_patterns as j_split
from test_e2e_adaptive import tiny_patterns

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "default-config.yaml")
SCENE = os.path.join(ROOT, "configs", "default-scene.yaml")
DT = 0.006


@pytest.fixture(scope="module")
def pair():
    """(JAX sim, port sim, JAX state, port state) of the perturbed initial state."""
    js = j_create(j_params.load_params(CONFIG), j_scene.load_scene(SCENE))
    ts = t_create(t_params.load_params(CONFIG), t_scene.load_scene(SCENE), device="cpu")
    for f in ("origin", "cell0", "levels", "populated", "tq", "capacity", "mscale"):
        assert getattr(ts.tile_cfg, f) == getattr(js.tile_cfg, f), f
    arrays = {k: np.array(getattr(js.state, k)) for k in FIELDS}
    rng = np.random.default_rng(4)
    alive = arrays["alive"]
    C = alive.shape[0]
    arrays["mass"] = np.where(alive, arrays["mass"] * rng.choice(
        [0.02, 0.08, 0.4, 1.0, 3.0], C).astype(np.float32), 0).astype(np.float32)
    arrays["h"] = np.where(alive, h_from_mass_np(arrays["mass"], 1.0), 0).astype(np.float32)
    arrays["h_next"] = arrays["h"].copy()
    # surface distance: depth below the top of each column, a few without level
    y = arrays["position"][:, 1]
    arrays["level"] = np.where(alive, -(np.max(y[alive]) - y) * 0.5, 0).astype(np.float32)
    arrays["has_level"] = alive & (rng.uniform(size=C) < 0.9)
    jst = js.state.replace(**{k: jnp.asarray(v) for k, v in arrays.items()})
    tst = convert.state_from_numpy(arrays, device="cpu")
    return js, ts, jst, tst


def test_classify_matches_jax(pair):
    js, ts, jst, tst = pair
    jc = np.asarray(jax.jit(lambda s: j_adapt.classify(s, js.params))(jst))
    tc = t_adapt.classify(tst, ts.params).numpy()
    np.testing.assert_array_equal(tc, jc)
    assert len(np.unique(jc[np.asarray(jst.alive)])) == 5


@pytest.mark.parametrize("mode", ["share", "merge"])
def test_find_partners_and_transfer_match_jax(pair, mode):
    js, ts, jst, tst = pair
    jp, tp = js.params, ts.params
    dt = jnp.float32(DT)

    def jax_side(s):
        cls = j_adapt.classify(s, jp)
        part = j_adapt.find_partners_tiles(s, js.tile_cfg, cls, dt, jp, mode)
        return part, j_adapt._apply_transfer(s, part[0], part[1], dt, jp, mode)

    (jpart, jcnt, jact), jout = jax.jit(jax_side)(jst)
    tcls = t_adapt.classify(tst, tp)
    tpart, tcnt, tact = t_adapt.find_partners_tiles(tst, ts.tile_cfg, tcls, torch.tensor(DT),
                                                    tp, mode)
    np.testing.assert_array_equal(tpart.numpy(), np.asarray(jpart))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    np.testing.assert_array_equal(tact.numpy(), np.asarray(jact))
    assert int(np.sum(np.asarray(jcnt) > 0)) > 0, "no donor found a partner"
    tout = t_adapt._apply_transfer(tst, tpart, tcnt, torch.tensor(DT), tp, mode)
    np.testing.assert_array_equal(tout.alive.numpy(), np.asarray(jout.alive))
    for k in ("mass", "position", "velocity", "h_next"):
        np.testing.assert_allclose(getattr(tout, k).numpy(), np.asarray(getattr(jout, k)),
                                   rtol=1e-6, atol=1e-30, err_msg=k)


@pytest.mark.parametrize("table", ["default", "tiny"])
def test_split_matches_jax(pair, table):
    js, ts, jst, tst = pair
    jpat = j_split.load_default_patterns() if table == "default" else tiny_patterns()
    tpat = convert.split_patterns_from_numpy(jpat, device="cpu")
    max_splits = t_adapt._max_splits(tst.capacity)
    assert max_splits == j_adapt._max_splits(jst.capacity)
    jout, jd = jax.jit(lambda s: j_adapt.split(s, js.params, jpat, max_splits))(jst)
    tout, td = t_adapt.split(tst, ts.params, tpat, max_splits)
    for k in ("splits", "split_deferred", "split_missing_pattern"):
        assert int(td[k]) == int(jd[k]), k
    assert int(td["splits"]) > 0
    assert int(tout.n) == int(jout.n)
    for k in ("alive", "has_level"):
        np.testing.assert_array_equal(getattr(tout, k).numpy(), np.asarray(getattr(jout, k)), k)
    for k in ("mass", "position", "velocity", "h", "h_next", "level", "level_old", "pressure",
              "density"):
        np.testing.assert_allclose(getattr(tout, k).numpy(), np.asarray(getattr(jout, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_deferred_splits_grow_capacity():
    # the first step of the default dam break defers splits (more TooLarge
    # particles than max_splits): the capacity doubles after the step, the
    # state is carried over unchanged, and the rebuilt step runs
    sim = t_create(t_params.load_params(CONFIG), t_scene.load_scene(SCENE), device="cpu")
    assert sim.state.capacity == 3072
    seen = []
    inner = sim.step_fn

    def spy(state, step_number):
        out = inner(state, step_number)
        seen.append(out[0])
        return out

    sim.step_fn = spy
    d = sim.step()
    assert d["split_deferred"] > 0
    assert sim.state.capacity == 6144 and sim.tile_cfg.capacity == 6144
    assert sim.counters.values["capacity-growth"] == [6144.0]
    before = seen[0]
    n = before.capacity
    for k in FIELDS:
        a, b = getattr(before, k), getattr(sim.state, k)
        if a.ndim and a.shape[0] == n:
            assert torch.equal(b[:n], a), k
            assert not b[n:].any(), k
        else:
            assert torch.equal(a, b), k
    d2 = sim.step()
    assert d2["mass_conservation_error"] < 0.005 and sim.num_fluid_particles > 1035


def test_split_pattern_table_is_a_copy_of_the_reference():
    assert filecmp.cmp(t_split.DEFAULT_PATTERN_PATH, j_split.DEFAULT_PATTERN_PATH, shallow=False)
    tpos, tcnt = t_split.load_default_patterns()
    jpos, jcnt = j_split.load_default_patterns()
    np.testing.assert_array_equal(tpos, np.asarray(jpos))
    np.testing.assert_array_equal(tcnt, jcnt)


def test_sizing_function_and_level_count_match_jax():
    rng = np.random.default_rng(2)
    level = rng.uniform(-10, 0, 4096).astype(np.float32)  # surface distances are <= 0
    for sizing in ("Mass", "Radius", "Radius2"):
        jp = j_params.SimulationParams(sizing_function=j_params.SizingFunction(sizing))
        tp = convert.params_from_dict(dataclasses.asdict(jp))
        want = np.asarray(jax.jit(lambda l: j_params.optimal_mass_from_level(l, jp))(level))
        got = t_params.optimal_mass_from_level(torch.from_numpy(level), tp).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=sizing)
        assert t_params.num_levels_for(tp) == j_params.num_levels_for(jp)


def tiny_pattern_list(maxc=16):
    """tests/test_e2e_adaptive.py's tiny_patterns as the pattern list a YAML
    table holds: n children on a circle of radius 0.55, n = 2..maxc."""
    pats = []
    for n in range(2, maxc + 1):
        ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
        pos = 0.55 * np.stack([np.cos(ang), np.sin(ang)], -1)
        pats.append({"mass_s": [float(np.pi / n)] * n, "pos_s": pos.tolist(), "h_s": [1.0] * n})
    return pats


def test_split_patterns_variable_names_the_table(pair, tmp_path, monkeypatch):
    # ASPH_SPLIT_PATTERNS names the table both packages' create_simulation
    # load, and a split with it gives the children JAX's split gives
    path = tmp_path / "tiny.yaml"
    t_split.save_patterns(tiny_pattern_list(), str(path))
    monkeypatch.setenv("ASPH_SPLIT_PATTERNS", str(path))
    js_env = j_create(j_params.load_params(CONFIG), j_scene.load_scene(SCENE))
    ts_env = t_create(t_params.load_params(CONFIG), t_scene.load_scene(SCENE), device="cpu")
    jpat, (tpos, tcnt) = js_env.split_patterns, ts_env.split_patterns
    np.testing.assert_array_equal(tcnt, np.asarray(jpat[1]))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpat[0]))
    np.testing.assert_array_equal(tcnt, np.asarray(tiny_patterns()[1]))
    _, _, jst, tst = pair
    max_splits = t_adapt._max_splits(tst.capacity)
    jout, jd = jax.jit(lambda s: j_adapt.split(s, js_env.params, jpat, max_splits))(jst)
    tout, td = t_adapt.split(tst, ts_env.params, ts_env.split_patterns, max_splits)
    assert int(td["splits"]) == int(jd["splits"]) > 0
    np.testing.assert_array_equal(tout.alive.numpy(), np.asarray(jout.alive))
    for k in ("mass", "position", "h"):
        np.testing.assert_allclose(getattr(tout, k).numpy(), np.asarray(getattr(jout, k)),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


def test_split_patterns_default_without_the_variable(monkeypatch):
    monkeypatch.delenv("ASPH_SPLIT_PATTERNS", raising=False)
    pos, cnt = t_split.load_default_patterns()
    want_pos, want_cnt = t_split.to_padded_table(
        t_split.load_patterns_yaml(t_split.DEFAULT_PATTERN_PATH))
    np.testing.assert_array_equal(cnt, want_cnt)
    np.testing.assert_array_equal(pos, want_pos)
    jpos, jcnt = j_split.load_default_patterns()
    np.testing.assert_array_equal(cnt, np.asarray(jcnt))
    np.testing.assert_array_equal(pos, np.asarray(jpos))
