"""The fixed episodes: an episode run twice from the restored initial state
repeats its diagnostics and its end state (CPU); the seed moves the initial
state and nothing else."""

import numpy as np
import pytest

import tiny
from benchlib import harness, inputs
from benchlib.spec import Spec


@pytest.fixture(scope="module")
def spec(tmp_path_factory):
    return Spec(tiny.make_root(tmp_path_factory.mktemp("root"), episode_steps=3))


@pytest.mark.parametrize("cell", ["tiny-stress", "tiny-adaptive"])
def test_an_episode_repeats_from_the_restored_state(spec, cell):
    c = harness.setup(spec, cell, seed=2**31 + 7, device="cpu")
    warm = c.eps.warm_up()
    assert warm == (2 if cell == "tiny-adaptive" else 1)  # the adaptive one grows once
    runs = []
    for _ in range(2):
        c.eps.restore()
        diags = []
        for _ in range(c.eps.E):
            _, sn, d, failed = c.eps.step()
            assert not failed
            diags.append((sn, {k: v for k, v in d.items() if isinstance(v, (int, float))}))
        st = c.sim.state
        runs.append((diags, st.position.numpy().copy(), st.alive.numpy().copy(),
                     c.sim.step_number))
    # repr: NaN averages (every pressure clamped) compare equal as text
    assert repr(runs[0][0]) == repr(runs[1][0])
    assert np.array_equal(runs[0][1], runs[1][1]) and np.array_equal(runs[0][2], runs[1][2])
    assert runs[0][3] == runs[1][3] == c.eps.E
    # the episode after the last restarts by itself
    c.eps.step()
    assert c.eps.ep_step == 1 and c.sim.step_number == 1


def test_the_seed_moves_only_the_initial_positions(spec):
    a = harness.setup(spec, "tiny-stress", seed=1, device="cpu")
    b = harness.setup(spec, "tiny-stress", seed=2**33 + 1, device="cpu")
    a2 = harness.setup(spec, "tiny-stress", seed=1, device="cpu")
    assert np.array_equal(a.init.position.numpy(), a2.init.position.numpy())
    assert not np.array_equal(a.init.position.numpy(), b.init.position.numpy())
    for f in ("mass", "velocity", "alive"):
        assert np.array_equal(getattr(a.init, f).numpy(), getattr(b.init, f).numpy())
    # the jitter stays within its stated share of each particle's radius
    alive = a.init.alive.numpy()
    m = a.init.mass.numpy()[alive]
    d = np.abs(a.init.position.numpy() - b.init.position.numpy())[alive]
    r = np.sqrt(m / np.pi)
    assert (d <= 2 * 0.02 * r[:, None] * (1 + 1e-5) + 1e-7).all()


def test_replicas_tile_the_scene():
    cfg = spec_cfg = Spec(tiny.ROOT).config("ratio-stress-test")
    sd = inputs.scene_dict(cfg, {"replicas": 4})
    assert sd["boundary"]["width"] == 8 and len(sd["blocks"]) == 8
    xs = sorted(b["pos"][0] for b in sd["blocks"])
    assert xs[0] == pytest.approx(-0.95 - 3.0) and xs[-1] == pytest.approx(0.4 + 3.0)
    assert inputs.scene_dict(spec_cfg, {"replicas": 1}) == cfg["scene"]
