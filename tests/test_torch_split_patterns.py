"""PyTorch port, split-pattern generation, against the JAX package on the CPU.

- The hex lattice and the lattice mass (`find_optimal_mass`) equal to JAX's.
- The objective E = sum m tau^2 within rel 1e-5 and its gradient by
  torch.autograd within 1e-5 of max |grad| of `jax.grad`'s, for 2-8
  children at seeded positions.
- One optimiser attempt from the same start (JAX's own start for the seed,
  n * 1000) over 2,000 iterations: the same status, positions within 1e-4.
- JAX's own properties of generated patterns (tests/test_adaptivity.py) for
  2 and 3 children: the count, mass conservation, children inside the
  parent's support, the SVG's circles; and the CLI subcommand writing the
  YAML schema the loader reads. These two run the optimiser for 2,000
  iterations instead of 40,000 (the same code; an attempt is judged from
  1,000 on), since the full run takes ~30 s a pattern on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sph_torch import cli
from adaptive_sph_torch.utils import split_patterns as T
from adaptive_sph_tpu.ops import kernels as jk
from adaptive_sph_tpu.utils import split_patterns as J

torch.set_num_threads(2)
ITERS = 2000


@functools.lru_cache(maxsize=None)
def lattice():
    """(pos_n, mass, h, neighbors_distance) of the reference's pipeline, from
    the JAX package's functions."""
    bound = 2.0 * 2.0 * float(jk.smoothing_length_from_volume(jk.radius_to_sphere_volume(1.0, 2),
                                                              2))
    pos = J.generate_tetrahedral_point_set(1.0, bound)
    r = float(jk.sphere_volume_to_radius(J.find_optimal_mass(1.0, 1.0, pos), 2))
    pos = pos / r
    mass = float(jk.radius_to_sphere_volume(1.0, 2))
    h = float(jk.smoothing_length_from_mass(mass, 1.0, 2))
    return np.delete(pos, int(np.argmin(np.linalg.norm(pos, axis=-1))), axis=0), mass, h, 1.0 / r


def test_lattice_and_mass_equal_jax():
    bound = 2.0 * 2.0 * float(jk.smoothing_length_from_volume(jk.radius_to_sphere_volume(1.0, 2),
                                                              2))
    a = J.generate_tetrahedral_point_set(1.0, bound)
    b = T.generate_tetrahedral_point_set(1.0, bound)
    assert a.shape == b.shape == (263, 2) and np.array_equal(a, b)
    assert T.find_optimal_mass(1.0, 1.0, b) == J.find_optimal_mass(1.0, 1.0, a)


@pytest.mark.parametrize("s", range(2, 9))
def test_objective_and_gradient_match_jax(s):
    pos_n, mass, h, _ = lattice()
    ps = np.random.default_rng(100 + s).uniform(-0.6, 0.6, (s, 2)).astype(np.float32)
    child_mass = mass / s
    child_h = float(jk.smoothing_length_from_mass(child_mass, 1.0, 2))
    arrays = {"mass_s": np.full(s, child_mass, np.float32),
              "h_s": np.full(s, child_h, np.float32),
              "pos_n": pos_n.astype(np.float32),
              "mass_n": np.full(len(pos_n), mass, np.float32),
              "h_n": np.full(len(pos_n), h, np.float32)}
    r_on = np.linalg.norm(arrays["pos_n"], axis=-1)
    rho_o = float(mass * jk.kernel_w(0.0, h, 2) + jnp.sum(
        arrays["mass_n"] * jk.kernel_w(jnp.asarray(r_on), 0.5 * (arrays["h_n"] + h), 2)))
    Ja = {k: jnp.asarray(v) for k, v in arrays.items()}
    Ta = {k: torch.as_tensor(v) for k, v in arrays.items()}

    def fj(p):
        return J._objective(p, Ja["mass_s"], Ja["h_s"], Ja["pos_n"], Ja["mass_n"], Ja["h_n"],
                            jnp.zeros(2), mass, h, rho_o)[0]

    e_j = float(jax.jit(fj)(jnp.asarray(ps)))
    g_j = np.asarray(jax.jit(jax.grad(fj))(jnp.asarray(ps)))
    p_t = torch.as_tensor(ps).requires_grad_(True)
    e_t = T._objective(p_t, Ta["mass_s"], Ta["h_s"], Ta["pos_n"], Ta["mass_n"], Ta["h_n"],
                       torch.zeros(2), mass, h, rho_o)[0]
    g_t = torch.autograd.grad(e_t, p_t)[0].numpy()
    assert np.isfinite(g_t).all() and np.abs(g_j).max() > 0
    assert float(e_t.detach()) == pytest.approx(e_j, rel=1e-5)
    assert np.abs(g_t - g_j).max() <= 1e-5 * np.abs(g_j).max()


@pytest.mark.parametrize("s", [2, 3, 4])
def test_attempt_from_the_same_start_matches_jax(s):
    pos_n, mass, h, nd = lattice()
    seed = s * 1000
    # the JAX package's start for the seed (its `run`)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    angle = jax.random.uniform(k1, (s,), minval=0.0, maxval=2.0 * np.pi)
    dist = jnp.sqrt(jax.random.uniform(k2, (s,))) * 0.6
    ps0 = np.array(jnp.stack([jnp.cos(angle), jnp.sin(angle)], -1) * dist[:, None])
    pj, status_j = J.make_pattern_optimizer(s, pos_n, mass, h, 1.0, nd, max_iters=ITERS)(seed)
    run = T.make_pattern_optimizer(s, pos_n, mass, h, 1.0, nd, max_iters=ITERS, device="cpu")
    pt, status_t = run.attempt(torch.as_tensor(ps0))
    assert T.STATUS_NAMES[status_t] == status_j == "valid"
    np.testing.assert_allclose(pt.numpy(), pj, atol=1e-4)
    # run(seed) starts from the port's own generator
    p2, status2 = run(seed)
    assert p2.shape == (s, 2) and status2 in T.STATUS_NAMES.values()


@pytest.fixture
def short_optimiser(monkeypatch):
    monkeypatch.setattr(T, "make_pattern_optimizer",
                        functools.partial(T.make_pattern_optimizer, max_iters=ITERS))


def test_generated_patterns_have_the_references_properties(short_optimiser, tmp_path):
    parent = float(jk.radius_to_sphere_volume(1.0, 2))
    h = float(jk.smoothing_length_from_mass(parent, 1.0, 2))
    for n in (2, 3):
        p, attempts = T.precalculate_split_pattern(n, device="cpu")
        assert attempts >= 1
        assert len(p["pos_s"]) == n and len(p["mass_s"]) == n and len(p["h_s"]) == n
        assert abs(sum(p["mass_s"]) - parent) < 1e-6 * parent
        r = np.linalg.norm(np.asarray(p["pos_s"], np.float64), axis=1)
        assert float(r.max()) < 2.0 * h
    path = tmp_path / "split-3.svg"
    T.export_pattern_svg(p, str(path))
    text = path.read_text()
    assert text.startswith("<svg") and text.count("<circle") == 3 + 2


def test_cli_writes_the_schema_the_loader_reads(short_optimiser, tmp_path, capsys):
    out = tmp_path / "patterns.yaml"
    svg = tmp_path / "svg"
    assert cli.main(["generate-split-patterns", str(out), "--max-children", "2",
                     "--svg-dir", str(svg), "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "pattern 2:" in text and "s per attempt" in text
    patterns = T.load_patterns_yaml(str(out))
    assert len(patterns) == 1 and set(patterns[0]) == {"mass_s", "pos_s", "h_s"}
    assert J.load_patterns_yaml(str(out)) == patterns
    pos, counts = T.to_padded_table(patterns)
    assert pos.shape == (1, 2, 2) and counts.tolist() == [2]
    assert (svg / "split-2.svg").read_text().count("<circle") == 2 + 2
