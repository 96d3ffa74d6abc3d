"""PyTorch port, the particle (Akinci) boundary, against the JAX package on the CPU.

- The handler on the same positions and the same boundary arrays
  (`convert.particle_boundary_from_numpy`): the fluid-to-boundary lists
  (bidx / bmask) equal as per-row sets, the pseudo-masses within rel 1e-6,
  the density term, G and the distance to the boundary within atol 1e-6; on
  the dam break's boundary at both uniform h (up to 6 and 12 boundary
  neighbours a particle) and with a narrow list (kb 8, 4 a cell) that cuts
  crowded particles and cells, where the port must cut the same ones.
- The whole-solve kernels' table rows and the mirrored-pressure scalar of
  the particle kind (and the others) against JAX's `_resident_table_cols`.
- Three steps of `stress.akinci_dam_scene()` (the default dam break with
  its blocks swapped, n = 1,035, 264 boundary particles) through both
  packages, streamed HybridDFSPH (with check_aii) and resident IISPH, with
  the gate of tests/test_torch_sweep_modes.py's check_pair: iteration
  counts equal at every step, dt rel 1e-6, positions atol 2e-5, density
  rtol 2e-5, velocity atol 2e-4.
- tests/data/torch_port_akinci_ref.npz (scripts/torch_port_akinci_ref.py,
  which chip_smoke.py holds the GPU runs against): its runs are complete,
  and the port's ten-step dam runs on the CPU follow it.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from adaptive_sph_torch import convert
from adaptive_sph_torch.models import boundary as t_bnd
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.models import tile_physics as t_tp
from adaptive_sph_torch.ops import jacobi
from adaptive_sph_torch.runner import create_simulation as t_create
from adaptive_sph_torch.stress import akinci_dam_scene, akinci_runs
from adaptive_sph_torch.utils import params as t_params
from adaptive_sph_tpu.models import boundary as j_bnd
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.models import tile_physics as j_tp
from adaptive_sph_tpu.utils import params as j_params
from test_torch_sweep_modes import check_pair

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "torch_port_akinci_ref.npz")
AKINCI = {"particle_sizes": "Uniform", "init_boundary_handler": "Particles"}


def jax_params(**kw):
    return j_params.load_params(os.path.join(ROOT, "configs", "default-config.yaml"),
                                update_attributes={**AKINCI, **kw})


def handlers(scene: dict, kb=32, max_per_cell=16):
    """(JAX handler, port handler over the JAX handler's arrays, JAX params,
    port params) of `scene`, h from its first block."""
    jp = jax_params()
    jsc = j_scene.scene_from_dict(scene)
    jp = j_params.init_h_for_uniform(jp, jsc.blocks[0].spacing, jsc.blocks[0].volume_fill_ratio)
    jh = j_scene.make_boundary_handler(jsc, jp)
    if (kb, max_per_cell) != (32, 16):
        jh = j_bnd.build_particle_boundary(jh.static.positions, jp, kb, max_per_cell)
    th = convert.particle_boundary_from_numpy(dataclasses.asdict(jh.static))
    return jh, th, jp, convert.params_from_dict(dataclasses.asdict(jp))


def cloud(n=6000, seed=0):
    """Positions over the whole box and a margin past the boundary particles."""
    return np.random.default_rng(seed).uniform(-1.05, 1.05, (n, 2)).astype(np.float32)


def default_scene():
    import yaml

    with open(os.path.join(ROOT, "configs", "default-scene.yaml")) as f:
        return yaml.safe_load(f)


@pytest.mark.parametrize("case", ["default_scene", "blocks_swapped", "narrow_list"])
def test_handler_matches_jax(case):
    scene = default_scene() if case == "default_scene" else akinci_dam_scene()
    jh, th, jp, tp = handlers(scene, *((8, 4) if case == "narrow_list" else ()))
    # the port builds the same arrays from the same positions
    ts = t_bnd.build_particle_boundary(jh.static.positions, tp, jh.static.kb,
                                       jh.static.max_per_cell).static
    np.testing.assert_allclose(ts.psi, jh.static.psi, rtol=1e-6)
    for f in ("sorted_cell_ids", "order", "dom_min"):
        assert np.array_equal(getattr(ts, f), getattr(jh.static, f)), f
    assert (ts.width, ts.cell) == (jh.static.width, jh.static.cell)

    pos = cloud()
    h = np.full(len(pos), jp.h, np.float32)

    @jax.jit
    def jax_terms(p, hh):
        bt = jh.update_after_advect(p, hh, jp)
        return (bt.bidx, bt.bmask, j_bnd.density_boundary_term(bt, p, hh, jp),
                j_bnd.solver_terms(bt, p, hh, jp).G, j_bnd.distance_to_boundary(bt))

    jb = [np.asarray(x) for x in jax_terms(jnp.asarray(pos), jnp.asarray(h))]
    P, H = torch.as_tensor(pos), torch.as_tensor(h)
    bt = th.update_after_advect(P, H, tp)
    got = [bt.bidx.numpy(), bt.bmask.numpy(), t_bnd.density_boundary_term(bt, P, H, tp).numpy(),
           t_bnd.solver_terms(bt, P, H, tp).G.numpy(), t_bnd.distance_to_boundary(bt).numpy()]
    assert t_bnd.lambda_sum(bt) is None
    counts = jb[1].sum(1)
    assert counts.max() > 4 and (counts > 0).sum() > 500
    if case == "narrow_list":
        assert counts.max() == 8  # rows cut at kb
    for k in range(len(pos)):
        assert set(got[0][k][got[1][k]]) == set(jb[0][k][jb[1][k]]), k
    np.testing.assert_allclose(got[2], jb[2], atol=1e-6)
    np.testing.assert_allclose(got[3], jb[3], atol=1e-6 * max(1.0, np.abs(jb[3]).max()))
    fin = np.isfinite(jb[4])
    assert np.array_equal(np.isfinite(got[4]), fin)
    np.testing.assert_allclose(got[4][fin], jb[4][fin], atol=1e-6)


@pytest.mark.parametrize("kind", ["particles", "sdf", "none"])
@pytest.mark.parametrize("od", ["ConsistentSimpleGradient", "ConsistentSymmetricGradient"])
def test_resident_table_rows_match_jax(kind, od):
    rng = np.random.default_rng(5)
    n = 1024
    a = {k: rng.normal(0, 1, n).astype(np.float32) for k in ("aii", "s2x", "s2y", "Gx", "Gy")}
    a["aii"][::17] = 0.0  # singular rows
    rho = rng.uniform(0.8, 1.2, n).astype(np.float32)
    alive = rng.uniform(size=n) < 0.9
    jp = j_params.SimulationParams(operator_discretization=j_params.OperatorDiscretization(od))
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    J = {k: jnp.asarray(v) for k, v in a.items()}
    Tt = {k: torch.as_tensor(v) for k, v in a.items()}
    rho_inv = (1.0 / rho).astype(np.float32)
    z = jnp.zeros(n, jnp.float32)
    jcols, jsing, jmp, jw = j_tp._resident_table_cols(
        J["aii"], jnp.asarray(alive), jp, jnp.asarray(rho), jnp.asarray(rho_inv), z, z,
        J["s2x"], J["s2y"], J["Gx"], J["Gy"], kind)
    rows, tsing, tmp, tw = t_tp._resident_table_cols(
        Tt["aii"], torch.as_tensor(alive), tp, torch.as_tensor(rho_inv), Tt["s2x"], Tt["s2y"],
        Tt["Gx"], Tt["Gy"], kind)
    assert tmp == pytest.approx(jmp, rel=1e-7) and tw == jw
    assert np.array_equal(tsing.numpy(), np.asarray(jsing))
    for col, key in ((0, jacobi.T_WAII), (1, jacobi.T_NSING), (2, jacobi.T_RINV),
                     (3, jacobi.T_GXP), (4, jacobi.T_GYP), (7, jacobi.T_BDX), (8, jacobi.T_BDY),
                     (9, jacobi.T_ALIVE), (11, jacobi.T_S2X), (12, jacobi.T_S2Y)):
        np.testing.assert_allclose(rows[key].numpy(), np.asarray(jcols[col]), rtol=1e-6,
                                   atol=1e-7, err_msg=str(key))


DAM_CASES = {
    "hybrid_streamed_check_aii": {"check_aii": True},
    "iisph_resident": {"pressure_solver_method": "IISPH", "resident_solver": True},
}


@pytest.mark.parametrize("case", list(DAM_CASES))
def test_dam_break_steps_match_jax(case):
    js, ts, diags = check_pair(jax_params(**DAM_CASES[case]), akinci_dam_scene(), None, 3)
    assert ts.tile_cfg.capacity == 2048 and ts.num_fluid_particles == 1035
    assert ts.boundary_handler.static.positions.shape == (264, 2)
    # the fluid reaches the boundary: the left block's first column lies
    # within the support radius of the left wall
    st = ts.state
    pos_s, h_s = st.position, torch.clamp(st.h, min=1e-6)
    bt = ts.boundary_handler.update_after_advect(pos_s, h_s, ts.params)
    assert int((bt.bmask.any(1) & st.alive).sum()) > 20
    if case == "iisph_resident":
        assert all("div_iterations" not in d for _, d in diags)
        assert max(d["density_iterations"] for _, d in diags) > 2


def test_fixture_holds_every_run():
    ref = np.load(FIXTURE)
    for run, (_, scene, _, steps) in akinci_runs().items():
        for k in ("dt", "div_iterations", "density_iterations"):
            assert ref[f"{run}__{k}"].shape == (steps,), (run, k)
        n = ref[f"{run}__position"].shape[0]
        assert n == (33750 if run.startswith("scene2") else 1035), run
        for k in ("velocity", "density", "pressure"):
            assert ref[f"{run}__{k}"].shape[0] == n, (run, k)


@pytest.mark.parametrize("run", ["dam_hybrid", "dam_iisph_resident"])
def test_dam_runs_follow_the_fixture(run):
    params, scene, capacity, steps = akinci_runs()[run]
    ref = np.load(FIXTURE)
    sim = t_create(params, t_scene.scene_from_dict(scene), capacity=capacity, device="cpu",
                   counters_enabled=False)
    for k in range(steps):
        d = sim.step()
        for name in ("div_iterations", "density_iterations"):
            assert d.get(name, -1) == int(ref[f"{run}__{name}"][k]), (name, k)
        assert np.float32(d["dt"]) == ref[f"{run}__dt"][k]
    st = sim.state
    alive = st.alive.numpy()
    pos = st.position.numpy()[alive]
    want = ref[f"{run}__position"]
    _, j = cKDTree(pos).query(want, k=1)
    assert (np.sort(j) == np.arange(len(pos))).all()
    np.testing.assert_allclose(pos[j], want, atol=2e-5)
    np.testing.assert_allclose(st.density.numpy()[alive][j], ref[f"{run}__density"], rtol=2e-5)
    np.testing.assert_allclose(st.velocity.numpy()[alive][j], ref[f"{run}__velocity"],
                               atol=2e-4)


def test_adaptive_sizes_still_raise_in_create_simulation():
    p = t_params.params_from_dict({"init_boundary_handler": "Particles",
                                   "particle_sizes": "Adaptive"})
    with pytest.raises(ValueError, match="Uniform"):
        t_create(p, t_scene.scene_from_dict(akinci_dam_scene()), device="cpu")
