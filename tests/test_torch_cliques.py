"""PyTorch port, the clique / patch-major layout (ASPH_CLIQUE): the patch mode
of ops/tiles.py and the operator of ops/cliques.py against the JAX package.

Layout: build_tiles' patch mode, build_halo and window_ranges (patch rows,
cross_only) equal JAX's integers on the reference test's `_scene` clouds
(tests/test_cliques.py, seeds 0-2; the JAX side jitted, as inside its step).
The port's halo clips cell coordinates as build_tiles bins them; the
reference's clips to the padded patch grid (ADVICE.md), so one test puts a
particle past the grid's +x edge and shows the pairs JAX drops there.
Operators: clique_build and clique_visc within 1e-5 of each column's
largest magnitude; CliqueOperator's products, with the cross-level pairs
K1's list over the cross_only windows (its plain twin here), against JAX's
operator with cross_pack entries and against a brute force.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sph_torch import runner as t_runner
from adaptive_sph_torch.ops import cliques as t_cliques
from adaptive_sph_torch.ops import grid as t_grid
from adaptive_sph_torch.ops import pair_ops
from adaptive_sph_torch.ops import tiles as t_tiles
from adaptive_sph_tpu import runner as j_runner
from adaptive_sph_tpu.ops import grid as j_grid
from adaptive_sph_tpu.ops import tiles as j_tiles

torch.set_num_threads(2)

SCALE = 2.0
# the reference test's clouds: (seed, fluid particles, capacity, two levels);
# seed 2's 1,900 particles (8,192 slots there) at 4,096 slots: 37 occupied
# patches want 4,736, so 249 particles find no slot, counted alike by both
SCENES = [(0, 700, 4096, True), (1, 1000, 4096, False), (2, 1900, 4096, True)]


def scene(seed, n, C, two_levels=True):
    """tests/test_cliques.py's `_scene`: a jittered block at spacing 1.05 h,
    3% of it coarse when two_levels, the dead rows scattered in the box."""
    rng = np.random.default_rng(seed)
    hf = 0.02
    sp = 1.05 * hf
    side = int(np.ceil(np.sqrt(n)))
    gx, gy = np.meshgrid(np.arange(side), np.arange(side))
    pos = np.stack([gx.ravel(), gy.ravel()], axis=1)[:n] * sp - 0.85
    pos = pos + rng.uniform(-0.2 * sp, 0.2 * sp, size=pos.shape)
    pos = np.concatenate([pos, rng.uniform(-0.9, 0.9, size=(C - n, 2))]).astype(np.float32)
    h = np.full(C, hf, np.float32)
    if two_levels:
        big = rng.random(n) < 0.03
        h[:n] = np.where(big, 0.11, hf)
    mass = (h * h * 1000.0 / 3.61).astype(np.float32)
    alive = np.zeros(C, bool)
    alive[:n] = True
    h = np.where(alive, h, 0).astype(np.float32)
    return pos, h, mass, alive


def configs(h, alive, C, patch=4):
    """(JAX, port) TileConfig of a cloud in the (-1, 1)^2 box."""
    lo, hi = float(h[alive].min()), float(h[alive].max())
    jg = j_grid.make_grid_config((-1.0, -1.0), (1.0, 1.0), SCALE, lo, hi, C, mpc=32)
    tg = t_grid.make_grid_config((-1.0, -1.0), (1.0, 1.0), SCALE, lo, hi, C, mpc=32)
    return (j_tiles.TileConfig.from_grid(jg, SCALE, tq=128, patch=patch),
            t_tiles.TileConfig.from_grid(tg, SCALE, tq=128, patch=patch))


def layouts(pos, h, mass, alive, jcfg, tcfg):
    """Both packages' patch layouts: (jbins, tbins, jst, tst, jhalo, thalo)."""
    jb = jax.jit(lambda p, hh, a: j_tiles.build_tiles(p, hh * jnp.float32(jcfg.mscale), hh, a,
                                                      jcfg))(
        jnp.asarray(pos), jnp.asarray(h), jnp.asarray(alive))
    th = torch.from_numpy(h)
    tb = t_tiles.build_tiles(torch.from_numpy(pos), th * tcfg.mscale, th,
                             torch.from_numpy(alive), tcfg)
    jst = jax.jit(lambda: j_tiles.sort_fields(jb, [jnp.asarray(pos), jnp.asarray(h),
                                                   jnp.asarray(mass)]))()
    tst = t_tiles.sort_fields(tb, [torch.from_numpy(pos), th, torch.from_numpy(mass)])
    jhalo = jax.jit(lambda s: j_tiles.build_halo(jcfg, jb, s))(jst)
    thalo = t_tiles.build_halo(tcfg, tb, tst)
    return jb, tb, jst, tst, jhalo, thalo


def cloud(seed, n, C, two):
    pos, h, mass, alive = scene(seed, n, C, two)
    jcfg, tcfg = configs(h, alive, C)
    return (pos, h, mass, alive, jcfg, tcfg) + layouts(pos, h, mass, alive, jcfg, tcfg)


@pytest.fixture(scope="module", params=SCENES, ids=lambda s: f"seed{s[0]}")
def built(request):
    return cloud(*request.param)


def test_patch_config_equals_jax():
    pos, h, mass, alive = scene(*SCENES[0])
    jcfg, tcfg = configs(h, alive, SCENES[0][2])
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg.patch_dims(tcfg.populated[-1]) == jcfg.patch_dims(jcfg.populated[-1])
    assert tcfg.cell_offsets == jcfg.cell_offsets
    assert tcfg.patch_offsets == jcfg.patch_offsets


def test_build_tiles_patch_mode_equals_jax(built):
    _, _, _, _, _, tcfg, jb, tb, jst, tst, _, _ = built
    for name in ("perm", "pp", "cell_starts", "n_padded", "n_patches", "overflow",
                 "level_overflow", "h_max_lvl"):
        np.testing.assert_array_equal(getattr(tb, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    assert int(tb.n_padded) == min(int(tb.n_patches) * 128, tcfg.capacity)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def test_build_halo_equals_jax(built):
    *_, jhalo, thalo = built
    np.testing.assert_array_equal(thalo[0].numpy(), np.asarray(jhalo[0]))
    assert int(thalo[1]) == int(jhalo[1])


@pytest.mark.parametrize("cross_only", [False, True])
def test_window_ranges_patch_mode_equals_jax(built, cross_only):
    _, _, _, _, jcfg, tcfg, jb, tb, jst, tst, _, _ = built
    jwm, jcol = jax.jit(lambda b, s: j_tiles.window_ranges(jcfg, b, s, cross_only=cross_only))(
        jb, jst[:, 0:4])
    twm, tcol = t_tiles.window_ranges(tcfg, tb, tst[:, 0:4].contiguous(), cross_only=cross_only)
    np.testing.assert_array_equal(twm.numpy(), np.asarray(jwm))
    assert int(tcol) == int(jcol)


def col_rel(got, want):
    """max |got - want| over each column's largest |want| (a column per output)."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(g - w)) / max(float(np.max(np.abs(w))), 1e-30))


@pytest.fixture(scope="module")
def two_level():
    """Seed 0's two-level cloud, its layouts and JAX's and the port's halo."""
    return cloud(*SCENES[0])


@pytest.mark.parametrize("seed", [0, 1])
def test_clique_build_equals_jax(seed):
    from adaptive_sph_tpu.ops import cliques as j_cliques

    _, _, _, _, jcfg, tcfg, _, _, jst, tst, jhalo, thalo = cloud(*SCENES[seed])
    for jdt, tdt in ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)):
        jout = jax.jit(lambda: j_cliques.clique_build(jcfg, jhalo[0], jst, SCALE, jdt))()
        tout = t_cliques.clique_build(thalo[0], tst, SCALE, tdt)
        for k, name in enumerate(("wx", "wy", "s1x", "s1y", "s1sq", "den")):
            want = np.asarray(jout[k].astype(jnp.float32))
            assert tout[k].dtype == (tdt if k < 2 else torch.float32), name
            assert col_rel(tout[k].float().numpy(), want) < 1e-5, (name, tdt)
        # the blocks hold one pair term per entry, rounded as JAX's: bit-equal
        np.testing.assert_array_equal(tout[0].float().numpy(), np.asarray(jout[0].astype(
            jnp.float32)))


@pytest.mark.parametrize("mode", ["laplace", "wcsph"])
def test_clique_visc_equals_jax(two_level, mode):
    from adaptive_sph_tpu.ops import cliques as j_cliques

    _, _, _, _, jcfg, tcfg, _, _, jst, tst, jhalo, thalo = two_level
    C = tcfg.capacity
    rng = np.random.default_rng(1)
    vx, vy = (rng.standard_normal(C).astype(np.float32) for _ in range(2))
    rho = (1000.0 + 30 * rng.standard_normal(C)).astype(np.float32)
    jv = jax.jit(lambda: j_cliques.clique_visc(jcfg, jhalo[0], jst, jnp.asarray(vx),
                                               jnp.asarray(vy), jnp.asarray(rho), SCALE, mode,
                                               0.02))()
    tv = t_cliques.clique_visc(thalo[0], tst, torch.from_numpy(vx), torch.from_numpy(vy),
                               torch.from_numpy(rho), SCALE, mode, 0.02)
    for k in range(2):
        assert float(np.max(np.abs(np.asarray(jv[k])))) > 0
        assert col_rel(tv[k].numpy(), jv[k]) < 1e-5


def brute_products(pos, h, mass, alive, u, tx, ty):
    """float64 brute force over the original order: (sum_j w_ij u_j (x, y),
    sum_j w_ij . t_j), w_ij = m_j grad W_ij, pairs |x_ij| < SCALE h_ij."""
    p = np.where(alive[:, None], pos, 0.0).astype(np.float64)
    h = np.where(alive, h, 1.0)
    d = p[:, None, :] - p[None, :, :]
    r = np.sqrt((d ** 2).sum(-1))
    hij = 0.5 * (h[:, None] + h[None, :]).astype(np.float64)
    ok = (r < SCALE * hij) & alive[:, None] & alive[None, :] & (r > 0)
    q = r / (2 * hij)
    norm = 10.0 / (7.0 * np.pi * hij * hij)
    dw = np.where(q < 0.5, 18 * q * q - 12 * q, np.where(q < 1.0, -6 * (1 - q) ** 2, 0.0))
    g = np.where(ok, mass[None, :] * norm * dw / (2 * hij) / np.where(ok, r, 1.0), 0.0)
    wx, wy = g * d[..., 0], g * d[..., 1]
    return wx @ u, wy @ u, wx @ tx + wy @ ty


def test_clique_operator_equals_jax_and_brute_force(two_level):
    """matvec2 / matvec_div with the cross-level pairs as K1's list over the
    cross_only windows (its plain twin on the CPU) against JAX's operator
    with cross_pack entries from its block walk over the same windows, and
    against a float64 brute force; the prep sums too."""
    from adaptive_sph_tpu.ops import cliques as j_cliques
    from adaptive_sph_tpu.ops.pallas_matvec import build_weight_cache_prep

    pos, h, mass, alive, jcfg, tcfg, jb, tb, jst, tst, jhalo, thalo = two_level
    C = tcfg.capacity
    jout = jax.jit(lambda: j_cliques.clique_build(jcfg, jhalo[0], jst, SCALE, jnp.float32))()
    jwm, _ = jax.jit(lambda s: j_tiles.window_ranges(jcfg, jb, s, cross_only=True))(jst)
    vel = jnp.zeros((C, 2), jnp.float32)
    wc, meta, cnt, jprep = jax.jit(lambda: build_weight_cache_prep(
        jcfg, jb, jst, vel, SCALE, jcfg.b_max, "none", 0.0, wmeta=jwm, wdtype=jnp.float32,
        want_s2=False, fuse_density=True, scalar=False))()
    wxc, wyc, src, dst, xovf = jax.jit(lambda: j_cliques.cross_pack(wc, meta, cnt, jcfg.tq, 64))()
    assert int(cnt[1]) == 0 and int(xovf) == 0
    jop = j_cliques.CliqueOperator(wx=jout[0], wy=jout[1], halo_src=jhalo[0], wxc=wxc, wyc=wyc,
                                   src=src, dst=dst)

    tout = t_cliques.clique_build(thalo[0], tst, SCALE)
    twm, _ = t_tiles.window_ranges(tcfg, tb, tst[:, 0:4].contiguous(), cross_only=True)
    flat = torch.cat([tst[:, 0:4], torch.zeros(C, 2)], dim=1).contiguous()
    cross = pair_ops.pair_build(tb.cell_starts, twm, flat, tcfg.tq, SCALE, 0.0, False)
    assert cross.num_pairs > 0
    top = t_cliques.CliqueOperator(wx=tout[0], wy=tout[1], halo_src=thalo[0], cross=cross)

    rng = np.random.default_rng(0)
    u, tx, ty = (rng.standard_normal(C).astype(np.float32) for _ in range(3))
    jmx, jmy = jax.jit(jop.matvec2)(jnp.asarray(u))
    jdiv = jax.jit(jop.matvec_div)(jnp.asarray(tx), jnp.asarray(ty))
    tmx, tmy = top.matvec2(torch.from_numpy(u))
    tdiv = top.matvec_div(torch.from_numpy(tx), torch.from_numpy(ty))
    for got, want in ((tmx, jmx), (tmy, jmy), (tdiv, jdiv)):
        assert col_rel(got.numpy(), want) < 1e-5

    # the brute force runs over the original order: slot s holds particle perm[s]
    perm = tb.perm.numpy()
    real = perm < C
    slot_of = np.full(C, -1)
    slot_of[perm[real]] = np.flatnonzero(real)
    u_o, tx_o, ty_o = (np.where(alive, v[np.maximum(slot_of, 0)], 0.0) for v in (u, tx, ty))
    bx, by, bd = brute_products(pos, h, mass, alive, u_o, tx_o, ty_o)
    for got, want in ((tmx, bx), (tmy, by), (tdiv, bd)):
        g = got.numpy()[slot_of[alive]]
        assert col_rel(g, want[alive]) < 1e-5

    # the a_ii and density sums: clique plus the cross list's prep rows
    jp = np.asarray(jprep)
    for k, name in ((0, "s1x"), (1, "s1y"), (2, "s1sq"), (3, "den")):
        want = np.asarray(jout[2 + k]) + jp[:, k, :].reshape(C)
        got = (tout[2 + k] + cross.prep[k]).numpy()
        assert col_rel(got, want) < 1e-5, name


def test_halo_covers_pairs_past_the_grid_edge():
    """Particles past the +x and +y edges of a level whose dims are not a
    multiple of P (53 = 13 x 4 + 1 cells): build_tiles clips them into the
    level's last cell, which is the left (bottom) edge cell of the last
    patch, and so does the port's halo. The reference's halo clips to the
    padded patch grid instead (ADVICE.md, adaptive_sph_tpu/ops/tiles.py:418)
    and does not count them as edge particles. Both halos still cover every
    same-level pair of a brute force and are equal: such a particle sits at
    least one cell from the patch it is withheld from, and a same-level
    pair's radius is at most one cell (the level assignment; the grid's
    cell0 carries a margin over it), so the rectangle test leaves it out of
    that ring in both. The reference's fault costs no pair here."""
    C = 2048
    h0 = 0.02
    pos, h, mass, alive = scene(3, 300, C, two_levels=False)
    jcfg, tcfg = configs(h, alive, C)
    ny, nx = tcfg.dims(tcfg.populated[0])
    P = tcfg.patch
    assert nx % P == 1 and ny % P == 1, "the last cell must open the last patch"
    # columns hugging the +x and +y edges of the grid, and particles just past them
    cell = tcfg.cell(tcfg.populated[0])
    x_edge = tcfg.origin[0] + nx * cell
    y_edge = tcfg.origin[1] + ny * cell
    ts = -0.2 + np.arange(6) * 0.9 * h0
    inside_x = np.stack([np.full(6, x_edge - 1.2 * cell), ts], 1)
    past_x = np.stack([np.full(6, x_edge + 0.05 * cell), ts + 0.3 * h0], 1)
    inside_y = np.stack([ts, np.full(6, y_edge - 1.2 * cell)], 1)
    past_y = np.stack([ts + 0.3 * h0, np.full(6, y_edge + 0.05 * cell)], 1)
    extra = np.concatenate([inside_x, past_x, inside_y, past_y])
    k = len(extra)
    pos[300:300 + k] = extra
    h[300:300 + k] = h0
    mass[300:300 + k] = mass[0]
    alive[300:300 + k] = True
    jb, tb, jst, tst, jhalo, thalo = layouts(pos, h, mass, alive, jcfg, tcfg)
    np.testing.assert_array_equal(tb.perm.numpy(), np.asarray(jb.perm))
    assert int(tb.overflow) == 0 and int(thalo[1]) == 0
    # the trigger: past the edge, build_tiles' cell opens its patch, the
    # padded grid's does not
    fx = (pos[alive, 0] - tcfg.origin[0]) / cell
    past = np.floor(fx) >= nx
    assert past.sum() == 6
    assert ((nx - 1) % P == 0) and np.all(np.minimum(np.floor(fx[past]), nx - 1) % P == 0)
    assert np.all(np.minimum(np.floor(fx[past]), -(-nx // P) * P - 1) % P != 0)

    def missed(halo_src, bins):
        pp = bins.pp.numpy()
        halo = np.asarray(halo_src)
        own = pp // 128
        sets = {}
        for s in np.flatnonzero(halo < C):
            sets.setdefault(s // 128, set()).add(int(halo[s]))
        n = pairs = 0
        for i, j in zip(*np.nonzero(brute_pairs(pos, h, alive))):
            pairs += 1
            if own[i] != own[j] and pp[j] not in sets.get(own[i], ()):
                n += 1
        assert pairs > 0
        return n

    assert missed(thalo[0], tb) == 0
    assert missed(jhalo[0], tb) == 0
    np.testing.assert_array_equal(thalo[0].numpy(), np.asarray(jhalo[0]))


def brute_pairs(pos, h, alive):
    d = pos[:, None, :].astype(np.float64) - pos[None, :, :]
    hij = 0.5 * (h[:, None] + h[None, :])
    ok = ((d ** 2).sum(-1) < (SCALE * hij) ** 2) & alive[:, None] & alive[None, :]
    np.fill_diagonal(ok, False)
    return ok


def host_of(state):
    return {k: getattr(state, k).cpu().numpy() for k in ("mass", "position", "alive")}


def scene_host(seed, n, C, two):
    """A `_scene` cloud as a state's host arrays, the masses those whose h
    (from the mass, at the default rest density) is the cloud's."""
    from adaptive_sph_torch.ops.kernels import ETA

    pos, h, _, alive = scene(seed, n, C, two)
    rest = adaptive_params().rest_density
    mass = (rest * np.pi * (h.astype(np.float64) / ETA) ** 2).astype(np.float32)
    return {"mass": mass, "position": pos, "alive": alive}


def patch_case(monkeypatch, host, params, tparams=None, capacity=None, tq=128, mode="1"):
    """(port, JAX) _tile_patch on the same host arrays and scene box."""
    from adaptive_sph_torch import convert
    from adaptive_sph_torch.models import scene as t_scene
    from adaptive_sph_tpu.models import scene as j_scene
    from adaptive_sph_tpu.utils import params as j_params

    monkeypatch.setenv("ASPH_CLIQUE", mode)
    capacity = capacity or len(host["mass"])
    box = {"boundary": {"type": "box", "width": 2, "height": 2},
           "blocks": [{"pos": [-0.9, -0.9], "size": [0.2, 0.2], "spacing": 0.05,
                       "volume_fill_ratio": 0.93, "velocity": [0, 0]}]}
    jp = j_params.params_from_dict(convert.params_to_dict(params))
    tg = t_runner.grid_config_for(params, t_scene.scene_from_dict(box), host, capacity)
    jg = j_runner.grid_config_for(jp, j_scene.scene_from_dict(box), None, capacity, host=host)
    return (t_runner._tile_patch(host, params, tg, capacity, tq),
            j_runner._tile_patch(None, jp, jg, capacity, tq, host=host)), tg


def adaptive_params(**kw):
    from adaptive_sph_torch.utils.params import ParticleSizes, SimulationParams

    return SimulationParams(particle_sizes=ParticleSizes.Adaptive, merging=False, sharing=False,
                            splitting=False, **kw)


@pytest.mark.parametrize("case", SCENES, ids=lambda s: f"seed{s[0]}")
def test_tile_patch_equals_jax_on_clouds(monkeypatch, case):
    (got, want), _ = patch_case(monkeypatch, scene_host(*case), adaptive_params())
    assert got == want
    assert got[0] > 0


@pytest.mark.parametrize("which", ["touching", "stress"])
def test_tile_patch_equals_jax_on_scenes(monkeypatch, which):
    from adaptive_sph_torch import stress
    from adaptive_sph_torch.models import scene as t_scene

    params, scene_d = ((stress.touching_params(), stress.TOUCHING_SCENE) if which == "touching"
                       else (stress.stress_params(), stress.STRESS_SCENE))
    params = params.replace(h=0.0)
    state = t_scene.init_fluid_state(t_scene.scene_from_dict(scene_d), params, None,
                                     device="cpu")
    host = host_of(state)
    monkeypatch.setenv("ASPH_CLIQUE", "1")
    from adaptive_sph_torch import convert
    from adaptive_sph_tpu.models import scene as j_scene
    from adaptive_sph_tpu.utils import params as j_params

    jp = j_params.params_from_dict(convert.params_to_dict(params))
    C = state.capacity
    tg = t_runner.grid_config_for(params, t_scene.scene_from_dict(scene_d), host, C)
    jg = j_runner.grid_config_for(jp, j_scene.scene_from_dict(scene_d), None, C, host=host)
    got = t_runner._tile_patch(host, params, tg, C, 128)
    assert got == j_runner._tile_patch(None, jp, jg, C, 128, host=host)
    assert got == ((4, 3072) if which == "touching" else (4, 28672))


def test_tile_patch_gates_equal_jax(monkeypatch):
    """Every gate gives P = 0 in both packages: ASPH_CLIQUE unset or 0,
    Winchenbach2020, resident_solver, ASPH_RESIDENT_SOLVER=1,
    ASPH_NO_WCACHE=1, tq != 128, a capacity 128 does not divide, resampling
    without "force"; with "force" the resampling cloud takes a patch side."""
    from adaptive_sph_torch.utils.params import OperatorDiscretization

    host = scene_host(*SCENES[0])
    base = adaptive_params()
    cases = [
        ("unset", base, {}, {"mode": "0"}),
        ("w2020", base.replace(operator_discretization=OperatorDiscretization.Winchenbach2020),
         {}, {}),
        ("resident", base.replace(resident_solver=True), {}, {}),
        ("resident env", base, {"ASPH_RESIDENT_SOLVER": "1"}, {}),
        ("no wcache", base, {"ASPH_NO_WCACHE": "1"}, {}),
        ("tq 64", base, {}, {"tq": 64}),
        ("capacity", base, {}, {"capacity": 4096 + 64}),
        ("resampling", base.replace(merging=True, sharing=True, splitting=True), {}, {}),
    ]
    for name, params, env, kw in cases:
        with monkeypatch.context() as m:
            for k, v in env.items():
                m.setenv(k, v)
            (got, want), _ = patch_case(m, host, params, **kw)
            assert got == want == (0, 0), name
    (got, want), _ = patch_case(monkeypatch, host,
                                base.replace(merging=True, sharing=True, splitting=True),
                                mode="force")
    assert got == want and got[0] > 0


def test_slab_config_keeps_the_packed_layout(monkeypatch):
    """The slab-decomposed step never takes the patch layout (the reference's
    parallel/tile_sharding.py builds its TileConfig without a patch)."""
    from adaptive_sph_torch import stress
    from adaptive_sph_torch.models import scene as t_scene
    from adaptive_sph_torch.parallel import tile_sharding

    monkeypatch.setenv("ASPH_CLIQUE", "1")
    params = stress.touching_params()
    scene_o = t_scene.scene_from_dict(stress.TOUCHING_SCENE)
    state = t_scene.init_fluid_state(scene_o, params, 4096, device="cpu")
    gcfg = t_runner.grid_config_for(params, scene_o, host_of(state), state.capacity)
    scfg = tile_sharding.make_slab_config(params, gcfg, state, 2, tq=128)
    assert scfg.tcfg.patch == 0


@pytest.mark.parametrize("case", [SCENES[0], SCENES[1], "touching"],
                         ids=["seed0", "seed1", "touching"])
def test_ring_estimate_bounds_build_halo(monkeypatch, case):
    """ADVICE.md's _tile_patch finding: the host's ring estimate
    (runner.patch_occupancy, the numbers _tile_patch sizes from) bounds the
    ring particles build_halo actually lists for each occupied patch."""
    from adaptive_sph_torch import stress
    from adaptive_sph_torch.models import scene as t_scene
    from adaptive_sph_torch.models.state import h_from_mass_np

    if case == "touching":
        params = stress.touching_params()
        scene_o = t_scene.scene_from_dict(stress.TOUCHING_SCENE)
        state = t_scene.init_fluid_state(scene_o, params, 3072, device="cpu")
        host = host_of(state)
        gcfg = t_runner.grid_config_for(params, scene_o, host, state.capacity)
    else:
        params = adaptive_params()
        host = scene_host(*case)
        (got, _), gcfg = patch_case(monkeypatch, host, params)
    C = len(host["mass"])
    P = 4
    pos, h = t_runner._alive_h(host, params)
    _, rings = t_runner.patch_occupancy(pos, h, params, gcfg, P)
    tcfg = t_tiles.TileConfig.from_grid(gcfg, t_runner.max_scale(params), tq=128, patch=P)
    alive = torch.from_numpy(host["alive"])
    hh = torch.from_numpy(np.where(host["alive"], h_from_mass_np(host["mass"],
                                                                  params.rest_density, 2), 0.0)
                          .astype(np.float32))
    bins = t_tiles.build_tiles(torch.from_numpy(host["position"]), hh * tcfg.mscale, hh, alive,
                               tcfg)
    st = t_tiles.sort_fields(bins, [torch.from_numpy(host["position"]), hh,
                                    torch.from_numpy(host["mass"])])
    halo, ovf = t_tiles.build_halo(tcfg, bins, st)
    assert int(bins.overflow) == 0 and int(ovf) == 0
    halo = halo.numpy().reshape(C // 128, 128)
    # each occupied patch's (level, px, py) from its first particle
    ratio = np.maximum(st[:, 2].numpy() * tcfg.mscale / tcfg.cell0, 1.0)
    n_rings = 0
    for row in range(int(bins.n_patches)):
        s = row * 128
        lvl = int(np.clip(np.ceil(np.log2(ratio[s]) - 1e-6), 0, tcfg.levels - 1))
        lvl = min(l for l in tcfg.populated if l >= lvl)
        cell = tcfg.cell(lvl)
        x, y = st[s, 0].item(), st[s, 1].item()
        key = (lvl, int(np.floor((x - tcfg.origin[0]) / cell)) // P,
               int(np.floor((y - tcfg.origin[1]) / cell)) // P)
        actual = int(np.sum(halo[row] < C))
        n_rings += actual > 0
        assert actual <= rings.get(key, 0), (key, actual, rings.get(key, 0))
    assert n_rings > 0
