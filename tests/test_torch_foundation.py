"""PyTorch port, foundation modules: kernels, parameters, SDFs, the lambda
polynomial, boundary terms, the 1-D solver helpers, scene init and counters.

Each check feeds the same numpy inputs (seeded) to the JAX function and to the
port's counterpart. Tolerances: rtol 1e-6 where both evaluate the same float32
operations (only library rounding of sqrt/log may differ by an ulp), and the
reference's own golden bounds for the analytic checks.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from adaptive_sph_torch import convert
from adaptive_sph_torch.models import boundary as t_bnd
from adaptive_sph_torch.models import grid_physics as t_gp
from adaptive_sph_torch.models import scene as t_scene
from adaptive_sph_torch.ops import boundary_lambda as t_bl
from adaptive_sph_torch.ops import kernels as tk
from adaptive_sph_torch.ops import sdf as t_sdf
from adaptive_sph_torch.utils import params as t_params
from adaptive_sph_torch.utils import stats as t_stats
from adaptive_sph_tpu.models import boundary as j_bnd
from adaptive_sph_tpu.models import grid_physics as j_gp
from adaptive_sph_tpu.models import scene as j_scene
from adaptive_sph_tpu.ops import boundary_lambda as j_bl
from adaptive_sph_tpu.ops import kernels as jk
from adaptive_sph_tpu.ops import sdf as j_sdf
from adaptive_sph_tpu.utils import params as j_params
from adaptive_sph_tpu.utils import stats as j_stats

torch.set_num_threads(2)

RTOL = 1e-6


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, want, rtol=RTOL, atol=1e-7):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# kernels: the reference's golden checks, then JAX vs port on random inputs


def test_cubic_kernel_2d_integration():
    h = 5.0
    support_radius = 2.0 * h
    grid_size = 200
    square_len = 2.0 * support_radius / grid_size
    xs = (np.arange(grid_size) + 0.5) * square_len - support_radius
    gx, gy = np.meshgrid(xs, xs)
    r = np.sqrt(gx**2 + gy**2).astype(np.float32)
    integral = float(torch.sum(tk.kernel_w(T(r), h, dim=2).double()) * square_len**2)
    assert 1.0 / 1.00001 <= integral <= 1.00001


def test_cubic_kernel_3d_integration():
    h = 2.0
    support_radius = 2.0 * h
    grid_size = 96
    cell = 2.0 * support_radius / grid_size
    xs = (np.arange(grid_size) + 0.5) * cell - support_radius
    gx, gy, gz = np.meshgrid(xs, xs, xs)
    r = np.sqrt(gx**2 + gy**2 + gz**2).astype(np.float32)
    integral = float(torch.sum(tk.kernel_w(T(r), h, dim=3).double()) * cell**3)
    assert abs(integral - 1.0) < 1e-3


def test_cubic_kernel_2d_derivative_vs_finite_differences():
    h = 5.0
    support_radius = 2.0 * h
    n = 100
    diff = support_radius * 1e-2
    half = diff * 0.5
    probe_offset = 2.0 * support_radius / n
    xs = (np.arange(n + 1) + 0.5) * probe_offset - support_radius
    gx, gy = np.meshgrid(xs, xs)
    pts = np.stack([gx.ravel(), gy.ravel()], axis=-1).astype(np.float32)
    analytical = tk.kernel_grad(T(pts), h, dim=2).numpy()

    def w(p):
        p = T(np.asarray(p, np.float32))
        return tk.kernel_w(torch.linalg.norm(p, dim=-1), h, dim=2).numpy()

    approx_x = (w(pts + [half, 0.0]) - w(pts + [-half, 0.0])) / diff
    approx_y = (w(pts + [0.0, half]) - w(pts + [0.0, -half])) / diff
    assert np.max(np.abs(analytical - np.stack([approx_x, approx_y], axis=-1))) < 0.001


def test_radius_volume_roundtrip_and_neighbor_number():
    for dim in (2, 3):
        for x in (0.1, 0.5, 1.0, 100.0):
            x2 = float(tk.radius_to_sphere_volume(tk.sphere_volume_to_radius(x, dim), dim))
            assert abs(x - x2) < 1e-4 * max(1.0, x)
    assert abs(tk.optimal_neighbor_number(2) - (1.9 * 2.0) ** 2) < 1e-6


@pytest.mark.parametrize("name", ["w", "grad", "dw_dH", "h_from_mass", "cubic", "cubic_deriv"])
def test_kernels_match_jax(name):
    rng = np.random.default_rng(3)
    n = 4096
    h = rng.uniform(0.005, 0.5, n).astype(np.float32)
    r = (rng.uniform(0.0, 1.1, n) * 2.0 * h).astype(np.float32)
    diff = rng.normal(0, 1, (n, 2)).astype(np.float32) * h[:, None]
    q = rng.uniform(0.0, 1.2, n).astype(np.float32)
    m = rng.uniform(1e-5, 0.2, n).astype(np.float32)
    if name == "w":
        got, want = tk.kernel_w(T(r), T(h)), jk.kernel_w(jnp.asarray(r), jnp.asarray(h))
    elif name == "grad":
        got, want = tk.kernel_grad(T(diff), T(h)), jk.kernel_grad(jnp.asarray(diff), jnp.asarray(h))
    elif name == "dw_dH":
        got = tk.kernel_dw_dH(T(r), T(2 * h))
        want = jk.kernel_dw_dH(jnp.asarray(r), jnp.asarray(2 * h))
    elif name == "h_from_mass":
        got = tk.smoothing_length_from_mass(T(m), 1.0)
        want = jk.smoothing_length_from_mass(jnp.asarray(m), 1.0)
    elif name == "cubic":
        got, want = tk.cubic_kernel_unnormalized(T(q)), jk.cubic_kernel_unnormalized(jnp.asarray(q))
    else:
        got = tk.cubic_kernel_unnormalized_deriv(T(q))
        want = jk.cubic_kernel_unnormalized_deriv(jnp.asarray(q))
    scale = float(np.max(np.abs(np.asarray(want)))) + 1e-30
    close(got, want, rtol=RTOL, atol=RTOL * scale)


# ---------------------------------------------------------------------------
# parameters


def _default_value(cls, f):
    if f.default is not dataclasses.MISSING:
        v = f.default
    else:
        v = f.default_factory()
    return v.value if hasattr(v, "value") else v


def test_params_fields_and_defaults_equal_jax():
    jf = dataclasses.fields(j_params.SimulationParams)
    tf = dataclasses.fields(t_params.SimulationParams)
    assert [f.name for f in jf] == [f.name for f in tf]
    for a, b in zip(jf, tf):
        assert _default_value(j_params.SimulationParams, a) == \
            _default_value(t_params.SimulationParams, b), a.name
    for name, enum_cls in j_params._ENUM_FIELDS.items():
        tenum = t_params._ENUM_FIELDS[name]
        assert [e.value for e in enum_cls] == [e.value for e in tenum], name


@pytest.mark.parametrize("upd", [
    {"max_iters": 77, "viscosity": 0.01, "pressure_solver_method": "HybridDFSPH"},
    {"particle_sizes": "Uniform", "fill_stash_with": "SurfaceDistanceMiddle",
     "pull_fluid_to": [0.5, 0.25], "weight_cache_bf16": True, "jacobi_momentum": 0.9}])
def test_load_params_matches_jax(upd):
    path = "configs/default-config.yaml"
    jp = j_params.load_params(path, update_attributes=upd)
    tp = t_params.load_params(path, update_attributes=upd)
    assert convert.params_to_dict(tp) == convert.params_to_dict(convert.params_from_dict(
        dataclasses.asdict(jp)))
    assert convert.params_to_dict(tp) == {
        k: (v.value if hasattr(v, "value") else v) for k, v in dataclasses.asdict(jp).items()}
    # the inverse feeds the JAX parser
    assert j_params.params_from_dict(convert.params_to_dict(tp)) == jp
    with pytest.raises(KeyError):
        t_params.load_params(path, update_attributes={"no_such_field": 1})


def test_init_h_for_uniform_matches_jax():
    for spacing, fill in ((0.06, 0.93), (0.008, 0.93), (0.1, 1.0)):
        jp = j_params.init_h_for_uniform(
            j_params.SimulationParams(particle_sizes=j_params.ParticleSizes.Uniform), spacing, fill)
        tp = t_params.init_h_for_uniform(
            t_params.SimulationParams(particle_sizes=t_params.ParticleSizes.Uniform), spacing, fill)
        assert tp.h == jp.h
    assert t_params.init_h_for_uniform(t_params.SimulationParams(), 0.06, 0.93).h == 0.0


# ---------------------------------------------------------------------------
# SDFs and the lambda polynomial


def _box():
    return (-1.0, -1.0), (1.0, 1.0)


def test_plane_and_polygon_probes_match_jax():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-1.3, 1.3, size=(512, 2)).astype(np.float32)
    planes_j, planes_t = j_sdf.boundary_box_planes(*_box()), t_sdf.boundary_box_planes(*_box())
    poly_j, poly_t = j_sdf.boundary_box_polygon(*_box()), t_sdf.boundary_box_polygon(*_box())
    close(t_sdf.probe_all(planes_t, T(pts)), j_sdf.probe_all(planes_j, jnp.asarray(pts)))
    close(t_sdf.gradient_all(planes_t, T(pts), 1e-5),
          j_sdf.gradient_all(planes_j, jnp.asarray(pts), 1e-5))
    close(poly_t.probe(T(pts)), poly_j.probe(jnp.asarray(pts)), atol=1e-6)
    close(poly_t.gradient(T(pts), 1e-4), poly_j.gradient(jnp.asarray(pts), 1e-4), atol=2e-3)
    # the reference's own checks
    d = t_sdf.probe_all(planes_t, T(np.array([[0.0, 0.0], [0.9, 0.0], [-1.5, 0.0]], np.float32)))
    np.testing.assert_allclose(d[0].numpy(), [1.0] * 4, atol=1e-6)
    assert abs(float(d[1].min()) - 0.1) < 1e-6 and float(d[2, 0]) < 0.0
    c = float(poly_t.probe(T(np.array([[1.3, 1.4]], np.float32)))[0])
    assert abs(c - (-np.hypot(0.3, 0.4))) < 1e-5


def test_polygon_geometry_is_built_once_per_device():
    # a boundary update probes the polygon five times (the distance and the
    # gradient's four differences): its device geometry is built once, and
    # the probes still equal JAX's
    poly_j = j_sdf.SdfPolygon2D(points=((-0.7, -0.6), (0.8, -0.7), (0.6, 0.7), (-0.7, 0.5)))
    poly_t = t_sdf.SdfPolygon2D(points=((-0.7, -0.6), (0.8, -0.7), (0.6, 0.7), (-0.7, 0.5)))
    pts = np.random.default_rng(3).uniform(-1.0, 1.0, size=(256, 2)).astype(np.float32)
    t_sdf._polygon_geometry.cache_clear()
    d = poly_t.probe(T(pts))
    g = poly_t.gradient(T(pts), 1e-4)
    info = t_sdf._polygon_geometry.cache_info()
    assert (info.misses, info.hits) == (1, 4)
    close(d, poly_j.probe(jnp.asarray(pts)), atol=1e-6)
    close(g, poly_j.gradient(jnp.asarray(pts), 1e-4), atol=2e-3)


def test_lambda_tables_and_poly_match_jax():
    lam_t, dlam_t = t_bl._lut_tables_np()
    lam_j, dlam_j = j_bl._lut_tables_np()
    np.testing.assert_array_equal(lam_t, lam_j)
    np.testing.assert_array_equal(dlam_t, dlam_j)
    x = np.random.default_rng(2).uniform(-1.2, 1.2, 20000).astype(np.float32)
    gl, gd = t_bl.lambda_dlambda_poly(T(x))
    wl, wd = j_bl.lambda_dlambda_poly(jnp.asarray(x))
    close(gl, wl, atol=1e-7)
    close(gd, wd, atol=1e-6)
    # poly vs the reference's 10k-entry LUT, its documented contract
    lam_tab, dlam_tab = t_bl.lut_tables()
    close(t_bl.lut_lookup(lam_tab, T(x)), j_bl.lut_lookup(jnp.asarray(lam_j), jnp.asarray(x)),
          atol=1e-6)
    assert float((gl - t_bl.lut_lookup(lam_tab, T(x))).abs().max()) < 1e-5


# ---------------------------------------------------------------------------
# boundary terms


@pytest.mark.parametrize("sizes,handler", [
    ("Adaptive", "AnalyticOverestimate"), ("Uniform", "AnalyticOverestimate"),
    ("Adaptive", "AnalyticUnderestimate"), ("Adaptive", "NoBoundary")])
def test_boundary_terms_match_jax(sizes, handler):
    rng = np.random.default_rng(5)
    n = 1024
    pos = rng.uniform(-1.02, 1.02, (n, 2)).astype(np.float32)
    h = rng.uniform(0.005, 0.2, n).astype(np.float32)
    jp = j_params.SimulationParams(particle_sizes=j_params.ParticleSizes(sizes),
                                   init_boundary_handler=j_params.InitBoundaryHandlerType(handler),
                                   h=0.05 if sizes == "Uniform" else 0.0)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    sc = {"boundary": {"type": "box", "width": 2, "height": 2},
          "blocks": [{"pos": [0, 0], "size": [0.1, 0.1], "spacing": 0.05,
                      "volume_fill_ratio": 1.0, "velocity": [0, 0]}]}
    jh = j_scene.make_boundary_handler(j_scene.scene_from_dict(sc), jp)
    th = t_scene.make_boundary_handler(t_scene.scene_from_dict(sc), tp)
    jbt = jh.update_after_advect(jnp.asarray(pos), jnp.asarray(h), jp)
    tbt = th.update_after_advect(T(pos), T(h), tp)
    assert jbt.kind == tbt.kind
    close(t_bnd.density_boundary_term(tbt, T(pos), T(h), tp),
          j_bnd.density_boundary_term(jbt, jnp.asarray(pos), jnp.asarray(h), jp), atol=1e-6)
    jst = j_bnd.solver_terms(jbt, jnp.asarray(pos), jnp.asarray(h), jp)
    tst = t_bnd.solver_terms(tbt, T(pos), T(h), tp)
    g = np.asarray(jst.G)
    close(tst.G, g, rtol=1e-5, atol=1e-5 * (np.abs(g).max() + 1e-30))
    if tbt.kind == "sdf":
        close(tbt.lam, jbt.lam, atol=1e-6)
        np.testing.assert_array_equal(tbt.lam_mask.numpy(), np.asarray(jbt.lam_mask))
        close(t_bnd.distance_to_boundary(tbt), j_bnd.distance_to_boundary(jbt), atol=1e-6)
        close(t_bnd.lambda_sum(tbt), j_bnd.lambda_sum(jbt), atol=1e-6)
    else:
        assert t_bnd.distance_to_boundary(tbt) is None and t_bnd.lambda_sum(tbt) is None


def test_particle_boundary_handler_raises():
    # the particle boundary with adaptive sizes raises in both packages (the
    # reference leaves it unimplemented); with uniform sizes both build the
    # same boundary: positions, pseudo-masses and static cell grid
    d = {"boundary": {"type": "box", "width": 2, "height": 2},
         "blocks": [{"pos": [0, 0], "size": [0.1, 0.1], "spacing": 0.05,
                     "volume_fill_ratio": 1.0, "velocity": [0, 0]}]}
    jp = j_params.SimulationParams(
        init_boundary_handler=j_params.InitBoundaryHandlerType.Particles)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    with pytest.raises(AssertionError):
        j_scene.make_boundary_handler(j_scene.scene_from_dict(d), jp)
    with pytest.raises(ValueError, match="Uniform"):
        t_scene.make_boundary_handler(t_scene.scene_from_dict(d), tp)
    jp = j_params.init_h_for_uniform(jp.replace(particle_sizes=j_params.ParticleSizes.Uniform),
                                     0.05, 1.0)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    js = j_scene.make_boundary_handler(j_scene.scene_from_dict(d), jp).static
    ts = t_scene.make_boundary_handler(t_scene.scene_from_dict(d), tp).static
    assert ts.positions.shape == (160, 2)
    for f in dataclasses.fields(js):
        want, got = getattr(js, f.name), getattr(ts, f.name)
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and np.array_equal(got, want), f.name
        else:
            assert got == want, f.name


# ---------------------------------------------------------------------------
# the three 1-D helpers


@pytest.mark.parametrize("kind", ["sdf", "none", "particles"])
@pytest.mark.parametrize("od", ["ConsistentSimpleGradient", "ConsistentSymmetricGradient",
                                "Winchenbach2020"])
def test_1d_helpers_match_jax(kind, od):
    rng = np.random.default_rng(11)
    n = 2048
    a = {k: rng.normal(0, 1, n).astype(np.float32) for k in
         ("s1x", "s1y", "s2x", "s2y", "Gx", "Gy", "p", "qx", "qy")}
    a["s1sq"] = rng.uniform(0, 5, n).astype(np.float32)
    a["s2sq"] = rng.uniform(0, 5, n).astype(np.float32)
    rho = rng.uniform(0.8, 1.2, n).astype(np.float32)
    mass = rng.uniform(1e-4, 0.1, n).astype(np.float32)
    jp = j_params.SimulationParams(operator_discretization=j_params.OperatorDiscretization(od))
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    J = {k: jnp.asarray(v) for k, v in a.items()}
    Tt = {k: T(v) for k, v in a.items()}
    want = j_gp.assemble_aii_1d(J["s1x"], J["s1y"], J["s1sq"], J["s2x"], J["s2y"], J["s2sq"],
                                {"rho": jnp.asarray(rho), "mass": jnp.asarray(mass)},
                                J["Gx"], J["Gy"], kind, jp)
    got = t_gp.assemble_aii_1d(Tt["s1x"], Tt["s1y"], Tt["s1sq"], Tt["s2x"], Tt["s2y"], Tt["s2sq"],
                               {"rho": T(rho), "mass": T(mass)}, Tt["Gx"], Tt["Gy"], kind, tp)
    close(got, want, rtol=1e-6, atol=1e-6)
    wx, wy = j_gp.boundary_accel_slots_1d(J["Gx"], J["Gy"], J["p"], jnp.asarray(rho), kind, jp)
    gx, gy = t_gp.boundary_accel_slots_1d(Tt["Gx"], Tt["Gy"], Tt["p"], T(rho), kind, tp)
    wd = j_gp.boundary_div_slots_1d(J["Gx"], J["Gy"], J["qx"], J["qy"], jnp.asarray(rho), kind, jp)
    gd = t_gp.boundary_div_slots_1d(Tt["Gx"], Tt["Gy"], Tt["qx"], Tt["qy"], T(rho), kind, tp)
    if kind == "none":
        assert (gx, gy, gd) == (0.0, 0.0, 0.0) and (wx, wy, wd) == (0.0, 0.0, 0.0)
    else:
        close(gx, wx)
        close(gy, wy)
        close(gd, wd)


# ---------------------------------------------------------------------------
# scene init and counters


STRESS = {"boundary": {"type": "box", "width": 2, "height": 2}, "blocks": [
    {"pos": [0.4, -0.5], "size": [0.55, 1.4], "spacing": 0.4, "volume_fill_ratio": 0.93,
     "velocity": [0, 0]},
    {"pos": [-0.95, -0.5], "size": [0.55, 1.4], "spacing": 0.008, "volume_fill_ratio": 0.93,
     "velocity": [0, 0]}]}


@pytest.mark.parametrize("scene", ["stress", "stress-yaml", "dam-uniform"])
def test_scene_init_matches_jax(scene):
    if scene == "stress":
        jsc, tsc = j_scene.scene_from_dict(STRESS), t_scene.scene_from_dict(STRESS)
        jp = j_params.SimulationParams(merging=False, sharing=False, splitting=False)
    elif scene == "stress-yaml":
        path = "configs/media/ratio-stress-test-scene.yaml"
        jsc, tsc = j_scene.load_scene(path), t_scene.load_scene(path)
        jp = j_params.SimulationParams(merging=False, sharing=False, splitting=False)
    else:
        d = {"boundary": {"type": "box", "width": 2, "height": 2},
             "blocks": [{"pos": [0.4, -0.5], "size": [0.55, 1.4], "spacing": 0.06,
                         "volume_fill_ratio": 0.93, "velocity": [0.1, 0]}]}
        jsc, tsc = j_scene.scene_from_dict(d), t_scene.scene_from_dict(d)
        jp = j_params.SimulationParams(particle_sizes=j_params.ParticleSizes.Uniform)
    tp = convert.params_from_dict(dataclasses.asdict(jp))
    assert dataclasses.asdict(jsc) == dataclasses.asdict(tsc)
    js = j_scene.init_fluid_state(jsc, jp)
    ts = t_scene.init_fluid_state(tsc, tp, device="cpu")
    if scene == "stress":
        assert int(ts.n) == 11835 and ts.capacity == 14336
    assert ts.capacity == js.capacity
    got = convert.state_to_numpy(ts)
    for k, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(getattr(js, k)), err_msg=k)
    back = convert.state_from_numpy(got, device="cpu")
    for k in got:
        assert torch.equal(getattr(back, k), getattr(ts, k)), k


def test_counters_write_statistics_match_jax():
    jc, tc = j_stats.Counters(), t_stats.Counters()
    for c in (jc, tc):
        c.add_time("simulation-step", 0.5)
        c.add_time("simulation-step", 0.25)
        for v in (2, 3, 4):
            c.add_value("div-iterations", v)
            c.add_value("particle-count", 100.0)
    assert t_stats.write_statistics(tc) == j_stats.write_statistics(jc)
    off = t_stats.Counters(enabled=False)
    off.add_value("x", 1.0)
    assert not off.values
