"""Pair-sweep ops of the level estimation, and the relaxed-Jacobi pressure loop.

Counterpart of adaptive_sph_tpu/models/tile_physics.py:
- the SweepOps that level estimation, smoothing, the classic branch's
  density, the viscosity after the divergence solve, IISPH2's Omega, the
  h estimators from the particle distribution, the diagnostic fields,
  CenterDiff, the neighbourhood constraint and check_aii run through
  ops/sweeps.py: COUNT_OP, DENSITY_OP, `normal_op`, CONE_OP / `cone_op`,
  WAVEFRONT_OP / `wavefront_op` (range-limited under FromDistribution and
  FromDistribution2), SMOOTH_OP, `visc_op`, OMEGA_OP, H_W_SUM_OP,
  `h_vw_sum_op`, CONSTANT_FIELD_OP, `centerdiff_op`, FRINGE_COUNT_OP,
  `check_aii_op`, and the sweep-only step's `prep_op`, AII_SUMS_OP,
  ACCEL_OP and `div_op` (the adaptivity ops live in models/adaptivity.py);
- `tile_jacobi`. The reference runs the loop on the device; here it runs
  eagerly, and the host reads ONE flag per iteration (the exit test), which
  also gates the momentum term of the next sweep. Iteration counts equal the
  reference's on the same input.
- `tile_jacobi_resident` and `tile_hybrid_resident`: the same solves as one
  kernel launch each (ops/jacobi.py), with no host read; their iteration
  counts and statistics stay on the device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import spans
from ..ops import jacobi, kernels, sweeps
from ..ops.pair_ops import SPEED_OF_SOUND, wcsph_coef
from ..ops.numerics import div_const, fma, rdiv
from ..ops.sweeps import NEG_BIG, SweepOp
from ..utils.params import (OperatorDiscretization, SimulationParams, SupportLengthEstimation,
                            ViscosityType)
from .solver import DENSITY_ERROR, SINGULAR_AII_EPS, SolveResult

COUNT_OP = SweepOp(name="count", op_id=sweeps.OP_COUNT, n_out=1,
                   emit=lambda q, c, ctx: [torch.ones_like(ctx.r2)])

# the fluid density sum m_j W_ij (the classic branch's density)
DENSITY_OP = SweepOp(name="density", op_id=sweeps.OP_DENSITY, n_out=1,
                     emit=lambda q, c, ctx: [c["mass"] * ctx.w])


def normal_op(params: SimulationParams):
    """EmptyAngle SPH normal: -(m_i / rho0) grad W."""
    rest = float(params.rest_density)

    def emit(q, c, ctx):
        coef = -div_const(q["mass"], rest)
        return [coef * ctx.gx, coef * ctx.gy]

    return SweepOp(name="normal", op_id=sweeps.OP_NORMAL, n_out=2, emit=emit,
                   params={"inv_rest": float(np.float32(1.0) / np.float32(rest))})


# EmptyAngle 50-degree cone scan: 1 if some neighbour lies inside the cone
# around the outward normal (unx, uny), else 0 (max over pairs). Under the
# FromDistribution estimators `cone_op` adds the level-estimation range.
CONE_THRESHOLD = float(np.float32(math.cos(50.0 * math.pi / 180.0)))
# f32(1 / f32(pi)): the folded divisor of sphere_volume_to_radius
INV_PI = float(np.float32(1.0) / np.float32(math.pi))


def _cone_emit(q, c, ctx):
    # direction i -> j is -diff / r
    d = (-ctx.dx * q["unx"] - ctx.dy * q["uny"]) / (ctx.r + 1e-6)
    return [(d > CONE_THRESHOLD).to(torch.float32)]


CONE_OP = SweepOp(name="cone", op_id=sweeps.OP_CONE, n_out=1, emit=_cone_emit,
                  dyn_names=("unx", "uny"), reduce="max", fill=0.0,
                  params={"cone_thr": CONE_THRESHOLD})


def _wavefront_emit(q, c, ctx):
    return [torch.where(c["has"] > 0.5, c["lvl"] - ctx.r, torch.full_like(ctx.r, NEG_BIG))]


# level propagation: max_j (has_j ? lvl_j - r : NEG_BIG)
WAVEFRONT_OP = SweepOp(name="wavefront", op_id=sweeps.OP_WAVEFRONT, n_out=1,
                       dyn_names=("lvl", "has"), reduce="max", fill=NEG_BIG,
                       emit=_wavefront_emit)


def _range_limited(params: SimulationParams) -> bool:
    """Whether level estimation limits its pairs to the query's range
    (the FromDistribution and FromDistribution2 estimators)."""
    return params.support_length_estimation in (SupportLengthEstimation.FromDistribution,
                                                 SupportLengthEstimation.FromDistribution2)


def _range_params(params: SimulationParams) -> dict:
    return {"inv_rest": float(np.float32(1.0) / np.float32(params.rest_density)),
            "max_range": float(np.float32(params.maximum_range)), "inv_pi": INV_PI}


def _range_ok(q, ctx, params: SimulationParams):
    """The pair lies in the query's level-estimation range: r <= R(m_i / rho0)
    * maximum_range, R the radius of the circle of that area."""
    radius = kernels.sphere_volume_to_radius(div_const(q["mass"], float(params.rest_density)), 2)
    return ctx.r <= radius * float(np.float32(params.maximum_range))


def cone_op(params: SimulationParams) -> SweepOp:
    """The cone scan; under FromDistribution / FromDistribution2 only the
    pairs in the query's range count (the `cone_range` functor)."""
    if not _range_limited(params):
        return CONE_OP

    def emit(q, c, ctx):
        (hit,) = _cone_emit(q, c, ctx)
        return [torch.where(_range_ok(q, ctx, params), hit, torch.zeros_like(hit))]

    return SweepOp(name="cone_range", op_id=sweeps.OP_CONE_RANGE, n_out=1, emit=emit,
                   dyn_names=("unx", "uny"), reduce="max", fill=0.0,
                   params={"cone_thr": CONE_THRESHOLD, **_range_params(params)})


def wavefront_op(params: SimulationParams) -> SweepOp:
    """The wavefront; under FromDistribution / FromDistribution2 only the
    pairs in the query's range count (the `wavefront_range` functor)."""
    if not _range_limited(params):
        return WAVEFRONT_OP

    def emit(q, c, ctx):
        (v,) = _wavefront_emit(q, c, ctx)
        return [torch.where(_range_ok(q, ctx, params), v, torch.full_like(v, NEG_BIG))]

    return SweepOp(name="wavefront_range", op_id=sweeps.OP_WAVEFRONT_RANGE, n_out=1,
                   dyn_names=("lvl", "has"), reduce="max", fill=NEG_BIG, emit=emit,
                   params=_range_params(params))


# sum_j W_ij: the FromDistribution, Clamped1 and Clamped2 estimators' sum
H_W_SUM_OP = SweepOp(name="h_w_sum", op_id=sweeps.OP_H_W_SUM, n_out=1,
                     emit=lambda q, c, ctx: [ctx.w])


def h_vw_sum_op(params: SimulationParams) -> SweepOp:
    """sum_j (m_j / rho0) W_ij: the FromDistribution2 estimator's sum."""
    rest = float(params.rest_density)
    return SweepOp(name="h_vw_sum", op_id=sweeps.OP_H_VW_SUM, n_out=1,
                   emit=lambda q, c, ctx: [div_const(c["mass"], rest) * ctx.w],
                   params={"inv_rest": float(np.float32(1.0) / np.float32(rest))})


# the constant-field diagnostic sum_j m_j / rho_j W_ij over dyn (rho)
CONSTANT_FIELD_OP = SweepOp(
    name="constant_field", op_id=sweeps.OP_CONSTANT_FIELD, n_out=1, dyn_names=("rho",),
    emit=lambda q, c, ctx: [c["mass"] / torch.clamp(c["rho"], min=1e-30) * ctx.w])


def centerdiff_op(params: SimulationParams) -> SweepOp:
    """CenterDiff surface detection's sums [sum V_j W, sum V_j W x_j,
    sum V_j W y_j, sum V_j W r_j], V_j = m_j / rho0, r_j = R(V_j)."""
    rest = float(params.rest_density)

    def emit(q, c, ctx):
        vol = div_const(c["mass"], rest)
        r_j = kernels.sphere_volume_to_radius(vol, 2)
        wv = ctx.w * vol
        return [wv, wv * c["x"], wv * c["y"], wv * r_j]

    return SweepOp(name="centerdiff", op_id=sweeps.OP_CENTERDIFF, n_out=4, emit=emit,
                   params={"inv_rest": float(np.float32(1.0) / np.float32(rest)),
                           "inv_pi": INV_PI})


def _fringe_emit(q, c, ctx):
    f = 2.0 * ctx.r - c["h"] * kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH
    return [(f > q["t"]).to(torch.float32)]


# #{j : 2 r_ij - 2 h_j > t_i}: the counting primitive of the neighbourhood
# constraint, whose bisection on t finds the k-th largest fringe
FRINGE_COUNT_OP = SweepOp(name="fringe_count", op_id=sweeps.OP_FRINGE_COUNT, n_out=1,
                          dyn_names=("t",), emit=_fringe_emit)


def check_aii_op(w2020: bool) -> SweepOp:
    """check_aii's brute-force fluid divergence of the unit self pressure,
    over dyn (rho, ax, ay): sum_j w_j ((m_i / rho_i^2) grad W - a_i) . grad W,
    w_j = m_j / rho_j under Winchenbach2020, else m_j."""

    def emit(q, c, ctx):
        coef = q["mass"] / torch.clamp(q["rho"] * q["rho"], min=1e-30)
        gx, gy = ctx.gx, ctx.gy
        d = (coef * gx - q["ax"]) * gx + (coef * gy - q["ay"]) * gy
        m = c["mass"] / torch.clamp(c["rho"], min=1e-30) if w2020 else c["mass"]
        return [m * d]

    return SweepOp(name="check_aii_w2020" if w2020 else "check_aii",
                   op_id=sweeps.OP_CHECK_AII_W2020 if w2020 else sweeps.OP_CHECK_AII, n_out=1,
                   dyn_names=("rho", "ax", "ay"), emit=emit)


def _smooth_emit(q, c, ctx):
    dxn = q["xnew"] - c["xnew"]
    dyn = q["ynew"] - c["ynew"]
    wctx = sweeps.PairCtx(dxn, dyn, fma(dxn, dxn, dyn * dyn), ctx.h_ij)
    vw = c["mass"] / torch.clamp(c["rho"], min=1e-30) * wctx.w
    return [vw * c["dist"], vw]


# Volume-weighted level smoothing over the step's pair set: the pair mask uses
# the statics (binning) positions, W is evaluated at the advected xnew/ynew
SMOOTH_OP = SweepOp(name="smooth", op_id=sweeps.OP_SMOOTH, n_out=2, emit=_smooth_emit,
                    dyn_names=("rho", "dist", "xnew", "ynew"))


def visc_op(params: SimulationParams):
    """The pair viscosity acceleration over dyn (rho, vx, vy), attracting
    pairs only: WCSPH (-m_j pi_ab grad W, pi_ab = -2 nu h_ij c dot / (rho_i +
    rho_j) / (r^2 + 0.001 h_ij^2), c = SPEED_OF_SOUND) or ApproxLaplace (nu m_j
    2 (D + 2) dot / (r^2 + 0.01 h_ij^2) / rho_ij grad W, rho_ij the mean
    density); any other viscosity type is taken as ApproxLaplace, as the
    reference's pair term takes it."""
    nu = float(params.viscosity)
    if params.viscosity_type == ViscosityType.WCSPH:
        two_nu = wcsph_coef(nu, classic=True)

        def emit(q, c, ctx):
            dot = ctx.dx * (q["velx"] - c["velx"]) + ctx.dy * (q["vely"] - c["vely"])
            vt = two_nu * ctx.h_ij * SPEED_OF_SOUND / torch.clamp(q["rho"] + c["rho"], min=1e-30)
            pi_ab = -vt * dot / (ctx.r2 + 0.001 * ctx.h_ij * ctx.h_ij)
            coef = torch.where(dot < 0.0, -c["mass"] * pi_ab, torch.zeros_like(dot))
            return [coef * ctx.gx, coef * ctx.gy]

        return SweepOp(name="visc_wcsph", op_id=sweeps.OP_VISC_WCSPH, n_out=2, emit=emit,
                       dyn_names=("rho", "velx", "vely"), params={"visc": two_nu})

    def emit(q, c, ctx):
        dot = ctx.dx * (q["velx"] - c["velx"]) + ctx.dy * (q["vely"] - c["vely"])
        rho_ij = torch.clamp((q["rho"] + c["rho"]) * 0.5, min=1e-30)
        coef = nu * c["mass"] * (8.0 * dot / (ctx.r2 + 0.01 * ctx.h_ij * ctx.h_ij) / rho_ij)
        coef = torch.where(dot < 0.0, coef, torch.zeros_like(dot))
        return [coef * ctx.gx, coef * ctx.gy]

    return SweepOp(name="visc_laplace", op_id=sweeps.OP_VISC_LAPLACE, n_out=2, emit=emit,
                   dyn_names=("rho", "velx", "vely"), params={"visc": nu})


# the IISPH2 Omega neighbour sum m_j dW/dH at H = 2 h_ij
OMEGA_OP = SweepOp(
    name="omega", op_id=sweeps.OP_OMEGA, n_out=1,
    emit=lambda q, c, ctx: [c["mass"] * kernels.kernel_dw_dH(
        ctx.r, ctx.h_ij * kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH, 2)])


# The sweep-only step's ops. Their pair terms round as the reference's
# compiled sweep does (probed with isolated pairs, one pair per row): the
# gradient factor with one division (PairCtx.gmag1), and |grad W|^2, the dot
# products and r^2 + c h^2 as fused multiply-adds.

def _grad_w(ctx):
    gm = ctx.gmag1
    return gm * ctx.dx, gm * ctx.dy


def _aii_terms(c, gx, gy):
    """The a_ii fluid sums' pair terms [m_j grad W, m_j |grad W|^2, (m_j /
    rho_j) grad W, (m_j / rho_j) |grad W|^2]."""
    g2 = fma(gx, gx, gy * gy)
    m = c["mass"]
    mbr = m / torch.clamp(c["rho"], min=1e-30)
    return [m * gx, m * gy, m * g2, mbr * gx, mbr * gy, mbr * g2]


def _prep_visc_coef(params: SimulationParams):
    """The first kick's viscosity coefficient of grad W per pair over dyn
    (rho, vx, vy), attracting pairs only: `visc_op`'s terms with
    dot = fma(dx, dvx, dy dvy), r^2 + c h^2 = fma(c h, h, r^2) and
    ApproxLaplace's two divisions as one."""
    nu = float(params.viscosity)
    wcsph = params.viscosity_type == ViscosityType.WCSPH
    two_nu = wcsph_coef(nu, classic=True)

    def coef_of(q, c, ctx):
        dot = fma(ctx.dx, q["velx"] - c["velx"], ctx.dy * (q["vely"] - c["vely"]))
        if wcsph:
            vt = two_nu * ctx.h_ij * SPEED_OF_SOUND / torch.clamp(q["rho"] + c["rho"], min=1e-30)
            coef = -c["mass"] * (-vt * dot / fma(0.001 * ctx.h_ij, ctx.h_ij, ctx.r2))
        else:
            rho_ij = torch.clamp((q["rho"] + c["rho"]) * 0.5, min=1e-30)
            coef = nu * c["mass"] * (8.0 * dot / (fma(0.01 * ctx.h_ij, ctx.h_ij, ctx.r2)
                                                  * rho_ij))
        return torch.where(dot < 0.0, coef, torch.zeros_like(dot))

    return coef_of, {"visc": two_nu if wcsph else nu}


def prep_op(params: SimulationParams) -> SweepOp:
    """The sweep-only step's once-per-step sweep over dyn (rho, vx, vy): the
    six a_ii sums (columns 0-5) and the first kick's viscosity (columns 6-7,
    ApproxLaplace or WCSPH; zeros under XSPH)."""
    dyn = ("rho", "velx", "vely")
    if params.viscosity_type == ViscosityType.XSPH:
        def emit(q, c, ctx):
            z = torch.zeros_like(ctx.r2)
            return _aii_terms(c, *_grad_w(ctx)) + [z, z]

        return SweepOp(name="prep_xsph", op_id=sweeps.OP_PREP_XSPH, n_out=8, emit=emit,
                       dyn_names=dyn)
    coef_of, prm = _prep_visc_coef(params)

    def emit(q, c, ctx):
        gx, gy = _grad_w(ctx)
        coef = coef_of(q, c, ctx)
        return _aii_terms(c, gx, gy) + [coef * gx, coef * gy]

    wcsph = params.viscosity_type == ViscosityType.WCSPH
    return SweepOp(name="prep_wcsph" if wcsph else "prep_laplace",
                   op_id=sweeps.OP_PREP_WCSPH if wcsph else sweeps.OP_PREP_LAPLACE, n_out=8,
                   emit=emit, dyn_names=dyn, params=prm)


# the six a_ii sums alone, over dyn (rho,): the sweep-only step's prep when
# the first non-pressure kick comes after the divergence solve
AII_SUMS_OP = SweepOp(name="aii_sums", op_id=sweeps.OP_AII_SUMS, n_out=6, dyn_names=("rho",),
                      emit=lambda q, c, ctx: _aii_terms(c, *_grad_w(ctx)))


def _accel_emit(q, c, ctx):
    term = (q["p"] / torch.clamp(q["rho"] * q["rho"], min=1e-30)
            + c["p"] / torch.clamp(c["rho"] * c["rho"], min=1e-30))
    coef = -c["mass"] * term
    gx, gy = _grad_w(ctx)
    return [coef * gx, coef * gy]


# the pressure acceleration's fluid sum over dyn (rho, p):
# -sum_j m_j (p_i / rho_i^2 + p_j / rho_j^2) grad W
ACCEL_OP = SweepOp(name="accel", op_id=sweeps.OP_ACCEL, n_out=2, dyn_names=("rho", "p"),
                   emit=_accel_emit)


def div_op(w2020: bool) -> SweepOp:
    """The divergence's fluid sum over dyn (rho, qx, qy): sum_j w_j (q_j -
    q_i) . grad W, w_j = m_j / rho_j under Winchenbach2020, else m_j (the
    caller divides by rho_i then)."""

    def emit(q, c, ctx):
        gx, gy = _grad_w(ctx)
        dq_dot = fma(c["qx"] - q["qx"], gx, (c["qy"] - q["qy"]) * gy)
        m = c["mass"] / torch.clamp(c["rho"], min=1e-30) if w2020 else c["mass"]
        return [m * dq_dot]

    return SweepOp(name="div_w2020" if w2020 else "div",
                   op_id=sweeps.OP_DIV_W2020 if w2020 else sweeps.OP_DIV, n_out=1, emit=emit,
                   dyn_names=("rho", "qx", "qy"))


def tile_jacobi(accel_fn, div_fn, aii, src, alive, max_avg_error, residual_type,
                params: SimulationParams, dt, rho, p0=None, psum=None,
                pmax=None) -> SolveResult:
    """Relaxed Jacobi with omega, the >=2-iteration rule, the clamp to p >= 0,
    singular-a_ii rows pinned to zero, and heavy-ball momentum gated off after
    a converged sweep.

    accel_fn(p) -> (ax, ay); div_fn(ax, ay) -> (C,); both include the boundary
    terms. p0: warm-start pressure (None = cold start at zero).
    psum / pmax: the slab decomposition's reductions (`alive` is then the
    owned rows): the statistics, and so the exit test the host reads, are
    global, and every rank runs the same iterations."""
    singular = torch.abs(aii) < SINGULAR_AII_EPS
    aii_safe = torch.where(singular, torch.ones_like(aii), aii)
    w = float(params.jacobi_omega)
    beta = float(params.jacobi_momentum)
    zero = torch.zeros_like(aii)

    nonsing_mask = alive & (~singular)
    n_sing = torch.sum(alive & singular)
    n_nonsing = torch.sum(nonsing_mask)
    if psum is not None:
        n_sing, n_nonsing = psum(torch.stack([n_sing, n_nonsing])).unbind()
    if residual_type == DENSITY_ERROR:
        tol = None
    else:
        # max_avg_error / dt with one rounding (the reference divides a
        # constant by the traced dt)
        tol = torch.full_like(dt, max_avg_error) / dt

    def one_sweep(p, p_prev, beta_on):
        a_p = div_fn(*accel_fn(p))
        res = src - a_p
        p_next = p + w * res / aii_safe
        if beta > 0.0:
            # projected heavy-ball: momentum before the projection; off on a
            # sweep whose predecessor already met the tolerance
            b = beta if beta_on else 0.0
            p_next = p_next + b * (p - p_prev)
        p_next = torch.where(singular, zero, p_next)
        if residual_type == DENSITY_ERROR:
            predicted = rho * dt * dt * res
        else:
            predicted = dt * res
        clamped = p_next <= 0.0
        p_next = torch.where(clamped, zero, p_next)
        is_normal = nonsing_mask & (~clamped)
        n_normal = torch.sum(is_normal)
        pred_sum = torch.sum(torch.where(is_normal, predicted, zero))
        if psum is not None:  # one reduction: the count is exact in float32
            pred_sum, n32 = psum(torch.stack([pred_sum, n_normal.to(torch.float32)])).unbind()
            n_normal = n32.to(n_normal.dtype)
        avg = pred_sum / torch.clamp(n_normal, min=1).to(torch.float32)
        avg = torch.where(n_normal > 0, avg, torch.full_like(avg, float("nan")))
        if residual_type == DENSITY_ERROR:
            ok = torch.abs(avg / params.rest_density) < max_avg_error
        else:
            ok = torch.abs(avg) < tol
        conv = (n_normal == 0) | ok
        return p_next, predicted, n_normal, avg, conv

    if p0 is None:
        p = torch.zeros_like(aii)
    else:
        p = torch.where(nonsing_mask, torch.clamp(p0, min=0.0), zero)
    p_prev = p
    prev_conv = False
    iters = 0
    density_error = torch.zeros_like(aii)
    while True:
        p_next, predicted, n_normal, avg, conv = one_sweep(p, p_prev, not prev_conv)
        spans.reads["solve-exit"] += 1
        conv = bool(conv)  # the iteration's one host read
        brk = (conv and iters > 1) or iters == params.max_iters
        if residual_type == DENSITY_ERROR:
            density_error = predicted
        p_prev, p = p, p_next
        prev_conv = conv
        if brk:
            break
        iters += 1
    spans.set_sweeps(iters)

    if residual_type == DENSITY_ERROR:
        is_normal_f = nonsing_mask & (p > 0.0)
        mx = torch.max(torch.where(is_normal_f, torch.abs(density_error), zero))
        if pmax is not None:
            mx = pmax(mx)
    else:
        mx = torch.zeros((), dtype=torch.float32, device=aii.device)
    final_accel = accel_fn(p)
    return SolveResult(
        pressure=p,
        pressure_accel=final_accel,
        density_error=density_error,
        iterations=iters,
        avg_error=avg,
        max_error=mx,
        normal_count=n_normal,
        singular_count=n_sing,
        negative_count=n_nonsing - n_normal,
    )


def _resident_table_cols(aii, alive, params: SimulationParams, rho_inv, s2x, s2y, Gx, Gy,
                         bt_kind: str):
    """Table rows T_WAII..T_BDY, T_ALIVE and T_S2X / T_S2Y of the whole-solve
    kernels (the boundary terms folded into per-particle rows and the scalar
    `mp`), plus (singular, mp, w2020)."""
    singular = torch.abs(aii) < SINGULAR_AII_EPS
    aii_safe = torch.where(singular, torch.ones_like(aii), aii)
    waii = rdiv(float(params.jacobi_omega), aii_safe)
    z, one = torch.zeros_like(aii), torch.ones_like(aii)
    nsing = torch.where(singular, z, one)
    alive_f = torch.where(alive, one, z)
    rho_b = float(params.rest_density)
    od = params.operator_discretization
    w2020 = od == OperatorDiscretization.Winchenbach2020
    if bt_kind == "none":
        gxp = gyp = bdx = bdy = z
        mp = 0.0
    elif bt_kind == "sdf":
        # the mirrored boundary pressure: 1 / rho0^2 under ConsistentSymmetricGradient
        mirror = 1.0 if od == OperatorDiscretization.ConsistentSymmetricGradient else 0.0
        mp = mirror / (rho_b * rho_b)
        gxp, gyp = Gx * rho_b, Gy * rho_b
        # the boundary divergence drops its rho0 / rho_i factor under Winchenbach2020
        bscale = one if w2020 else rho_b * rho_inv
        bdx, bdy = Gx * bscale, Gy * bscale
    else:  # particles: G is sum_b Psi_b grad W_ib, mirrored unless ConsistentSimpleGradient
        mirror = 0.0 if od == OperatorDiscretization.ConsistentSimpleGradient else 1.0
        mp = mirror / (rho_b * rho_b)
        gxp, gyp = Gx, Gy
        bdx, bdy = Gx * rho_inv, Gy * rho_inv
    rows = {jacobi.T_WAII: waii, jacobi.T_NSING: nsing, jacobi.T_RINV: rho_inv,
            jacobi.T_GXP: gxp, jacobi.T_GYP: gyp, jacobi.T_BDX: bdx, jacobi.T_BDY: bdy,
            jacobi.T_ALIVE: alive_f, jacobi.T_S2X: s2x, jacobi.T_S2Y: s2y}
    return rows, singular, mp, w2020


def _p_init(p0, alive, singular, like):
    if p0 is None:
        return torch.zeros_like(like)
    return torch.where(alive & (~singular), torch.clamp(p0, min=0.0), torch.zeros_like(like))


def _table(rows: dict, like):
    z = torch.zeros_like(like)
    return torch.stack([rows.get(k, z) for k in range(jacobi.T_ROWS)])


def _solve_result(stats, off, pressure, accel, perr, n_sing):
    return SolveResult(
        pressure=pressure, pressure_accel=accel, density_error=perr,
        iterations=stats[off + jacobi.S_ITERS].to(torch.int32),
        avg_error=stats[off + jacobi.S_AVG],
        max_error=stats[off + jacobi.S_MAX],
        normal_count=stats[off + jacobi.S_NORMAL].to(torch.int32),
        singular_count=n_sing,
        negative_count=stats[off + jacobi.S_NEG].to(torch.int32))


def tile_jacobi_resident(csr, aii, src, alive, max_avg_error, residual_type,
                         params: SimulationParams, dt, rho, rho_inv, s1x, s1y, s2x, s2y, Gx, Gy,
                         bt_kind: str, p0=None, vel=None, omega_inv=None):
    """tile_jacobi semantics (without momentum) in one kernel launch.

    vel=(vx, vy): the kernel computes the source src - div(vel) * omega_inv /
    dt itself (the IISPH and OnlyDivergence source forms; `src` is then the
    velocity-independent part) and the return is (SolveResult, full_src).
    Without vel, `src` is the complete source and the return is the
    SolveResult. Its iteration count and statistics are device tensors. s2x,
    s2y: the rho_j-weighted gradient sums, which the Winchenbach2020
    divergence subtracts."""
    rows, singular, mp, w2020 = _resident_table_cols(aii, alive, params, rho_inv, s2x, s2y, Gx,
                                                     Gy, bt_kind)
    rows.update({jacobi.T_SRC: src, jacobi.T_S1X: s1x, jacobi.T_S1Y: s1y, jacobi.T_RHO: rho,
                 jacobi.T_P0: _p_init(p0, alive, singular, aii)})
    if vel is not None:
        rows.update({jacobi.T_VX0: vel[0], jacobi.T_VY0: vel[1],
                     jacobi.T_OMGI: torch.ones_like(aii) if omega_inv is None else omega_inv})
    scal = torch.stack([dt.to(torch.float32), torch.full_like(dt, max_avg_error),
                        torch.full_like(dt, params.rest_density), torch.zeros_like(dt)])
    m, stats = jacobi.jacobi_solve(
        csr, _table(rows, aii), scal, density_type=residual_type == DENSITY_ERROR,
        max_iters=int(params.max_iters), mp=mp, write_perr=residual_type == DENSITY_ERROR,
        src_from_div=vel is not None, w2020=w2020)
    res = _solve_result(stats, 0, m[jacobi.M_P], (m[jacobi.M_AX], m[jacobi.M_AY]),
                        m[jacobi.M_PERR], torch.sum(alive & singular))
    return (res, m[jacobi.M_SRC]) if vel is not None else res


def tile_hybrid_resident(csr, aii, alive, params: SimulationParams, dt, rho, rho_inv, s1x, s1y,
                         s2x, s2y, Gx, Gy, bt_kind: str, vx, vy, den_with_div: bool, p0_div=None,
                         p0_den=None):
    """The whole HybridDFSPH solver section in one kernel launch. Returns
    (res_div, res_den, v2x, v2y, src2): res_div carries no acceleration or
    density error, v2 are the post-divergence-solve velocities, src2 the
    density source."""
    rows, singular, mp, w2020 = _resident_table_cols(aii, alive, params, rho_inv, s2x, s2y, Gx,
                                                     Gy, bt_kind)
    # the density part of the density source: -(rho0 - rho) / (rho~ dt^2),
    # rho~ = rho0 under Winchenbach2020, else rho
    next_rho = torch.full_like(rho, params.rest_density) if w2020 else rho
    src0 = -(params.rest_density - rho) / (next_rho * dt * dt)
    rows.update({jacobi.T_SRC: src0, jacobi.T_S1X: s1x, jacobi.T_S1Y: s1y, jacobi.T_RHO: rho,
                 jacobi.T_P0: _p_init(p0_den, alive, singular, aii),
                 jacobi.T_P0DIV: _p_init(p0_div, alive, singular, aii),
                 jacobi.T_VX0: vx, jacobi.T_VY0: vy})
    scal = torch.stack([dt.to(torch.float32),
                        torch.full_like(dt, params.hybrid_dfsph_max_avg_divergence_error),
                        torch.full_like(dt, params.hybrid_dfsph_max_avg_density_error),
                        torch.full_like(dt, params.rest_density)])
    m, stats = jacobi.hybrid_solve(csr, _table(rows, aii), scal, max_iters=int(params.max_iters),
                                   mp=mp, den_with_div=den_with_div, w2020=w2020)
    n_sing = torch.sum(alive & singular)
    z = torch.zeros_like(aii)
    res_div = _solve_result(stats, 8, m[jacobi.M_PDIV], (z, z), z, n_sing)
    res_den = _solve_result(stats, 0, m[jacobi.M_P], (m[jacobi.M_AX], m[jacobi.M_AY]),
                            m[jacobi.M_PERR], n_sing)
    return res_div, res_den, m[jacobi.M_VX], m[jacobi.M_VY], m[jacobi.M_SRC]
