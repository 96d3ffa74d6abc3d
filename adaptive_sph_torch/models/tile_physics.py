"""Pair-sweep ops of the level estimation, and the relaxed-Jacobi pressure loop.

Counterpart of adaptive_sph_tpu/models/tile_physics.py:
- the SweepOps that level estimation, smoothing and the classic branch's
  density run through ops/sweeps.py: COUNT_OP, DENSITY_OP, `normal_op`,
  CONE_OP, WAVEFRONT_OP, SMOOTH_OP (the adaptivity ops live in
  models/adaptivity.py);
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

from ..ops import jacobi, sweeps
from ..ops.numerics import div_const, fma, rdiv
from ..ops.sweeps import NEG_BIG, SweepOp
from ..utils.params import SimulationParams
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
# around the outward normal (unx, uny), else 0 (max over pairs). The
# FromDistribution estimators' range limit is not ported (the runner rejects
# them).
CONE_THRESHOLD = float(np.float32(math.cos(50.0 * math.pi / 180.0)))


def _cone_emit(q, c, ctx):
    # direction i -> j is -diff / r
    d = (-ctx.dx * q["unx"] - ctx.dy * q["uny"]) / (ctx.r + 1e-6)
    return [(d > CONE_THRESHOLD).to(torch.float32)]


CONE_OP = SweepOp(name="cone", op_id=sweeps.OP_CONE, n_out=1, emit=_cone_emit,
                  dyn_names=("unx", "uny"), reduce="max", fill=0.0,
                  params={"cone_thr": CONE_THRESHOLD})

# level propagation: max_j (has_j ? lvl_j - r : NEG_BIG)
WAVEFRONT_OP = SweepOp(
    name="wavefront", op_id=sweeps.OP_WAVEFRONT, n_out=1, dyn_names=("lvl", "has"),
    reduce="max", fill=NEG_BIG,
    emit=lambda q, c, ctx: [torch.where(c["has"] > 0.5, c["lvl"] - ctx.r,
                                        torch.full_like(ctx.r, NEG_BIG))])


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


def tile_jacobi(accel_fn, div_fn, aii, src, alive, max_avg_error, residual_type,
                params: SimulationParams, dt, rho, p0=None) -> SolveResult:
    """Relaxed Jacobi with omega, the >=2-iteration rule, the clamp to p >= 0,
    singular-a_ii rows pinned to zero, and heavy-ball momentum gated off after
    a converged sweep.

    accel_fn(p) -> (ax, ay); div_fn(ax, ay) -> (C,); both include the boundary
    terms. p0: warm-start pressure (None = cold start at zero)."""
    singular = torch.abs(aii) < SINGULAR_AII_EPS
    aii_safe = torch.where(singular, torch.ones_like(aii), aii)
    w = float(params.jacobi_omega)
    beta = float(params.jacobi_momentum)
    zero = torch.zeros_like(aii)

    nonsing_mask = alive & (~singular)
    n_sing = torch.sum(alive & singular)
    n_nonsing = torch.sum(nonsing_mask)
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
        avg = torch.sum(torch.where(is_normal, predicted, zero)) / torch.clamp(
            n_normal, min=1).to(torch.float32)
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
        conv = bool(conv)  # the iteration's one host read
        brk = (conv and iters > 1) or iters == params.max_iters
        if residual_type == DENSITY_ERROR:
            density_error = predicted
        p_prev, p = p, p_next
        prev_conv = conv
        if brk:
            break
        iters += 1

    if residual_type == DENSITY_ERROR:
        is_normal_f = nonsing_mask & (p > 0.0)
        mx = torch.max(torch.where(is_normal_f, torch.abs(density_error), zero))
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


def _resident_table_cols(aii, alive, params: SimulationParams, rho_inv, Gx, Gy, bt_kind: str):
    """Table rows T_WAII..T_BDY and T_ALIVE of the whole-solve kernels (the
    boundary terms folded into per-particle rows and the scalar `mp`), plus
    (singular, mp)."""
    singular = torch.abs(aii) < SINGULAR_AII_EPS
    aii_safe = torch.where(singular, torch.ones_like(aii), aii)
    waii = rdiv(float(params.jacobi_omega), aii_safe)
    z, one = torch.zeros_like(aii), torch.ones_like(aii)
    nsing = torch.where(singular, z, one)
    alive_f = torch.where(alive, one, z)
    rho_b = float(params.rest_density)
    # the reference's mirrored-pressure coefficient mp is 1 / rho0^2 only under
    # ConsistentSymmetricGradient, which the port does not accept
    mp = 0.0
    if bt_kind == "none":
        gxp = gyp = bdx = bdy = z
    elif bt_kind == "sdf":
        gxp, gyp = Gx * rho_b, Gy * rho_b
        bscale = rho_b * rho_inv
        bdx, bdy = Gx * bscale, Gy * bscale
    else:
        raise NotImplementedError(f"resident solver: boundary kind {bt_kind!r} is not ported")
    rows = {jacobi.T_WAII: waii, jacobi.T_NSING: nsing, jacobi.T_RINV: rho_inv,
            jacobi.T_GXP: gxp, jacobi.T_GYP: gyp, jacobi.T_BDX: bdx, jacobi.T_BDY: bdy,
            jacobi.T_ALIVE: alive_f}
    return rows, singular, mp


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
                         params: SimulationParams, dt, rho, rho_inv, s1x, s1y, Gx, Gy,
                         bt_kind: str, p0=None, vel=None, omega_inv=None):
    """tile_jacobi semantics (without momentum) in one kernel launch.

    vel=(vx, vy): the kernel computes the source src - div(vel) * omega_inv /
    dt itself (the IISPH and OnlyDivergence source forms; `src` is then the
    velocity-independent part) and the return is (SolveResult, full_src).
    Without vel, `src` is the complete source and the return is the
    SolveResult. Its iteration count and statistics are device tensors."""
    rows, singular, mp = _resident_table_cols(aii, alive, params, rho_inv, Gx, Gy, bt_kind)
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
        src_from_div=vel is not None)
    res = _solve_result(stats, 0, m[jacobi.M_P], (m[jacobi.M_AX], m[jacobi.M_AY]),
                        m[jacobi.M_PERR], torch.sum(alive & singular))
    return (res, m[jacobi.M_SRC]) if vel is not None else res


def tile_hybrid_resident(csr, aii, alive, params: SimulationParams, dt, rho, rho_inv, s1x, s1y,
                         Gx, Gy, bt_kind: str, vx, vy, den_with_div: bool, p0_div=None,
                         p0_den=None):
    """The whole HybridDFSPH solver section in one kernel launch. Returns
    (res_div, res_den, v2x, v2y, src2): res_div carries no acceleration or
    density error, v2 are the post-divergence-solve velocities, src2 the
    density source."""
    rows, singular, mp = _resident_table_cols(aii, alive, params, rho_inv, Gx, Gy, bt_kind)
    # the density part of the density source: -(rho0 - rho) / (rho dt^2)
    src0 = -(params.rest_density - rho) / (rho * dt * dt)
    rows.update({jacobi.T_SRC: src0, jacobi.T_S1X: s1x, jacobi.T_S1Y: s1y, jacobi.T_RHO: rho,
                 jacobi.T_P0: _p_init(p0_den, alive, singular, aii),
                 jacobi.T_P0DIV: _p_init(p0_div, alive, singular, aii),
                 jacobi.T_VX0: vx, jacobi.T_VY0: vy})
    scal = torch.stack([dt.to(torch.float32),
                        torch.full_like(dt, params.hybrid_dfsph_max_avg_divergence_error),
                        torch.full_like(dt, params.hybrid_dfsph_max_avg_density_error),
                        torch.full_like(dt, params.rest_density)])
    m, stats = jacobi.hybrid_solve(csr, _table(rows, aii), scal, max_iters=int(params.max_iters),
                                   mp=mp, den_with_div=den_with_div)
    n_sing = torch.sum(alive & singular)
    z = torch.zeros_like(aii)
    res_div = _solve_result(stats, 8, m[jacobi.M_PDIV], (z, z), z, n_sing)
    res_den = _solve_result(stats, 0, m[jacobi.M_P], (m[jacobi.M_AX], m[jacobi.M_AY]),
                            m[jacobi.M_PERR], n_sing)
    return res_div, res_den, m[jacobi.M_VX], m[jacobi.M_VY], m[jacobi.M_SRC]
