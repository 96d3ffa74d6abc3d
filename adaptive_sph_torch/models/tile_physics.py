"""Pair-sweep ops of the level estimation, and the relaxed-Jacobi pressure loop.

Counterpart of adaptive_sph_tpu/models/tile_physics.py:
- the SweepOps that level estimation and smoothing run through
  ops/sweeps.py: COUNT_OP, `normal_op`, CONE_OP, WAVEFRONT_OP, SMOOTH_OP
  (the adaptivity ops live in models/adaptivity.py);
- `tile_jacobi`. The reference runs the loop on the device; here it runs
  eagerly, and the host reads ONE flag per iteration (the exit test), which
  also gates the momentum term of the next sweep. Iteration counts equal the
  reference's on the same input.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import sweeps
from ..ops.numerics import div_const, fma
from ..ops.sweeps import NEG_BIG, SweepOp
from ..utils.params import SimulationParams
from .solver import DENSITY_ERROR, SINGULAR_AII_EPS, SolveResult

COUNT_OP = SweepOp(name="count", op_id=sweeps.OP_COUNT, n_out=1,
                   emit=lambda q, c, ctx: [torch.ones_like(ctx.r2)])


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
