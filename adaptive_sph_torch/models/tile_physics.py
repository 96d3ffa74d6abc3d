"""Relaxed-Jacobi pressure loop in sorted space.

Counterpart of `tile_jacobi` in adaptive_sph_tpu/models/tile_physics.py. The
reference runs the loop on the device; here it runs eagerly, and the host
reads ONE flag per iteration (the exit test), which also gates the momentum
term of the next sweep. Iteration counts equal the reference's on the same
input.
"""

from __future__ import annotations

import torch

from ..utils.params import SimulationParams
from .solver import DENSITY_ERROR, SINGULAR_AII_EPS, SolveResult


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
