"""Solver constants, the result record of one pressure solve, and the list
backend's relaxed-Jacobi solve and integrators.

Counterpart of adaptive_sph_tpu/models/solver.py. The tile backend solves in
models/tile_physics.py and ops/jacobi.py; the functions here serve the list
backend (models/simulation.py `single_step_without_adaptivity`): the Jacobi
loop over the step's EdgeCache, IISPH2's Omega, and the four integrators.
The reference's on-device `while_loop` becomes a Python loop with one host
read per iteration under the same stopping rule: at least two iterations
past the first, at most `max_iters`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import kernels
from ..ops.edge_cache import reduce_edges
from ..ops.neighbors import Neighborhood
from ..ops.numerics import sqrt
from ..utils.params import HybridDfsphDensitySourceTerm, PressureSolverMethod, SimulationParams
from . import physics
from .state import SIZE_LARGE

DENSITY_ERROR = 0
DIVERGENCE_ERROR = 1

SINGULAR_AII_EPS = 1e-3  # |a_ii| below this is treated as singular


class SolveResult(NamedTuple):
    pressure: torch.Tensor
    pressure_accel: object  # (ax (C,), ay (C,)) on the tile backend, (C, 2) on lists
    density_error: torch.Tensor
    iterations: int  # the reference's returned iteration count
    avg_error: torch.Tensor  # () f32, last sweep, per-normal-particle average
    max_error: torch.Tensor  # () f32
    normal_count: torch.Tensor
    singular_count: torch.Tensor
    negative_count: torch.Tensor


def iisph_pressure_iterations(nb: Neighborhood, cache, bst, mass, density, aii,
                              ppe_source_term, alive, max_avg_error: float, residual_type: int,
                              clamp_negative_pressures: bool, params: SimulationParams, dt,
                              p0=None) -> SolveResult:
    """Jacobi sweeps until the average error meets the tolerance, with the
    at-least-two-iterations rule; p0 warm-starts the pressure (the reference
    cold-starts at zero). With jacobi_momentum > 0, heavy-ball momentum,
    gated off after a sweep that already met the tolerance."""
    C = mass.shape[0]
    zero_q = torch.zeros(2, dtype=torch.float32, device=mass.device)
    singular = torch.abs(aii) < SINGULAR_AII_EPS
    aii_safe = torch.where(singular, torch.ones_like(aii), aii)
    w = float(np.float32(params.jacobi_omega))
    beta = float(params.jacobi_momentum)
    zero = torch.zeros_like(mass)

    def one_sweep(pressure, p_prev, beta_on):
        accel = physics.pressure_accel(nb, cache, bst, pressure, mass, density, params)
        a_p = physics.divergence(nb, cache, bst, accel, zero_q, mass, density, params)
        residual = ppe_source_term - a_p
        p_next = pressure + w * residual / aii_safe
        if beta > 0.0:
            b = float(np.float32(beta)) * beta_on.to(torch.float32)
            p_next = p_next + b * (pressure - p_prev)
        p_next = torch.where(singular, zero, p_next)
        if residual_type == DENSITY_ERROR:
            predicted = density * dt * dt * residual
        else:
            predicted = dt * residual
        clamped = (p_next <= 0.0) & bool(clamp_negative_pressures)
        p_next = torch.where(clamped, zero, p_next)
        is_normal = alive & ~singular & ~clamped
        normal = torch.sum(is_normal)
        avg = torch.sum(torch.where(is_normal, predicted, zero)) / torch.clamp(
            normal, min=1).to(torch.float32)
        avg = torch.where(normal > 0, avg, torch.full_like(avg, float("nan")))
        stats = {"normal": normal, "singular": torch.sum(alive & singular),
                 "negative": torch.sum(alive & ~singular & clamped), "avg": avg,
                 "max": torch.max(torch.where(is_normal, torch.abs(predicted), zero))}
        perr = predicted if residual_type == DENSITY_ERROR else zero
        return p_next, stats, perr

    def converged(stats):
        if residual_type == DENSITY_ERROR:
            ok = torch.abs(stats["avg"] / params.rest_density) < max_avg_error
        else:
            ok = torch.abs(stats["avg"]) < max_avg_error / dt
        return (stats["normal"] == 0) | ok

    if p0 is None:
        p = torch.zeros(C, dtype=torch.float32, device=mass.device)
    else:
        p = torch.where(alive & ~singular, torch.clamp(p0, min=0.0), zero)
    p_prev = p
    prev_conv = torch.zeros((), dtype=torch.bool, device=mass.device)
    iters = 0
    while True:
        p_next, stats, perr = one_sweep(p, p_prev, ~prev_conv)
        conv = converged(stats)
        # the one host read of the iteration (none while the floor holds)
        done = iters == params.max_iters or (iters > 1 and bool(conv))
        p_prev, prev_conv, p = p, conv, p_next
        if done:
            break
        iters += 1

    final_accel = physics.pressure_accel(nb, cache, bst, p, mass, density, params)
    return SolveResult(pressure=p, pressure_accel=final_accel, density_error=perr,
                       iterations=iters, avg_error=stats["avg"], max_error=stats["max"],
                       normal_count=stats["normal"], singular_count=stats["singular"],
                       negative_count=stats["negative"])


def compute_omega_iisph2(nb: Neighborhood, cache, mass, density, h, size_class, params):
    """Omega = 1 + H_i / (3 rho_i) sum_j m_j dW/dH, clamped to [0.125, 2.5];
    Large particles take the self term at d = 0 alone."""
    srbs = kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH
    dwdh = kernels.kernel_dw_dH(cache.r, cache.h_ij * srbs, dim=2)
    sum_term = reduce_edges(nb, cache.mass_j * dwdh, mass[:, None] * dwdh)
    H_i = h * srbs
    omega_neigh = 1.0 + H_i / (3.0 * density) * sum_term
    self_term = mass * kernels.kernel_dw_dH(torch.zeros_like(h), H_i, dim=2)
    omega_large = 1.0 + H_i / (3.0 * density) * self_term
    omega = torch.where(size_class == SIZE_LARGE, omega_large, omega_neigh)
    return torch.clamp(omega, 0.125, 2.5)


def solve_and_integrate(nb, cache, bst, state, h, dt, params: SimulationParams):
    """The pressure solver's dispatch and the integration of the list
    backend. state carries this step's density and a_ii; cache has rho_j.
    Returns (dict of new fields, diagnostics)."""
    pos, vel = state.position, state.velocity
    mass, rho, alive = state.mass, state.density, state.alive
    warm = bool(params.warm_start_pressure)
    diag = {}

    def nonpressure(v):
        return v + dt * physics.non_pressure_accel(nb, cache, pos, v, rho, mass, params)

    def solve(src, tol, residual, p0):
        return iisph_pressure_iterations(nb, cache, bst, mass, rho, state.aii, src, alive, tol,
                                         residual, True, params, dt, p0=p0 if warm else None)

    def stats(res):
        return (res.normal_count, res.singular_count, res.negative_count)

    method = params.pressure_solver_method
    if method in (PressureSolverMethod.IISPH, PressureSolverMethod.IISPH2):
        iisph2 = method == PressureSolverMethod.IISPH2
        if iisph2:
            omega = compute_omega_iisph2(nb, cache, mass, rho, h, state.size_class, params)
        else:
            omega = state.omega
        vel = nonpressure(vel)
        if iisph2:
            src = physics.source_term_full_with_omega(nb, cache, bst, vel, mass, rho, omega,
                                                      params, dt)
        else:
            src = physics.source_term_full(nb, cache, bst, vel, mass, rho, params, dt)
        p0 = state.pressure * sqrt(omega) if iisph2 else state.pressure
        res = solve(src, params.iisph_max_avg_density_error, DENSITY_ERROR, p0)
        pressure, accel = res.pressure, res.pressure_accel
        if iisph2:
            pressure = pressure / sqrt(omega)
            accel = physics.pressure_accel(nb, cache, bst, pressure, mass, rho, params)
        vel = vel + dt * accel
        pos = pos + dt * vel
        diag.update(density_iterations=res.iterations, density_avg_error=res.avg_error,
                    density_max_error=res.max_error, solver_stats=stats(res))
        return dict(position=pos, velocity=vel, pressure=pressure, pressure_accel=accel,
                    ppe_source_term=src, density_error=res.density_error, omega=omega), diag

    if method == PressureSolverMethod.OnlyDivergence:
        vel = nonpressure(vel)
        src = physics.source_term_divergence(nb, cache, bst, vel, mass, rho, params, dt)
        res = solve(src, params.hybrid_dfsph_max_avg_divergence_error, DIVERGENCE_ERROR,
                    state.pressure)
        vel = vel + dt * res.pressure_accel
        pos = pos + dt * vel
        diag.update(div_iterations=res.iterations, div_avg_error=res.avg_error,
                    solver_stats=stats(res))
        return dict(position=pos, velocity=vel, pressure=res.pressure,
                    pressure_accel=res.pressure_accel, ppe_source_term=src,
                    density_error=res.density_error, omega=state.omega), diag

    if method != PressureSolverMethod.HybridDFSPH:
        raise NotImplementedError(f"pressure_solver_method={method}")
    before = params.hybrid_dfsph_non_pressure_accel_before_divergence_free
    if before:
        vel = nonpressure(vel)
    # the divergence-free solve: a velocity update only
    src = physics.source_term_divergence(nb, cache, bst, vel, mass, rho, params, dt)
    res_div = solve(src, params.hybrid_dfsph_max_avg_divergence_error, DIVERGENCE_ERROR,
                    state.pressure_div)
    vel = vel + dt * res_div.pressure_accel
    diag.update(div_iterations=res_div.iterations, div_avg_error=res_div.avg_error)
    if not before:
        vel = nonpressure(vel)

    if params.hybrid_dfsph_density_source_term == HybridDfsphDensitySourceTerm.DensityAndDivergence:
        src2 = physics.source_term_full(nb, cache, bst, vel, mass, rho, params, dt)
    else:
        src2 = physics.source_term_only_density(rho, params, dt)
    res_den = solve(src2, params.hybrid_dfsph_max_avg_density_error, DENSITY_ERROR,
                    state.pressure)
    diag.update(density_iterations=res_den.iterations, density_avg_error=res_den.avg_error,
                density_max_error=res_den.max_error)

    # the position-level correction and the blended velocity correction
    accel = res_den.pressure_accel
    pos = pos + dt * vel + dt * dt * accel
    vel = vel + dt * accel * torch.clamp(dt * params.hybrid_dfsph_factor, max=1.0)
    new = dict(position=pos, velocity=vel, pressure=res_den.pressure, pressure_accel=accel,
               ppe_source_term=src2, density_error=res_den.density_error, omega=state.omega)
    if warm:
        new["pressure_div"] = res_div.pressure
    diag["solver_stats"] = stats(res_den)
    return new, diag
