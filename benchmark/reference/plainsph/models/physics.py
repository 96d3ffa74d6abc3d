"""SPH physics sweeps of the list backend: density, viscosity, operators,
a_ii and the PPE source terms.

Counterpart of adaptive_sph_tpu/models/physics.py. Every sweep runs over
the step's EdgeCache (ops/edge_cache.py): kernel values, gradients, distances
and gathered masses and densities come from it, so a Jacobi sweep is one
gather of the changing field, elementwise arithmetic and the pair reduction.
The boundary enters through the per-particle vector G of
`boundary.solver_terms`. The operator discretization and the boundary
model are chosen in Python per call.
"""

from __future__ import annotations

import torch

from ..ops import kernels
from ..ops.edge_cache import EdgeCache, reduce_edges
from ..ops.neighbors import Neighborhood
from ..ops.numerics import sqrt
from ..utils.params import OperatorDiscretization, ParticleSizes, SimulationParams, ViscosityType
from . import boundary as bnd

SPEED_OF_SOUND = 88.0  # the WCSPH viscosity's c


def effective_h(h, params: SimulationParams):
    """Uniform sizes use the global params.h everywhere."""
    if params.particle_sizes == ParticleSizes.Uniform:
        return torch.full_like(h, float(params.h))
    return h


def compute_density(nb: Neighborhood, cache: EdgeCache, bt, position, h,
                    params: SimulationParams, mass):
    """rho_i = sum_j m_j W_ij + the boundary term."""
    rho = reduce_edges(nb, cache.mass_j * cache.w, mass[:, None] * cache.w)
    return rho + bnd.density_boundary_term(bt, position, h, params)


def compute_constant_field(nb, cache: EdgeCache, bt, position, h, params, mass, density):
    """<1>_i = sum_j (m_j / rho_j) W_ij + boundary / rho0."""
    cf = reduce_edges(nb, cache.mass_j / cache.rho_j * cache.w,
                      (mass / density)[:, None] * cache.w)
    return cf + bnd.density_boundary_term(bt, position, h, params) / params.rest_density


def non_pressure_accel(nb, cache: EdgeCache, position, velocity, density, mass,
                       params: SimulationParams):
    """Viscosity (ApproxLaplace or WCSPH; XSPH contributes none) + gravity +
    the pull towards `pull_fluid_to`."""
    D = position.shape[1]
    if params.viscosity_type == ViscosityType.XSPH:
        visc = torch.zeros_like(position)
    else:
        v_ab = velocity[:, None, :] - velocity[nb.idx]  # the same for both directions
        dot = torch.sum(cache.diff * v_ab, -1)  # x_ij . v_ij, symmetric under the swap
        r2 = cache.r * cache.r
        attract = (dot < 0.0)[..., None]
        rho_i = density[:, None]
        if params.viscosity_type == ViscosityType.WCSPH:
            viscous = 2.0 * params.viscosity * cache.h_ij * SPEED_OF_SOUND / (rho_i + cache.rho_j)
            pi_ab = -viscous * dot / (r2 + 0.001 * cache.h_ij * cache.h_ij)
            fwd = (-cache.mass_j * pi_ab)[..., None] * cache.grad
            # reversed edge: x, v and grad all flip, pi stays; m_i and -grad
            bwd = (mass[:, None] * pi_ab)[..., None] * cache.grad
        else:  # ApproxLaplace
            rho_ij = (rho_i + cache.rho_j) * 0.5
            coeff = 2.0 * (D + 2) * dot / (r2 + 0.01 * cache.h_ij * cache.h_ij) / rho_ij
            fwd = (params.viscosity * cache.mass_j * coeff)[..., None] * cache.grad
            bwd = (-params.viscosity * mass[:, None] * coeff)[..., None] * cache.grad
        zero = torch.zeros_like(fwd)
        visc = reduce_edges(nb, torch.where(attract, fwd, zero), torch.where(attract, bwd, zero))

    g = torch.tensor(params.gravity_vector(D), dtype=torch.float32, device=position.device)
    accel = visc + g[None, :]
    if params.pull_fluid_to is not None:
        target = torch.tensor(params.pull_fluid_to[:D], dtype=torch.float32,
                              device=position.device)
        d = target[None, :] - position
        norm = sqrt(torch.sum(d * d, dim=-1, keepdim=True))
        accel = accel + d / torch.clamp(norm, min=1e-9) * 13.0
    return accel


def divergence(nb, cache: EdgeCache, bst, quantity, quantity_b, mass, density,
               params: SimulationParams):
    """div(A)_i of the (C, 2) field `quantity` (+ the boundary term through
    bst, the BoundarySolverTerms, or None); quantity_b is the boundary's
    value."""
    dq_dot = torch.sum((quantity[nb.idx] - quantity[:, None, :]) * cache.grad, -1)
    if params.operator_discretization == OperatorDiscretization.Winchenbach2020:
        # the reversed edge: (q_i - q_j) . (-grad) = dq_dot
        s = reduce_edges(nb, cache.mass_j / cache.rho_j * dq_dot,
                         (mass / density)[:, None] * dq_dot)
    else:
        s = reduce_edges(nb, cache.mass_j * dq_dot, mass[:, None] * dq_dot) / density
    if bst is not None:
        s = s + bnd.boundary_divergence_fast(bst, quantity, quantity_b, density, params)
    return s


def pressure_accel(nb, cache: EdgeCache, bst, pressure, mass, density,
                   params: SimulationParams):
    """a_p = -sum_j m_j (p_i / rho_i^2 + p_j / rho_j^2) grad W_ij + boundary."""
    term = pressure / (density * density)
    term_pair = term[:, None] + pressure[nb.idx] / (cache.rho_j * cache.rho_j)
    fwd = (-cache.mass_j * term_pair)[..., None] * cache.grad
    bwd = (mass[:, None] * term_pair)[..., None] * cache.grad  # -m_i term (-grad)
    acc = reduce_edges(nb, fwd, bwd)
    if bst is not None:
        acc = acc + bnd.boundary_pressure_accel_fast(bst, pressure, density, params)
    return acc


def compute_aii(nb, cache: EdgeCache, bt, bst, mass, density, params: SimulationParams):
    """The closed-form diagonal a_ii for the boundary model and the
    discretization (no boundary: the fluid terms of the
    ConsistentSimpleGradient form)."""
    rho_i = density
    rho_i_sq = rho_i * rho_i
    rho_i_cu = rho_i_sq * rho_i
    rho_b = params.rest_density
    od = params.operator_discretization
    grad2 = torch.sum(cache.grad * cache.grad, -1)
    m_rho_j = cache.mass_j / cache.rho_j
    m_rho_i = (mass / density)[:, None]
    sums = reduce_edges(
        nb,
        fwd={"mj_wij": cache.mass_j[..., None] * cache.grad,
             "mj_wij_sq": cache.mass_j * grad2,
             "mj_by_rhoj_wij": m_rho_j[..., None] * cache.grad,
             "mj_by_rhoj_wij_sq": m_rho_j * grad2},
        bwd={"mj_wij": -mass[:, None, None] * cache.grad,
             "mj_wij_sq": mass[:, None] * grad2,
             "mj_by_rhoj_wij": -m_rho_i[..., None] * cache.grad,
             "mj_by_rhoj_wij_sq": m_rho_i * grad2},
    )
    mj_wij = sums["mj_wij"]
    mj_wij_sq = sums["mj_wij_sq"]
    mi = mass

    if bt.kind == "particles":
        p_ib_coeff = 0.0 if od == OperatorDiscretization.ConsistentSimpleGradient else 1.0
        G = bst.G
        lhs = (mj_wij / rho_i_sq[:, None] + G / rho_i_sq[:, None]
               + G * (p_ib_coeff / (rho_b * rho_b)))
        rhs = mj_wij + G
        return torch.sum(lhs * rhs, -1) / rho_i + mi * mj_wij_sq / rho_i_cu

    if bt.kind == "sdf":
        G = bst.G
        if od == OperatorDiscretization.Winchenbach2020:
            lhs = mj_wij / rho_i_sq[:, None] + G * (rho_b / rho_i_sq)[:, None]
            rhs = sums["mj_by_rhoj_wij"] + G
            return torch.sum(lhs * rhs, -1) + mi * sums["mj_by_rhoj_wij_sq"] / rho_i_sq
        p_ib_coeff = 1.0 if od == OperatorDiscretization.ConsistentSymmetricGradient else 0.0
        sum_boundary = G * (rho_b * (1.0 / rho_i_sq + p_ib_coeff / (rho_b * rho_b)))[:, None]
        lhs = mj_wij / rho_i_sq[:, None] + sum_boundary
        rhs = mj_wij / rho_i[:, None] + (G * rho_b) / rho_i[:, None]
        return torch.sum(lhs * rhs, -1) + mi * mj_wij_sq / rho_i_cu

    lhs = mj_wij / rho_i_sq[:, None]
    return torch.sum(lhs * mj_wij, -1) / rho_i + mi * mj_wij_sq / rho_i_cu


def _zero_q(like):
    return torch.zeros(2, dtype=torch.float32, device=like.device)


def _next_rho(density, params: SimulationParams):
    if params.operator_discretization == OperatorDiscretization.Winchenbach2020:
        return torch.full_like(density, float(params.rest_density))
    return density


def source_term_divergence(nb, cache, bst, velocity, mass, density, params, dt):
    """-div(v) / dt."""
    div_v = divergence(nb, cache, bst, velocity, _zero_q(velocity), mass, density, params)
    return -div_v / dt


def source_term_only_density(density, params: SimulationParams, dt):
    """-(rho0 - rho) / (rho~ dt^2)."""
    return -(params.rest_density - density) / (_next_rho(density, params) * dt * dt)


def source_term_full(nb, cache, bst, velocity, mass, density, params, dt):
    """The density and divergence source."""
    div_v = divergence(nb, cache, bst, velocity, _zero_q(velocity), mass, density, params)
    return (-(params.rest_density - density) / (_next_rho(density, params) * dt * dt)
            - div_v / dt)


def source_term_full_with_omega(nb, cache, bst, velocity, mass, density, omega, params, dt):
    """IISPH2's Omega-corrected source."""
    div_v = divergence(nb, cache, bst, velocity, _zero_q(velocity), mass, density, params)
    next_rho = params.rest_density
    return -(params.rest_density - density) / (next_rho * dt * dt) - div_v / (dt * omega)


def cfl_dt(velocity, h, alive, params: SimulationParams):
    """dt = min(max_dt, cfl min_i sqrt(sr_i^2 / (|v|^2 + 0.01))), () f32."""
    sr = effective_h(h, params) * kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH
    v2 = torch.sum(velocity * velocity, -1)
    val = sr * sr / (v2 + 0.01)
    val = torch.where(alive, val, torch.full_like(val, float("inf")))
    cfl = params.cfl_factor * sqrt(torch.min(val))
    return torch.clamp(cfl, max=float(params.max_dt))
