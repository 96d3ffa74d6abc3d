"""Slot-space physics of the dense grid engine (`backend="grid"`).

Counterpart of adaptive_sph_tpu/models/grid_physics.py: every pair sum is a
`grid_pairs.pair_apply` over shifted grid windows and every per-particle
quantity lives in the slot layout of ops/grid.py. The boundary terms are
computed flat once per step (models/boundary.py) and scattered in; inside
the Jacobi loop they enter through the factored per-slot vector G. The
reference's Jacobi `while_loop` is a host loop with one device read per
iteration, under its stopping rule. The channel-split 1-D helpers at the
end (`assemble_aii_1d`, `boundary_accel_slots_1d`, `boundary_div_slots_1d`)
serve the tile engine.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from ..ops.numerics import fma_tensors, rdiv, sqrt
from ..utils.params import OperatorDiscretization, SimulationParams, ViscosityType
from . import grid_pairs
from .physics import SPEED_OF_SOUND
from .solver import DENSITY_ERROR, SINGULAR_AII_EPS, SolveResult
from .state import SIZE_LARGE


def _w(geom):
    return kernels.kernel_w(geom.r, geom.h_ij, dim=2)


def pair_grad(geom):
    """grad W_ij as kernels.kernel_grad evaluates it, from the pair's r (the
    reference recomputes the same r from diff: sqrt(max(r^2, 1e-30)) equals
    sqrt(r^2 + 1e-30) for every r^2 a particle pair can have)."""
    h = geom.h_ij
    q = geom.r / (2.0 * h)
    mag = kernels.kernel_norm_factor(h, 2) * kernels.cubic_kernel_unnormalized_deriv(q) / (2.0 * h)
    grad = mag[..., None] * (geom.diff / geom.r[..., None])
    return torch.where((q > 1.0e-5)[..., None], grad, torch.zeros_like(grad))


def dot2(a, b):
    """sum(a * b, -1) over a trailing axis of 2, rounded as the reference's
    compiled step: fma(a_y, b_y, a_x * b_x)."""
    return fma_tensors(a[..., 1], b[..., 1], a[..., 0] * b[..., 0])


def _rho_floor(x):
    return torch.clamp(x, min=1e-30)


def density_slots(cfg, bins, sf, scale):
    """rho = sum_j m_j W_ij; the caller adds the boundary term."""

    def edge(vi, vj, geom):
        return {"rho": vj["mass"] * _w(geom)}

    return grid_pairs.pair_apply(cfg, bins, sf, scale, edge)["rho"]


def constant_field_slots(cfg, bins, sf, scale):
    """<1>_i = sum_j (m_j / rho_j) W_ij; the caller adds the boundary term."""

    def edge(vi, vj, geom):
        return {"cf": vj["mass"] / _rho_floor(vj["rho"]) * _w(geom)}

    return grid_pairs.pair_apply(cfg, bins, sf, scale, edge)["cf"]


def _aii_terms(vj, gw):
    g2 = dot2(gw, gw)
    m_by_rho = vj["mass"] / _rho_floor(vj["rho"])
    return {
        "mj_wij": vj["mass"][..., None] * gw,
        "mj_wij_sq": vj["mass"] * g2,
        "mj_by_rhoj_wij": m_by_rho[..., None] * gw,
        "mj_by_rhoj_wij_sq": m_by_rho * g2,
    }


def aii_sums_slots(cfg, bins, sf, scale, params: SimulationParams):
    """The four fluid sums of the closed-form a_ii."""

    def edge(vi, vj, geom):
        return _aii_terms(vj, pair_grad(geom))

    return grid_pairs.pair_apply(cfg, bins, sf, scale, edge)


def _viscosity_pair(vi, vj, geom, gw, params: SimulationParams):
    """The viscosity's pair term (ApproxLaplace or WCSPH), attracting pairs
    only. Rounded as the reference's compiled step: r^2 + c h^2 as
    fma(r, r, c h h), WCSPH's constants 2 nu c_s folded in float32, and
    ApproxLaplace's two divisions as one."""
    v_ab = vi["vel"] - vj["vel"]
    dot = dot2(geom.diff, v_ab)
    h = geom.h_ij
    if params.viscosity_type == ViscosityType.WCSPH:
        c = float(np.float32(np.float32(2.0 * params.viscosity) * np.float32(SPEED_OF_SOUND)))
        vt = (c * h) / _rho_floor(vi["rho"] + vj["rho"])
        pi_ab = -vt * dot / fma_tensors(geom.r, geom.r, 0.001 * h * h)
        contrib = (-vj["mass"] * pi_ab)[..., None] * gw
    else:  # ApproxLaplace
        rho_ij = _rho_floor((vi["rho"] + vj["rho"]) * 0.5)
        coeff = 8.0 * dot / (fma_tensors(geom.r, geom.r, 0.01 * h * h) * rho_ij)
        contrib = (params.viscosity * vj["mass"] * coeff)[..., None] * gw
    return torch.where((dot < 0.0)[..., None], contrib, torch.zeros_like(contrib))


def fused_prep_sweep(cfg, bins, sf, scale, vel, params: SimulationParams):
    """One pair reduction giving the a_ii fluid sums and the viscosity
    acceleration (without gravity and pull). Returns (sums, viscosity)."""
    fields = dict(sf)
    fields["vel"] = vel
    use_xsph = params.viscosity_type == ViscosityType.XSPH

    def edge(vi, vj, geom):
        gw = pair_grad(geom)
        out = _aii_terms(vj, gw)
        if not use_xsph:
            out["visc"] = _viscosity_pair(vi, vj, geom, gw, params)
        return out

    res = grid_pairs.pair_apply(cfg, bins, fields, scale, edge)
    visc = res.pop("visc", None)
    return res, torch.zeros_like(vel) if visc is None else visc


def assemble_aii(sums, sf, G, bt_kind: str, params: SimulationParams):
    """a_ii from the fluid sums and the factored boundary vector G (slots, 2)."""
    rho_i = _rho_floor(sf["rho"])
    rho_i_sq = rho_i * rho_i
    rho_i_cu = rho_i_sq * rho_i
    rho_b = params.rest_density
    od = params.operator_discretization
    mi = sf["mass"]
    mj_wij = sums["mj_wij"]
    mj_wij_sq = sums["mj_wij_sq"]

    if bt_kind == "particles":
        p_ib_coeff = 0.0 if od == OperatorDiscretization.ConsistentSimpleGradient else 1.0
        lhs = mj_wij / rho_i_sq[:, None] + G / rho_i_sq[:, None] + G * (p_ib_coeff / (rho_b**2))
        rhs = mj_wij + G
        return dot2(lhs, rhs) / rho_i + mi * mj_wij_sq / rho_i_cu

    if bt_kind == "sdf":
        if od == OperatorDiscretization.Winchenbach2020:
            sum_boundary = G * rdiv(rho_b, rho_i_sq)[:, None]
            lhs = mj_wij / rho_i_sq[:, None] + sum_boundary
            rhs = sums["mj_by_rhoj_wij"] + G
            return dot2(lhs, rhs) + mi * sums["mj_by_rhoj_wij_sq"] / rho_i_sq
        p_ib_coeff = 1.0 if od == OperatorDiscretization.ConsistentSymmetricGradient else 0.0
        sum_boundary = G * (rho_b * (rdiv(1.0, rho_i_sq) + p_ib_coeff / (rho_b**2)))[:, None]
        lhs = mj_wij / rho_i_sq[:, None] + sum_boundary
        rhs = mj_wij / rho_i[:, None] + (G * rho_b) / rho_i[:, None]
        return dot2(lhs, rhs) + mi * mj_wij_sq / rho_i_cu

    lhs = mj_wij / rho_i_sq[:, None]
    return dot2(lhs, mj_wij) / rho_i + mi * mj_wij_sq / rho_i_cu


def aii_slots(cfg, bins, sf, scale, G, bt_kind: str, params: SimulationParams):
    """a_ii on its own sweep (where the fused prep sweep does not apply)."""
    return assemble_aii(aii_sums_slots(cfg, bins, sf, scale, params), sf, G, bt_kind, params)


def boundary_accel_slots(G, pressure, rho, bt_kind: str, params: SimulationParams):
    """The boundary's pressure acceleration through G."""
    if bt_kind == "none":
        return 0.0
    rho_b = params.rest_density
    coeff = -(pressure / _rho_floor(rho * rho) + _mirror(bt_kind, params) * pressure / (rho_b**2))
    if bt_kind == "sdf":
        coeff = coeff * rho_b
    return G * coeff[:, None]


def boundary_div_slots(G, q, qb, rho, bt_kind: str, params: SimulationParams):
    """The boundary part of the divergence of q (slots, 2); qb the boundary's value."""
    if bt_kind == "none":
        return 0.0
    dq_dot = dot2(qb[None, :] - q, G)
    if bt_kind == "sdf":
        if params.operator_discretization == OperatorDiscretization.Winchenbach2020:
            return dq_dot
        return dq_dot * rdiv(params.rest_density, _rho_floor(rho))
    return dq_dot / _rho_floor(rho)


def pressure_accel_slots(cfg, bins, sf, scale, p, G, bt_kind, params):
    """-sum_j m_j (p_i / rho_i^2 + p_j / rho_j^2) grad W + the boundary term."""
    fields = dict(sf)
    fields["p"] = p

    def edge(vi, vj, geom):
        term = (vi["p"] / _rho_floor(vi["rho"] ** 2) + vj["p"] / _rho_floor(vj["rho"] ** 2))
        return {"acc": (-vj["mass"] * term)[..., None] * pair_grad(geom)}

    acc = grid_pairs.pair_apply(cfg, bins, fields, scale, edge)["acc"]
    return acc + boundary_accel_slots(G, p, sf["rho"], bt_kind, params)


def divergence_slots(cfg, bins, sf, scale, q, qb, G, bt_kind, params):
    """div(q) per particle + the boundary term."""
    w2020 = params.operator_discretization == OperatorDiscretization.Winchenbach2020
    fields = dict(sf)
    fields["q"] = q

    def edge(vi, vj, geom):
        dq_dot = dot2(vj["q"] - vi["q"], pair_grad(geom))
        if w2020:
            return {"div": vj["mass"] / _rho_floor(vj["rho"]) * dq_dot}
        return {"div": vj["mass"] * dq_dot}

    s = grid_pairs.pair_apply(cfg, bins, fields, scale, edge)["div"]
    if not w2020:
        s = s / _rho_floor(sf["rho"])
    return s + boundary_div_slots(G, q, qb, sf["rho"], bt_kind, params)


def gravity_and_pull(accel, pos, params: SimulationParams):
    """accel + gravity + the pull towards params.pull_fluid_to."""
    g = torch.tensor(params.gravity_vector(2), dtype=torch.float32, device=accel.device)
    accel = accel + g[None, :]
    if params.pull_fluid_to is not None:
        target = torch.tensor(params.pull_fluid_to[:2], dtype=torch.float32, device=accel.device)
        d = target[None, :] - pos
        norm = sqrt(dot2(d, d))[:, None]
        accel = accel + d / torch.clamp(norm, min=1e-9) * 13.0
    return accel


def non_pressure_accel_slots(cfg, bins, sf, scale, vel, params: SimulationParams):
    """Viscosity + gravity + pull (XSPH contributes no viscosity)."""
    if params.viscosity_type == ViscosityType.XSPH:
        visc = torch.zeros_like(vel)
    else:
        fields = dict(sf)
        fields["vel"] = vel

        def edge(vi, vj, geom):
            return {"visc": _viscosity_pair(vi, vj, geom, pair_grad(geom), params)}

        visc = grid_pairs.pair_apply(cfg, bins, fields, scale, edge)["visc"]
    return gravity_and_pull(visc, sf["pos"], params)


def omega_iisph2_slots(cfg, bins, sf, scale, size_class_slots, params):
    """IISPH2's Omega, clamped to [0.125, 2.5]; Large particles take the
    self term alone."""
    srbs = kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH

    def edge(vi, vj, geom):
        return {"s": vj["mass"] * kernels.kernel_dw_dH(geom.r, geom.h_ij * srbs, dim=2)}

    sum_term = grid_pairs.pair_apply(cfg, bins, sf, scale, edge)["s"]
    H_i = sf["h"] * srbs
    rho = _rho_floor(sf["rho"])
    omega_neigh = 1.0 + H_i / (3.0 * rho) * sum_term
    self_term = sf["mass"] * kernels.kernel_dw_dH(torch.zeros_like(H_i), H_i, dim=2)
    omega_large = 1.0 + H_i / (3.0 * rho) * self_term
    omega = torch.where(size_class_slots == SIZE_LARGE, omega_large, omega_neigh)
    return torch.clamp(omega, 0.125, 2.5)


def jacobi_iterations_slots(cfg, bins, sf, scale, aii, src, G, bt_kind, alive_slots,
                            max_avg_error, residual_type, params, dt, p0=None) -> SolveResult:
    """The relaxed-Jacobi solve in slot space. It stops after the sweep
    where (converged and iterations > 1) or iterations == max_iters, as the
    reference's loop does; the returned count is the reference's. One host
    read per sweep. p0: warm-start pressure (params.warm_start_pressure)."""
    total = sf["pos"].shape[0]
    dev = aii.device
    zero_q = torch.zeros(2, dtype=torch.float32, device=dev)
    zero = torch.zeros_like(aii)
    singular = torch.abs(aii) < SINGULAR_AII_EPS
    aii_safe = torch.where(singular, torch.ones_like(aii), aii)
    w = float(np.float32(params.jacobi_omega))
    rho = sf["rho"]

    def one_sweep(p):
        accel = pressure_accel_slots(cfg, bins, sf, scale, p, G, bt_kind, params)
        a_p = divergence_slots(cfg, bins, sf, scale, accel, zero_q, G, bt_kind, params)
        p_next = p + w * (src - a_p) / aii_safe
        p_next = torch.where(singular, zero, p_next)
        if residual_type == DENSITY_ERROR:
            predicted = rho * dt * dt * (src - a_p)
        else:
            predicted = dt * (src - a_p)
        clamped = p_next <= 0.0
        p_next = torch.where(clamped, zero, p_next)
        is_normal = alive_slots & ~singular & ~clamped
        n_normal = torch.sum(is_normal)
        avg = torch.sum(torch.where(is_normal, predicted, zero)) / torch.clamp(
            n_normal, min=1).to(torch.float32)
        avg = torch.where(n_normal > 0, avg, torch.full_like(avg, float("nan")))
        stats = {"normal": n_normal, "singular": torch.sum(alive_slots & singular),
                 "negative": torch.sum(alive_slots & ~singular & clamped), "avg": avg,
                 "max": torch.max(torch.where(is_normal, torch.abs(predicted), zero))}
        return p_next, predicted, stats

    def converged(st):
        if residual_type == DENSITY_ERROR:
            ok = torch.abs(st["avg"] / params.rest_density) < max_avg_error
        else:
            ok = torch.abs(st["avg"]) < max_avg_error / dt
        return (st["normal"] == 0) | ok

    if p0 is None:
        p = torch.zeros(total, dtype=torch.float32, device=dev)
    else:
        p = torch.where(alive_slots & ~singular, torch.clamp(p0, min=0.0), zero)
    density_error = torch.zeros(total, dtype=torch.float32, device=dev)
    iters = 0
    while True:
        p, perr, stats = one_sweep(p)
        if residual_type == DENSITY_ERROR:
            density_error = perr
        # the one host read of the iteration (none while the floor holds)
        if iters == params.max_iters or (iters > 1 and bool(converged(stats))):
            break
        iters += 1
    final_accel = pressure_accel_slots(cfg, bins, sf, scale, p, G, bt_kind, params)
    return SolveResult(pressure=p, pressure_accel=final_accel, density_error=density_error,
                       iterations=iters, avg_error=stats["avg"], max_error=stats["max"],
                       normal_count=stats["normal"], singular_count=stats["singular"],
                       negative_count=stats["negative"])


def assemble_aii_1d(s1x, s1y, s1sq, s2x, s2y, s2sq, sf, Gx, Gy, bt_kind: str,
                    params: SimulationParams):
    """a_ii from the fluid gradient sums. s1* = sum m_j gradW_ij (and its
    squared-norm sum), s2* = the rho_j-weighted variants; Gx/Gy the factored
    boundary vector; sf holds "rho" and "mass"."""
    rho_i = torch.clamp(sf["rho"], min=1e-30)
    rho_i_sq = rho_i * rho_i
    rho_i_cu = rho_i_sq * rho_i
    rho_b = params.rest_density
    od = params.operator_discretization
    mi = sf["mass"]

    if bt_kind == "particles":
        p_ib_coeff = 0.0 if od == OperatorDiscretization.ConsistentSimpleGradient else 1.0
        lx = s1x / rho_i_sq + Gx / rho_i_sq + Gx * (p_ib_coeff / (rho_b**2))
        ly = s1y / rho_i_sq + Gy / rho_i_sq + Gy * (p_ib_coeff / (rho_b**2))
        return (lx * (s1x + Gx) + ly * (s1y + Gy)) / rho_i + mi * s1sq / rho_i_cu

    if bt_kind == "sdf":
        if od == OperatorDiscretization.Winchenbach2020:
            sb = rdiv(rho_b, rho_i_sq)
            lx = s1x / rho_i_sq + Gx * sb
            ly = s1y / rho_i_sq + Gy * sb
            return lx * (s2x + Gx) + ly * (s2y + Gy) + mi * s2sq / rho_i_sq
        p_ib_coeff = 1.0 if od == OperatorDiscretization.ConsistentSymmetricGradient else 0.0
        sb = rho_b * (rdiv(1.0, rho_i_sq) + p_ib_coeff / (rho_b**2))
        lx = s1x / rho_i_sq + Gx * sb
        ly = s1y / rho_i_sq + Gy * sb
        rx = (s1x + Gx * rho_b) / rho_i
        ry = (s1y + Gy * rho_b) / rho_i
        return lx * rx + ly * ry + mi * s1sq / rho_i_cu

    return (s1x * s1x + s1y * s1y) / (rho_i_sq * rho_i) + mi * s1sq / rho_i_cu


def _mirror(bt_kind: str, params: SimulationParams) -> float:
    od = params.operator_discretization
    if bt_kind == "sdf":
        return 1.0 if od == OperatorDiscretization.ConsistentSymmetricGradient else 0.0
    return 0.0 if od == OperatorDiscretization.ConsistentSimpleGradient else 1.0


def boundary_accel_slots_1d(Gx, Gy, pressure, rho, bt_kind: str,
                            params: SimulationParams):
    """Boundary pressure acceleration (x, y) through the factored vector G."""
    if bt_kind == "none":
        return 0.0, 0.0
    rho_b = params.rest_density
    mirror = _mirror(bt_kind, params)
    coeff = -(pressure / torch.clamp(rho * rho, min=1e-30) + mirror * pressure / (rho_b**2))
    if bt_kind == "sdf":
        coeff = coeff * rho_b
    return Gx * coeff, Gy * coeff


def boundary_div_slots_1d(Gx, Gy, qx, qy, rho, bt_kind: str,
                          params: SimulationParams):
    """Boundary part of the divergence of (qx, qy) with a resting boundary."""
    if bt_kind == "none":
        return 0.0
    dq_dot = -(qx * Gx + qy * Gy)
    if bt_kind == "sdf":
        if params.operator_discretization == OperatorDiscretization.Winchenbach2020:
            return dq_dot
        return dq_dot * rdiv(params.rest_density, torch.clamp(rho, min=1e-30))
    return dq_dot / torch.clamp(rho, min=1e-30)
