"""Per-particle a_ii assembly and boundary solver terms on channel-split 1-D tensors.

Counterpart of assemble_aii_1d, boundary_accel_slots_1d and
boundary_div_slots_1d in adaptive_sph_tpu/models/grid_physics.py (the dense
grid engine itself is not ported: the tile engine replaced it).
"""

from __future__ import annotations

import torch

from ..ops.numerics import rdiv
from ..utils.params import OperatorDiscretization, SimulationParams


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
