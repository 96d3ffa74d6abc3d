"""Boundary handlers: semi-analytic SDF (Winchenbach 2020) and none.

Counterpart of adaptive_sph_tpu/models/boundary.py. Each handler owns static
geometry and turns (position, h) into per-step `BoundaryTerms`; the physics
consumes only those terms. The particle-based (Akinci) handler is not ported
yet (scene.make_boundary_handler raises for it).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops import boundary_lambda as bl
from ..ops import kernels
from ..ops import sdf as sdf_mod
from ..ops.numerics import sqrt
from ..utils.params import BoundaryPenaltyTerm, ParticleSizes, SimulationParams


@dataclasses.dataclass
class BoundaryTerms:
    """Per-step boundary quantities (S = number of SDF shapes).

    lam          : (C, S) lambda * penalty
    grad_lam     : (C, S, D) its gradient, penalty included
    lam_mask     : (C, S) contact validity (d < 1 and a well-defined gradient)
    sdf_min_dist : (C,) distance to the nearest boundary
    """

    kind: str
    lam: Optional[torch.Tensor] = None
    grad_lam: Optional[torch.Tensor] = None
    lam_mask: Optional[torch.Tensor] = None
    sdf_min_dist: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class NoBoundaryHandler:
    def update_after_advect(self, position, h, params: SimulationParams) -> BoundaryTerms:
        return BoundaryTerms(kind="none")


def _penalty(d, term: BoundaryPenaltyTerm):
    """Penalty gamma(d) and gamma'(d)."""
    one = torch.ones_like(d)
    zero = torch.zeros_like(d)
    if term == BoundaryPenaltyTerm.NoPenalty:
        return one, zero
    if term == BoundaryPenaltyTerm.Linear:
        return 1.0 - d, -one
    if term == BoundaryPenaltyTerm.Quadratic1:
        p = torch.where(d > 0.0, one, torch.where(d > -1.0, 0.5 * d * d + 1.0, 0.5 - d))
        dp = torch.where(d > 0.0, zero, torch.where(d > -1.0, d, -one))
        return p, dp
    if term == BoundaryPenaltyTerm.Quadratic2:
        p = torch.where(d > 0.0, one, torch.where(d > -0.5, d * d + 1.0, 0.75 - d))
        dp = torch.where(d > 0.0, zero, torch.where(d > -0.5, 2.0 * d, -one))
        return p, dp
    raise ValueError(term)


@dataclasses.dataclass(frozen=True)
class WinchenbachBoundary:
    """SDF shapes are static geometry; the lambda terms are per step."""

    sdfs: tuple  # of SdfPlane / SdfPolygon2D

    def update_after_advect(self, position, h, params: SimulationParams) -> BoundaryTerms:
        """lambda + grad(lambda) per particle x SDF."""
        sr = h * kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH
        if params.particle_sizes == ParticleSizes.Uniform:
            sr = torch.full_like(h, params.h * kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH)

        dist = sdf_mod.probe_all(self.sdfs, position)  # (C, S)
        d = dist / sr[:, None]

        grad = sdf_mod.gradient_all(self.sdfs, position, params.sdf_gradient_eps)  # (C, S, D)
        grad_norm = sqrt(torch.sum(grad * grad, dim=-1))
        grad_ok = grad_norm >= 1e-5
        grad_unit = grad / torch.clamp(grad_norm, min=1e-5)[..., None]

        in_contact = (d < 1.0) & grad_ok

        pen, dpen = _penalty(d, params.boundary_penalty_term)

        lam_p, dlam_p = bl.lambda_dlambda_poly(d)
        # d <= -1: fully submerged -> lambda = 1, dlambda = 0
        sub = d <= -1.0
        lam = torch.where(sub, torch.ones_like(lam_p), lam_p)
        dlam = torch.where(sub, torch.zeros_like(dlam_p), dlam_p)

        lam_pen = lam * pen
        grad_lam_pen = grad_unit / sr[:, None, None] * (dpen * lam + pen * dlam)[..., None]

        lam_pen = torch.where(in_contact, lam_pen, torch.zeros_like(lam_pen))
        grad_lam_pen = torch.where(in_contact[..., None], grad_lam_pen,
                                   torch.zeros_like(grad_lam_pen))

        return BoundaryTerms(
            kind="sdf",
            lam=lam_pen,
            grad_lam=grad_lam_pen,
            lam_mask=in_contact,
            sdf_min_dist=torch.min(dist, dim=-1).values,
        )


def density_boundary_term(bt: BoundaryTerms, position, h, params: SimulationParams):
    """Boundary density contribution: sum of lambda, added unscaled (exact with
    rest_density = 1, as in every committed config)."""
    if bt.kind == "none":
        return torch.zeros(position.shape[0], dtype=torch.float32, device=position.device)
    if bt.kind == "sdf":
        return torch.sum(bt.lam, dim=-1)
    raise ValueError(bt.kind)


@dataclasses.dataclass
class BoundarySolverTerms:
    """Per-step reduction of the boundary handler for the solver's inner loop:
    the pressure-accel and divergence terms factor through one vector G per
    particle (the sum of grad-lambda over shapes)."""

    kind: str
    G: Optional[torch.Tensor] = None  # (C, D)


def solver_terms(bt: BoundaryTerms, position, h, params: SimulationParams) -> BoundarySolverTerms:
    C, D = position.shape
    if bt.kind == "none":
        return BoundarySolverTerms(
            kind="none", G=torch.zeros((C, D), dtype=torch.float32, device=position.device))
    if bt.kind == "sdf":
        glam = torch.where(bt.lam_mask[..., None], bt.grad_lam, torch.zeros_like(bt.grad_lam))
        return BoundarySolverTerms(kind="sdf", G=torch.sum(glam, dim=1))
    raise ValueError(bt.kind)


def distance_to_boundary(bt: BoundaryTerms):
    """Nearest boundary distance per particle."""
    if bt.kind == "none":
        return None
    if bt.kind == "sdf":
        return bt.sdf_min_dist
    raise ValueError(bt.kind)


def lambda_sum(bt: BoundaryTerms):
    """sum_s lambda_s (occluded volume fraction); None without SDF shapes."""
    if bt.kind == "sdf":
        return torch.sum(bt.lam, dim=-1)
    return None
