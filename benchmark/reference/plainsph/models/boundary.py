"""Boundary handlers: semi-analytic SDF (Winchenbach 2020), particle-based
(Akinci) and none.

Counterpart of adaptive_sph_tpu/models/boundary.py. Each handler owns static
geometry and turns (position, h) into per-step `BoundaryTerms`; the physics
consumes only those terms, and the solver only their per-particle reduction G.

The particle handler's boundary particles are static: their cell grid and the
pseudo-masses Psi_b = rho0 / sum_b' W_bb' are computed on the host once, in
numpy float32 in the reference's order of operations (h is fixed per run).
Each step gathers up to `kb` boundary neighbours per fluid particle from the
nine cells around it, `max_per_cell` candidates a cell, and keeps the first
`kb` valid ones in cell order, so that a crowded cell or particle is cut where
the reference cuts it. Uniform sizes only, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import boundary_lambda as bl
from ..ops import kernels
from ..ops import sdf as sdf_mod
from ..ops.numerics import div_const, fma, sqrt
from ..utils.params import (
    BoundaryPenaltyTerm,
    OperatorDiscretization,
    ParticleSizes,
    SimulationParams,
)


@dataclasses.dataclass
class BoundaryTerms:
    """Per-step boundary quantities.

    SDF handler (S = number of SDF shapes):
      lam          : (C, S) lambda * penalty
      grad_lam     : (C, S, D) its gradient, penalty included
      lam_mask     : (C, S) contact validity (d < 1 and a well-defined gradient)
      sdf_min_dist : (C,) distance to the nearest boundary
    Particle handler (KB = boundary neighbours per fluid particle):
      bidx      : (C, KB) int64 boundary-particle indices (0 where masked)
      bmask     : (C, KB)
      bpos      : (B, D) boundary positions; bpsi: (B,) pseudo-masses
      min_bdist : (C,) distance to the nearest boundary neighbour (inf if none)
    """

    kind: str
    lam: Optional[torch.Tensor] = None
    grad_lam: Optional[torch.Tensor] = None
    lam_mask: Optional[torch.Tensor] = None
    sdf_min_dist: Optional[torch.Tensor] = None
    bidx: Optional[torch.Tensor] = None
    bmask: Optional[torch.Tensor] = None
    bpos: Optional[torch.Tensor] = None
    bpsi: Optional[torch.Tensor] = None
    min_bdist: Optional[torch.Tensor] = None


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


@dataclasses.dataclass(frozen=True)
class ParticleBoundaryStatic:
    """Host-side precomputed boundary data (static geometry, fixed global h)."""

    positions: np.ndarray  # (B, D) f32
    psi: np.ndarray  # (B,) pseudo-masses
    sorted_cell_ids: np.ndarray  # (B,) int32
    order: np.ndarray  # (B,) int32
    dom_min: np.ndarray  # (D,)
    width: int
    cell: float
    kb: int  # boundary neighbours per fluid particle
    max_per_cell: int


def build_particle_boundary(boundary_positions: np.ndarray, params: SimulationParams,
                            kb: int = 32, max_per_cell: int = 16) -> "ParticleBoundaryHandler":
    """Pseudo-masses Psi_b = rho0 / sum_b' W(x_bb', h) over the boundary-boundary
    pairs (an exact O(B^2) sum on the host, numpy float32) and the static
    boundary cell grid. Uniform sizes only: the reference leaves the particle
    boundary with adaptive sizes unimplemented."""
    if params.particle_sizes != ParticleSizes.Uniform:
        raise ValueError("the particle boundary (init_boundary_handler: Particles) needs "
                         "particle_sizes: Uniform, as in the reference")
    bp = np.asarray(boundary_positions, dtype=np.float32)
    sr = params.h * kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH

    diff = bp[:, None, :] - bp[None, :, :]
    r = np.sqrt((diff ** 2).sum(-1))
    w = kernels.kernel_w_np(r / np.float32(2.0 * params.h), params.h, bp.shape[1])
    w[r >= sr] = 0.0
    number_density = w.sum(1)
    psi = params.rest_density / number_density

    cell = sr
    dom_min = bp.min(0) - 2 * cell
    ci = np.floor((bp - dom_min) / cell).astype(np.int32) + 1
    width = int(ci[:, 0].max()) + 3
    cid = ci[:, 0] + ci[:, 1] * width
    order = np.argsort(cid, kind="stable").astype(np.int32)
    static = ParticleBoundaryStatic(
        positions=bp, psi=psi.astype(np.float32), sorted_cell_ids=cid[order].astype(np.int32),
        order=order, dom_min=dom_min.astype(np.float32), width=width, cell=float(cell),
        kb=kb, max_per_cell=max_per_cell)
    return ParticleBoundaryHandler(static=static)


def _r2(diff):
    """|diff|^2 over the trailing axis of size 2, rounded as the reference's
    jnp.sum(diff * diff, -1) compiles on the CPU: fma(dy, dy, dx * dx)."""
    return fma(diff[..., 1], diff[..., 1], diff[..., 0] * diff[..., 0])


@dataclasses.dataclass(frozen=True)
class ParticleBoundaryHandler:
    static: ParticleBoundaryStatic
    # the static arrays as tensors, per device (filled at first use)
    _tensors: dict = dataclasses.field(default_factory=dict, compare=False, repr=False)

    def tensors(self, device):
        """(bpos, bpsi, sorted cell ids, order, dom_min) on `device`."""
        key = str(torch.device(device))
        if key not in self._tensors:
            st = self.static
            self._tensors[key] = tuple(
                torch.as_tensor(a).to(device)
                for a in (st.positions, st.psi, st.sorted_cell_ids, st.order.astype(np.int64),
                          st.dom_min))
        return self._tensors[key]

    def update_after_advect(self, position, h, params: SimulationParams) -> BoundaryTerms:
        """Fluid -> boundary neighbour lists of fixed width kb from the static
        boundary grid: candidates of the nine cells in (oy, ox) order, each a
        window of max_per_cell sorted slots; the first kb within the support
        radius are kept, in that order."""
        st = self.static
        bpos, bpsi, sorted_ids, order, dom_min = self.tensors(position.device)
        B = st.positions.shape[0]
        dev = position.device
        sr = float(np.float32(params.h * kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH))
        sr2 = float(np.float32(sr) * np.float32(sr))
        ci = torch.floor(div_const(position - dom_min[None, :], st.cell)).to(torch.int32) + 1
        offs = torch.arange(st.max_per_cell, dtype=torch.int32, device=dev)[None, :]
        idx_parts, valid_parts = [], []
        for oy in (-1, 0, 1):
            for ox in (-1, 0, 1):
                ncid = (ci[:, 0] + ox) + (ci[:, 1] + oy) * st.width
                start = torch.searchsorted(sorted_ids, ncid, right=False).to(torch.int32)
                window = start[:, None] + offs
                wc = torch.clamp(window, max=B - 1).long()
                idx = order[wc]
                valid = (sorted_ids[wc] == ncid[:, None]) & (window < B)
                valid = valid & (_r2(position[:, None, :] - bpos[idx]) < sr2)
                idx_parts.append(idx)
                valid_parts.append(valid)
        cand_idx = torch.cat(idx_parts, dim=1)
        cand_valid = torch.cat(valid_parts, dim=1)
        # the first kb valid candidates in column order (the reference's
        # stable sort on valid-first keys) by their rank among the valid
        # ones: each goes to slot rank, the others to a spare slot kb
        rank = torch.cumsum(cand_valid, dim=1) - 1
        slot = torch.where(cand_valid & (rank < st.kb), rank, st.kb)
        C = position.shape[0]
        bidx = torch.zeros((C, st.kb + 1), dtype=torch.int64, device=dev).scatter_(
            1, slot, cand_idx)[:, :st.kb]
        bmask = torch.arange(st.kb, device=dev)[None, :] < torch.sum(cand_valid, dim=1,
                                                                     keepdim=True)
        dist = sqrt(_r2(position[:, None, :] - bpos[bidx]) + 1e-30)
        min_bdist = torch.min(torch.where(bmask, dist, torch.full_like(dist, float("inf"))),
                              dim=1).values
        return BoundaryTerms(kind="particles", bidx=bidx, bmask=bmask, bpos=bpos, bpsi=bpsi,
                             min_bdist=min_bdist)


def _fb_constants(params: SimulationParams):
    """The fluid-boundary kernel's float32 constants under uniform sizes, as the
    reference's compiler folds them (h is a constant there): c = 1 / 2h, the
    2D norm 10 / (7 pi h^2), and the products the gradient's chain folds into
    (18 c, 12 c, norm c)."""
    f32 = np.float32
    h = f32(params.h)
    c = f32(1.0) / f32(2.0 * params.h)
    norm = f32(10.0) / (f32(7.0 * kernels.PI) * (h * h))
    return {"c": float(c), "norm": float(norm), "c18": float(f32(18.0) * c),
            "c12": float(f32(12.0) * c), "norm_c": float(norm * c)}


def _lane_sum(a, b=None):
    """sum over axis 1 (a multiple of 8 columns) in the order the reference's
    compiled reduction takes on the CPU: eight partial sums over the columns
    k mod 8, then halved 8 -> 4 -> 2 -> 1. With b, the sum of a * b, each
    product fused into its partial sum."""
    C, K = a.shape[0], a.shape[1]
    a = a.reshape(C, K // 8, 8, *a.shape[2:])
    b = None if b is None else b.reshape(C, K // 8, 8, *b.shape[2:])
    acc = a[:, 0] if b is None else a[:, 0] * b[:, 0]
    for blk in range(1, K // 8):
        acc = acc + a[:, blk] if b is None else fma(a[:, blk], b[:, blk], acc)
    while acc.shape[1] > 1:
        half = acc.shape[1] // 2
        acc = acc[:, :half] + acc[:, half:]
    return acc[:, 0]


def density_boundary_term(bt: BoundaryTerms, position, h, params: SimulationParams):
    """Boundary density contribution. SDF: the sum of lambda, added unscaled
    (exact with rest_density = 1, as in every committed config); particles:
    sum_b Psi_b W_ib."""
    if bt.kind == "none":
        return torch.zeros(position.shape[0], dtype=torch.float32, device=position.device)
    if bt.kind == "sdf":
        return torch.sum(bt.lam, dim=-1)
    k = _fb_constants(params)
    r = sqrt(_r2(position[:, None, :] - bt.bpos[bt.bidx]) + 1e-30)
    w = kernels.cubic_kernel_unnormalized(r * k["c"]) * k["norm"]
    terms = bt.bpsi[bt.bidx] * w
    return _lane_sum(torch.where(bt.bmask, terms, torch.zeros_like(terms)))


@dataclasses.dataclass
class BoundarySolverTerms:
    """Per-step reduction of the boundary handler for the solver's inner loop:
    the pressure-accel and divergence terms factor through one vector G per
    particle (the sum of grad-lambda over shapes, or of Psi_b grad W_ib over
    the boundary neighbours)."""

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
    # G = sum_b Psi_b grad W_ib, grad W = norm W'(q) / 2h (x_ib / r)
    k = _fb_constants(params)
    diff = position[:, None, :] - bt.bpos[bt.bidx]
    r = sqrt(torch.clamp(_r2(diff), min=1e-30))
    q = r * k["c"]
    v = 1.0 - q
    inner = fma(r * k["c18"], q, -(r * k["c12"]))  # 18 q^2 - 12 q
    outer = (v * -6.0) * v
    zero = torch.zeros_like(q)
    mag = torch.where(q < 0.5, inner, torch.where(q < 1.0, outer, zero)) * k["norm_c"]
    gw = mag[..., None] * (diff / r[..., None])
    gw = torch.where(((q > 1.0e-5) & bt.bmask)[..., None], gw, torch.zeros_like(gw))
    psi = torch.where(bt.bmask, bt.bpsi[bt.bidx], torch.zeros_like(bt.bpsi[bt.bidx]))
    return BoundarySolverTerms(kind="particles", G=_lane_sum(psi[..., None], gw))


def _smoothing_h_fb(h_i, params: SimulationParams):
    """The fluid-boundary smoothing length: params.h under uniform sizes."""
    if params.particle_sizes == ParticleSizes.Uniform:
        return torch.full_like(h_i, float(params.h))
    return h_i


def _mirror(kind: str, params: SimulationParams) -> float:
    """1.0 where the boundary mirrors the particle's pressure: the SDF
    boundary under ConsistentSymmetricGradient, the particle boundary under
    every discretization but ConsistentSimpleGradient."""
    od = params.operator_discretization
    if kind == "sdf":
        return 1.0 if od == OperatorDiscretization.ConsistentSymmetricGradient else 0.0
    return 0.0 if od == OperatorDiscretization.ConsistentSimpleGradient else 1.0


def boundary_pressure_accel(bt: BoundaryTerms, position, h, pressure, density,
                            params: SimulationParams):
    """The boundary's pressure acceleration (C, 2), element by element (the
    list backend's check_aii; the solver uses the factored form)."""
    C, D = position.shape
    if bt.kind == "none":
        return torch.zeros((C, D), dtype=torch.float32, device=position.device)
    rho_b = params.rest_density
    p_ib = pressure * _mirror(bt.kind, params)
    if bt.kind == "sdf":
        coeff = -rho_b * (pressure / (density * density) + p_ib / (rho_b * rho_b))
        return torch.sum(bt.grad_lam * coeff[:, None, None], dim=1)
    hfb = _smoothing_h_fb(h, params)
    gw = kernels.kernel_grad(position[:, None, :] - bt.bpos[bt.bidx], hfb[:, None], dim=D)
    psi = bt.bpsi[bt.bidx]
    term = -psi * (pressure[:, None] / (density * density)[:, None]
                   + p_ib[:, None] / (rho_b * rho_b))
    contrib = term[..., None] * gw
    return torch.sum(torch.where(bt.bmask[..., None], contrib, torch.zeros_like(contrib)), dim=1)


def boundary_divergence(bt: BoundaryTerms, quantity, quantity_b, position, h, density,
                        params: SimulationParams):
    """The boundary part of the divergence of `quantity` (C, 2), element by
    element; quantity_b is the boundary's value."""
    C = position.shape[0]
    if bt.kind == "none":
        return torch.zeros(C, dtype=torch.float32, device=position.device)
    if bt.kind == "sdf":
        dots = torch.sum((quantity_b[None, None, :] - quantity[:, None, :]) * bt.grad_lam, dim=-1)
        if params.operator_discretization == OperatorDiscretization.Winchenbach2020:
            return torch.sum(dots, dim=1)
        return torch.sum(dots, dim=1) * (params.rest_density / density)
    hfb = _smoothing_h_fb(h, params)
    gw = kernels.kernel_grad(position[:, None, :] - bt.bpos[bt.bidx], hfb[:, None],
                             dim=position.shape[1])
    s = bt.bpsi[bt.bidx] * torch.sum((quantity[:, None, :] - quantity_b[None, None, :]) * gw,
                                     dim=-1)
    return -torch.sum(torch.where(bt.bmask, s, torch.zeros_like(s)), dim=1) / density


def boundary_pressure_accel_fast(bst: BoundarySolverTerms, pressure, density,
                                 params: SimulationParams):
    """boundary_pressure_accel through the factored vector G."""
    if bst.kind == "none":
        return 0.0
    rho_b = params.rest_density
    coeff = -(pressure / (density * density)
              + _mirror(bst.kind, params) * pressure / (rho_b * rho_b))
    if bst.kind == "sdf":
        coeff = coeff * rho_b
    return bst.G * coeff[:, None]


def boundary_divergence_fast(bst: BoundarySolverTerms, quantity, quantity_b, density,
                             params: SimulationParams):
    """boundary_divergence through the factored vector G."""
    if bst.kind == "none":
        return 0.0
    dq_dot = torch.sum((quantity_b[None, :] - quantity) * bst.G, -1)
    if bst.kind == "sdf":
        if params.operator_discretization == OperatorDiscretization.Winchenbach2020:
            return dq_dot
        return dq_dot * (params.rest_density / density)
    # particles: -sum psi (q_i - q_b) . grad W / rho_i = (q_b - q_i) . G / rho_i
    return dq_dot / density


def distance_to_boundary(bt: BoundaryTerms):
    """Nearest boundary distance per particle."""
    if bt.kind == "none":
        return None
    if bt.kind == "sdf":
        return bt.sdf_min_dist
    return bt.min_bdist


def lambda_sum(bt: BoundaryTerms):
    """sum_s lambda_s (occluded volume fraction); None without SDF shapes (the
    particle boundary too)."""
    if bt.kind == "sdf":
        return torch.sum(bt.lam, dim=-1)
    return None
