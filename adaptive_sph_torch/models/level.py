"""Surface detection and level (surface-distance) estimation of the list
backend.

Counterpart of adaptive_sph_tpu/models/level.py: the EmptyAngle detector
(a particle is interior when a neighbour lies in the 50-degree cone around
its normal), the CenterDiff detector (distance to the weighted centre of the
neighbourhood against the average radius), the wavefront propagation of
the level to a fixed point (each sweep, an unassigned particle takes
max_j(level_j - |x_ij|) over its assigned neighbours), and the
volume-weighted smoothing of the clamped field. Every pair quantity comes
from the step's EdgeCache. The reference's on-device `while_loop` of the
propagation becomes a Python loop with one host read per sweep.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels
from ..ops.edge_cache import EdgeCache, reduce_edges
from ..ops.neighbors import Neighborhood, r2
from ..ops.numerics import div_const, sqrt
from ..ops.pairwise import segment_reduce
from ..utils.params import (
    FillStashWith,
    LevelEstimationMethod,
    SimulationParams,
    SupportLengthEstimation,
)
from . import boundary as bnd

NEG_INF = float(np.float32(-3.0e38))
CONE_COS = float(np.float32(np.cos(50.0 * np.pi / 180.0)))  # the EmptyAngle cone


def _range_check_needed(params: SimulationParams) -> bool:
    """The neighbour range limit applies to the FromDistribution modes only."""
    return params.support_length_estimation in (SupportLengthEstimation.FromDistribution,
                                                SupportLengthEstimation.FromDistribution2)


def _range_masks(nb: Neighborhood, cache: EdgeCache, mass, params: SimulationParams):
    """|x_ij| <= r_receiver maximum_range for both edge directions (receiver
    = row particle, then column particle); all true when the check is off."""
    if not _range_check_needed(params):
        t = torch.ones_like(cache.r, dtype=torch.bool)
        return t, t
    radius = kernels.sphere_volume_to_radius(div_const(mass, params.rest_density), dim=2)
    rng = float(params.maximum_range)
    return cache.r <= radius[:, None] * rng, cache.r <= radius[nb.idx] * rng


def _full(like, value):
    return torch.full_like(like, value)


def detect_surface_empty_angle(nb: Neighborhood, cache: EdgeCache, bt, mass, h, alive,
                               params: SimulationParams):
    """EmptyAngle; returns (level, has_level, surface, insufficient)."""
    # normal_i = -sum_j (m_i / rho0) grad W_ij: the receiver's mass, as the
    # reference has it; the reversed edge's receiver is j, with -grad
    rho0 = params.rest_density
    normal = reduce_edges(nb, -(mass / rho0)[:, None, None] * cache.grad,
                          (cache.mass_j / rho0)[..., None] * cache.grad)
    norm2 = torch.sum(normal * normal, -1)
    unit_normal = normal / sqrt(torch.clamp(norm2, min=1e-30))[:, None]

    rng_i, rng_j = _range_masks(nb, cache, mass, params)
    xij_unit = cache.diff / (cache.r + 1e-6)[..., None]
    hit_fwd = nb.mask & rng_i & (torch.sum(-xij_unit * unit_normal[:, None, :], -1) > CONE_COS)
    hit_bwd = rng_j & (torch.sum(xij_unit * unit_normal[nb.idx], -1) > CONE_COS)
    cone_hit = torch.any(hit_fwd, dim=1) | (
        segment_reduce(nb, hit_bwd.to(torch.float32), "max", 0.0) > 0.5)

    insufficient = nb.count < (2 * 2 - 1)
    symmetric = norm2 < 1e-5
    near_boundary = torch.zeros_like(symmetric)
    dist_b = bnd.distance_to_boundary(bt)
    if not params.boundary_is_fluid_surface and dist_b is not None:
        # the raw h: zero under uniform sizes, where the test never fires
        near_boundary = dist_b < h * 1.5
    interior = ~insufficient & (symmetric | near_boundary | cone_hit)
    surface = ~interior & alive
    return torch.zeros_like(mass), surface, surface, insufficient & alive


def detect_surface_center_diff(nb: Neighborhood, cache: EdgeCache, position, mass, alive,
                               params: SimulationParams):
    """CenterDiff; returns (level, has_level, surface)."""
    rho0 = params.rest_density
    vol_j = cache.mass_j / rho0
    wv_f = cache.w * vol_j
    vol_i = (mass / rho0)[:, None]
    wv_b = cache.w * vol_i
    pos_j = position[nb.idx]
    sums = reduce_edges(
        nb,
        fwd={"w_sum": wv_f, "avg_center": wv_f[..., None] * pos_j,
             "avg_radius": wv_f * kernels.sphere_volume_to_radius(vol_j, dim=2)},
        bwd={"w_sum": wv_b, "avg_center": wv_b[..., None] * position[:, None, :],
             "avg_radius": wv_b * kernels.sphere_volume_to_radius(vol_i, dim=2)},
    )
    w_sum = torch.clamp(sums["w_sum"], min=1e-30)
    avg_radius = sums["avg_radius"] / w_sum
    surface_level = -0.85 * avg_radius
    avg_center = sums["avg_center"] / w_sum[:, None]
    phi_initial = sqrt(r2(position - avg_center)) - avg_radius
    phi = torch.where(nb.count < 5, surface_level, phi_initial)
    is_surface = phi >= surface_level
    level = torch.where(is_surface, phi, torch.zeros_like(phi))
    return level, is_surface & alive, is_surface & alive


def propagate_levels(nb: Neighborhood, cache: EdgeCache, mass, alive, level, has_level, stash,
                     params: SimulationParams):
    """Wavefront propagation to a fixed point; assigned particles keep their
    value. With FillStashWith::SurfaceDistanceMiddle the stash takes the
    field after the first sweep. Returns (level, has_level, stash)."""
    rng_i, rng_j = _range_masks(nb, cache, mass, params)
    fwd_ok = nb.mask & rng_i
    neg = _full(cache.r, NEG_INF)

    def one_sweep(level, has_level):
        est_f = torch.where(fwd_ok & has_level[nb.idx], level[nb.idx] - cache.r, neg)
        est = torch.max(est_f, dim=1).values
        # reversed edges: j receives level_i - r when i is assigned
        est_b = torch.where(rng_j & has_level[:, None], level[:, None] - cache.r, neg)
        est = torch.maximum(est, segment_reduce(nb, est_b, "max", NEG_INF))
        newly = ~has_level & (est > NEG_INF * 0.5) & alive
        return torch.where(newly, est, level), has_level | newly, torch.any(newly)

    level, has_level, changed = one_sweep(level, has_level)
    if params.fill_stash_with == FillStashWith.SurfaceDistanceMiddle:
        stash = torch.where(has_level, level, _full(level, -float(params.maximum_surface_distance)))
    while bool(changed):  # one host read per sweep
        level, has_level, changed = one_sweep(level, has_level)
    return level, has_level, stash


def smooth_level_field(nb: Neighborhood, cache: EdgeCache, mass, density, level, has_level,
                       params: SimulationParams):
    """Volume-weighted SPH smoothing of the clamped level field over the
    filtered neighbourhood with this step's densities (cache has rho_j)."""
    max_depth = -float(params.maximum_surface_distance)
    lvl = torch.where(has_level, torch.clamp(level, min=max_depth), _full(level, max_depth))
    vw_f = cache.mass_j / cache.rho_j * cache.w
    vw_b = (mass / density)[:, None] * cache.w
    sums = reduce_edges(nb, fwd={"level": lvl[nb.idx] * vw_f, "weight": vw_f},
                        bwd={"level": lvl[:, None] * vw_b, "weight": vw_b})
    new_level = sums["level"] / torch.clamp(sums["weight"], min=1e-30)
    return new_level, torch.ones_like(has_level)


def perform_level_estimation(nb: Neighborhood, cache: EdgeCache, bt, position, mass, h, alive,
                             stash, params: SimulationParams):
    """Detection and propagation; returns (level, has_level, flag_surface,
    flag_insufficient, stash)."""
    if params.level_estimation_method == LevelEstimationMethod.NoneMethod:
        z = torch.zeros_like(mass)
        f = torch.zeros_like(alive)
        return z, f, f, f, stash
    if params.level_estimation_method == LevelEstimationMethod.EmptyAngle:
        level, has_level, flag_surface, flag_insufficient = detect_surface_empty_angle(
            nb, cache, bt, mass, h, alive, params)
    else:
        level, has_level, flag_surface = detect_surface_center_diff(nb, cache, position, mass,
                                                                    alive, params)
        flag_insufficient = torch.zeros_like(flag_surface)
    if params.fill_stash_with == FillStashWith.SurfaceDistanceFirstIteration:
        stash = torch.where(has_level, level, _full(level, -float(params.maximum_surface_distance)))
    level, has_level, stash = propagate_levels(nb, cache, mass, alive, level, has_level, stash,
                                               params)
    return level, has_level, flag_surface, flag_insufficient, stash
