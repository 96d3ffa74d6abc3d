"""The dense grid engine's step (`backend="grid"`).

Counterpart of adaptive_sph_tpu/models/grid_step.py: the stage order and
semantics of the list step (models/simulation.py), with every pair sum a
`grid_pairs.pair_apply` over the dense grid windows. One binning per step,
with cells sized for the largest search radius, serves the extended level
estimation and the 2h physics sums through distance masks. Plain torch: the
reference's engine is XLA array code, so the step launches no kernel of the
port's library. The state comes back in the caller's particle order.

The reference's grid step ignores four settings without a word
(`constrain_neighborhood_count`, `check_aii`, `check_neighborhood`, levels
after advection) and asserts against CenterDiff before advection; the
runner refuses all five on this backend (`runner.check_supported`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import kernels
from ..ops.grid import GridConfig, build_bins, gather_result, scatter_field
from ..ops.numerics import div_const, sqrt
from ..utils.params import (
    FillStashWith,
    HybridDfsphDensitySourceTerm,
    LevelEstimationMethod,
    OperatorDiscretization,
    ParticleSizes,
    PressureSolverMethod,
    SimulationParams,
    SupportLengthEstimation,
)
from . import boundary as bnd
from . import grid_pairs
from . import grid_physics as gp
from .physics import cfl_dt, effective_h
from .solver import DENSITY_ERROR, DIVERGENCE_ERROR
from .state import FluidState
from .tile_step import max_scale, physics_scale  # noqa: F401  (the same scales as the tiles')

NEG_INF = float(np.float32(-3.0e38))
CONE_COS = float(np.float32(math.cos(50.0 * math.pi / 180.0)))


def supports_grid_backend(params: SimulationParams) -> bool:
    """The reference's gate (which its runner never calls): no neighbourhood
    constraint, no check_aii, no levels after advection."""
    if params.constrain_neighborhood_count or params.check_aii:
        return False
    if params.level_estimation_active() and params.level_estimation_after_advection:
        return False
    return True


def _range_ok(vi, vj, geom, params: SimulationParams):
    """The level-estimation neighbour range (FromDistribution modes only),
    receiver side: |x_ij| <= R(V_i) maximum_range."""
    if params.support_length_estimation not in (SupportLengthEstimation.FromDistribution,
                                                SupportLengthEstimation.FromDistribution2):
        return True
    radius = kernels.sphere_volume_to_radius(div_const(vi["mass"], params.rest_density), dim=2)
    return geom.r <= radius * params.maximum_range


def _count_edge(vi, vj, geom):
    return {"n": torch.ones_like(geom.r)}


def level_estimation_slots(cfg, bins, sf, ext_scale, dist_b_slots, params: SimulationParams):
    """EmptyAngle or CenterDiff surface detection and the wavefront
    propagation to a fixed point (one host read per sweep), in slot space.
    Returns (level, has, surface, insufficient, count, stash or None)."""
    alive_slots = bins.slot_mask
    count = grid_pairs.pair_apply(cfg, bins, sf, ext_scale, _count_edge)["n"]

    if params.level_estimation_method == LevelEstimationMethod.EmptyAngle:
        def normal_edge(vi, vj, geom):
            gw = gp.pair_grad(geom)
            return {"nrm": -div_const(vi["mass"], params.rest_density)[..., None] * gw}

        normal = grid_pairs.pair_apply(cfg, bins, sf, ext_scale, normal_edge)["nrm"]
        norm2 = gp.dot2(normal, normal)
        f2 = dict(sf)
        f2["un"] = normal / sqrt(torch.clamp(norm2, min=1e-30))[:, None]

        def cone_edge(vi, vj, geom):
            xji = -geom.diff / (geom.r + 1e-6)[..., None]
            hit = (gp.dot2(xji, vi["un"]) > CONE_COS) & _range_ok(vi, vj, geom, params)
            return {"hit": hit.to(torch.float32)}

        cone = grid_pairs.pair_apply(cfg, bins, f2, ext_scale, cone_edge, reduce="max",
                                     fill=0.0)["hit"] > 0.5
        insufficient = count < (2 * 2 - 1)
        symmetric = norm2 < 1e-5
        near_boundary = torch.zeros_like(symmetric)
        if not params.boundary_is_fluid_surface and dist_b_slots is not None:
            near_boundary = dist_b_slots < sf["h_raw"] * 1.5
        interior = ~insufficient & (symmetric | near_boundary | cone)
        is_surface = ~interior & alive_slots
        level = torch.zeros_like(sf["h"])
        flag_insufficient = insufficient & alive_slots
    else:  # CenterDiff
        def cd_edge(vi, vj, geom):
            vol_j = div_const(vj["mass"], params.rest_density)
            w = kernels.kernel_w(geom.r, geom.h_ij, dim=2) * vol_j
            return {"w_sum": w, "cx": w * vj["pos"][..., 0], "cy": w * vj["pos"][..., 1],
                    "ar": w * kernels.sphere_volume_to_radius(vol_j, dim=2)}

        s = grid_pairs.pair_apply(cfg, bins, sf, ext_scale, cd_edge)
        w_sum = torch.clamp(s["w_sum"], min=1e-30)
        avg_radius = s["ar"] / w_sum
        surface_level = -0.85 * avg_radius
        center = torch.stack([s["cx"], s["cy"]], -1) / w_sum[:, None]
        d = sf["pos"] - center
        phi = torch.where(count < 5, surface_level, sqrt(gp.dot2(d, d)) - avg_radius)
        is_surface = (phi >= surface_level) & alive_slots
        level = torch.where(is_surface, phi, torch.zeros_like(phi))
        flag_insufficient = torch.zeros_like(is_surface)
    has = is_surface

    def one_sweep(lvl, hasv):
        f = dict(sf)
        f["lvl"] = lvl
        f["has"] = hasv.to(torch.float32)

        def prop_edge(vi, vj, geom):
            ok = (vj["has"] > 0.5) & _range_ok(vi, vj, geom, params)
            return {"est": torch.where(ok, vj["lvl"] - geom.r,
                                       torch.full_like(geom.r, NEG_INF))}

        est = grid_pairs.pair_apply(cfg, bins, f, ext_scale, prop_edge, reduce="max",
                                    fill=NEG_INF)["est"]
        newly = ~hasv & (est > NEG_INF * 0.5) & alive_slots
        return torch.where(newly, est, lvl), hasv | newly, torch.any(newly)

    max_depth = -float(np.float32(params.maximum_surface_distance))
    stash = None
    if params.fill_stash_with == FillStashWith.SurfaceDistanceFirstIteration:
        stash = torch.where(has, level, torch.full_like(level, max_depth))
    level, has, changed = one_sweep(level, has)
    if params.fill_stash_with == FillStashWith.SurfaceDistanceMiddle:
        stash = torch.where(has, level, torch.full_like(level, max_depth))
    while bool(changed):  # one host read per sweep
        level, has, changed = one_sweep(level, has)
    return level, has, is_surface, flag_insufficient, count, stash


def smooth_level_slots(cfg, bins, sf, scale, level, has, params: SimulationParams):
    """Volume-weighted smoothing of the clamped level field at the physics
    radius. Pairs follow sf["pos_old"] (the pre-advection binning positions,
    the reference's stale lists) while the kernels see sf["pos"]."""
    max_depth = -float(np.float32(params.maximum_surface_distance))
    f = dict(sf)
    f["dist"] = torch.where(has, torch.clamp(level, min=max_depth),
                            torch.full_like(level, max_depth))

    def edge(vi, vj, geom):
        vw = vj["mass"] / torch.clamp(vj["rho"], min=1e-30) * kernels.kernel_w(geom.r, geom.h_ij, 2)
        return {"lvl": vj["dist"] * vw, "w": vw}

    mask_key = "pos_old" if "pos_old" in f else "pos"
    s = grid_pairs.pair_apply(cfg, bins, f, scale, edge, mask_pos_key=mask_key)
    return s["lvl"] / torch.clamp(s["w"], min=1e-30)


def h_next_distribution_slots(cfg, bins, sf, scale, bv_slots, params: SimulationParams, mode):
    """h_next from the particle distribution (the FromDistribution estimators)."""
    if mode == SupportLengthEstimation.FromDistribution2:
        def vw_edge(vi, vj, geom):
            return {"w": div_const(vj["mass"], params.rest_density)
                    * kernels.kernel_w(geom.r, geom.h_ij, 2)}

        v_w_sum = grid_pairs.pair_apply(cfg, bins, sf, scale, vw_edge)["w"]
        volume = div_const(sf["mass"], params.rest_density) / torch.clamp(v_w_sum + bv_slots,
                                                                         min=1e-30)
    else:
        def w_edge(vi, vj, geom):
            return {"w": kernels.kernel_w(geom.r, geom.h_ij, 2)}

        w_sum = grid_pairs.pair_apply(cfg, bins, sf, scale, w_edge)["w"]
        volume = (1.0 - torch.clamp(bv_slots, max=0.5)) / torch.clamp(w_sum, min=1e-30)
    h_next = 0.5 * (kernels.ETA * kernels.sphere_volume_to_radius(volume, dim=2)) + 0.5 * sf["h"]
    if mode == SupportLengthEstimation.FromDistributionClamped1:
        h_next = torch.minimum(h_next, kernels.smoothing_length_from_mass(
            sf["mass"], params.rest_density, 2))
    elif mode == SupportLengthEstimation.FromDistributionClamped2:
        h_next = torch.minimum(h_next, 2.0 * kernels.smoothing_length_from_mass(
            sf["mass"], params.rest_density, 2))
    return h_next


def _full(like, value):
    return torch.full_like(like, value)


def single_step_grid(state: FluidState, params: SimulationParams, gcfg: GridConfig,
                     boundary_handler):
    """One step on the dense grid engine, without resampling. Returns
    (state, dt, diag); the state keeps the particle order."""
    diag = {}
    adaptive = params.particle_sizes == ParticleSizes.Adaptive
    sle = params.support_length_estimation
    h_next = state.h_next
    if adaptive and sle == SupportLengthEstimation.FromMass:
        h = kernels.smoothing_length_from_mass(state.mass, params.rest_density, 2)
    elif adaptive:
        h = state.h_next  # the distribution estimate of the previous step
    else:
        h = state.h
    h_eff = effective_h(h, params)
    alive, pos = state.alive, state.position
    max_depth = -float(np.float32(params.maximum_surface_distance))

    # binning at the largest search radius serves every sweep of the step
    bins = build_bins(pos, h_eff * float(np.float32(max_scale(params))), alive, gcfg)
    zero_i = torch.zeros((), dtype=torch.int32, device=pos.device)
    diag["neighbor_overflow"] = (bins.overflow, zero_i, bins.level_overflow)

    def slots(field):
        return scatter_field(bins, gcfg, field)

    def flat(slot_values, fill=0.0):
        return gather_result(bins, gcfg, slot_values, fill)

    sf = {"pos": slots(pos), "h": slots(h_eff), "h_raw": slots(h), "mass": slots(state.mass)}
    alive_slots = bins.slot_mask
    binned = bins.slot_of >= 0
    pscale = physics_scale(params)
    ext_scale = float(np.float32(params.level_estimation_range / kernels.ETA))

    # the boundary terms, flat, then in slot space
    bt = boundary_handler.update_after_advect(pos, h, params)
    G_slots = slots(bnd.solver_terms(bt, pos, h, params).G)
    bdens_slots = slots(bnd.density_boundary_term(bt, pos, h, params))
    dist_b = bnd.distance_to_boundary(bt)
    dist_b_slots = slots(dist_b) if dist_b is not None else None
    lam = bnd.lambda_sum(bt)
    lam_slots = slots(lam) if lam is not None else torch.zeros_like(sf["h"])

    # level estimation before advection
    level_slots = slots(state.level)
    has_slots = slots(state.has_level)
    flag_surface = state.flag_is_fluid_surface
    flag_insufficient = state.flag_insufficient_neighs
    stash = state.stash
    do_levels = params.level_estimation_active()
    if do_levels and not params.level_estimation_after_advection:
        level_slots, has_slots, surf_slots, insuf_slots, _, stash_slots = level_estimation_slots(
            gcfg, bins, sf, ext_scale, dist_b_slots, params)
        flag_surface = flat(surf_slots, False) & alive
        flag_insufficient = flat(insuf_slots, False) & alive
        if stash_slots is not None:
            stash = torch.where(alive, flat(stash_slots, max_depth), state.stash)

    # the neighbour count at the physics radius (a diagnostic field)
    if params.force_diagnostic_fields:
        ncount_slots = grid_pairs.pair_apply(gcfg, bins, sf, pscale, _count_edge)["n"]
        neighbor_count = flat(ncount_slots, 0.0).to(torch.int32)
    else:
        neighbor_count = state.neighbor_count

    if adaptive and sle != SupportLengthEstimation.FromMass:
        hn_slots = h_next_distribution_slots(gcfg, bins, sf, pscale, lam_slots, params, sle)
        h_next = torch.where(alive & binned, flat(hn_slots, 0.0), state.h_next)

    dt = cfl_dt(state.velocity, h, alive, params)
    diag["dt"] = dt

    rho_slots = gp.density_slots(gcfg, bins, sf, pscale) + bdens_slots
    rho_slots = torch.where(alive_slots, rho_slots, torch.ones_like(rho_slots))
    sf["rho"] = rho_slots
    density = torch.where(alive, flat(rho_slots, 1.0), torch.ones_like(state.density))

    if params.force_diagnostic_fields:
        cf_slots = (gp.constant_field_slots(gcfg, bins, sf, pscale)
                    + div_const(bdens_slots, params.rest_density))
        constant_field = flat(cf_slots, 0.0)
    else:
        constant_field = state.constant_field

    # one fused sweep gives the a_ii sums and the first non-pressure kick's
    # viscosity, except for HybridDFSPH with the kick after the divergence solve
    vel_slots = slots(state.velocity)
    zero_q = torch.zeros(2, dtype=torch.float32, device=pos.device)
    method = params.pressure_solver_method
    warm = bool(params.warm_start_pressure)
    pdiv_slots = None
    first_np_at_start = (method != PressureSolverMethod.HybridDFSPH
                         or params.hybrid_dfsph_non_pressure_accel_before_divergence_free)
    if first_np_at_start:
        aii_sums, visc0 = gp.fused_prep_sweep(gcfg, bins, sf, pscale, vel_slots, params)
        aii_slots = gp.assemble_aii(aii_sums, sf, G_slots, bt.kind, params)
        first_np_vel = vel_slots + dt * gp.gravity_and_pull(visc0, sf["pos"], params)
    else:
        aii_slots = gp.aii_slots(gcfg, bins, sf, pscale, G_slots, bt.kind, params)
        first_np_vel = None
    aii_slots = torch.where(alive_slots, aii_slots, torch.zeros_like(aii_slots))
    aii = torch.where(alive, flat(aii_slots, 0.0), torch.zeros_like(state.aii))
    diag["negative_aii"] = torch.sum(alive & (aii < 0.0) & binned)

    def nonpressure(v):
        if first_np_vel is not None and v is vel_slots:
            return first_np_vel  # the fused sweep produced it
        return v + dt * gp.non_pressure_accel_slots(gcfg, bins, sf, pscale, v, params)

    omega_slots = slots(state.omega)
    pos_slots = sf["pos"]
    w2020 = params.operator_discretization == OperatorDiscretization.Winchenbach2020
    next_rho = torch.full_like(rho_slots, float(params.rest_density)) if w2020 else rho_slots

    def div_of_vel(v):
        return gp.divergence_slots(gcfg, bins, sf, pscale, v, zero_q, G_slots, bt.kind, params)

    def src_only_density():
        return -(params.rest_density - rho_slots) / (next_rho * dt * dt)

    def src_full(v):
        return src_only_density() - div_of_vel(v) / dt

    def solve(src, tol, residual, p0):
        return gp.jacobi_iterations_slots(gcfg, bins, sf, pscale, aii_slots, src, G_slots,
                                          bt.kind, alive_slots, tol, residual, params, dt, p0=p0)

    def stats(res):
        return (res.normal_count, res.singular_count, res.negative_count)

    if method in (PressureSolverMethod.IISPH, PressureSolverMethod.IISPH2):
        iisph2 = method == PressureSolverMethod.IISPH2
        if iisph2:
            omega_slots = gp.omega_iisph2_slots(gcfg, bins, sf, pscale, slots(state.size_class),
                                                params)
        vel_slots = nonpressure(vel_slots)
        if iisph2:
            src = (-(params.rest_density - rho_slots) / (params.rest_density * dt * dt)
                   - div_of_vel(vel_slots) / (dt * omega_slots))
        else:
            src = src_full(vel_slots)
        p0 = None
        if warm:
            p0 = slots(state.pressure)
            if iisph2:
                p0 = p0 * sqrt(omega_slots)
        res = solve(src, params.iisph_max_avg_density_error, DENSITY_ERROR, p0)
        pressure_slots, accel_slots = res.pressure, res.pressure_accel
        if iisph2:
            pressure_slots = pressure_slots / sqrt(omega_slots)
            accel_slots = gp.pressure_accel_slots(gcfg, bins, sf, pscale, pressure_slots,
                                                  G_slots, bt.kind, params)
        vel_slots = vel_slots + dt * accel_slots
        pos_slots = pos_slots + dt * vel_slots
        diag.update(density_iterations=res.iterations, density_avg_error=res.avg_error,
                    density_max_error=res.max_error, solver_stats=stats(res))
        src_slots, derr_slots = src, res.density_error
    elif method == PressureSolverMethod.OnlyDivergence:
        vel_slots = nonpressure(vel_slots)
        src = -div_of_vel(vel_slots) / dt
        res = solve(src, params.hybrid_dfsph_max_avg_divergence_error, DIVERGENCE_ERROR,
                    slots(state.pressure) if warm else None)
        vel_slots = vel_slots + dt * res.pressure_accel
        pos_slots = pos_slots + dt * vel_slots
        pressure_slots, accel_slots = res.pressure, res.pressure_accel
        diag.update(div_iterations=res.iterations, div_avg_error=res.avg_error,
                    solver_stats=stats(res))
        src_slots, derr_slots = src, res.density_error
    else:  # HybridDFSPH
        before = params.hybrid_dfsph_non_pressure_accel_before_divergence_free
        if before:
            vel_slots = nonpressure(vel_slots)
        src = -div_of_vel(vel_slots) / dt
        res_div = solve(src, params.hybrid_dfsph_max_avg_divergence_error, DIVERGENCE_ERROR,
                        slots(state.pressure_div) if warm else None)
        vel_slots = vel_slots + dt * res_div.pressure_accel
        diag.update(div_iterations=res_div.iterations, div_avg_error=res_div.avg_error)
        if not before:
            vel_slots = nonpressure(vel_slots)
        if (params.hybrid_dfsph_density_source_term
                == HybridDfsphDensitySourceTerm.DensityAndDivergence):
            src2 = src_full(vel_slots)
        else:
            src2 = src_only_density()
        res_den = solve(src2, params.hybrid_dfsph_max_avg_density_error, DENSITY_ERROR,
                        slots(state.pressure) if warm else None)
        diag.update(density_iterations=res_den.iterations, density_avg_error=res_den.avg_error,
                    density_max_error=res_den.max_error, solver_stats=stats(res_den))
        accel_slots = res_den.pressure_accel
        pos_slots = pos_slots + dt * vel_slots + dt * dt * accel_slots
        vel_slots = vel_slots + dt * accel_slots * torch.clamp(dt * params.hybrid_dfsph_factor,
                                                               max=1.0)
        pressure_slots = res_den.pressure
        src_slots, derr_slots = src2, res_den.density_error
        pdiv_slots = res_div.pressure if warm else None

    # level smoothing at the advected positions over the pre-advection binning
    level, has_level, level_old = state.level, state.has_level, state.level_old
    if do_levels:
        sf_smooth = dict(sf)
        sf_smooth["pos_old"] = sf["pos"]
        sf_smooth["pos"] = pos_slots
        sm_slots = smooth_level_slots(gcfg, bins, sf_smooth, pscale, level_slots, has_slots,
                                      params)
        level = torch.where(alive, flat(sm_slots, max_depth), torch.zeros_like(state.level))
        has_level = alive & binned
        level_old = level

    keep = (alive & binned)[:, None]
    pos2 = torch.where(keep, flat(pos_slots, 0.0), pos)
    vel2 = torch.where(keep, flat(vel_slots, 0.0), state.velocity)
    pressure_div = state.pressure_div
    if pdiv_slots is not None:
        pressure_div = torch.where(alive, flat(pdiv_slots, 0.0), torch.zeros_like(pressure_div))
    new_state = state.replace(
        position=pos2,
        velocity=vel2,
        pressure=flat(pressure_slots, 0.0),
        pressure_div=pressure_div,
        pressure_accel=flat(accel_slots, 0.0),
        ppe_source_term=flat(src_slots, 0.0),
        density_error=flat(derr_slots, 0.0),
        omega=torch.where(alive, flat(omega_slots, 1.0), torch.ones_like(state.omega)),
        density=density,
        aii=aii,
        constant_field=constant_field,
        stash=stash,
        h=h,
        h_next=h_next,
        level=level,
        has_level=has_level,
        level_old=level_old,
        neighbor_count=neighbor_count,
        flag_is_fluid_surface=flag_surface,
        flag_insufficient_neighs=flag_insufficient,
        time=state.time + dt,
        step_number=state.step_number + 1,
    )
    return new_state, dt, diag
