"""Per-step functions of both backends.

Counterpart of adaptive_sph_tpu/models/simulation.py. There is no jit: the
returned functions run one step eagerly. With adaptive sizes and resampling
on, the physics step is followed by the adaptivity step (share, then merge
or split).

- The tile backend (`make_step_fn`, `make_two_phase_step_fns`): the step of
  models/tile_step.py; partner matching runs on the tile layout.
- The neighbour-list backend (`single_step_without_adaptivity`,
  `make_list_step_fn`): the reference's list step in plain torch over
  ops/neighbors.py, ops/pairwise.py and ops/edge_cache.py, independent of
  the tile walk and its kernels; partner matching runs over the physics
  step's lists. It serves `backend="lists"` and the one setting the tile
  engine refuses: levels after advection without the extended range, which
  the reference estimates over the stale pre-advection pair set.
- The dense grid engine (`make_grid_step_fn`): the step of
  models/grid_step.py, plain torch; with resampling, partner matching runs
  over a neighbour list built at the support radius after the step.
"""

from __future__ import annotations

import torch

from .. import spans
from ..ops import kernels
from ..ops import neighbors as nbr
from ..ops.edge_cache import build_edge_cache, reduce_edges, with_density
from ..ops.numerics import sqrt
from ..utils.params import (
    LevelEstimationMethod,
    ParticleSizes,
    SimulationParams,
    SupportLengthEstimation,
)
from . import adaptivity as adapt
from . import boundary as bnd
from . import debug_checks
from . import level as level_mod
from . import physics, solver
from .grid_step import single_step_grid
from .state import FluidState
from .tile_step import single_step_tiles


def make_two_phase_step_fns(params: SimulationParams, boundary_handler, split_patterns,
                            tile_cfg):
    """Physics-only step and a separate adaptivity step (the image exporter's
    order: physics step, the frames of the step's window, then resampling, so
    that the census never changes inside an interpolation window).

    physics_fn(state, emit_prev_pos=True) -> (state, diag); diag carries "dt"
        and, with emit_prev_pos, "pos_prev" (start-of-step positions in the
        returned order);
    adaptivity_fn(state, dt, step_number) -> (state, adiag); step_number: the
        host's count of steps taken, the physics step included (its parity
        picks merge or split without a read). Without resampling it returns
        the state unchanged and no diagnostics.

    The phases run under the spans "tile-step" and "adaptivity"
    (adaptive_sph_torch/spans.py)."""
    resampling = params.particle_sizes == ParticleSizes.Adaptive and (
        params.sharing or params.merging or params.splitting)

    def physics_fn(state: FluidState, emit_prev_pos: bool = True):
        with spans.span("tile-step"):
            state, _, diag = single_step_tiles(state, params, tile_cfg, boundary_handler,
                                               emit_prev_pos=emit_prev_pos)
        return state, diag

    def adaptivity_fn(state: FluidState, dt, step_number: int):
        if not resampling:
            return state, {}

        def partner_fn(st, cls, mode):
            return adapt.find_partners_tiles(st, tile_cfg, cls, dt, params, mode)

        with spans.span("adaptivity"):
            return adapt.single_step_adaptivity(state, dt, params, split_patterns, partner_fn,
                                                step_number)

    return physics_fn, adaptivity_fn


def make_step_fn(params: SimulationParams, boundary_handler, tile_cfg, split_patterns=None):
    """step(state, step_number) -> (state, diag): the two phases fused.
    step_number: the host's count of steps once this one is done (the value
    the state's step_number reaches), so its parity is known without a read."""
    physics_fn, adaptivity_fn = make_two_phase_step_fns(params, boundary_handler,
                                                        split_patterns, tile_cfg)

    def step(state: FluidState, step_number: int):
        state, diag = physics_fn(state, emit_prev_pos=False)
        state, adiag = adaptivity_fn(state, diag["dt"], step_number)
        diag.update(adiag)
        return state, diag

    return step


# ---------------------------------------------------------------------------
# The neighbour-list backend


def estimate_h_next_from_distribution(nb, cache, bt, mass, h, params: SimulationParams,
                                      clamping_factor):
    """V_est = (1 - min(lambda, 0.5)) / sum_j W_ij, blended 50/50 with the
    old h; clamped to clamping_factor x h(mass) when given."""
    w_sum = reduce_edges(nb, cache.w, cache.w)
    bv = bnd.lambda_sum(bt)
    if bv is None:
        bv = torch.zeros_like(w_sum)  # the particle boundary has no lambda
    volume = (1.0 - torch.clamp(bv, max=0.5)) / torch.clamp(w_sum, min=1e-30)
    h_next = 0.5 * (kernels.ETA * kernels.sphere_volume_to_radius(volume, dim=2)) + 0.5 * h
    if clamping_factor is not None:
        h_next = torch.minimum(h_next, clamping_factor * kernels.smoothing_length_from_mass(
            mass, params.rest_density, 2))
    return h_next


def estimate_h_next_from_distribution2(nb, cache, bt, mass, h, params: SimulationParams):
    """V_est = V_i / (sum_j V_j W_ij + lambda), blended 50/50 with the old h."""
    rho0 = params.rest_density
    v_w_sum = reduce_edges(nb, cache.mass_j / rho0 * cache.w, (mass / rho0)[:, None] * cache.w)
    bv = bnd.lambda_sum(bt)
    if bv is None:
        bv = torch.zeros_like(v_w_sum)
    volume = (mass / rho0) / torch.clamp(v_w_sum + bv, min=1e-30)
    return 0.5 * (kernels.ETA * kernels.sphere_volume_to_radius(volume, dim=2)) + 0.5 * h


def _masked_rows(mask, a, fill):
    m = mask[:, None] if a.ndim == 2 else mask
    return torch.where(m, a, torch.full_like(a, fill))


def single_step_without_adaptivity(state: FluidState, params: SimulationParams,
                                   ncfg: nbr.NeighborConfig, boundary_handler):
    """One step of the list backend without resampling, in the reference's
    stage order: h, the neighbour search (at the extended range with level
    estimation before advection, then filtered down), h_next, the
    neighbourhood constraint, the boundary terms, dt, density, the constant
    field, a_ii (and the opt-in checks), the solve and integration, level
    estimation after advection, the level smoothing. The particle order is
    kept. Returns (state, nb, dt, diag); nb is the physics neighbourhood,
    built at the start-of-step positions."""
    diag = {}
    adaptive = params.particle_sizes == ParticleSizes.Adaptive
    sle = params.support_length_estimation
    if adaptive and sle == SupportLengthEstimation.FromMass:
        h = kernels.smoothing_length_from_mass(state.mass, params.rest_density, 2)
    elif adaptive:
        h = state.h_next  # the distribution estimate of the previous step
    else:
        h = state.h
    h_next = state.h_next
    h_eff = physics.effective_h(h, params)
    alive, pos, mass = state.alive, state.position, state.mass
    support = kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH

    level, has_level, stash = state.level, state.has_level, state.stash
    flag_surface = state.flag_is_fluid_surface
    flag_insufficient = state.flag_insufficient_neighs
    do_levels = params.level_estimation_active()
    ext_scale = params.level_estimation_range / kernels.ETA
    if do_levels and not params.level_estimation_after_advection:
        if not params.use_extended_range_for_level_estimation:
            raise NotImplementedError("levels before advection need the extended range, as in "
                                      "the reference")
        if params.level_estimation_method == LevelEstimationMethod.CenterDiff:
            raise NotImplementedError("CenterDiff needs the post-advection densities")
        nb = nbr.build_neighborhood(pos, h_eff, alive, ext_scale, ncfg)
        bt_lvl = boundary_handler.update_after_advect(pos, h, params)
        # the near-boundary interior test takes the raw h (zero under uniform
        # sizes, where it never fires)
        level, has_level, flag_surface, flag_insufficient, stash = (
            level_mod.perform_level_estimation(nb, build_edge_cache(nb, pos, h_eff, mass), bt_lvl,
                                               pos, mass, h, alive, stash, params))
        nb = nbr.filter_down(nb, pos, h_eff, alive, support, ncfg.levels)
    else:
        nb = nbr.build_neighborhood(pos, h_eff, alive, support, ncfg)
    neighbor_count = nb.count
    diag["neighbor_overflow"] = (nb.row_overflow, nb.cell_overflow, nb.level_overflow)
    cache = build_edge_cache(nb, pos, h_eff, mass)

    # the boundary terms before the h_next estimate, which reads their lambda
    bt = boundary_handler.update_after_advect(pos, h, params)
    if adaptive and sle != SupportLengthEstimation.FromMass:
        if sle == SupportLengthEstimation.FromDistribution2:
            h_next = estimate_h_next_from_distribution2(nb, cache, bt, mass, h_eff, params)
        else:
            clamp = {SupportLengthEstimation.FromDistribution: None,
                     SupportLengthEstimation.FromDistributionClamped1: 1.0,
                     SupportLengthEstimation.FromDistributionClamped2: 2.0}[sle]
            h_next = estimate_h_next_from_distribution(nb, cache, bt, mass, h_eff, params, clamp)

    # the neighbourhood-count constraint: shed the excess neighbours by
    # shrinking h to the fringe 2 |x_ij| - sr_j of the k-th farthest
    flag_reduced = state.flag_neighborhood_reduced
    if adaptive and params.constrain_neighborhood_count:
        target = int(kernels.optimal_neighbor_number(2)) + 5
        need = alive & (nb.count > target)
        dist = sqrt(nbr.r2(pos[:, None, :] - pos[nb.idx]) + 1e-30)
        fringe = torch.where(nb.mask, 2.0 * dist - h_eff[nb.idx] * support,
                             torch.full_like(dist, float("-inf")))
        fringe_sorted = torch.sort(fringe, dim=1, descending=True).values
        k = torch.clamp(nb.count - target, 0, fringe.shape[1] - 1).long()
        h_constrained = torch.clamp(torch.gather(fringe_sorted, 1, k[:, None])[:, 0], min=0.0)
        # the reference overwrites h_next wholesale and swaps
        h_next = h
        h = torch.where(need, h_constrained, h)
        h_eff = physics.effective_h(h, params)
        flag_reduced = need
        cache = build_edge_cache(nb, pos, h_eff, mass)

    dt = physics.cfl_dt(state.velocity, h, alive, params)
    diag["dt"] = dt

    density = physics.compute_density(nb, cache, bt, pos, h_eff, params, mass)
    density = torch.where(alive, density, torch.ones_like(density))
    cache = with_density(cache, nb, density)
    bst = bnd.solver_terms(bt, pos, h, params)
    constant_field = physics.compute_constant_field(nb, cache, bt, pos, h_eff, params, mass,
                                                    density)
    aii = physics.compute_aii(nb, cache, bt, bst, mass, density, params)
    aii = torch.where(alive, aii, torch.zeros_like(aii))
    diag["negative_aii"] = torch.sum(alive & (aii < 0.0))
    if params.check_aii:
        diag["aii_deviation"] = debug_checks.check_aii_deviation(nb, bt, pos, mass, density, h_eff,
                                                                 aii, alive, params)
    if params.check_neighborhood:
        eng = debug_checks.list_neighbor_count(nb, pos, h_eff)
        ref = debug_checks.bruteforce_neighbor_count(pos, h_eff, alive, support)
        diag["neighborhood_check_mismatch"] = torch.sum(
            torch.where(alive, torch.abs(eng - ref), torch.zeros_like(eng)))

    st = state.replace(density=density, aii=aii, h=h)
    new, sdiag = solver.solve_and_integrate(nb, cache, bst, st, h_eff, dt, params)
    diag.update(sdiag)
    pos2 = torch.where(alive[:, None], new["position"], pos)
    vel2 = torch.where(alive[:, None], new["velocity"], state.velocity)

    if params.level_estimation_after_advection and do_levels:
        if params.use_extended_range_for_level_estimation:
            nb_lvl = nbr.build_neighborhood(pos2, h_eff, alive, ext_scale, ncfg)
        else:
            nb_lvl = nb  # the stale pre-advection pair set
        lvl_cache = build_edge_cache(nb_lvl, pos2, h_eff, mass)
        bt2 = boundary_handler.update_after_advect(pos2, h, params)
        level, has_level, flag_surface, flag_insufficient, stash = (
            level_mod.perform_level_estimation(nb_lvl, lvl_cache, bt2, pos2, mass, h, alive,
                                               stash, params))
        nb_smooth, smooth_cache = nb_lvl, with_density(lvl_cache, nb_lvl, density)
    else:
        # the reference smooths at the advected positions over the
        # pre-advection lists
        nb_smooth = nb
        smooth_cache = with_density(build_edge_cache(nb, pos2, h_eff, mass), nb, density)

    level_old = state.level_old
    if do_levels:
        level, has_level = level_mod.smooth_level_field(nb_smooth, smooth_cache, mass, density,
                                                        level, has_level, params)
        level_old = level

    fields = dict(
        position=pos2, velocity=vel2,
        pressure=_masked_rows(alive, new["pressure"], 0.0),
        pressure_accel=_masked_rows(alive, new["pressure_accel"], 0.0),
        ppe_source_term=_masked_rows(alive, new["ppe_source_term"], 0.0),
        density_error=new["density_error"], omega=new["omega"], density=density, aii=aii,
        constant_field=constant_field, h=h, h_next=h_next, level=level, has_level=has_level,
        level_old=level_old, neighbor_count=neighbor_count, flag_is_fluid_surface=flag_surface,
        flag_insufficient_neighs=flag_insufficient, flag_neighborhood_reduced=flag_reduced,
        stash=stash, time=state.time + dt, step_number=state.step_number + 1)
    # pressure_div is not kept, as in the reference's list step: its
    # divergence solve warm-starts from the initial zeros
    return state.replace(**fields), nb, dt, diag


def make_list_step_fn(params: SimulationParams, boundary_handler, ncfg: nbr.NeighborConfig,
                      split_patterns=None):
    """step(state, step_number) -> (state, diag) on the list backend: the
    physics step, then (with resampling) share and merge or split, whose
    partner matching runs over the physics step's neighbourhood (built at
    the start-of-step positions) at the advected positions, as the
    reference's list step does."""
    resampling = params.particle_sizes == ParticleSizes.Adaptive and (
        params.sharing or params.merging or params.splitting)

    def step(state: FluidState, step_number: int):
        state, nb, dt, diag = single_step_without_adaptivity(state, params, ncfg,
                                                             boundary_handler)
        if resampling:
            def partner_fn(st, cls, mode):
                return adapt._find_partners(st, nb, cls, dt, params, mode)

            state, adiag = adapt.single_step_adaptivity(state, dt, params, split_patterns,
                                                        partner_fn, step_number)
            diag.update(adiag)
        return state, diag

    return step


def make_grid_step_fn(params: SimulationParams, boundary_handler, grid_cfg,
                      ncfg: nbr.NeighborConfig, split_patterns=None):
    """step(state, step_number) -> (state, diag) on the dense grid engine:
    `single_step_grid`, then (with resampling) share and merge or split over
    a neighbour list built at the support radius from the advected state,
    as the reference's grid branch does."""
    resampling = params.particle_sizes == ParticleSizes.Adaptive and (
        params.sharing or params.merging or params.splitting)
    support = kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH

    def step(state: FluidState, step_number: int):
        state, dt, diag = single_step_grid(state, params, grid_cfg, boundary_handler)
        if resampling:
            nb = nbr.build_neighborhood(state.position, physics.effective_h(state.h, params),
                                        state.alive, support, ncfg)

            def partner_fn(st, cls, mode):
                return adapt._find_partners(st, nb, cls, dt, params, mode)

            state, adiag = adapt.single_step_adaptivity(state, dt, params, split_patterns,
                                                        partner_fn, step_number)
            diag.update(adiag)
        return state, diag

    return step
