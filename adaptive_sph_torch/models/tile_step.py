"""Tile-backend step: one pair walk per step, then the pressure solves.

Counterpart of `single_step_tiles` in adaptive_sph_tpu/models/tile_step.py
for the configuration the port supports (runner.check_supported): adaptive
sizes (h from the mass, or from the particle distribution by any of its four
estimators) or uniform sizes, EmptyAngle level estimation before advection,
EmptyAngle or CenterDiff after it (or none), the stash, the diagnostic
fields, the neighbourhood-count constraint, check_aii and
check_neighborhood, ApproxLaplace or WCSPH viscosity, the
ConsistentSimpleGradient, ConsistentSymmetricGradient or Winchenbach2020
discretization, SDF or no boundary, `pull_fluid_to`; HybridDFSPH (its
non-pressure step before or after the divergence solve), IISPH, IISPH2 or
OnlyDivergence. Stage order per step:

  1. h from the mass or the previous step's h_next; one sort into the tile
     layout (build_tiles, sort_fields, window_meta)
  2. boundary terms
  3. level estimation before advection (when active): COUNT, normal and
     cone sweeps at the extended range, then wavefront sweeps to a fixed
     point (pair_sweep); the stash before or after the first of them.
     Then, each when asked for: the diagnostic neighbour count;
     check_neighborhood (the COUNT sweep against models/debug_checks.py);
     h_next from the particle distribution (the h_w_sum or h_vw_sum sweep);
     the neighbourhood-count constraint (30 fringe_count sweeps of a
     bisection, the new h, the boundary terms again)
  4. the CFL dt
  5. the pair walk, on one of the reference's two branches:
     - mega (the default): one K1 pair_build walk gives the pair weights, the
       a_ii sums, the density sum and the viscosity pair factors; then the
       density and the viscosity stream (K3 pair_visc). With
       ASPH_SCALAR_BLOCKS=1 at tq = 128 the list stores one scalar per pair
       and the streams are K2s / K3s (pair_matvec_scalar, pair_visc_scalar),
       as the reference's opt-in scalar-g blocks;
     - classic (`resident_solver`, ASPH_RESIDENT_SOLVER=1 or Winchenbach2020,
       whatever the momentum): the DENSITY pair_sweep, then K1 in classic
       mode (pair weights, the a_ii sums and their w / rho_j variants, the
       inline viscosity)
     - sweep-only (ASPH_NO_WCACHE=1, read at every step as the reference
       reads it; it overrides both): the DENSITY pair_sweep, then the prep
       sweep (the a_ii sums and the first kick's viscosity) or, with the kick
       after the divergence solve, the aii_sums sweep; no pair list
     - clique (the patch-major layout, tcfg.patch > 0, which the runner
       sets under ASPH_CLIQUE): build_halo, then clique_build (the
       same-level weight blocks, a_ii sums and density, ops/cliques.py);
       with more than one populated level K1 in the mega mode over the
       cross_only windows gives the cross-level list and its sums; the
       viscosity is clique_visc plus K3 on the cross list. Every other pair
       sum walks the patch rows with pair_sweep
     The walk's viscosity is the first non-pressure kick's; with HybridDFSPH's
     non-pressure step after the divergence solve the walk has none.
  6. a_ii assembly (and check_aii's sweep), the constant-field sweep, the
     non-pressure kick (viscosity, gravity, the pull)
  7. the solves: HybridDFSPH's divergence solve, velocity kick (then, with
     the non-pressure step after it, the `visc` pair_sweep over the new
     velocities) and density solve; IISPH's density solve; IISPH2's (the
     `omega` pair_sweep, the clamped Omega, the 1 / Omega source, p / sqrt
     Omega); OnlyDivergence's divergence solve. Classic branch with
     `resident_solver`, momentum 0, inside the reference's capacity gate:
     one whole-solve kernel launch per solve (ops/jacobi.py: pair_hybrid
     for HybridDFSPH with the non-pressure step first, else pair_jacobi,
     with the source computed in the kernel where the reference does; the
     Winchenbach2020 divergence in their w2020 mode). Otherwise:
     tile_jacobi over K2 pair_matvec (or K2s), one host read per iteration;
     on the sweep-only branch over an accel and a div pair_sweep; on the
     clique branch over the CliqueOperator's batched products and K2 on
     the cross list.
  8. integration
  9. level smoothing at the advected positions (when active; pair_sweep);
     with levels after advection, a second layout at the advected
     positions, detection, propagation and smoothing over its pairs, and
     the results unsorted back to the step's order

The returned state is in this step's sorted order (no unsort), exactly as the
reference returns it, so the next step starts from the same order.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .. import spans
from ..ops import cliques, jacobi, kernels, pair_ops
from ..ops.numerics import div_const, fma, rdiv, sqrt
from ..ops.sweeps import NEG_BIG, pair_sweep
from ..ops.tiles import (
    TileConfig,
    build_halo,
    build_tiles,
    sort_fields,
    unsort,
    window_meta,
    window_ranges,
)
from ..utils.params import (
    FillStashWith,
    HybridDfsphDensitySourceTerm,
    LevelEstimationMethod,
    OperatorDiscretization,
    ParticleSizes,
    PressureSolverMethod,
    SimulationParams,
    SupportLengthEstimation,
    ViscosityType,
)
from . import boundary as bnd
from . import debug_checks
from . import grid_physics as gp
from . import tile_physics as tp
from .solver import DENSITY_ERROR, DIVERGENCE_ERROR, SINGULAR_AII_EPS
from .state import SIZE_LARGE, FluidState


def physics_scale(params) -> float:
    """Radius scale of the physics pair set (support radius / h)."""
    return kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH


def max_scale(params: SimulationParams) -> float:
    """The largest radius scale any pair walk of the step uses."""
    s = kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH
    if params.level_estimation_active() and not params.level_estimation_after_advection:
        s = max(s, params.level_estimation_range / kernels.ETA)
    elif params.level_estimation_active() and params.use_extended_range_for_level_estimation:
        s = max(s, params.level_estimation_range / kernels.ETA)
    return s


def step_geometry(state: FluidState, params: SimulationParams, tcfg: TileConfig, owned=None):
    """Stage 1: smoothing lengths (from the mass, or the previous step's
    estimate from the particle distribution), the sorted layout and the
    sorted columns.

    Returns (h_eff, bins, cols, wm): cols maps a name to its sorted column
    (a view of one gathered table); cols["flat"] is the walk's contiguous
    (C, 6) candidate table [x, y, h_eff, m, vx, vy]. owned (the slab
    decomposition's owned rows) rides the same gather as cols["owned"]."""
    adaptive = params.particle_sizes == ParticleSizes.Adaptive
    if adaptive and params.support_length_estimation == SupportLengthEstimation.FromMass:
        h = kernels.smoothing_length_from_mass(state.mass, params.rest_density, 2)
    elif adaptive:  # the previous step's estimate from the particle distribution
        h = state.h_next
    else:
        h = state.h
    h_next = state.h_next
    h_eff = h if adaptive else torch.full_like(h, params.h)

    bins = build_tiles(state.position, h_eff * tcfg.mscale, h_eff, state.alive, tcfg)

    # column order matters: [pos, h_eff, mass, vel] is the walk's table
    names, fields = [], []

    def add(name, arr):
        names.append((name, 1 if arr.ndim == 1 else arr.shape[1]))
        fields.append(arr)

    add("pos", state.position)
    add("h_eff", h_eff)
    add("mass", state.mass)
    add("vel", state.velocity)
    add("h_raw", h)
    add("omega", state.omega)
    add("level", state.level)
    add("has_level", state.has_level)
    add("size_class", state.size_class)
    if params.warm_start_pressure:
        add("pressure", state.pressure)
        add("pressure_div", state.pressure_div)
    add("h_next", h_next)
    if owned is not None:
        add("owned", owned)
    table = sort_fields(bins, fields)
    cols, a = {}, 0
    for name, width in names:
        cols[name] = table[:, a] if width == 1 else table[:, a:a + width]
        a += width
    cols["flat"] = table[:, 0:6].contiguous()
    wm = window_meta(tcfg, bins, table[:, 0:4])
    return h_eff, bins, cols, wm


def single_step_tiles(state: FluidState, params: SimulationParams, tcfg: TileConfig,
                      boundary_handler, emit_prev_pos: bool = False, halo=None):
    """One full step. Returns (new_state, dt, diag); diag values are tensors
    (read once by the runner) except the solver iteration counts (ints).

    The returned state is in this step's sorted order. emit_prev_pos adds
    diag["pos_prev"], the start-of-step positions in that order, so that the
    video exporter can interpolate frames across the step. Its stages run
    under the spans of adaptive_sph_torch/spans.py: neighborhood,
    boundary-terms, level-estimation (with its wavefront sweeps),
    pair-build, div-solver, density-solver and, for the resident HybridDFSPH
    launch that runs both solves, hybrid-solvers.

    halo: a rank's HaloHooks (parallel/tile_sharding.py) in the slab
    decomposition, or None on one device. Its owned rows restrict the
    reductions and the solves' statistics; its refresh pulls the ghost rows'
    values from their owners before the wavefront sweeps, after the density,
    before every pair-list product and before the smoothing sweep; psum /
    pmin / pmax make every diagnostic and every host decision global;
    diag["_owned_sorted"] is the owned mask in the returned order. The
    tcfg's origin is the rank's own. Under halo the resident flag runs the
    classic branch with the streamed solves, as the reference gates its
    resident kernel off there; scalar-g storage and levels after advection
    raise."""
    diag = {}
    with spans.span("neighborhood"):
        h_eff, bins, cols, wm = step_geometry(state, params, tcfg,
                                              owned=None if halo is None else halo.owned)
    if halo is None:
        diag["neighbor_overflow"] = (bins.overflow, torch.zeros_like(bins.overflow),
                                     bins.level_overflow)
    else:
        ov = halo.psum(torch.stack([bins.overflow, bins.level_overflow]))
        diag["neighbor_overflow"] = (ov[0], torch.zeros_like(ov[0]), ov[1])
    warm = bool(params.warm_start_pressure)

    px_s, py_s = cols["pos"][:, 0], cols["pos"][:, 1]
    pos_s = cols["pos"]
    h_s = cols["h_eff"]
    mass_s = cols["mass"]
    h_raw_s = cols["h_raw"]
    vx_s, vy_s = cols["vel"][:, 0], cols["vel"][:, 1]
    alive_s = h_s > 0.0
    zero_s = torch.zeros_like(h_s)
    pscale = float(physics_scale(params))
    if halo is None:
        owned_s, refresh = alive_s, None
        psum = pmin = pmax = _identity
    else:
        owned_s, refresh = cols["owned"] > 0.5, halo.make_refresher(bins)
        psum, pmin, pmax = halo.psum, halo.pmin, halo.pmax

    adaptive = params.particle_sizes == ParticleSizes.Adaptive
    rest = params.rest_density

    def boundary_terms(h_raw):
        """The boundary terms on the sorted positions: (kind, Gx, Gy, the
        density term, the distance to the boundary, the lambda sum)."""
        with spans.span("boundary-terms"):
            h_safe = torch.clamp(h_raw, min=1e-6)
            bt = boundary_handler.update_after_advect(pos_s, h_safe, params)
            bst = bnd.solver_terms(bt, pos_s, h_safe, params)
            lam = bnd.lambda_sum(bt)
            return (bt.kind, torch.where(alive_s, bst.G[:, 0], zero_s),
                    torch.where(alive_s, bst.G[:, 1], zero_s),
                    torch.where(alive_s, bnd.density_boundary_term(bt, pos_s, h_safe, params),
                                zero_s),
                    bnd.distance_to_boundary(bt),
                    zero_s if lam is None else torch.where(alive_s, lam, zero_s))

    bt_kind, Gx_s, Gy_s, bdens_s, dist_b, lam_s = boundary_terms(h_raw_s)

    # level estimation before advection, at the extended range
    st = cols["flat"][:, 0:4].contiguous()

    def sweep(op, dyn, scale):
        # reads `st` when called: the neighbourhood constraint replaces it
        return pair_sweep(bins.cell_starts, wm, st, dyn, op, scale, tcfg.tq)

    do_levels = params.level_estimation_active()
    after_advection = do_levels and params.level_estimation_after_advection
    if after_advection and halo is not None:
        raise NotImplementedError("the slab-decomposed step does not run level estimation "
                                  "after advection (the reference asserts it away)")
    ext_scale = float(params.level_estimation_range / kernels.ETA)
    stash_s = None
    if do_levels and not after_advection:
        with spans.span("level-estimation"):
            level_s, has_s, surf_s, insuf_s, stash_s, n_wave = _level_estimation(
                sweep, ext_scale, px_s, py_s, dist_b, h_raw_s, alive_s, params,
                refresh=refresh, psum=None if halo is None else psum)
        diag["wavefront_sweeps"] = n_wave

    # the diagnostic neighbour count at the physics radius
    ncount_s = sweep(tp.COUNT_OP, None, pscale)[:, 0] if params.force_diagnostic_fields else None

    # check_neighborhood: the walk's pair count against a brute-force count
    if params.check_neighborhood:
        eng = sweep(tp.COUNT_OP, None, pscale)[:, 0].to(torch.int32)
        ref_cnt = debug_checks.bruteforce_neighbor_count(pos_s, h_s, alive_s, pscale)
        diag["neighborhood_check_mismatch"] = psum(torch.sum(
            torch.where(owned_s, torch.abs(eng - ref_cnt), torch.zeros_like(eng))))

    # h_next from the particle distribution (unsorted with the state)
    hn_s = None
    if adaptive and params.support_length_estimation != SupportLengthEstimation.FromMass:
        hn_s = _h_next_distribution(sweep, st, lam_s, params, pscale)

    # the neighbourhood-count constraint: each particle above the target count
    # shrinks h to its k-th largest fringe 2 r_ij - 2 h_j, found by 30 bisection
    # sweeps of fringe_count (no host read); the windows stay supersets
    flag_reduced_s = None
    if adaptive and params.constrain_neighborhood_count:
        srbs = kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH
        target_n = float(int(kernels.optimal_neighbor_number(2)) + 5)
        count_n = sweep(tp.COUNT_OP, None, pscale)[:, 0]
        need = alive_s & (count_n > target_n)
        m_pos = torch.clamp(count_n - target_n, min=0.0)  # 0-indexed descending rank
        h_max_all = pmax(torch.max(torch.where(alive_s, h_s, zero_s)))
        lo = (-(h_max_all * srbs)).expand_as(h_s)
        hi = (2.0 * pscale * h_max_all).expand_as(h_s)
        for _ in range(30):
            mid = 0.5 * (lo + hi)
            gt = sweep(tp.FRINGE_COUNT_OP, mid[:, None], pscale)[:, 0] > m_pos
            lo, hi = torch.where(gt, mid, lo), torch.where(gt, hi, mid)
        # h_next <- the old h (any distribution estimate is discarded), h <-
        # the constrained h where the count was above the target
        hn_s = h_raw_s
        h_raw_s = torch.where(need, torch.clamp(hi, min=0.0), h_raw_s)
        h_s = h_raw_s  # adaptive: h_eff == h
        st = torch.cat([pos_s, h_raw_s[:, None], mass_s[:, None]], dim=1)
        flag_reduced_s = need
        bt_kind, Gx_s, Gy_s, bdens_s, dist_b, _ = boundary_terms(h_raw_s)

    # the CFL dt; after the constraint from the sorted h
    if flag_reduced_s is not None:
        sr_s = h_raw_s * kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH
        val = torch.where(owned_s, sr_s * sr_s / (fma(vx_s, vx_s, vy_s * vy_s) + 0.01),
                          torch.full_like(sr_s, float("inf")))
    else:
        sr = h_eff * kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH
        v2 = torch.sum(state.velocity * state.velocity, dim=-1)
        owned_flat = state.alive if halo is None else state.alive & halo.owned
        val = torch.where(owned_flat, sr * sr / (v2 + 0.01), torch.full_like(sr, float("inf")))
    dt = torch.clamp(params.cfl_factor * sqrt(pmin(torch.min(val))), max=float(params.max_dt))
    diag["dt"] = dt

    # the pair walk. `resident_solver` (or ASPH_RESIDENT_SOLVER=1, read at
    # every step as the reference reads it) and the Winchenbach2020
    # discretization turn the reference's mega branch off (its need_s2),
    # whether or not the whole-solve kernels can then run: the classic branch
    # is a density sweep, then K1 in classic mode with the inline viscosity.
    # Otherwise the mega branch: one walk that also sums the density, then the
    # viscosity stream. The whole-solve kernels have no momentum and the
    # reference's capacity gate; else the classic branch's solves stream over
    # K2. The walk's viscosity (ApproxLaplace or WCSPH) is the first
    # non-pressure kick's; with HybridDFSPH's non-pressure step after the
    # divergence solve it walks none, and a `visc` sweep runs between the
    # solves instead.
    method = params.pressure_solver_method
    first_np_at_start = (method != PressureSolverMethod.HybridDFSPH
                         or params.hybrid_dfsph_non_pressure_accel_before_divergence_free)
    if first_np_at_start and params.viscosity_type == ViscosityType.WCSPH:
        vm = "wcsph"
    elif first_np_at_start and params.viscosity_type == ViscosityType.ApproxLaplace:
        vm = "laplace"
    else:
        vm = "none"
    nu = float(params.viscosity)
    w2020 = params.operator_discretization == OperatorDiscretization.Winchenbach2020
    wdtype = torch.bfloat16 if params.weight_cache_bf16 else torch.float32
    resident_flag = (bool(params.resident_solver)
                     or os.environ.get("ASPH_RESIDENT_SOLVER", "0") == "1")
    # ASPH_NO_WCACHE=1 (read at every step, as the reference reads it): the
    # sweep-only branch, no pair list; neither the whole-solve kernels nor
    # scalar-g storage then run, whatever their settings say
    sweep_only = os.environ.get("ASPH_NO_WCACHE", "0") == "1"
    classic = resident_flag or w2020
    # the slab step streams its solves: the whole-solve kernels would need the
    # ghost rows refreshed inside their sweeps
    resident = (not sweep_only and halo is None and resident_flag
                and params.jacobi_momentum == 0.0
                and jacobi.resident_supported(tcfg.capacity, tcfg.tq, wdtype))
    # the reference's opt-in scalar-g storage (mega branch at tq = 128 only)
    scalar = (not sweep_only and not classic and pair_ops.scalar_blocks_supported(tcfg.tq)
              and os.environ.get("ASPH_SCALAR_BLOCKS", "0") == "1")
    if scalar and halo is not None:
        raise NotImplementedError("the slab-decomposed step does not run scalar-g storage "
                                  "(ASPH_SCALAR_BLOCKS=1)")
    diag["wcache_overflow"] = torch.zeros_like(bins.overflow)  # CSR is sized exactly
    # the clique branch (the runner sets tcfg.patch only where the reference
    # takes it: one device, the mega branch)
    clique = tcfg.patch > 0
    if clique and (halo is not None or sweep_only or classic):
        raise ValueError("the patch-major layout runs on one device on the mega branch only "
                         "(no slab halo, ASPH_NO_WCACHE, resident_solver or Winchenbach2020)")
    csr = clq = None
    if clique:
        visc_stream = vm != "none" and nu != 0.0
        hs_map, halo_ovf = build_halo(tcfg, bins, st)
        cwx, cwy, s1x, s1y, s1sq, den = cliques.clique_build(hs_map, st, pscale, wdtype)
        cross = None
        if len(tcfg.populated) > 1:
            # the cross-level pairs: K1 over the other levels' windows
            wm_cross = window_ranges(tcfg, bins, st, cross_only=True)[0]
            flat = cols["flat"] if flag_reduced_s is None else torch.cat(
                [st, cols["flat"][:, 4:6]], dim=1)
            with spans.span("pair-build"):
                cross = pair_ops.pair_build(bins.cell_starts, wm_cross, flat, tcfg.tq, pscale,
                                            nu, visc_stream, wdtype, wcsph=vm == "wcsph")
            s1x, s1y, s1sq = s1x + cross.prep[0], s1y + cross.prep[1], s1sq + cross.prep[2]
            den = den + cross.prep[3]
        diag["clique_overflow"] = halo_ovf
        clq = cliques.CliqueOperator(wx=cwx, wy=cwy, halo_src=hs_map, cross=cross)
        rho_s = torch.where(alive_s, den + bdens_s, torch.ones_like(den))
        s2x = s2y = s2sq = zero_s
        if visc_stream:
            visc_x, visc_y = cliques.clique_visc(hs_map, st, vx_s, vy_s, rho_s, pscale, vm, nu)
            if cross is not None:
                cvx, cvy = pair_ops.pair_visc(cross, rho_s)
                visc_x, visc_y = visc_x + cvx, visc_y + cvy
        else:
            visc_x = visc_y = zero_s
    elif sweep_only:
        # the DENSITY sweep, then one sweep for the a_ii sums (and the first
        # kick's viscosity when that kick comes first); no pair list
        rho_s = sweep(tp.DENSITY_OP, None, pscale)[:, 0] + bdens_s
        rho_s = torch.where(alive_s, rho_s, torch.ones_like(rho_s))
        if refresh is not None:  # the ghost rows' densities from their owners
            rho_s = refresh(rho_s)
        if first_np_at_start:
            prep = sweep(tp.prep_op(params), torch.stack([rho_s, vx_s, vy_s], dim=1), pscale)
            visc_x, visc_y = prep[:, 6], prep[:, 7]
        else:
            prep = sweep(tp.AII_SUMS_OP, rho_s, pscale)
            visc_x = visc_y = zero_s
        s1x, s1y, s1sq, s2x, s2y, s2sq = prep[:, 0:6].unbind(1)
    elif classic:
        rho_s = sweep(tp.DENSITY_OP, None, pscale)[:, 0] + bdens_s
        rho_s = torch.where(alive_s, rho_s, torch.ones_like(rho_s))
        if refresh is not None:  # the ghost rows' densities from their owners
            rho_s = refresh(rho_s)
        cand = torch.cat([st, rho_s[:, None], cols["flat"][:, 4:6]], dim=1)
        with spans.span("pair-build"):
            csr = pair_ops.pair_build(bins.cell_starts, wm, cand, tcfg.tq, pscale,
                                      nu if vm != "none" else 0.0, False, wdtype, classic=True,
                                      wcsph=vm == "wcsph")
        s2x, s2y, s2sq = csr.prep[3], csr.prep[4], csr.prep[5]
        visc_x, visc_y = csr.prep[6], csr.prep[7]
    else:
        visc_stream = vm != "none" and nu != 0.0
        # the walk's table [x, y, h, m, vx, vy], with the constrained h
        flat = cols["flat"] if flag_reduced_s is None else torch.cat(
            [st, cols["flat"][:, 4:6]], dim=1)
        with spans.span("pair-build"):
            csr = pair_ops.pair_build(bins.cell_starts, wm, flat, tcfg.tq, pscale, nu,
                                      visc_stream, wdtype, scalar=scalar, wcsph=vm == "wcsph")
        rho_s = csr.prep[3] + bdens_s
        rho_s = torch.where(alive_s, rho_s, torch.ones_like(rho_s))
        if refresh is not None:  # the ghost rows' densities from their owners
            rho_s = refresh(rho_s)
        s2x = s2y = s2sq = zero_s
        if visc_stream:
            visc = pair_ops.pair_visc_scalar if scalar else pair_ops.pair_visc
            visc_x, visc_y = visc(csr, rho_s)
        else:
            visc_x = visc_y = zero_s
    if csr is not None:
        s1x, s1y, s1sq = csr.prep[0], csr.prep[1], csr.prep[2]
    matvec = pair_ops.pair_matvec_scalar if scalar else pair_ops.pair_matvec

    aii_s = gp.assemble_aii_1d(s1x, s1y, s1sq, s2x, s2y, s2sq,
                               {"rho": rho_s, "mass": mass_s}, Gx_s, Gy_s, bt_kind, params)
    aii_s = torch.where(alive_s, aii_s, zero_s)
    diag["negative_aii"] = psum(torch.sum(owned_s & (aii_s < 0.0)))

    # the constant-field diagnostic: sum_j m_j / rho_j W_ij plus the boundary's share
    cf_s = None
    if params.force_diagnostic_fields:
        cf_s = sweep(tp.CONSTANT_FIELD_OP, rho_s, pscale)[:, 0] + div_const(bdens_s, rest)

    # check_aii: a_ii against the divergence of the acceleration that a unit
    # self pressure gives (a brute-force sweep over the pairs)
    if params.check_aii:
        rr2 = torch.clamp(rho_s * rho_s, min=1e-30)
        bux, buy = gp.boundary_accel_slots_1d(Gx_s, Gy_s, torch.ones_like(rho_s), rho_s,
                                              bt_kind, params)
        acsx = -s1x / rr2 + bux
        acsy = -s1y / rr2 + buy
        fluid_div = sweep(tp.check_aii_op(w2020), torch.stack([rho_s, acsx, acsy], dim=1),
                          pscale)[:, 0]
        if not w2020:
            fluid_div = fluid_div / torch.clamp(rho_s, min=1e-30)
        aii_real = fluid_div + gp.boundary_div_slots_1d(Gx_s, Gy_s, acsx, acsy, rho_s,
                                                         bt_kind, params)
        diag["aii_deviation"] = pmax(torch.max(torch.where(owned_s, torch.abs(aii_real - aii_s),
                                                           zero_s)))

    g = params.gravity_vector(2)
    pull = params.pull_fluid_to

    def finish_nonpressure(viscx, viscy):
        """The non-pressure acceleration: viscosity, gravity and the pull
        towards `pull_fluid_to` (13 / |d| d)."""
        ax = viscx + float(g[0])
        ay = viscy + float(g[1])
        if pull is not None:
            dx = float(np.float32(pull[0])) - px_s
            dy = float(np.float32(pull[1])) - py_s
            inv = rdiv(13.0, torch.clamp(sqrt(dx * dx + dy * dy), min=1e-9))
            ax = ax + dx * inv
            ay = ay + dy * inv
        return ax, ay

    def nonpressure(vx, vy):
        """The non-pressure kick after the divergence solve: the viscosity of
        the post-divergence velocities by the `visc` sweep."""
        vis = sweep(tp.visc_op(params), torch.stack([rho_s, vx, vy], dim=1), pscale)
        ax, ay = finish_nonpressure(vis[:, 0], vis[:, 1])
        return vx + dt * ax, vy + dt * ay

    # the non-pressure kick before the solves (the walk's viscosity)
    if first_np_at_start:
        ax0, ay0 = finish_nonpressure(visc_x, visc_y)
        v2x, v2y = vx_s + dt * ax0, vy_s + dt * ay0
    else:  # the columns of the sorted table are strided views; the kernels take dense rows
        v2x, v2y = vx_s.contiguous(), vy_s.contiguous()

    rho_inv = rdiv(1.0, torch.clamp(rho_s, min=1e-30))

    def accel_fn_sweep(p):
        # the pair acceleration as one accel sweep over (rho, p)
        if refresh is not None:
            p = refresh(p)
        a = sweep(tp.ACCEL_OP, torch.stack([rho_s, p], dim=1), pscale)
        bx, by = gp.boundary_accel_slots_1d(Gx_s, Gy_s, p, rho_s, bt_kind, params)
        return a[:, 0] + bx, a[:, 1] + by

    def div_fn_sweep(qx, qy):
        # the divergence as one div sweep over (rho, qx, qy), the ghost rows
        # refreshed first; divided by rho_i unless Winchenbach2020
        q = torch.stack([qx, qy], dim=1)
        if refresh is not None:
            q = refresh(q)
        s = sweep(tp.div_op(w2020), torch.stack([rho_s, q[:, 0], q[:, 1]], dim=1),
                  pscale)[:, 0]
        if not w2020:
            s = s / torch.clamp(rho_s, min=1e-30)
        return s + gp.boundary_div_slots_1d(Gx_s, Gy_s, qx, qy, rho_s, bt_kind, params)

    def accel_fn(p):
        if refresh is not None:
            p = refresh(p)
        u = p * rho_inv * rho_inv
        mvx, mvy = matvec(csr, u, k_out=2)
        bx, by = gp.boundary_accel_slots_1d(Gx_s, Gy_s, p, rho_s, bt_kind, params)
        return -u * s1x - mvx + bx, -u * s1y - mvy + by

    def accel_fn_clique(p):
        u = p * rho_inv * rho_inv
        mvx, mvy = clq.matvec2(u)
        bx, by = gp.boundary_accel_slots_1d(Gx_s, Gy_s, p, rho_s, bt_kind, params)
        return -u * s1x - mvx + bx, -u * s1y - mvy + by

    def div_fn_clique(qx, qy):
        s = (clq.matvec_div(qx, qy) - (qx * s1x + qy * s1y)) * rho_inv
        return s + gp.boundary_div_slots_1d(Gx_s, Gy_s, qx, qy, rho_s, bt_kind, params)

    def div_fn(qx, qy):
        # the ghost rows before the product (their neighbours read them); the
        # row terms only feed owned rows, which the refresh leaves alone
        if refresh is None:
            tx, ty = qx, qy
        else:  # the kernels take dense columns
            t = refresh(torch.stack([qx, qy], dim=1))
            tx, ty = t[:, 0].contiguous(), t[:, 1].contiguous()
        if w2020:
            # K2 over t = q / rho, minus q . S2
            s = matvec(csr, (tx * rho_inv, ty * rho_inv), k_out=1) - (qx * s2x + qy * s2y)
        else:
            s = (matvec(csr, (tx, ty), k_out=1) - (qx * s1x + qy * s1y)) * rho_inv
        return s + gp.boundary_div_slots_1d(Gx_s, Gy_s, qx, qy, rho_s, bt_kind, params)

    if sweep_only:
        accel_fn, div_fn = accel_fn_sweep, div_fn_sweep
    elif clique:
        accel_fn, div_fn = accel_fn_clique, div_fn_clique

    def solve(src, tol, rtype, p0, vel=None, omega_inv=None):
        """vel=(vx, vy) only on the resident path: the kernel then computes
        src - div(vel) * omega_inv / dt itself and the return is
        (SolveResult, full_src)."""
        if resident:
            return tp.tile_jacobi_resident(csr, aii_s, src, alive_s, tol, rtype, params, dt,
                                           rho_s, rho_inv, s1x, s1y, s2x, s2y, Gx_s, Gy_s,
                                           bt_kind, p0=p0, vel=vel, omega_inv=omega_inv)
        return tp.tile_jacobi(accel_fn, div_fn, aii_s, src, owned_s, tol, rtype, params, dt,
                              rho_s, p0=p0, psum=None if halo is None else psum,
                              pmax=None if halo is None else pmax)

    # the density source's rho~: rest density under Winchenbach2020, else rho
    next_rho = torch.full_like(rho_s, rest) if w2020 else rho_s

    def src_density():
        return -(rest - rho_s) / (next_rho * dt * dt)

    omega_s = torch.where(alive_s, cols["omega"], torch.ones_like(rho_s))
    p_prev_s = cols["pressure"] if warm else None
    pdiv_prev_s = pdiv_s = cols["pressure_div"] if warm else None
    iisph2 = method == PressureSolverMethod.IISPH2
    if method in (PressureSolverMethod.IISPH, PressureSolverMethod.IISPH2,
                  PressureSolverMethod.OnlyDivergence):
        iisph = method != PressureSolverMethod.OnlyDivergence
        omgi = None
        if iisph2:
            omega_s = _omega(sweep(tp.OMEGA_OP, None, pscale)[:, 0], h_s, rho_s, mass_s,
                             cols["size_class"])
            if warm:
                p_prev_s = p_prev_s * sqrt(omega_s)
            src_v = -(rest - rho_s) / (rest * dt * dt)
            omgi = rdiv(1.0, omega_s)
        if iisph:
            tol, rtype = params.iisph_max_avg_density_error, DENSITY_ERROR
            src_v = src_v if iisph2 else src_density()
        else:
            tol, rtype = params.hybrid_dfsph_max_avg_divergence_error, DIVERGENCE_ERROR
            src_v = zero_s
        with spans.span("density-solver" if iisph else "div-solver"):
            if resident:
                res, src_s = solve(src_v, tol, rtype, p_prev_s, vel=(v2x, v2y), omega_inv=omgi)
            else:
                if iisph2:
                    src_s = src_v - div_fn(v2x, v2y) / (dt * omega_s)
                else:
                    src_s = src_v - div_fn(v2x, v2y) / dt
                res = solve(src_s, tol, rtype, p_prev_s)
        pressure_s = res.pressure
        ax_sv, ay_sv = res.pressure_accel
        if iisph2:
            pressure_s = pressure_s / sqrt(omega_s)
            ax_sv, ay_sv = accel_fn(pressure_s)
        v2x = v2x + dt * ax_sv
        v2y = v2y + dt * ay_sv
        p2x = px_s + dt * v2x
        p2y = py_s + dt * v2y
        kind = "density" if iisph else "div"
        diag[f"{kind}_iterations"] = res.iterations
        diag[f"{kind}_avg_error"] = res.avg_error
        if iisph:
            diag["density_max_error"] = res.max_error
        res_den = res
    else:  # HybridDFSPH: divergence solve, velocity kick, density solve
        den_with_div = (params.hybrid_dfsph_density_source_term
                        == HybridDfsphDensitySourceTerm.DensityAndDivergence)
        if resident and first_np_at_start:
            with spans.span("hybrid-solvers"):
                res_div, res_den, v2x, v2y, src_s = tp.tile_hybrid_resident(
                    csr, aii_s, alive_s, params, dt, rho_s, rho_inv, s1x, s1y, s2x, s2y, Gx_s,
                    Gy_s, bt_kind, v2x, v2y, den_with_div, p0_div=pdiv_prev_s, p0_den=p_prev_s)
        else:
            with spans.span("div-solver"):
                src = -div_fn(v2x, v2y) / dt
                res_div = solve(src, params.hybrid_dfsph_max_avg_divergence_error,
                                DIVERGENCE_ERROR, pdiv_prev_s)
            adx, ady = res_div.pressure_accel
            v2x = v2x + dt * adx
            v2y = v2y + dt * ady
            if not first_np_at_start:
                v2x, v2y = nonpressure(v2x, v2y)
            with spans.span("density-solver"):
                src_s = src_density() - div_fn(v2x, v2y) / dt if den_with_div else src_density()
                res_den = solve(src_s, params.hybrid_dfsph_max_avg_density_error,
                                DENSITY_ERROR, p_prev_s)
        diag["div_iterations"] = res_div.iterations
        diag["div_avg_error"] = res_div.avg_error
        diag["density_iterations"] = res_den.iterations
        diag["density_avg_error"] = res_den.avg_error
        diag["density_max_error"] = res_den.max_error
        # unclamped residual statistics over every alive non-singular particle
        ns = owned_s & (torch.abs(aii_s) >= SINGULAR_AII_EPS)
        err_sum = torch.sum(torch.where(ns, res_den.density_error, zero_s))
        if halo is None:
            nn = torch.clamp(torch.sum(ns), min=1).to(torch.float32)
        else:  # the sum and the count in one reduction (the count is exact in float32)
            err_sum, nn = psum(torch.stack([err_sum, torch.sum(ns).to(torch.float32)])).unbind()
            nn = torch.clamp(nn, min=1.0)
        diag["density_avg_error_all"] = err_sum / nn
        diag["density_max_error_all"] = pmax(torch.max(
            torch.where(ns, torch.abs(res_den.density_error), zero_s)))
        ax_sv, ay_sv = res_den.pressure_accel
        p2x = px_s + dt * v2x + dt * dt * ax_sv
        p2y = py_s + dt * v2y + dt * dt * ay_sv
        blend = torch.clamp(dt * params.hybrid_dfsph_factor, max=1.0)
        v2x = v2x + dt * ax_sv * blend
        v2y = v2y + dt * ay_sv * blend
        pdiv_s = res_div.pressure
        pressure_s = res_den.pressure
    diag["solver_stats"] = (res_den.normal_count, res_den.singular_count,
                            res_den.negative_count)

    # the returned state IS the sorted layout; empty slots read zeros/fills
    def msk(v, fill=0.0):
        return torch.where(alive_s, v, torch.full_like(v, fill))

    false_s = torch.zeros_like(alive_s)
    max_depth = -float(params.maximum_surface_distance)
    if after_advection:
        # level estimation after advection: a second layout at the advected
        # positions, at the extended range; detection, propagation and the
        # smoothing run over its pairs and map back to this step's order
        with spans.span("level-estimation"):
            sm_s, surf_s, insuf_s, stash_s, n_wave = _levels_after_advection(
                torch.stack([p2x, p2y], dim=1), st[:, 2].contiguous(), mass_s, h_raw_s, rho_s,
                alive_s, params, tcfg, boundary_handler, ext_scale, diag)
        diag["wavefront_sweeps"] = n_wave
    elif do_levels:
        # level smoothing over this step's pair set, W at the advected positions
        with spans.span("level-estimation"):
            dist_s = torch.where(has_s, torch.clamp(level_s, min=max_depth),
                                 torch.full_like(level_s, max_depth))
            if refresh is None:
                dyn = torch.stack([rho_s, dist_s, p2x, p2y], dim=1)
            else:  # rho_s was refreshed after the density
                dyn = torch.cat([rho_s[:, None],
                                 refresh(torch.stack([dist_s, p2x, p2y], dim=1))], dim=1)
            sm = sweep(tp.SMOOTH_OP, dyn, pscale)
            sm_s = sm[:, 0] / torch.clamp(sm[:, 1], min=1e-30)
    if do_levels:
        level_out = msk(sm_s)
        has_out = alive_s
        surf_out, insuf_out = surf_s & alive_s, insuf_s & alive_s
    else:
        level_out = msk(cols["level"])
        has_out = (cols["has_level"] > 0.5) & alive_s
        surf_out = insuf_out = false_s
    new_state = state.replace(
        mass=msk(mass_s),
        position=torch.stack([msk(p2x), msk(p2y)], dim=1),
        velocity=torch.stack([msk(v2x), msk(v2y)], dim=1),
        pressure=msk(pressure_s),
        pressure_div=msk(pdiv_s) if warm else zero_s,
        stash=zero_s if stash_s is None else msk(stash_s),
        pressure_accel=torch.stack([msk(ax_sv), msk(ay_sv)], dim=1),
        ppe_source_term=msk(src_s),
        density_error=msk(res_den.density_error),
        omega=msk(omega_s, 1.0),
        density=msk(rho_s, 1.0),
        aii=msk(aii_s),
        constant_field=zero_s if cf_s is None else msk(cf_s),
        h=msk(h_raw_s),
        h_next=msk(cols["h_next"] if hn_s is None else hn_s),
        level=level_out,
        has_level=has_out,
        level_old=level_out,
        size_class=msk(cols["size_class"]).to(torch.int32),
        neighbor_count=(torch.zeros_like(alive_s, dtype=torch.int32) if ncount_s is None
                        else msk(ncount_s).to(torch.int32)),
        flag_is_fluid_surface=surf_out,
        flag_insufficient_neighs=insuf_out,
        flag_neighborhood_reduced=false_s if flag_reduced_s is None else flag_reduced_s & alive_s,
        alive=alive_s,
        time=state.time + dt,
        step_number=state.step_number + 1,
    )
    # the stored list's pairs: none on the sweep-only branch, the cross-level
    # list's on the clique branch (its same-level blocks are dense)
    if clique:
        diag["num_pairs"] = 0 if clq.cross is None else clq.cross.num_pairs
    else:
        diag["num_pairs"] = 0 if csr is None else csr.num_pairs
    if emit_prev_pos:
        diag["pos_prev"] = torch.stack([msk(px_s), msk(py_s)], dim=1)
    if halo is not None:
        diag["_owned_sorted"] = owned_s
    return new_state, dt, diag


def _identity(x):
    return x


def _omega(sum_term, h_s, rho_s, mass_s, size_class_s):
    """IISPH2's Omega = 1 + H / (3 rho) sum_j m_j dW/dH (the omega sweep's
    sum; a particle of size class LARGE takes its self term alone), clamped
    to [0.125, 2.5]."""
    H = h_s * kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH
    f = H / (3.0 * torch.clamp(rho_s, min=1e-30))
    omega_neigh = 1.0 + f * sum_term
    omega_large = 1.0 + f * (mass_s * kernels.kernel_dw_dH(torch.zeros_like(H), H, 2))
    return torch.clamp(torch.where(size_class_s == float(SIZE_LARGE), omega_large, omega_neigh),
                       0.125, 2.5)


def _level_estimation(sweep, ext_scale, px_s, py_s, dist_b, h_raw_s, alive_s,
                      params: SimulationParams, refresh=None, psum=None):
    """Surface detection (EmptyAngle or CenterDiff) and wavefront propagation
    in sorted space.

    Returns (level, has, is_surface, flag_insufficient, stash or None,
    wavefront sweeps). The stash takes the levels before the first wavefront
    sweep (SurfaceDistanceFirstIteration) or after it (SurfaceDistanceMiddle).
    The reference propagates in an on-device while-loop; here the host reads
    the "changed" flag once per wavefront sweep.

    refresh / psum: the slab hooks (EmptyAngle only; CenterDiff runs after
    advection, which the slab step refuses): the ghost rows take their
    owners' surface flags and, before each wavefront sweep, levels; the
    "changed" flag is summed over the ranks, so that every rank runs the
    same number of sweeps."""
    if params.level_estimation_method == LevelEstimationMethod.CenterDiff:
        # phi = |x - the volume-weighted mean neighbour position| - the mean
        # neighbour radius
        cd = sweep(tp.centerdiff_op(params), None, ext_scale)
        count = sweep(tp.COUNT_OP, None, ext_scale)[:, 0]
        w_sum = torch.clamp(cd[:, 0], min=1e-30)
        avg_radius = cd[:, 3] / w_sum
        surface_level = -0.85 * avg_radius
        ex = px_s - cd[:, 1] / w_sum
        ey = py_s - cd[:, 2] / w_sum
        phi = sqrt(fma(ex, ex, ey * ey)) - avg_radius
        phi = torch.where(count < 5, surface_level, phi)
        is_surface = (phi >= surface_level) & alive_s
        level = torch.where(is_surface, phi, torch.zeros_like(phi))
        insufficient = torch.zeros_like(is_surface)
    else:
        count = sweep(tp.COUNT_OP, None, ext_scale)[:, 0]
        nrm = sweep(tp.normal_op(params), None, ext_scale)
        nx, ny = nrm[:, 0], nrm[:, 1]
        norm2 = nx * nx + ny * ny
        inv = rdiv(1.0, sqrt(torch.clamp(norm2, min=1e-30)))
        cone = sweep(tp.cone_op(params), torch.stack([nx * inv, ny * inv], dim=1),
                     ext_scale)[:, 0] > 0.5

        insufficient = count < (2 * 2 - 1)
        symmetric = norm2 < 1e-5
        near_boundary = torch.zeros_like(symmetric)
        if (not params.boundary_is_fluid_surface) and dist_b is not None:
            near_boundary = dist_b < h_raw_s * 1.5
        is_interior = (~insufficient) & (symmetric | near_boundary | cone)
        is_surface = (~is_interior) & alive_s
        if refresh is not None:
            is_surface = refresh(is_surface.to(torch.float32)) > 0.5
        level = torch.zeros_like(h_raw_s)
    wave_op = tp.wavefront_op(params)
    max_depth = torch.full_like(level, -float(params.maximum_surface_distance))

    def one_sweep(lvl, has):
        lh = torch.stack([lvl, has.to(torch.float32)], dim=1)
        if refresh is not None:
            lh = refresh(lh)
            lvl, has = lh[:, 0], lh[:, 1] > 0.5
        est = sweep(wave_op, lh, ext_scale)[:, 0]
        newly = (~has) & (est > NEG_BIG * 0.5) & alive_s
        changed = torch.any(newly) if psum is None else psum(torch.sum(newly)) > 0
        return torch.where(newly, est, lvl), has | newly, changed

    stash = None
    if params.fill_stash_with == FillStashWith.SurfaceDistanceFirstIteration:
        stash = torch.where(is_surface, level, max_depth)
    level, has, changed = one_sweep(level, is_surface)
    if params.fill_stash_with == FillStashWith.SurfaceDistanceMiddle:
        stash = torch.where(has, level, max_depth)
    n = 1
    while True:
        spans.reads["wavefront-exit"] += 1
        if not bool(changed):  # the sweep's one host read
            break
        level, has, changed = one_sweep(level, has)
        n += 1
    spans.set_sweeps(n)
    return level, has, is_surface, insufficient & alive_s, stash, n


def _levels_after_advection(pos2, h_eff_s, mass_s, h_raw_s, rho_s, alive_s,
                            params: SimulationParams, tcfg: TileConfig, boundary_handler,
                            ext_scale: float, diag: dict):
    """Level estimation at the advected positions `pos2` (the step's sorted
    order): a second tile layout at the extended range (its overflow added
    to diag["neighbor_overflow"]), detection and propagation over its pairs,
    then the smoothing over the same pairs. Returns (smoothed level, is
    surface, insufficient, stash or None, wavefront sweeps), mapped back to
    the step's order."""
    bins2 = build_tiles(pos2, h_eff_s * tcfg.mscale, h_eff_s, alive_s, tcfg)
    ro, co, lo = diag["neighbor_overflow"]
    diag["neighbor_overflow"] = (ro + bins2.overflow, co, lo + bins2.level_overflow)
    cols2 = sort_fields(bins2, [pos2, h_eff_s, mass_s, h_raw_s, rho_s])
    st2 = cols2[:, 0:4].contiguous()
    wm2 = window_meta(tcfg, bins2, st2)
    alive2 = st2[:, 2] > 0.0
    h_raw2, rho2 = cols2[:, 4], cols2[:, 5]

    def sweep2(op, dyn, scale):
        return pair_sweep(bins2.cell_starts, wm2, st2, dyn, op, scale, tcfg.tq)

    bt2 = boundary_handler.update_after_advect(st2[:, 0:2], torch.clamp(h_raw2, min=1e-6), params)
    level2, has2, surf2, insuf2, stash2, n_wave = _level_estimation(
        sweep2, ext_scale, st2[:, 0], st2[:, 1], bnd.distance_to_boundary(bt2), h_raw2, alive2,
        params)
    max_depth = -float(params.maximum_surface_distance)
    dist2 = torch.where(has2, torch.clamp(level2, min=max_depth),
                        torch.full_like(level2, max_depth))
    sm2 = sweep2(tp.SMOOTH_OP, torch.stack([rho2, dist2, st2[:, 0], st2[:, 1]], dim=1), ext_scale)
    back = [sm2[:, 0] / torch.clamp(sm2[:, 1], min=1e-30), surf2.to(torch.float32),
            insuf2.to(torch.float32)]
    if stash2 is not None:
        back.append(stash2)
    back = unsort(bins2, torch.stack(back, dim=1), 0.0)
    return (back[:, 0], back[:, 1] > 0.5, back[:, 2] > 0.5,
            back[:, 3] if stash2 is not None else None, n_wave)


def _h_next_distribution(sweep, st, lam_s, params: SimulationParams, pscale: float):
    """h_next from the particle distribution, in sorted space: h_new = ETA
    R(V), V = (1 - min(lambda, 0.5)) / sum_j W_ij (FromDistribution and its
    clamped variants) or V_i / (sum_j V_j W_ij + lambda) (FromDistribution2),
    lambda the boundary's occluded fraction; h_next = (h_new + h) / 2, clamped
    to the mass's h (Clamped1) or twice it (Clamped2)."""
    mode = params.support_length_estimation
    h_s, mass_s = st[:, 2], st[:, 3]
    rest = float(params.rest_density)
    if mode == SupportLengthEstimation.FromDistribution2:
        v_w_sum = sweep(tp.h_vw_sum_op(params), None, pscale)[:, 0]
        volume = div_const(mass_s, rest) / torch.clamp(v_w_sum + lam_s, min=1e-30)
    else:
        w_sum = sweep(tp.H_W_SUM_OP, None, pscale)[:, 0]
        volume = (1.0 - torch.clamp(lam_s, max=0.5)) / torch.clamp(w_sum, min=1e-30)
    h_next = 0.5 * (kernels.ETA * kernels.sphere_volume_to_radius(volume, 2)) + 0.5 * h_s
    if mode == SupportLengthEstimation.FromDistributionClamped1:
        h_next = torch.minimum(h_next, kernels.smoothing_length_from_mass(mass_s, rest, 2))
    elif mode == SupportLengthEstimation.FromDistributionClamped2:
        h_next = torch.minimum(h_next, 2.0 * kernels.smoothing_length_from_mass(mass_s, rest, 2))
    return h_next
