"""Tile-backend step: one pair walk per step, then the pressure solves.

Counterpart of `single_step_tiles` in adaptive_sph_tpu/models/tile_step.py
for the configuration the port supports (runner.check_supported): adaptive
sizes from mass or uniform sizes, EmptyAngle level estimation before
advection (or none), ApproxLaplace viscosity before the pressure solves,
ConsistentSimpleGradient, SDF or no boundary; HybridDFSPH, IISPH or
OnlyDivergence. Stage order per step:

  1. h from mass; one sort into the tile layout (build_tiles, sort_fields,
     window_meta)
  2. boundary terms
  3. level estimation (when active): COUNT, normal and cone sweeps at the
     extended range, then wavefront sweeps to a fixed point (pair_sweep)
  4. the CFL dt
  5. the pair walk, on one of the reference's two branches:
     - mega (the default): one K1 pair_build walk gives the pair weights, the
       a_ii sums, the density sum and the viscosity pair factors; then the
       density and the viscosity stream (K3 pair_visc). With
       ASPH_SCALAR_BLOCKS=1 at tq = 128 the list stores one scalar per pair
       and the streams are K2s / K3s (pair_matvec_scalar, pair_visc_scalar),
       as the reference's opt-in scalar-g blocks;
     - classic (`resident_solver` or ASPH_RESIDENT_SOLVER=1, whatever the
       momentum): the DENSITY
       pair_sweep, then K1 in classic mode (pair weights, the a_ii sums and
       their w / rho_j variants, the inline viscosity)
  6. a_ii assembly, the non-pressure kick
  7. the solves: HybridDFSPH's divergence solve, velocity kick and density
     solve; IISPH's density solve; OnlyDivergence's divergence solve. Classic
     branch with momentum 0 inside the reference's capacity gate: one
     whole-solve kernel launch (ops/jacobi.py: pair_hybrid for HybridDFSPH,
     pair_jacobi with the source computed in the kernel otherwise).
     Otherwise: tile_jacobi over K2 pair_matvec (or K2s), one host read per
     iteration.
  8. integration
  9. level smoothing at the advected positions (when active; pair_sweep)

The returned state is in this step's sorted order (no unsort), exactly as the
reference returns it, so the next step starts from the same order.
"""

from __future__ import annotations

import os

import torch

from ..ops import jacobi, kernels, pair_ops
from ..ops.numerics import rdiv, sqrt
from ..ops.sweeps import NEG_BIG, pair_sweep
from ..ops.tiles import TileConfig, build_tiles, sort_fields, window_meta
from ..utils.params import (
    HybridDfsphDensitySourceTerm,
    ParticleSizes,
    PressureSolverMethod,
    SimulationParams,
    ViscosityType,
)
from . import boundary as bnd
from . import grid_physics as gp
from . import tile_physics as tp
from .solver import DENSITY_ERROR, DIVERGENCE_ERROR, SINGULAR_AII_EPS
from .state import FluidState


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


def step_geometry(state: FluidState, params: SimulationParams, tcfg: TileConfig):
    """Stage 1: smoothing lengths, the sorted layout and the sorted columns.

    Returns (h_eff, bins, cols, wm): cols maps a name to its sorted column
    (a view of one gathered table); cols["flat"] is the walk's contiguous
    (C, 6) candidate table [x, y, h_eff, m, vx, vy]."""
    adaptive = params.particle_sizes == ParticleSizes.Adaptive
    if adaptive:
        h = kernels.smoothing_length_from_mass(state.mass, params.rest_density, 2)
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
    table = sort_fields(bins, fields)
    cols, a = {}, 0
    for name, width in names:
        cols[name] = table[:, a] if width == 1 else table[:, a:a + width]
        a += width
    cols["flat"] = table[:, 0:6].contiguous()
    wm = window_meta(tcfg, bins, table[:, 0:4])
    return h_eff, bins, cols, wm


def single_step_tiles(state: FluidState, params: SimulationParams, tcfg: TileConfig,
                      boundary_handler):
    """One full step. Returns (new_state, dt, diag); diag values are tensors
    (read once by the runner) except the solver iteration counts (ints)."""
    diag = {}
    h_eff, bins, cols, wm = step_geometry(state, params, tcfg)
    diag["neighbor_overflow"] = (bins.overflow, torch.zeros_like(bins.overflow),
                                 bins.level_overflow)
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

    # boundary terms on the sorted positions
    h_safe = torch.clamp(h_raw_s, min=1e-6)
    bt = boundary_handler.update_after_advect(pos_s, h_safe, params)
    bst = bnd.solver_terms(bt, pos_s, h_safe, params)
    Gx_s = torch.where(alive_s, bst.G[:, 0], zero_s)
    Gy_s = torch.where(alive_s, bst.G[:, 1], zero_s)
    bdens_s = torch.where(alive_s, bnd.density_boundary_term(bt, pos_s, h_safe, params), zero_s)

    # level estimation before advection, at the extended range
    st = cols["flat"][:, 0:4].contiguous()

    def sweep(op, dyn, scale):
        return pair_sweep(bins.cell_starts, wm, st, dyn, op, scale, tcfg.tq)

    do_levels = params.level_estimation_active()
    if do_levels:
        level_s, has_s, surf_s, insuf_s, n_wave = _level_estimation(
            sweep, float(params.level_estimation_range / kernels.ETA),
            bnd.distance_to_boundary(bt), h_raw_s, alive_s, params)
        diag["wavefront_sweeps"] = n_wave

    # CFL dt from the entering (unsorted) state
    sr = h_eff * kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH
    v2 = torch.sum(state.velocity * state.velocity, dim=-1)
    val = torch.where(state.alive, sr * sr / (v2 + 0.01), torch.full_like(sr, float("inf")))
    dt = torch.clamp(params.cfl_factor * sqrt(torch.min(val)), max=float(params.max_dt))
    diag["dt"] = dt

    # the pair walk. `resident_solver` (or ASPH_RESIDENT_SOLVER=1, read at
    # every step as the reference reads it) turns the reference's mega branch off
    # (its need_s2), whether or not the whole-solve kernels can then run: the
    # classic branch is a density sweep, then K1 in classic mode with the
    # inline viscosity. Otherwise the mega branch: one walk that also sums the
    # density, then the viscosity stream. The whole-solve kernels have no
    # momentum and the reference's capacity gate; else the classic branch's
    # solves stream over K2.
    wdtype = torch.bfloat16 if params.weight_cache_bf16 else torch.float32
    classic = bool(params.resident_solver) or os.environ.get("ASPH_RESIDENT_SOLVER", "0") == "1"
    resident = (classic and params.jacobi_momentum == 0.0
                and jacobi.resident_supported(tcfg.capacity, tcfg.tq, wdtype))
    # the reference's opt-in scalar-g storage (mega branch at tq = 128 only)
    scalar = (not classic and pair_ops.scalar_blocks_supported(tcfg.tq)
              and os.environ.get("ASPH_SCALAR_BLOCKS", "0") == "1")
    laplace = params.viscosity_type == ViscosityType.ApproxLaplace
    diag["wcache_overflow"] = torch.zeros_like(bins.overflow)  # CSR is sized exactly
    if classic:
        rho_s = sweep(tp.DENSITY_OP, None, pscale)[:, 0] + bdens_s
        rho_s = torch.where(alive_s, rho_s, torch.ones_like(rho_s))
        cand = torch.cat([cols["flat"][:, 0:4], rho_s[:, None], cols["flat"][:, 4:6]], dim=1)
        csr = pair_ops.pair_build(bins.cell_starts, wm, cand, tcfg.tq, pscale,
                                  float(params.viscosity) if laplace else 0.0, False, wdtype,
                                  classic=True)
        s2x, s2y, s2sq = csr.prep[3], csr.prep[4], csr.prep[5]
        visc_x, visc_y = csr.prep[6], csr.prep[7]
    else:
        visc_stream = laplace and float(params.viscosity) != 0.0
        csr = pair_ops.pair_build(bins.cell_starts, wm, cols["flat"], tcfg.tq, pscale,
                                  float(params.viscosity), visc_stream, wdtype, scalar=scalar)
        rho_s = csr.prep[3] + bdens_s
        rho_s = torch.where(alive_s, rho_s, torch.ones_like(rho_s))
        s2x = s2y = s2sq = zero_s
        if visc_stream:
            visc = pair_ops.pair_visc_scalar if scalar else pair_ops.pair_visc
            visc_x, visc_y = visc(csr, rho_s)
        else:
            visc_x = visc_y = zero_s
    s1x, s1y, s1sq = csr.prep[0], csr.prep[1], csr.prep[2]
    matvec = pair_ops.pair_matvec_scalar if scalar else pair_ops.pair_matvec

    aii_s = gp.assemble_aii_1d(s1x, s1y, s1sq, s2x, s2y, s2sq,
                               {"rho": rho_s, "mass": mass_s}, Gx_s, Gy_s, bt.kind, params)
    aii_s = torch.where(alive_s, aii_s, zero_s)
    diag["negative_aii"] = torch.sum(alive_s & (aii_s < 0.0))

    # the non-pressure kick before the solves
    g = params.gravity_vector(2)
    v2x = vx_s + dt * (visc_x + float(g[0]))
    v2y = vy_s + dt * (visc_y + float(g[1]))

    rho_inv = rdiv(1.0, torch.clamp(rho_s, min=1e-30))

    def accel_fn(p):
        u = p * rho_inv * rho_inv
        mvx, mvy = matvec(csr, u, k_out=2)
        bx, by = gp.boundary_accel_slots_1d(Gx_s, Gy_s, p, rho_s, bt.kind, params)
        return -u * s1x - mvx + bx, -u * s1y - mvy + by

    def div_fn(qx, qy):
        s = matvec(csr, (qx, qy), k_out=1)
        s = (s - (qx * s1x + qy * s1y)) * rho_inv
        return s + gp.boundary_div_slots_1d(Gx_s, Gy_s, qx, qy, rho_s, bt.kind, params)

    def solve(src, tol, rtype, p0, vel=None):
        """vel=(vx, vy) only on the resident path: the kernel then computes
        src - div(vel)/dt itself and the return is (SolveResult, full_src)."""
        if resident:
            return tp.tile_jacobi_resident(csr, aii_s, src, alive_s, tol, rtype, params, dt,
                                           rho_s, rho_inv, s1x, s1y, Gx_s, Gy_s, bt.kind,
                                           p0=p0, vel=vel)
        return tp.tile_jacobi(accel_fn, div_fn, aii_s, src, alive_s, tol, rtype, params, dt,
                              rho_s, p0=p0)

    rest = params.rest_density

    def src_density():
        return -(rest - rho_s) / (rho_s * dt * dt)

    p_prev_s = cols["pressure"] if warm else None
    pdiv_prev_s = pdiv_s = cols["pressure_div"] if warm else None
    method = params.pressure_solver_method
    if method in (PressureSolverMethod.IISPH, PressureSolverMethod.OnlyDivergence):
        iisph = method == PressureSolverMethod.IISPH
        if iisph:
            tol, rtype, src_v = params.iisph_max_avg_density_error, DENSITY_ERROR, src_density()
        else:
            tol, rtype = params.hybrid_dfsph_max_avg_divergence_error, DIVERGENCE_ERROR
            src_v = zero_s
        if resident:
            res, src_s = solve(src_v, tol, rtype, p_prev_s, vel=(v2x, v2y))
        else:
            src_s = src_v - div_fn(v2x, v2y) / dt
            res = solve(src_s, tol, rtype, p_prev_s)
        ax_sv, ay_sv = res.pressure_accel
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
        if resident:
            res_div, res_den, v2x, v2y, src_s = tp.tile_hybrid_resident(
                csr, aii_s, alive_s, params, dt, rho_s, rho_inv, s1x, s1y, Gx_s, Gy_s, bt.kind,
                v2x, v2y, den_with_div, p0_div=pdiv_prev_s, p0_den=p_prev_s)
        else:
            src = -div_fn(v2x, v2y) / dt
            res_div = solve(src, params.hybrid_dfsph_max_avg_divergence_error,
                            DIVERGENCE_ERROR, pdiv_prev_s)
            adx, ady = res_div.pressure_accel
            v2x = v2x + dt * adx
            v2y = v2y + dt * ady
            src_s = src_density() - div_fn(v2x, v2y) / dt if den_with_div else src_density()
            res_den = solve(src_s, params.hybrid_dfsph_max_avg_density_error,
                            DENSITY_ERROR, p_prev_s)
        diag["div_iterations"] = res_div.iterations
        diag["div_avg_error"] = res_div.avg_error
        diag["density_iterations"] = res_den.iterations
        diag["density_avg_error"] = res_den.avg_error
        diag["density_max_error"] = res_den.max_error
        # unclamped residual statistics over every alive non-singular particle
        ns = alive_s & (torch.abs(aii_s) >= SINGULAR_AII_EPS)
        nn = torch.clamp(torch.sum(ns), min=1).to(torch.float32)
        diag["density_avg_error_all"] = torch.sum(
            torch.where(ns, res_den.density_error, zero_s)) / nn
        diag["density_max_error_all"] = torch.max(
            torch.where(ns, torch.abs(res_den.density_error), zero_s))
        ax_sv, ay_sv = res_den.pressure_accel
        p2x = px_s + dt * v2x + dt * dt * ax_sv
        p2y = py_s + dt * v2y + dt * dt * ay_sv
        blend = torch.clamp(dt * params.hybrid_dfsph_factor, max=1.0)
        v2x = v2x + dt * ax_sv * blend
        v2y = v2y + dt * ay_sv * blend
        pdiv_s = res_div.pressure
    diag["solver_stats"] = (res_den.normal_count, res_den.singular_count,
                            res_den.negative_count)

    # the returned state IS the sorted layout; empty slots read zeros/fills
    def msk(v, fill=0.0):
        return torch.where(alive_s, v, torch.full_like(v, fill))

    false_s = torch.zeros_like(alive_s)
    if do_levels:
        # level smoothing over this step's pair set, W at the advected positions
        max_depth = -float(params.maximum_surface_distance)
        dist_s = torch.where(has_s, torch.clamp(level_s, min=max_depth),
                             torch.full_like(level_s, max_depth))
        sm = sweep(tp.SMOOTH_OP, torch.stack([rho_s, dist_s, p2x, p2y], dim=1), pscale)
        level_out = msk(sm[:, 0] / torch.clamp(sm[:, 1], min=1e-30))
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
        pressure=msk(res_den.pressure),
        pressure_div=msk(pdiv_s) if warm else zero_s,
        stash=zero_s,
        pressure_accel=torch.stack([msk(ax_sv), msk(ay_sv)], dim=1),
        ppe_source_term=msk(src_s),
        density_error=msk(res_den.density_error),
        omega=msk(cols["omega"], 1.0),
        density=msk(rho_s, 1.0),
        aii=msk(aii_s),
        constant_field=zero_s,
        h=msk(h_raw_s),
        h_next=msk(cols["h_next"]),
        level=level_out,
        has_level=has_out,
        level_old=level_out,
        size_class=msk(cols["size_class"]).to(torch.int32),
        neighbor_count=torch.zeros_like(alive_s, dtype=torch.int32),
        flag_is_fluid_surface=surf_out,
        flag_insufficient_neighs=insuf_out,
        flag_neighborhood_reduced=false_s,
        alive=alive_s,
        time=state.time + dt,
        step_number=state.step_number + 1,
    )
    diag["num_pairs"] = csr.num_pairs
    return new_state, dt, diag


def _level_estimation(sweep, ext_scale, dist_b, h_raw_s, alive_s, params: SimulationParams):
    """EmptyAngle surface detection and wavefront propagation in sorted space.

    Returns (level, has, is_surface, flag_insufficient, wavefront sweeps). The
    reference propagates in an on-device while-loop; here the host reads the
    "changed" flag once per wavefront sweep."""
    count = sweep(tp.COUNT_OP, None, ext_scale)[:, 0]
    nrm = sweep(tp.normal_op(params), None, ext_scale)
    nx, ny = nrm[:, 0], nrm[:, 1]
    norm2 = nx * nx + ny * ny
    inv = rdiv(1.0, sqrt(torch.clamp(norm2, min=1e-30)))
    cone = sweep(tp.CONE_OP, torch.stack([nx * inv, ny * inv], dim=1),
                 ext_scale)[:, 0] > 0.5

    insufficient = count < (2 * 2 - 1)
    symmetric = norm2 < 1e-5
    near_boundary = torch.zeros_like(symmetric)
    if (not params.boundary_is_fluid_surface) and dist_b is not None:
        near_boundary = dist_b < h_raw_s * 1.5
    is_interior = (~insufficient) & (symmetric | near_boundary | cone)
    is_surface = (~is_interior) & alive_s

    def one_sweep(lvl, has):
        est = sweep(tp.WAVEFRONT_OP, torch.stack([lvl, has.to(torch.float32)], dim=1), ext_scale)[:, 0]
        newly = (~has) & (est > NEG_BIG * 0.5) & alive_s
        return torch.where(newly, est, lvl), has | newly, torch.any(newly)

    level, has, changed = one_sweep(torch.zeros_like(h_raw_s), is_surface)
    n = 1
    while bool(changed):  # the sweep's one host read
        level, has, changed = one_sweep(level, has)
        n += 1
    return level, has, is_surface, insufficient & alive_s, n
