"""Tile-backend step: one pair walk per step, then the pressure solves.

Counterpart of `single_step_tiles` in adaptive_sph_tpu/models/tile_step.py
for the configuration the port supports (runner.check_supported): adaptive
sizes from mass or uniform sizes, EmptyAngle level estimation before
advection (or none), ApproxLaplace or WCSPH viscosity, the
ConsistentSimpleGradient, ConsistentSymmetricGradient or Winchenbach2020
discretization, SDF or no boundary, `pull_fluid_to`; HybridDFSPH (its
non-pressure step before or after the divergence solve), IISPH, IISPH2 or
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
     - classic (`resident_solver`, ASPH_RESIDENT_SOLVER=1 or Winchenbach2020,
       whatever the momentum): the DENSITY pair_sweep, then K1 in classic
       mode (pair weights, the a_ii sums and their w / rho_j variants, the
       inline viscosity)
     The walk's viscosity is the first non-pressure kick's; with HybridDFSPH's
     non-pressure step after the divergence solve the walk has none.
  6. a_ii assembly, the non-pressure kick (viscosity, gravity, the pull)
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
     tile_jacobi over K2 pair_matvec (or K2s), one host read per iteration.
  8. integration
  9. level smoothing at the advected positions (when active; pair_sweep)

The returned state is in this step's sorted order (no unsort), exactly as the
reference returns it, so the next step starts from the same order.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..ops import jacobi, kernels, pair_ops
from ..ops.numerics import rdiv, sqrt
from ..ops.sweeps import NEG_BIG, pair_sweep
from ..ops.tiles import TileConfig, build_tiles, sort_fields, window_meta
from ..utils.params import (
    HybridDfsphDensitySourceTerm,
    OperatorDiscretization,
    ParticleSizes,
    PressureSolverMethod,
    SimulationParams,
    ViscosityType,
)
from . import boundary as bnd
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
    classic = resident_flag or w2020
    resident = (resident_flag and params.jacobi_momentum == 0.0
                and jacobi.resident_supported(tcfg.capacity, tcfg.tq, wdtype))
    # the reference's opt-in scalar-g storage (mega branch at tq = 128 only)
    scalar = (not classic and pair_ops.scalar_blocks_supported(tcfg.tq)
              and os.environ.get("ASPH_SCALAR_BLOCKS", "0") == "1")
    diag["wcache_overflow"] = torch.zeros_like(bins.overflow)  # CSR is sized exactly
    if classic:
        rho_s = sweep(tp.DENSITY_OP, None, pscale)[:, 0] + bdens_s
        rho_s = torch.where(alive_s, rho_s, torch.ones_like(rho_s))
        cand = torch.cat([cols["flat"][:, 0:4], rho_s[:, None], cols["flat"][:, 4:6]], dim=1)
        csr = pair_ops.pair_build(bins.cell_starts, wm, cand, tcfg.tq, pscale,
                                  nu if vm != "none" else 0.0, False, wdtype, classic=True,
                                  wcsph=vm == "wcsph")
        s2x, s2y, s2sq = csr.prep[3], csr.prep[4], csr.prep[5]
        visc_x, visc_y = csr.prep[6], csr.prep[7]
    else:
        visc_stream = vm != "none" and nu != 0.0
        csr = pair_ops.pair_build(bins.cell_starts, wm, cols["flat"], tcfg.tq, pscale, nu,
                                  visc_stream, wdtype, scalar=scalar, wcsph=vm == "wcsph")
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

    def accel_fn(p):
        u = p * rho_inv * rho_inv
        mvx, mvy = matvec(csr, u, k_out=2)
        bx, by = gp.boundary_accel_slots_1d(Gx_s, Gy_s, p, rho_s, bt.kind, params)
        return -u * s1x - mvx + bx, -u * s1y - mvy + by

    def div_fn(qx, qy):
        if w2020:
            # K2 over t = q / rho, minus q . S2
            s = matvec(csr, (qx * rho_inv, qy * rho_inv), k_out=1) - (qx * s2x + qy * s2y)
        else:
            s = (matvec(csr, (qx, qy), k_out=1) - (qx * s1x + qy * s1y)) * rho_inv
        return s + gp.boundary_div_slots_1d(Gx_s, Gy_s, qx, qy, rho_s, bt.kind, params)

    def solve(src, tol, rtype, p0, vel=None, omega_inv=None):
        """vel=(vx, vy) only on the resident path: the kernel then computes
        src - div(vel) * omega_inv / dt itself and the return is
        (SolveResult, full_src)."""
        if resident:
            return tp.tile_jacobi_resident(csr, aii_s, src, alive_s, tol, rtype, params, dt,
                                           rho_s, rho_inv, s1x, s1y, s2x, s2y, Gx_s, Gy_s,
                                           bt.kind, p0=p0, vel=vel, omega_inv=omega_inv)
        return tp.tile_jacobi(accel_fn, div_fn, aii_s, src, alive_s, tol, rtype, params, dt,
                              rho_s, p0=p0)

    rest = params.rest_density
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
            res_div, res_den, v2x, v2y, src_s = tp.tile_hybrid_resident(
                csr, aii_s, alive_s, params, dt, rho_s, rho_inv, s1x, s1y, s2x, s2y, Gx_s, Gy_s,
                bt.kind, v2x, v2y, den_with_div, p0_div=pdiv_prev_s, p0_den=p_prev_s)
        else:
            src = -div_fn(v2x, v2y) / dt
            res_div = solve(src, params.hybrid_dfsph_max_avg_divergence_error,
                            DIVERGENCE_ERROR, pdiv_prev_s)
            adx, ady = res_div.pressure_accel
            v2x = v2x + dt * adx
            v2y = v2y + dt * ady
            if not first_np_at_start:
                v2x, v2y = nonpressure(v2x, v2y)
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
        pressure_s = res_den.pressure
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
        pressure=msk(pressure_s),
        pressure_div=msk(pdiv_s) if warm else zero_s,
        stash=zero_s,
        pressure_accel=torch.stack([msk(ax_sv), msk(ay_sv)], dim=1),
        ppe_source_term=msk(src_s),
        density_error=msk(res_den.density_error),
        omega=msk(omega_s, 1.0),
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
