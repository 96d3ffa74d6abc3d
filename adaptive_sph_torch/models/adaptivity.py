"""Adaptivity: classification, sharing, merging and splitting at fixed capacity.

Counterpart of adaptive_sph_tpu/models/adaptivity.py on the tile backend:
`classify`, the dropped-mass rules, `_apply_transfer`, `split`,
`single_step_adaptivity` and `find_partners_tiles`. Partner matching is the
reference's parallel deterministic matching: donors count eligible receivers
(two passes, the second with the mass check), a donor that is an eligible
receiver of a lower-index donor stands down, and every receiver adopts its
lowest-index active donor. Each of the four passes is one pair sweep
(ops/sweeps.py, the CUDA kernel pair_sweep on the card) over a fresh tile
layout at the post-step positions. Deleted particles become free slots in
place; split children fill free slots. Shapes never change; the particle
count does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels, sweeps
from ..ops.numerics import fma, rdiv
from ..ops.sweeps import NEG_BIG, SweepOp, pair_sweep
from ..ops.tiles import build_tiles, sort_fields, unsort, window_meta
from ..utils.params import ParticleSizes, SimulationParams, optimal_mass_from_level
from .state import (
    SIZE_LARGE,
    SIZE_OPTIMAL,
    SIZE_SMALL,
    SIZE_TOO_LARGE,
    SIZE_TOO_SMALL,
    FluidState,
)

# class thresholds on m / m_optimal, rounded to float32 as the reference compares
FACTOR_TOO_SMALL = 0.5
FACTOR_SMALL = float(np.float32(1.0 / 1.1))
FACTOR_LARGE = float(np.float32(1.1))
FACTOR_TOO_LARGE = 2.0


def _level_or_max_depth(state: FluidState, params: SimulationParams):
    return torch.where(state.has_level, state.level,
                       torch.full_like(state.level, -float(params.maximum_surface_distance)))


def classify(state: FluidState, params: SimulationParams):
    """m / m_optimal -> one of the five size classes (int32); dead rows OPTIMAL."""
    target = optimal_mass_from_level(_level_or_max_depth(state, params), params, dim=2)
    mrel = state.mass / torch.clamp(target, min=1e-30)

    def code(v):
        return torch.full_like(mrel, float(v))

    cls = torch.where(mrel <= FACTOR_TOO_SMALL, code(SIZE_TOO_SMALL), torch.where(
        mrel <= FACTOR_SMALL, code(SIZE_SMALL), torch.where(
            mrel < FACTOR_LARGE, code(SIZE_OPTIMAL), torch.where(
                mrel < FACTOR_TOO_LARGE, code(SIZE_LARGE), code(SIZE_TOO_LARGE)))))
    return torch.where(state.alive, cls, code(SIZE_OPTIMAL)).to(torch.int32)


def _dropped_mass_merging(level, mass, dt, params):
    """A merging donor gives all of its mass."""
    return mass


def _dropped_mass_sharing(level, mass, dt, params):
    """A sharing donor gives its excess over the target, at most a rate x dt."""
    target = optimal_mass_from_level(level, params, dim=2)
    return torch.minimum(mass - target, target * float(params.max_mass_transfer_sharing) * dt)


def _apply_transfer(state: FluidState, partner, cnt, dt, params, mode: str):
    """Masked mass, velocity and position transfer from donors to receivers;
    exactly conservative. mode: "merge" or "share"."""
    C = state.capacity
    level = _level_or_max_depth(state, params)
    if mode == "merge":
        dropped = _dropped_mass_merging(level, state.mass, dt, params)
        min_partners = params.minimum_merge_partners
    else:
        dropped = _dropped_mass_sharing(level, state.mass, dt, params)
        min_partners = params.minimum_share_partners

    donor_gives = (cnt > 0) & (cnt >= min_partners)
    p = torch.clamp(partner, max=C - 1).long()
    is_receiver = (partner < C) & donor_gives[p]
    zero = torch.zeros_like(state.mass)

    mass_n = torch.where(is_receiver, dropped[p] / torch.clamp(cnt[p], min=1).to(torch.float32),
                         zero)
    m_i = state.mass
    m_new = m_i + mass_n
    w_new = torch.where(is_receiver, rdiv(1.0, torch.clamp(m_new, min=1e-30)), zero)
    rcv = is_receiver[:, None]

    def blend(v):
        # mass-weighted mean; XLA contracts the sum into fma(mass_n, v_p, m_i v_i)
        return fma(mass_n[:, None], v[p], m_i[:, None] * v) * w_new[:, None]

    vel = torch.where(rcv, blend(state.velocity), state.velocity)
    pos = torch.where(rcv, blend(state.position), state.position)
    mass = torch.where(is_receiver, m_new, m_i)
    h_next = torch.where(is_receiver,
                         kernels.smoothing_length_from_mass(mass, params.rest_density, 2),
                         state.h_next)

    # donor side
    mass = torch.where(donor_gives, mass - dropped, mass)
    alive = state.alive
    if mode == "share":
        h_next = torch.where(donor_gives, kernels.smoothing_length_from_mass(
            torch.clamp(mass, min=1e-30), params.rest_density, 2), h_next)
    else:
        dead = donor_gives & (mass < 1e-6)
        alive = alive & ~dead
        mass = torch.where(dead, zero, mass)
    return state.replace(position=pos, velocity=vel, mass=mass, h_next=h_next, alive=alive)


def _scatter_rows(a, dest, v):
    """a with rows `dest` set to v; dest == len(a) drops the row."""
    ext = torch.cat([a, a[:1]])
    ext[dest] = v.to(a.dtype)
    return ext[:a.shape[0]]


def split(state: FluidState, params: SimulationParams, patterns, max_splits: int):
    """TooLarge particles -> n children placed by the pattern table.

    patterns: ((P, MAXC, 2) float32 tensor on the state's device, (P,) numpy
    child counts); row k places k + 2 children. Child 0 replaces the parent,
    the rest fill free (dead) slots. Splits beyond `max_splits` or beyond the
    free slots are deferred; returns (state, {"splits", "split_deferred",
    "split_missing_pattern"}) with tensor counts."""
    C = state.capacity
    dev = state.device
    pat_pos, pat_counts = patterns
    P, MAXC, _ = pat_pos.shape
    max_children = int(np.max(np.asarray(pat_counts)))

    cls = classify(state, params)
    too_large = state.alive & (cls == SIZE_TOO_LARGE)
    level = _level_or_max_depth(state, params)
    target = optimal_mass_from_level(level, params, dim=2)
    ratio = torch.round(state.mass / torch.clamp(target, min=1e-30))
    nch = torch.clamp(ratio.to(torch.int32), 2, max_children)
    missing_pattern = torch.sum(too_large & (ratio > max_children))

    idx = torch.arange(C, dtype=torch.int32, device=dev)
    order = torch.argsort(torch.where(too_large, idx, C + idx))
    parents = order[:max_splits]
    valid_parent = too_large[parents]
    deferred = torch.sum(too_large) - torch.sum(valid_parent)

    # children go into free slots (dead rows anywhere in the array)
    dead = ~state.alive
    dead_i = dead.to(torch.int32)
    n_free = torch.sum(dead_i)
    free_rank = torch.where(dead, torch.cumsum(dead_i, 0) - 1, C)
    free_slot = torch.full((C + 1,), C, dtype=torch.int32, device=dev)
    free_slot[free_rank.long()] = idx
    free_slot = free_slot[:C]

    zero_i = torch.zeros_like(parents, dtype=torch.int32)
    nch_p = torch.where(valid_parent, nch[parents], zero_i)
    new_per_parent = torch.clamp(nch_p - 1, min=0)
    offsets = torch.cumsum(new_per_parent, 0) - new_per_parent
    fits = offsets + new_per_parent <= n_free
    ok_parent = valid_parent & fits
    deferred = deferred + torch.sum(valid_parent & ~fits)
    nch_p = torch.where(ok_parent, nch_p, zero_i)
    new_per_parent = torch.clamp(nch_p - 1, min=0)
    offsets = torch.cumsum(new_per_parent, 0) - new_per_parent
    total_new = torch.sum(new_per_parent)

    # per-parent data
    pmass = state.mass[parents]
    child_mass = pmass / torch.clamp(nch_p, min=1).to(torch.float32)
    child_h = kernels.smoothing_length_from_mass(torch.clamp(child_mass, min=1e-30),
                                                 params.rest_density, 2)
    # positions scale with the parent's radius at the initial rest density 1
    scale = kernels.sphere_volume_to_radius(pmass, dim=2)
    prow = torch.clamp(nch_p - 2, 0, P - 1).long()
    ppos = state.position[parents]

    def upd(a, v):
        a = a.clone()
        m = ok_parent if v.ndim == 1 else ok_parent[:, None]
        a[parents] = torch.where(m, v, a[parents])
        return a

    st = state.replace(
        mass=upd(state.mass, child_mass),
        position=upd(state.position, fma(pat_pos[prow, 0], scale[:, None], ppos)),
        h=upd(state.h, child_h),
        h_next=upd(state.h_next, child_h),
    )

    # children 1..: flat (S, MAXC - 1)
    S = parents.shape[0]
    cslots = MAXC - 1
    c_idx = torch.arange(cslots, dtype=torch.int32, device=dev)[None, :]
    child_valid = ok_parent[:, None] & (c_idx + 1 < nch_p[:, None])
    rank = torch.clamp(offsets[:, None] + c_idx, max=C - 1)
    dest = torch.where(child_valid, free_slot[rank.long()], C).reshape(-1).long()

    cpos = fma(pat_pos[prow][:, 1:, :], scale[:, None, None], ppos[:, None, :]).reshape(-1, 2)

    def per_child(v):
        return v[:, None].expand(S, cslots).reshape(-1)

    ch = per_child(child_h)
    cmass = per_child(child_mass)
    st = st.replace(
        mass=_scatter_rows(st.mass, dest, cmass),
        position=_scatter_rows(st.position, dest, cpos),
        velocity=_scatter_rows(st.velocity, dest,
                               state.velocity[parents][:, None, :].expand(S, cslots, 2)
                               .reshape(-1, 2)),
        h=_scatter_rows(st.h, dest, ch),
        h_next=_scatter_rows(st.h_next, dest, ch),
        level=_scatter_rows(st.level, dest, per_child(state.level[parents])),
        has_level=_scatter_rows(st.has_level, dest, per_child(state.has_level[parents])),
        level_old=_scatter_rows(st.level_old, dest, per_child(state.level_old[parents])),
        alive=_scatter_rows(st.alive, dest, child_valid.reshape(-1)),
        pressure=_scatter_rows(st.pressure, dest, torch.zeros_like(cmass)),
        density=_scatter_rows(st.density, dest, torch.ones_like(cmass)),
        n=state.n + total_new.to(torch.int32),
    )
    return st, {"splits": torch.sum(ok_parent), "split_deferred": deferred,
                "split_missing_pattern": missing_pattern}


def _max_splits(capacity: int) -> int:
    return max(64, capacity // 16)


def single_step_adaptivity(state: FluidState, dt, params: SimulationParams, split_patterns,
                           partner_fn, step_number: int):
    """Share every step; merge on even steps, split on odd ones.

    step_number: the state's step number, already advanced by the physics
    step, as the host counts it (the reference branches on the device value;
    the port never reads it back). partner_fn(state, cls, mode) -> (partner,
    cnt, active) is the tile matcher."""
    diag = {}
    total_mass_1 = torch.sum(torch.where(state.alive, state.mass, torch.zeros_like(state.mass)))
    zero = torch.zeros((), dtype=torch.int32, device=state.device)

    if params.sharing:
        cls = classify(state, params)
        partner, cnt, _ = partner_fn(state, cls, "share")
        state = _apply_transfer(state, partner, cnt, dt, params, "share")
        diag["shares"] = torch.sum(cnt > 0)

    def do_merge(st):
        cls = classify(st, params)
        partner, cnt, _ = partner_fn(st, cls, "merge")
        st2 = _apply_transfer(st, partner, cnt, dt, params, "merge")
        # no compaction: deleted donors become free slots in place
        st2 = st2.replace(n=torch.sum(st2.alive).to(torch.int32))
        return st2, torch.sum(cnt > 0), zero, zero

    def do_split(st):
        st2, sdiag = split(st, params, split_patterns, _max_splits(st.capacity))
        return st2, sdiag["splits"], sdiag["split_missing_pattern"], sdiag["split_deferred"]

    even = (params.merging or params.splitting) and step_number % 2 == 0
    missing = deferred = zero
    if params.merging and params.splitting:
        state, count, missing, deferred = do_merge(state) if even else do_split(state)
        diag["merge_or_split_count"] = count
    elif params.merging:
        if even:
            state, count, missing, deferred = do_merge(state)
        else:
            count = zero
        diag["merges"] = count
    elif params.splitting:
        if not even:
            state, count, missing, deferred = do_split(state)
        else:
            count = zero
        diag["splits"] = count
    if params.splitting:
        diag["split_missing_pattern"] = missing
        diag["split_deferred"] = deferred

    total_mass_2 = torch.sum(torch.where(state.alive, state.mass, torch.zeros_like(state.mass)))
    diag["mass_conservation_error"] = torch.abs(total_mass_1 - total_mass_2)
    return state, diag


def _adapt_ops(params: SimulationParams, mode: str):
    """The four SweepOps of the matching for `mode` and the sweep scale.

    Dyn channels: cls, target, dropped, fidx, donor, then cnt0, then cand
    (donor candidates for the stand-down pass, active donors for the
    assignment pass). cnt0/cnt1: query = donor, candidate = receiver;
    claim/partner: query = receiver, candidate = donor."""
    merge = mode == "merge"
    max_dist_f = float(params.max_merge_distance if merge else params.max_share_distance)
    md32 = float(np.float32(max_dist_f))
    mass_base = float(np.float32(params.mass_base(2)))
    f_large = FACTOR_LARGE
    allow_opt = (params.allow_merge_with_optimal_particle if merge
                 else params.allow_share_with_optimal_particle)
    allow_size = bool(merge and params.allow_merge_on_size_difference)
    allow_small = bool((not merge) and params.allow_share_with_too_small_particle)

    def receiver_ok(d, r):
        rc = r["cls"]
        if merge:
            bad = (rc == float(SIZE_LARGE)) | (rc == float(SIZE_TOO_LARGE))
            if not allow_opt:
                bad = bad | (rc == float(SIZE_OPTIMAL))
            ok = ~bad
            if allow_size:
                ok = ok | (r["mass"] > 5.0 * d["mass"])
            return ok
        ok = rc == float(SIZE_SMALL)
        if allow_small:
            ok = ok | (rc == float(SIZE_TOO_SMALL))
        if allow_opt:
            ok = ok | (rc == float(SIZE_OPTIMAL))
        return ok

    def elig_base(d, r):
        return (d["donor"] > 0.5) & (d["fidx"] != r["fidx"]) & receiver_ok(d, r)

    def elig_full(d, r):
        new_mass_r = r["mass"] + d["dropped"] / d["cnt0"]
        mass_ok = (new_mass_r < r["target"] * f_large) & (new_mass_r <= mass_base)
        return elig_base(d, r) & mass_ok

    def near_mask(q, c, ctx):
        # the reference's inclusive bound |x_ij| <= max_dist h_ij; the sweep
        # radius is widened slightly so that the strict radius test keeps it
        md = md32 * ctx.h_ij
        return ctx.r2 <= md * md

    def edge(q, c, ctx):
        ok = (c["cand"] > 0.5) & elig_full(c, q)
        return [torch.where(ok, -c["fidx"], torch.full_like(ctx.r2, NEG_BIG))]

    base = ("cls", "target", "dropped", "fidx", "donor")
    prm = {"max_dist": md32, "mass_base": mass_base, "merge": int(merge),
           "allow_optimal": int(allow_opt), "allow_size_difference": int(allow_size),
           "allow_too_small": int(allow_small)}
    common = dict(n_out=1, mask_fn=near_mask, params=prm)
    ops = {
        "cnt0": SweepOp(name="adapt_cnt0", op_id=sweeps.OP_ADAPT_CNT0, dyn_names=base,
                        emit=lambda q, c, ctx: [elig_base(q, c).to(torch.float32)], **common),
        "cnt1": SweepOp(name="adapt_cnt1", op_id=sweeps.OP_ADAPT_CNT1,
                        dyn_names=base + ("cnt0",),
                        emit=lambda q, c, ctx: [elig_full(q, c).to(torch.float32)], **common),
        "claim": SweepOp(name="adapt_claim", op_id=sweeps.OP_ADAPT_EDGE,
                         dyn_names=base + ("cnt0", "cand"), emit=edge, reduce="max",
                         fill=NEG_BIG, **common),
        "partner": SweepOp(name="adapt_partner", op_id=sweeps.OP_ADAPT_EDGE,
                           dyn_names=base + ("cnt0", "cand"), emit=edge, reduce="max",
                           fill=NEG_BIG, **common),
    }
    # the reference only sees pairs inside its 2 h_ij neighbour lists
    scale = min(max_dist_f, float(kernels.SUPPORT_RADIUS_BY_SMOOTHING_LENGTH)) * (1.0 + 1e-6)
    return ops, scale


def find_partners_tiles(state: FluidState, tcfg, cls, dt, params: SimulationParams, mode: str):
    """Partner matching on the tile layout; returns (partner (C,) int32 with C
    = none, cnt (C,) int32 receivers per donor, active (C,) bool donors).

    Four sweeps over a fresh tile layout at the state's positions and h:
    receiver counts without and with the mass check, the donor stand-down
    (max of -index over claiming donor candidates) and the assignment (max
    of -index over claiming active donors)."""
    C = state.capacity
    dev = state.device
    idx = torch.arange(C, dtype=torch.int32, device=dev)
    level = _level_or_max_depth(state, params)
    target_mass = optimal_mass_from_level(level, params, dim=2)
    if params.particle_sizes == ParticleSizes.Uniform:
        h_eff = torch.full_like(state.h, float(params.h))
    else:
        h_eff = state.h
    if mode == "merge":
        donor_class = (cls == SIZE_TOO_SMALL) & state.alive
        dropped = _dropped_mass_merging(level, state.mass, dt, params)
    else:
        donor_class = (cls == SIZE_LARGE) & state.alive
        dropped = _dropped_mass_sharing(level, state.mass, dt, params)

    bins = build_tiles(state.position, h_eff * tcfg.mscale, h_eff, state.alive, tcfg)
    table = sort_fields(bins, [state.position, h_eff, state.mass, cls, target_mass, dropped,
                               idx, donor_class])
    st = table[:, 0:4].contiguous()
    wm = window_meta(tcfg, bins, st)
    ops, scale = _adapt_ops(params, mode)

    def sweep(name, dyn):
        return pair_sweep(bins.cell_starts, wm, st, dyn, ops[name], scale, tcfg.tq)[:, 0]

    dyn5 = table[:, 4:9]
    cnt0_s = torch.clamp(sweep("cnt0", dyn5.contiguous()), min=1.0)
    dyn6 = torch.cat([dyn5, cnt0_s[:, None]], dim=1)
    cnt1_s = sweep("cnt1", dyn6)
    donor_cand_s = (dyn6[:, 4] > 0.5) & (cnt1_s > 0.5)

    # donor stand-down: a candidate claimed by a lower-index candidate yields
    neg_min_claimer = sweep("claim", torch.cat([dyn6, donor_cand_s.to(torch.float32)[:, None]], 1))
    active_s = donor_cand_s & ~(-neg_min_claimer < dyn6[:, 3])

    # assignment: every receiver adopts its lowest-index active claimant
    neg_partner = sweep("partner", torch.cat([dyn6, active_s.to(torch.float32)[:, None]], 1))
    partner_f = -unsort(bins, neg_partner, NEG_BIG)
    active = (unsort(bins, active_s.to(torch.float32), 0.0) > 0.5) & state.alive
    has_partner = (partner_f < -NEG_BIG * 0.5) & state.alive & ~active
    partner = torch.where(has_partner, partner_f, torch.full_like(partner_f, float(C)))
    partner = partner.to(torch.int32)
    cnt = torch.zeros(C + 1, dtype=torch.int32, device=dev)
    cnt.index_add_(0, partner.long(), torch.ones_like(partner))
    return partner, cnt[:C], active
