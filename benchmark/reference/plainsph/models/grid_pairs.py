"""Pair reductions over the dense grid engine (ops/grid.py).

Counterpart of adaptive_sph_tpu/models/grid_pairs.py. `pair_apply`
evaluates, for every alive particle i,
    reduce_j edge_fn(v_i, v_j, geom_ij)
over all SPH neighbours j (|x_ij| < radius_scale * h_ij, self included)
without a per-edge gather: the candidates come from 3 x 3 shifted slices of
the per-level grid tensors, the cross-level windows from power-of-two up-
and downsampling.

Block structure: for each pair of populated levels (q, c) with q <= c, the
q-side sums reduce each query slot over its 9 * mpc window of level c; the
c-side sums of cross-level pairs reduce the same pair tensor over the query
axes (a sum to the coarse resolution and nine reverse shifts). The loop
order and the accumulation order are the reference's: for each query level
q, the coarser levels' reverse contributions first, then q's own sum.

Squared distances round as the reference's compiled step rounds
jnp.sum(diff * diff, -1): fma(dy, dy, dx * dx), as `neighbors.r2`.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.grid import (
    OFFSETS,
    GridBins,
    GridConfig,
    downsample_max2d,
    downsample_sum2d,
    level_view,
    shift2d,
    upsample2d,
)
from ..ops.numerics import fma_tensors, sqrt


def r2(diff):
    """|diff|^2 over a trailing axis of 2, fma(dy, dy, dx * dx)."""
    return fma_tensors(diff[..., 1], diff[..., 1], diff[..., 0] * diff[..., 0])


def _expand_q(a):
    """(ny, nx, MQ, ...) -> (ny, nx, MQ, 1, ...)"""
    return a[:, :, :, None]


def _expand_c(a):
    """(ny, nx, W, ...) -> (ny, nx, 1, W, ...)"""
    return a[:, :, None, :]


def _candidate_views(cfg: GridConfig, slot_array, c: int, factor: int, fill):
    """(ny_q, nx_q, 9 * mpc, ...) stacked candidate windows of level c at the
    resolution of the query level (c - log2(factor))."""
    base = level_view(cfg, slot_array, c)
    return torch.cat([upsample2d(shift2d(base, dy, dx, fill), factor) for dy, dx in OFFSETS],
                     dim=2)


class Geom:
    """Per-pair geometry handed to edge functions (broadcast shapes (..., MQ, W))."""

    __slots__ = ("diff", "r", "h_ij", "valid")

    def __init__(self, diff, r, h_ij, valid):
        self.diff = diff
        self.r = r
        self.h_ij = h_ij
        self.valid = valid

    def reversed(self):
        return Geom(-self.diff, self.r, self.h_ij, self.valid)


def _where(valid, e, fill):
    v = valid.reshape(tuple(valid.shape) + (1,) * (e.ndim - 4))
    return torch.where(v, e, torch.full((), fill, dtype=e.dtype, device=e.device))


def _combine(reduce: str):
    return torch.add if reduce == "sum" else torch.maximum


def pair_apply(
    cfg: GridConfig,
    bins: GridBins,
    slot_fields: dict,
    radius_scale,
    edge_fn: Callable,
    reduce: str = "sum",
    fill=0.0,
    mask_pos_key: str = "pos",
):
    """Run edge_fn over every interacting pair; returns a dict of slot-layout results.

    slot_fields: (total_slots, ...) tensors; must hold "pos" (slots, 2) and
    "h" (slots,). edge_fn(vi, vj, geom) -> dict of per-pair tensors
    (..., MQ, W[, F]) contributing to vi's particle; it is evaluated once per
    direction per block. reduce: "sum" or "max" (max uses `fill` for
    non-edges). mask_pos_key: the position field that decides membership
    (|x| < scale * h_ij); level smoothing passes the pre-advection
    positions there while the kernels see the advected ones."""
    scale = float(radius_scale)
    mask_flat = bins.slot_mask
    empty = 0.0 if reduce == "sum" else fill
    comb = _combine(reduce)
    out = None
    levels = sorted(set(cfg.populated))

    for q in levels:
        nyq, nxq = cfg.dims(q)
        qv = {k: level_view(cfg, v, q) for k, v in slot_fields.items()}
        qmask = level_view(cfg, mask_flat, q)
        q_acc = None

        for c in levels:
            if c < q:
                continue
            factor = 1 << (c - q)
            cand = {k: _candidate_views(cfg, v, c, factor, 0) for k, v in slot_fields.items()}
            cmask = _candidate_views(cfg, mask_flat, c, factor, False)

            diff = _expand_q(qv["pos"]) - _expand_c(cand["pos"])  # (ny, nx, MQ, W, 2)
            r = sqrt(r2(diff) + 1e-30)
            # the clamp keeps the kernels finite on empty-empty slot pairs, so
            # the masked reduction never meets a NaN
            h_ij = torch.clamp(0.5 * (_expand_q(qv["h"]) + _expand_c(cand["h"])), min=1e-6)
            if mask_pos_key == "pos":
                r_mask = r
            else:
                dmask = _expand_q(qv[mask_pos_key]) - _expand_c(cand[mask_pos_key])
                r_mask = sqrt(r2(dmask) + 1e-30)
            valid = _expand_q(qmask) & _expand_c(cmask) & (r_mask < scale * h_ij)
            geom = Geom(diff, r, h_ij, valid)
            vi = {k: _expand_q(v) for k, v in qv.items()}
            vj = {k: _expand_c(v) for k, v in cand.items()}

            fwd = edge_fn(vi, vj, geom)
            red = torch.sum if reduce == "sum" else torch.amax
            contrib_q = {k: red(_where(valid, e, empty), dim=3) for k, e in fwd.items()}
            q_acc = contrib_q if q_acc is None else {
                k: comb(q_acc[k], contrib_q[k]) for k in q_acc}

            if c > q:
                # the reversed direction: contributions to the coarse candidates
                bwd = edge_fn(vj, vi, geom.reversed())
                contrib_c = {k: _reverse(cfg, valid, e, c, factor, nyq, nxq, reduce, empty)
                             for k, e in bwd.items()}
                out = _accumulate_level(out, cfg, contrib_c, c, reduce, fill)
            del diff, r, h_ij, r_mask, valid, geom, fwd

        out = _accumulate_level(out, cfg, q_acc, q, reduce, fill)

    return out


def _reverse(cfg: GridConfig, valid, e, c: int, factor: int, nyq: int, nxq: int, reduce: str,
             empty):
    """A reversed-direction pair tensor reduced onto the coarse level c's
    slots: over the query slots, down to c's resolution, then the nine
    shifts undone (the candidate at offset (dy, dx) from a query cell
    receives from the query cells at (-dy, -dx))."""
    masked = _where(valid, e, empty)
    masked = masked.expand(tuple(valid.shape) + tuple(e.shape[4:]))
    if reduce == "sum":
        t = torch.sum(masked, dim=2)  # over MQ -> (nyq, nxq, W, ...)
    else:
        t = torch.amax(masked, dim=2)
    t = t.reshape((nyq, nxq, 9, cfg.mpc) + tuple(masked.shape[4:]))
    t = downsample_sum2d(t, factor) if reduce == "sum" else downsample_max2d(t, factor)
    acc = None
    for o, (dy, dx) in enumerate(OFFSETS):
        piece = shift2d(t[:, :, o], -dy, -dx, empty)
        acc = piece if acc is None else _combine(reduce)(acc, piece)
    return acc  # (nyc, nxc, mpc, ...)


def _accumulate_level(out, cfg: GridConfig, contrib: dict, l: int, reduce: str, fill):
    """Add a (ny_l, nx_l, mpc, ...) contribution into the flat slot accumulator."""
    offs, total = cfg.level_offsets
    ny, nx = cfg.dims(l)
    n = ny * nx * cfg.mpc
    if out is None:
        out = {}
        for k, cb in contrib.items():
            shape = (total,) + tuple(cb.shape[3:])
            out[k] = (torch.zeros(shape, dtype=cb.dtype, device=cb.device) if reduce == "sum"
                      else torch.full(shape, fill, dtype=cb.dtype, device=cb.device))
    for k, cb in contrib.items():
        seg = out[k][offs[l]: offs[l] + n]
        flat = cb.reshape((n,) + tuple(cb.shape[3:]))
        if reduce == "sum":
            seg.add_(flat)
        else:
            torch.maximum(seg, flat, out=seg)
    return out
