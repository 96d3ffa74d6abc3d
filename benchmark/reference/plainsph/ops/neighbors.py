"""Neighbour search of the list backend: per-level sorted cell grids and
fixed-width forward rows.

Counterpart of adaptive_sph_tpu/ops/neighbors.py, plain torch (the reference
is XLA array code: sorts, searchsorted, gathers and sorted segment sums).
Each particle gets the smallest level whose cell (c_min 2^level) covers its
search radius; each level's cell ids are sorted once, and every query
gathers a window of `max_per_cell` sorted slots from each of the 3 x 3 cells
around it. A pair (i, j) interacts iff |x_ij| < radius_scale (h_i + h_j) / 2.

The (C, K) rows hold only forward edges: for each i the neighbours j with
level(j) >= level(i) (a same-level pair appears in both rows, a pair across
levels only in the smaller particle's row). The larger side of a cross-level
pair is reached through `bwd_perm`, the edges sorted by target, which the
pair sums reduce per target in a fixed order (ops/pairwise.py). Overflow of
a cell window, a row or the level range is counted, not fatal; the runner
raises on it.

Levels no particle lives on are skipped (they add no candidate, so the rows
and the overflow flags stay the reference's). Squared distances round as the
reference's compiled `jnp.sum(diff * diff, -1)` does on the CPU, fma(dy, dy,
dx * dx) (`r2`), so that every radius test and every count agrees with the
reference bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .numerics import fma

INT_MAX = int(np.iinfo(np.int32).max)
BIG = 3.4e38  # float32 stand-in for +inf in the reductions below


@dataclasses.dataclass(frozen=True)
class NeighborConfig:
    """Static shape of the neighbour structure."""

    capacity: int  # C: particle capacity
    row_width: int  # K: forward neighbours per particle
    levels: int  # L: size levels (1 for uniform sizes)
    max_per_cell: int = 32  # MPC: sorted slots read per cell and level


@dataclasses.dataclass
class Neighborhood:
    """Fixed-shape neighbour structure of one step.

    idx[i, k]   : forward neighbour (level >= level(i)); i itself where masked
    mask[i, k]  : slot validity
    cross[i, k] : the edge's reverse direction must reach idx[i, k] (a
                  strictly larger neighbour)
    bwd_perm    : (C K,) permutation of the flattened edges sorting the cross
                  edges by target (stable), the other edges last
    bwd_seg     : (C K,) target row of each permuted edge (C if not cross)
    count       : (C,) int32 symmetric neighbour count, self included
    cell_overflow / row_overflow / level_overflow: () int32 diagnostics
    n_cross     : number of cross edges (the first n_cross of bwd_perm), read
                  once when the structure is built
    bwd_len     : (C,) cross edges per target, the segment lengths
    """

    idx: torch.Tensor
    mask: torch.Tensor
    cross: torch.Tensor
    bwd_perm: torch.Tensor
    bwd_seg: torch.Tensor
    count: torch.Tensor
    cell_overflow: torch.Tensor
    row_overflow: torch.Tensor
    level_overflow: torch.Tensor
    n_cross: int
    bwd_len: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.idx.shape[0]


def r2(diff):
    """|diff|^2 over a trailing axis of size 2, fma(dy, dy, dx * dx)."""
    return fma(diff[..., 1], diff[..., 1], diff[..., 0] * diff[..., 0])


def _f32(x: float) -> float:
    return float(np.float32(x))


def _compute_levels(sr, alive, num_levels: int):
    """The smallest level whose cell covers each search radius; returns
    (level int32, c_min () f32, level_overflow () int32)."""
    big = torch.full_like(sr, BIG)
    c_min = torch.min(torch.where(alive, sr, big))
    # all dead: 1.0 keeps the cell arithmetic finite
    c_min = torch.where(c_min >= BIG, torch.ones_like(c_min), c_min)
    ratio = torch.clamp(sr / c_min, min=1.0)
    log2 = torch.log(ratio) / torch.log(torch.tensor(2.0, dtype=ratio.dtype, device=ratio.device))
    level = torch.ceil(log2 - _f32(1e-6)).to(torch.int32)
    level_overflow = torch.any(alive & (level > num_levels - 1)).to(torch.int32)
    return torch.clamp(level, 0, num_levels - 1), c_min, level_overflow


def _finalize(idx, mask, level, row_overflow, cell_overflow, level_overflow) -> Neighborhood:
    C, K = idx.shape
    nlevel = torch.where(mask, level[idx], torch.full_like(idx, -1, dtype=level.dtype))
    cross = mask & (nlevel > level[:, None])
    flat_target = torch.where(cross.reshape(-1), idx.reshape(-1),
                              torch.full((C * K,), C, dtype=idx.dtype, device=idx.device))
    bwd_perm = torch.argsort(flat_target, stable=True)
    bwd_seg = flat_target[bwd_perm]
    bwd_len = torch.bincount(bwd_seg, minlength=C + 1)[:C]
    count = (torch.sum(mask, dim=1) + bwd_len).to(torch.int32)
    return Neighborhood(idx=idx, mask=mask, cross=cross, bwd_perm=bwd_perm, bwd_seg=bwd_seg,
                        count=count, cell_overflow=cell_overflow, row_overflow=row_overflow,
                        level_overflow=level_overflow, n_cross=int(bwd_len.sum()),
                        bwd_len=bwd_len)


def build_neighborhood(position, h, alive, radius_scale: float,
                       cfg: NeighborConfig) -> Neighborhood:
    """The forward neighbour structure of position (C, 2), h (C,), alive (C,).
    radius_scale: 2.0 for the physics radius, level_estimation_range / ETA
    for the extended search."""
    C, D = position.shape
    if C != cfg.capacity or D != 2:
        raise ValueError(f"positions {tuple(position.shape)} for capacity {cfg.capacity}, 2D")
    K, L, MPC = cfg.row_width, cfg.levels, cfg.max_per_cell
    dev = position.device
    rs = _f32(radius_scale)
    half_rs = _f32(rs * 0.5)

    sr = h * rs
    level, c_min, level_overflow = _compute_levels(sr, alive, L)
    level = torch.where(alive, level, torch.full_like(level, L))  # dead: outside every level

    inf = torch.full_like(position, BIG)
    dom_min = torch.min(torch.where(alive[:, None], position, inf), dim=0).values
    dom_min = torch.where(torch.isfinite(dom_min) & (dom_min < 1e37), dom_min,
                          torch.zeros_like(dom_min))
    dom_max = torch.max(torch.where(alive[:, None], position, -inf), dim=0).values
    dom_max = torch.where(dom_max > -1e37, dom_max, torch.zeros_like(dom_max))

    self_idx = torch.arange(C, device=dev)[:, None].expand(C, K)
    out_idx = self_idx
    out_mask = torch.zeros((C, K), dtype=torch.bool, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    row_overflow = cell_overflow = zero

    # the 3 x 3 window as one axis, (ox, oy) with ox fastest
    off = torch.tensor([(ox, oy) for oy in (-1, 0, 1) for ox in (-1, 0, 1)],
                       dtype=torch.int32, device=dev)
    arange_mpc = torch.arange(MPC, dtype=torch.int64, device=dev)
    slots = torch.arange(K, device=dev)[None, :]
    # a level no particle lives on adds no candidate: skip it (one host read)
    populated = torch.bincount(level.long(), minlength=L + 1)[:L].tolist()
    for lv in range(L):
        if populated[lv] == 0:
            continue
        cell = c_min * _f32(2.0 ** lv)
        # one cell of margin: every alive coordinate is >= 1, so the window
        # stays inside [0, width) and the row-major ids never collide
        ci = torch.floor((position - dom_min[None, :]) / cell).to(torch.int32) + 1
        width = torch.floor((dom_max[0] - dom_min[0]) / cell).to(torch.int32) + 4

        present = alive & (level == lv)
        cid = ci[:, 0] + ci[:, 1] * width
        sort_key = torch.where(present, cid, torch.full_like(cid, INT_MAX))
        order = torch.argsort(sort_key, stable=True)
        sorted_ids = sort_key[order].contiguous()

        query = alive & (level <= lv)
        ncid = (ci[:, 0:1] + off[None, :, 0]) + (ci[:, 1:2] + off[None, :, 1]) * width  # (C, 9)
        start = torch.searchsorted(sorted_ids, ncid.reshape(-1).contiguous(),
                                   right=False).reshape(C, 9)
        window = start[:, :, None] + arange_mpc  # (C, 9, MPC)
        window_c = torch.clamp(window, max=C - 1)
        cand_idx = order[window_c].reshape(C, 9 * MPC)
        valid = ((sorted_ids[window_c] == ncid[:, :, None]) & query[:, None, None]
                 & (window < C)).reshape(C, 9 * MPC)

        # cell overflow: a cell holds an (MPC + 1)-th member
        over_pos = torch.clamp(start + MPC, max=C - 1)
        over = query[:, None] & (start + MPC < C) & (sorted_ids[over_pos] == ncid)
        cell_overflow = torch.maximum(cell_overflow, torch.any(over).to(torch.int32))

        # the exact interaction test |x_ij| < radius_scale (h_i + h_j) / 2
        diff = position[:, None, :] - position[cand_idx]
        s_ij = half_rs * (h[:, None] + h[cand_idx])
        cand_valid = valid & (r2(diff) < s_ij * s_ij)

        # the first K valid candidates of [row so far, this level's], in order
        all_idx = torch.cat([out_idx, cand_idx], dim=1)
        all_valid = torch.cat([out_mask, cand_valid], dim=1)
        nvalid = torch.sum(all_valid, dim=1)
        rank = torch.cumsum(all_valid, dim=1) - 1
        slot = torch.where(all_valid & (rank < K), rank, torch.full_like(rank, K))
        out_idx = torch.zeros((C, K + 1), dtype=all_idx.dtype, device=dev).scatter_(
            1, slot, all_idx)[:, :K]
        out_mask = slots < torch.clamp(nvalid, max=K)[:, None]
        row_overflow = torch.maximum(row_overflow, torch.max(nvalid - K).to(torch.int32))

    out_idx = torch.where(out_mask, out_idx, self_idx)
    return _finalize(out_idx, out_mask, level, torch.clamp(row_overflow, min=0), cell_overflow,
                     level_overflow)


def filter_down(nb: Neighborhood, position, h, alive, radius_scale: float,
                num_levels: int) -> Neighborhood:
    """The structure cut to a smaller radius without binning again: the slot
    layout stays, the mask shrinks to |x_ij| < radius_scale h_ij, and the
    backward structure is built anew."""
    rs = _f32(radius_scale)
    sr = h * rs
    level, _, level_overflow = _compute_levels(sr, alive, num_levels)
    level = torch.where(alive, level, torch.full_like(level, num_levels))
    diff = position[:, None, :] - position[nb.idx]
    s_ij = _f32(rs * 0.5) * (h[:, None] + h[nb.idx])
    mask = nb.mask & (r2(diff) < s_ij * s_ij)
    idx = torch.where(mask, nb.idx, torch.arange(nb.capacity, device=position.device)[:, None])
    return _finalize(idx, mask, level, nb.row_overflow, nb.cell_overflow, level_overflow)


def brute_force_counts(position, h, alive, radius_scale: float):
    """O(C^2) symmetric neighbour counts (tests only)."""
    diff = position[:, None, :] - position[None, :, :]
    s_ij = _f32(_f32(radius_scale) * 0.5) * (h[:, None] + h[None, :])
    inter = (r2(diff) < s_ij * s_ij) & alive[:, None] & alive[None, :]
    return torch.sum(inter, dim=1).to(torch.int32)
