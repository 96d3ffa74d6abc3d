"""Sorted-tile layout: cell-sorted particles and per-tile candidate ranges.

Counterpart of adaptive_sph_tpu/ops/tiles.py (packed mode; the clique/patch
layout is not ported). Alive particles are sorted by (level, cell row, cell)
with one sort and packed without padding, so a sorted position IS a slot. A
particle's neighbor candidates at a level are a few contiguous slot ranges
(one per candidate cell row), found through the `cell_starts` CSR;
`window_ranges` lists them per query tile. Pair (i, j) interacts iff
|x_ij| < scale * (h_i + h_j) / 2.

The integer outputs (perm, pp, cell_starts, window meta) equal the reference's
exactly: the float arithmetic that decides a cell repeats the reference's
operations in the same order, including its compiler's folding of a division
by a constant into a multiply by the float32 reciprocal (`div_const`).
"""

from __future__ import annotations

import dataclasses

import torch

from .grid import GridConfig, by_level
from .numerics import div_const

RL = 16  # candidate-range descriptors per (tile, populated level)
WM_STRIDE = 1 + 2 * RL  # per-(tile, level) entry: [count, a0, b0, a1, b1, ...]
GW = 8  # hull-group width (lanes) inside a query tile


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Static geometry for the sorted-tile engine."""

    origin: tuple
    cell0: float
    levels: int
    nx0: int
    ny0: int
    capacity: int
    populated: tuple
    mscale: float  # the largest radius scale any pair walk uses (binning bound)
    tq: int = 32  # query-tile width
    dims_list: tuple = ()  # per-level (ny, nx); empty = nx0 >> l

    @classmethod
    def from_grid(cls, g: GridConfig, mscale: float, tq: int = 32) -> "TileConfig":
        if g.nx_raw and g.ny_raw:
            dims_list = tuple(
                (max(1, -(-g.ny_raw // (1 << l))), max(1, -(-g.nx_raw // (1 << l))))
                for l in range(g.levels)
            )
            nx0, ny0 = g.nx_raw, g.ny_raw
        else:
            dims_list = ()
            nx0, ny0 = g.nx0, g.ny0
        return cls(
            origin=g.origin, cell0=g.cell0, levels=g.levels, nx0=nx0, ny0=ny0,
            capacity=g.capacity, populated=tuple(sorted(set(g.populated))),
            mscale=float(mscale), tq=int(tq), dims_list=dims_list,
        )

    def dims(self, l: int):
        if self.dims_list:
            return self.dims_list[l]
        return self.ny0 >> l, self.nx0 >> l

    def cell(self, l: int) -> float:
        return self.cell0 * (2.0**l)

    @property
    def num_tiles(self) -> int:
        return self.capacity // self.tq

    @property
    def cell_offsets(self):
        """Flat offsets of each populated level's cell block, and the total."""
        offs, acc = {}, 0
        for l in self.populated:
            offs[l] = acc
            ny, nx = self.dims(l)
            acc += ny * nx
        return offs, acc


@dataclasses.dataclass
class TileBins:
    """Per-step sorted layout.

    perm        : (C,) sorted slot -> original particle index (C = empty slot)
    pp          : (C,) original particle -> sorted slot (C = dead)
    cell_starts : (total_cells+1,) CSR starts into the sorted array, all levels
    h_max_lvl   : (max(8, NL),) max h per populated-level position (0 elsewhere)
    n_padded    : () slots in use (the alive count)
    overflow    : () always 0 in the packed layout
    level_overflow : () alive particles above the top populated level
    """

    perm: torch.Tensor
    pp: torch.Tensor
    cell_starts: torch.Tensor
    h_max_lvl: torch.Tensor
    n_padded: torch.Tensor
    overflow: torch.Tensor
    level_overflow: torch.Tensor


def build_tiles(position, sr, h, alive, cfg: TileConfig) -> TileBins:
    """Sort alive particles into the packed tile layout.

    sr: search radius per particle (mscale * h_eff), decides the level.
    h:  smoothing length (per-level maxima bound the window ranges).
    """
    C = position.shape[0]
    dev = position.device
    P = list(cfg.populated)
    L = cfg.levels

    ratio = torch.clamp(div_const(sr, cfg.cell0), min=1.0)
    level = torch.ceil(torch.log2(ratio) - 1e-6).to(torch.int32)
    # snap up to the next populated level; above the top one is an overflow
    snap = torch.zeros_like(level)
    for lvl in P:
        snap += (level > lvl).to(torch.int32)
    level_overflow = torch.sum(alive & (snap > len(P) - 1)).to(torch.int32)
    level = by_level(torch.clamp(snap, 0, len(P) - 1), dict(enumerate(P)), 0)
    level = torch.where(alive, level, L)

    cell_size = cfg.cell0 * torch.exp2(level.to(torch.float32))
    cell_size = torch.where(level >= L, torch.full_like(cell_size, cfg.cell0), cell_size)
    nx_of = by_level(level, {lvl: cfg.dims(lvl)[1] for lvl in P}, 1)
    ny_of = by_level(level, {lvl: cfg.dims(lvl)[0] for lvl in P}, 1)
    cx = torch.floor((position[:, 0] - cfg.origin[0]) / cell_size).to(torch.int32)
    cy = torch.floor((position[:, 1] - cfg.origin[1]) / cell_size).to(torch.int32)
    cx = torch.minimum(torch.clamp(cx, min=0), nx_of - 1)
    cy = torch.minimum(torch.clamp(cy, min=0), ny_of - 1)

    coffs, total_cells = cfg.cell_offsets
    coff_of = by_level(level, coffs, 0)
    g = torch.where(alive, coff_of + cy * nx_of + cx, total_cells)

    # one sort by (cell, original index): the keys are unique, so the order
    # equals the reference's single-key sort of g * C + iota
    iota = torch.arange(C, dtype=torch.int64, device=dev)
    key = g.to(torch.int64) * C + iota
    ks = torch.sort(key).values
    src = (ks % C).to(torch.int32)
    gs = (ks // C).to(torch.int32)
    alive_s = gs < total_cells

    # the reference's (8,) table, longer where more levels are populated (its
    # tile backend leaves such grids to the neighbour-list backend)
    hm = torch.zeros(max(8, len(P)), dtype=torch.float32, device=dev)
    zero = torch.zeros_like(h)
    for p, lvl in enumerate(P):
        hm[p] = torch.max(torch.where(alive & (level == lvl), h, zero))

    n_alive = torch.sum(alive_s).to(torch.int32)
    iota32 = iota.to(torch.int32)
    perm = torch.where(alive_s, src, C)
    pp = torch.full((C + 1,), C, dtype=torch.int32, device=dev)
    pp.scatter_(0, perm.long(), iota32)  # dead slots all land on the dropped row C
    pp = pp[:C]

    # CSR cell starts: first-of-cell positions, empty cells filled from the right
    prev = torch.cat([gs[:1] - 1, gs[:-1]])
    is_first_cell = gs != prev
    starts = torch.full((total_cells + 2,), 2**30, dtype=torch.int32, device=dev)
    tgt = torch.where(alive_s & is_first_cell, gs, total_cells + 1)
    starts.scatter_(0, tgt.long(), iota32)
    starts = starts[: total_cells + 1]
    starts[total_cells] = torch.minimum(starts[total_cells], n_alive)
    starts = torch.flip(torch.cummin(torch.flip(starts, [0]), dim=0).values, [0])

    return TileBins(
        perm=perm,
        pp=pp,
        cell_starts=starts,
        h_max_lvl=hm,
        n_padded=n_alive,
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
        level_overflow=level_overflow,
    )


def sort_fields(bins: TileBins, fields):
    """Stack (C,)/(C, k) fields into one sorted (C, F) float32 table with one
    row gather; empty slots get 0."""
    cols = [f[:, None] if f.ndim == 1 else f for f in fields]
    flat = torch.cat([c.to(torch.float32) for c in cols], dim=1)
    C = flat.shape[0]
    safe = torch.clamp(bins.perm, max=C - 1).long()
    out = flat[safe]
    ok = (bins.perm < C)[:, None]
    return torch.where(ok, out, torch.zeros_like(out))


def unsort(bins: TileBins, sorted_vals, fill=0.0):
    """Sorted (C, ...) values -> original particle order; particles without a
    slot (dead) read `fill`."""
    C = sorted_vals.shape[0]
    vals = sorted_vals[torch.clamp(bins.pp, max=C - 1).long()]
    ok = (bins.pp < C).reshape((-1,) + (1,) * (vals.ndim - 1))
    return torch.where(ok, vals, torch.full_like(vals, fill))


def window_ranges(cfg: TileConfig, bins: TileBins, statics_sorted):
    """Per-tile flat candidate-range descriptors.

    Returns (wm, collapsed):
      wm: int32 (NT * NL * WM_STRIDE,). For tile t and populated-level
          position p, wm[(t*NL+p)*WM_STRIDE:] = [count, a0, b0, a1, b1, ...]:
          `count` cell-index pairs (a, b); a pair walk reads the slot range
          [cell_starts[a], cell_starts[b]).
      collapsed: () int32, (tile, level) entries whose candidate row count
          exceeded RL and were collapsed into one spanning pair (still a
          superset, so a diagnostic only).

    The tile is split into 8-lane groups; each group gets a hull rect of
    candidate cells at every level, and candidate row y's range is the x-hull
    of the groups whose rect reaches y: an exact superset of the pair set,
    disjoint across rows, ascending in slot order.
    """
    TQ = cfg.tq
    NT = cfg.capacity // TQ
    dev = statics_sorted.device
    gw = min(GW, TQ)
    GK = TQ // gw
    x = statics_sorted[:, 0].reshape(NT, GK, gw)
    y = statics_sorted[:, 1].reshape(NT, GK, gw)
    h = statics_sorted[:, 2].reshape(NT, GK, gw)
    valid = h > 0.0
    big = torch.full_like(x, 1e30)
    xmin = torch.where(valid, x, big).amin(dim=2)  # (NT, GK)
    xmax = torch.where(valid, x, -big).amax(dim=2)
    ymin = torch.where(valid, y, big).amin(dim=2)
    ymax = torch.where(valid, y, -big).amax(dim=2)
    hmax_g = torch.where(valid, h, torch.zeros_like(h)).amax(dim=2)
    alive_g = hmax_g > 0.0

    ox, oy = cfg.origin
    coffs, total_cells = cfg.cell_offsets
    kk = torch.arange(RL, dtype=torch.int32, device=dev)
    ibig, tc = 2**30, total_cells
    collapsed = torch.zeros((), dtype=torch.int32, device=dev)
    metas = []
    for p, l in enumerate(cfg.populated):
        ny, nx = cfg.dims(l)
        cellsz = cfg.cell(l)
        coff = coffs[l]
        rad = (0.5 * cfg.mscale) * (hmax_g + bins.h_max_lvl[p])

        def cell_of(v, n):
            c = torch.floor(div_const(v, cellsz)).to(torch.int32)
            return torch.clamp(c, 0, n - 1)

        cylo = cell_of(ymin - oy - rad, ny)
        cyhi = cell_of(ymax - oy + rad, ny)
        cxlo = cell_of(xmin - ox - rad, nx)
        cxhi = cell_of(xmax - ox + rad, nx)
        ylo_t = torch.where(alive_g, cylo, ibig).amin(dim=1)  # (NT,)
        yhi_t = torch.where(alive_g, cyhi, -1).amax(dim=1)
        alive_t = torch.any(alive_g, dim=1)
        nrows = torch.where(alive_t, yhi_t - ylo_t + 1, 0)
        collapse = nrows > RL
        collapsed = collapsed + torch.sum(collapse.to(torch.int32))
        cnt = torch.where(collapse, 1, nrows)
        yk = ylo_t[:, None] + kk[None, :]  # (NT, RL)
        reach = (
            alive_g[:, None, :]
            & (cylo[:, None, :] <= yk[:, :, None])
            & (yk[:, :, None] <= cyhi[:, None, :])
        )  # (NT, RL, GK)
        xlo_k = torch.where(reach, cxlo[:, None, :], ibig).amin(dim=2)
        xhi_k = torch.where(reach, cxhi[:, None, :], -1).amax(dim=2)
        row_live = torch.any(reach, dim=2)
        a = coff + (yk * nx + xlo_k)
        b = coff + (yk * nx + xhi_k + 1)
        a = torch.where(row_live, a, tc)
        b = torch.where(row_live, b, tc)
        # collapse: one pair from the first row's window start to the last
        # row's window end
        reach_lo = alive_g & (cylo <= ylo_t[:, None]) & (ylo_t[:, None] <= cyhi)
        reach_hi = alive_g & (cylo <= yhi_t[:, None]) & (yhi_t[:, None] <= cyhi)
        xlo_first = torch.where(reach_lo, cxlo, ibig).amin(dim=1)
        xhi_last = torch.where(reach_hi, cxhi, -1).amax(dim=1)
        a_span = coff + (ylo_t * nx + xlo_first)
        b_span = coff + (yhi_t * nx + xhi_last + 1)
        first = (kk == 0)[None, :]
        a = torch.where(collapse[:, None] & first, a_span[:, None], a)
        b = torch.where(collapse[:, None] & first, b_span[:, None], b)
        live = kk[None, :] < cnt[:, None]
        a = torch.where(live, a, tc)
        b = torch.where(live, b, tc)
        ent = torch.cat([cnt[:, None], torch.stack([a, b], dim=2).reshape(NT, 2 * RL)], dim=1)
        metas.append(ent)  # (NT, WM_STRIDE)
    wm = torch.stack(metas, dim=1).reshape(-1).to(torch.int32)
    return wm, collapsed


def window_meta(cfg: TileConfig, bins: TileBins, statics_sorted):
    """window_ranges without the collapsed diagnostic."""
    return window_ranges(cfg, bins, statics_sorted)[0]
