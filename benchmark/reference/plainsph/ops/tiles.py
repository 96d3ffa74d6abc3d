"""Sorted-tile layout: cell-sorted particles and per-tile candidate ranges.

Counterpart of adaptive_sph_tpu/ops/tiles.py, in both of its layouts:

- packed (TileConfig.patch == 0, the default): alive particles are sorted by
  (level, cell row, cell) with one sort and packed without padding, so a
  sorted position IS a slot. A particle's neighbor candidates at a level are
  a few contiguous slot ranges (one per candidate cell row), found through
  the `cell_starts` CSR; `window_ranges` lists them per query tile.
- patch-major (patch = P >= 2, the clique layout of ops/cliques.py, taken
  under ASPH_CLIQUE): cells are numbered patch by patch (P x P cells each,
  the level's grid padded to whole patches) and every occupied patch is
  padded to PATCH_SLOTS slots, so a query tile of 128 is one patch.
  `build_halo` lists each patch's same-level ring particles (its 128 halo
  slots); `window_ranges` emits whole patch rows, and with cross_only only
  the other levels' entries (the cross-level pairs K1 walks).

Pair (i, j) interacts iff |x_ij| < scale * (h_i + h_j) / 2.

The integer outputs (perm, pp, cell_starts, n_padded, n_patches, overflow,
the halo map and the window meta) equal the reference's exactly: the float
arithmetic that decides a cell repeats the reference's operations in the
same order, including its compiler's folding of a division by a constant
into a multiply by the float32 reciprocal (`div_const`). One deliberate
difference: `build_halo` clips cell coordinates to the level's dims, as
build_tiles bins them; the reference clips to the padded patch grid there,
so a particle past the grid's +x / +y edge in a level whose dims are not a
multiple of P joins the wrong patch's ring and its pairs are lost.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .grid import GridConfig, by_level
from .numerics import div_const

RL = 16  # candidate-range descriptors per (tile, populated level)
PATCH_SLOTS = 128  # slots per occupied patch in the patch-major layout, and its halo budget
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
    patch: int = 0  # patch side in cells: 0 = packed layout, >= 2 = patch-major

    def patch_dims(self, l: int):
        """(npy, npx): level l's grid of patches (patch mode)."""
        ny, nx = self.dims(l)
        return -(-ny // self.patch), -(-nx // self.patch)

    @classmethod
    def from_grid(cls, g: GridConfig, mscale: float, tq: int = 32,
                  patch: int = 0) -> "TileConfig":
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
            mscale=float(mscale), tq=int(tq), dims_list=dims_list, patch=int(patch),
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
        """Flat offsets of each populated level's cell block, and the total.
        Patch mode pads each level's grid to whole patches, so a patch's
        cells are one aligned block of ids: patch = cell id // P^2."""
        offs, acc = {}, 0
        for l in self.populated:
            offs[l] = acc
            if self.patch:
                npy, npx = self.patch_dims(l)
                acc += npy * npx * self.patch * self.patch
            else:
                ny, nx = self.dims(l)
                acc += ny * nx
        return offs, acc

    @property
    def patch_offsets(self):
        """Patch mode: flat offsets of each level's patch block, and the total."""
        offs, tot = self.cell_offsets
        P2 = self.patch * self.patch
        return {l: o // P2 for l, o in offs.items()}, tot // P2


@dataclasses.dataclass
class TileBins:
    """Per-step sorted layout.

    perm        : (C,) sorted slot -> original particle index (C = empty slot)
    pp          : (C,) original particle -> sorted slot (C = dead)
    cell_starts : (total_cells+1,) CSR starts into the sorted array, all levels
    h_max_lvl   : (max(8, NL),) max h per populated-level position (0 elsewhere)
    n_padded    : () slots in use (the alive count; PATCH_SLOTS x n_patches,
                  at most C, in patch mode)
    overflow    : () alive particles without a slot: always 0 in the packed
                  layout; in patch mode those of a patch fuller than
                  PATCH_SLOTS or past the capacity
    level_overflow : () alive particles above the top populated level
    n_patches   : () occupied patches (patch mode; None otherwise)
    """

    perm: torch.Tensor
    pp: torch.Tensor
    cell_starts: torch.Tensor
    h_max_lvl: torch.Tensor
    n_padded: torch.Tensor
    overflow: torch.Tensor
    level_overflow: torch.Tensor
    n_patches: Optional[torch.Tensor] = None


def build_tiles(position, sr, h, alive, cfg: TileConfig) -> TileBins:
    """Sort alive particles into the tile layout: packed, or patch-major
    with PATCH_SLOTS slots per occupied patch when cfg.patch > 0.

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
    if cfg.patch:
        # patch-major numbering: a patch's P x P cells are one block of ids
        PS = cfg.patch
        npx_of = by_level(level, {lvl: cfg.patch_dims(lvl)[1] for lvl in P}, 1)
        local = (cy % PS) * PS + (cx % PS)
        g = torch.where(alive, coff_of + ((cy // PS) * npx_of + cx // PS) * (PS * PS) + local,
                        total_cells)
    else:
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

    iota32 = iota.to(torch.int32)
    if cfg.patch:
        return _pad_patches(cfg, gs, src, alive_s, iota32, hm, level_overflow, total_cells)
    n_alive = torch.sum(alive_s).to(torch.int32)
    perm = torch.where(alive_s, src, C)
    pp = _scatter_drop(C, C, perm, iota32, dev)  # dead slots all land on the dropped row C
    starts = _cell_starts(gs, alive_s, iota32, n_alive, total_cells)

    return TileBins(
        perm=perm,
        pp=pp,
        cell_starts=starts,
        h_max_lvl=hm,
        n_padded=n_alive,
        overflow=torch.zeros((), dtype=torch.int32, device=dev),
        level_overflow=level_overflow,
    )


def _first_of_run(v):
    """True where v differs from its predecessor (and at 0)."""
    return v != torch.cat([v[:1] - 1, v[:-1]])


def _scatter_drop(n: int, fill: int, idx, vals, dev):
    """(n,) int32 filled with `fill`, vals written at idx; idx == n drops."""
    out = torch.full((n + 1,), fill, dtype=torch.int32, device=dev)
    out.scatter_(0, idx.long(), vals.to(torch.int32))
    return out[:n]


def _cell_starts(gs, write, dest, n_padded, total_cells):
    """CSR cell starts: each cell's first written entry's slot, empty cells
    filled from the right."""
    dev = gs.device
    tgt = torch.where(write & _first_of_run(gs), gs, total_cells + 1)
    starts = _scatter_drop(total_cells + 2, 2**30, tgt, dest, dev)[: total_cells + 1]
    starts[total_cells] = torch.minimum(starts[total_cells], n_padded)
    return torch.flip(torch.cummin(torch.flip(starts, [0]), dim=0).values, [0])


def _pad_patches(cfg: TileConfig, gs, src, alive_s, iota32, hm, level_overflow, total_cells):
    """Patch-mode tail of build_tiles: each occupied patch's particles, in
    sorted order, take the first slots of its own PATCH_SLOTS-slot block."""
    C = gs.shape[0]
    dev = gs.device
    pg = gs // (cfg.patch * cfg.patch)  # patch id of each sorted entry
    is_first = alive_s & _first_of_run(pg)
    o = torch.cumsum(is_first.to(torch.int32), 0, dtype=torch.int32) - 1  # occupied patch index
    seg_start = torch.cummax(torch.where(is_first, iota32, -1), 0).values
    r = iota32 - seg_start
    n_patches = torch.sum(is_first).to(torch.int32)
    d = o * PATCH_SLOTS + r
    ok = alive_s & (r < PATCH_SLOTS) & (d < C)
    overflow = torch.sum(alive_s & ~ok).to(torch.int32)
    n_padded = torch.clamp(n_patches * PATCH_SLOTS, max=C)
    perm = _scatter_drop(C, C, torch.where(ok, d, C), src, dev)
    pp = _scatter_drop(C, C, torch.where(ok, src, C), d, dev)
    # padding between patches extends the previous patch's last occupied cell
    # (every walk masks it by h == 0)
    starts = _cell_starts(gs, ok, d, n_padded, total_cells)
    return TileBins(perm=perm, pp=pp, cell_starts=starts, h_max_lvl=hm, n_padded=n_padded,
                    overflow=overflow, level_overflow=level_overflow, n_patches=n_patches)


# the 8 halo directions (dy, dx): a particle in the edge cell of its patch is
# a same-level candidate of the adjacent patch(es); the one-cell ring is an
# exact superset, since a level-l pair's radius 0.5 mscale (h_i + h_j) is at
# most cell(l) by the level assignment
HALO_DIRS = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1))


def halo_membership(cfg: TileConfig, statics_sorted, h_max_lvl):
    """Per sorted slot, its level's geometry and the directions in whose
    ring it lies. Returns (px, py, pid, npx, npy, [member (C,) bool per
    HALO_DIRS entry]): a particle joins the ring of the adjacent patch in
    direction (dy, dx) iff it sits in the edge cell toward it and within
    0.5 mscale (h + h_max of its level) of that patch's rectangle.

    Cell coordinates clip to the level's dims, as build_tiles bins them
    (the reference clips to the padded patch grid: see the module
    docstring)."""
    PS = cfg.patch
    NL = len(cfg.populated)
    poffs, _ = cfg.patch_offsets
    ox, oy = cfg.origin
    x, y, h = statics_sorted[:, 0], statics_sorted[:, 1], statics_sorted[:, 2]
    real = h > 0.0
    # the level position from h, the ladder snap of build_tiles
    ratio = torch.clamp(div_const(h * float(np.float32(cfg.mscale)), cfg.cell0), min=1.0)
    lvl = torch.ceil(torch.log2(ratio) - 1e-6).to(torch.int32)
    lvl_pos = torch.zeros_like(lvl)
    for l in cfg.populated:
        lvl_pos += (lvl > l).to(torch.int32)
    lvl_pos = torch.clamp(lvl_pos, 0, NL - 1)
    pos_of = dict(enumerate(cfg.populated))

    def sel(vals):
        return by_level(lvl_pos, {p: vals(l) for p, l in pos_of.items()}, 0)

    cell_s = torch.zeros_like(x)
    for p, l in pos_of.items():
        cell_s = torch.where(lvl_pos == p, float(np.float32(cfg.cell(l))), cell_s)
    npx_s = sel(lambda l: cfg.patch_dims(l)[1])
    npy_s = sel(lambda l: cfg.patch_dims(l)[0])
    poff_s = sel(lambda l: poffs[l])
    nx_s = sel(lambda l: cfg.dims(l)[1])
    ny_s = sel(lambda l: cfg.dims(l)[0])
    hml = h_max_lvl[lvl_pos.long()]

    fx = (x - float(np.float32(ox))) / cell_s
    fy = (y - float(np.float32(oy))) / cell_s
    cx = torch.minimum(torch.clamp(torch.floor(fx).to(torch.int32), min=0), nx_s - 1)
    cy = torch.minimum(torch.clamp(torch.floor(fy).to(torch.int32), min=0), ny_s - 1)
    px, py = cx // PS, cy // PS
    pid = poff_s + py * npx_s + px
    rad = float(np.float32(0.5 * np.float32(cfg.mscale))) * (h + hml)
    zero = torch.zeros_like(fx)
    members = []
    for dy, dx in HALO_DIRS:
        m = real
        if dx < 0:
            m = m & (cx % PS == 0)
        elif dx > 0:
            m = m & (cx % PS == PS - 1)
        if dy < 0:
            m = m & (cy % PS == 0)
        elif dy > 0:
            m = m & (cy % PS == PS - 1)
        # within rad of the neighbour patch's rectangle: the axis gap bounds
        # every pair distance into it from below
        gapx = zero if dx == 0 else (
            ((px + 1) * PS).to(torch.float32) - fx if dx > 0 else fx - (px * PS).to(torch.float32))
        gapy = zero if dy == 0 else (
            ((py + 1) * PS).to(torch.float32) - fy if dy > 0 else fy - (py * PS).to(torch.float32))
        gap2 = (gapx * gapx + gapy * gapy) * cell_s * cell_s
        members.append(m & (gap2 < rad * rad))
    return px, py, pid, npx_s, npy_s, members


def build_halo(cfg: TileConfig, bins: TileBins, statics_sorted):
    """Per-patch same-level halo slot map from the padded sorted statics.

    Returns (halo_src (C,) int32, halo_overflow () int32): for occupied
    patch o, halo_src[PATCH_SLOTS * o + r] is the sorted slot of its r-th
    halo particle (C where absent). Ring particles are listed by direction
    (HALO_DIRS order), each direction's in slot order; halo_overflow counts
    the members that found no free halo slot."""
    C = statics_sorted.shape[0]
    dev = statics_sorted.device
    NB = C // PATCH_SLOTS
    _, TOTP = cfg.patch_offsets
    px, py, pid, npx_s, npy_s, members = halo_membership(cfg, statics_sorted, bins.h_max_lvl)
    iota = torch.arange(C, dtype=torch.int32, device=dev)

    # per occupied patch (row of PATCH_SLOTS slots) its geometry from slot 0
    def row0(a):
        return a.reshape(NB, PATCH_SLOTS)[:, 0]

    row_occ = row0(statics_sorted[:, 2] > 0.0)
    pid_row = torch.where(row_occ, row0(pid), TOTP)
    px_row, py_row, npx_row, npy_row = row0(px), row0(py), row0(npx_s), row0(npy_s)
    rows = torch.arange(NB, dtype=torch.int32, device=dev)
    po = torch.full((TOTP + 1,), NB, dtype=torch.int32, device=dev)
    po.scatter_(0, pid_row.long(), rows)  # patch id -> row (row TOTP: unoccupied)

    o_dest, cnt = [], []
    for (dy, dx), m in zip(HALO_DIRS, members):
        vr = (row_occ & (py_row + dy >= 0) & (py_row + dy < npy_row)
              & (px_row + dx >= 0) & (px_row + dx < npx_row))
        nb = torch.clamp(pid_row + dy * npx_row + dx, 0, TOTP).long()
        o_dest.append(torch.where(vr, po[nb], NB))
        cnt.append(m.reshape(NB, PATCH_SLOTS).sum(1, dtype=torch.int32))
    o_dest = torch.stack(o_dest, 1)  # (NB, 8) destination row per direction
    cnt = torch.stack(cnt, 1)  # (NB, 8) members leaving per direction

    # arriving[dest, d] = cnt[the one source row of (dest, d), d]
    has = o_dest < NB
    dest = torch.where(has, o_dest, NB).long()
    dcol = torch.arange(8, device=dev)[None, :].expand(NB, 8)
    arriving = torch.zeros((NB + 1, 8), dtype=torch.int32, device=dev)
    arriving[dest, dcol] = torch.where(has, cnt, 0)
    base = torch.cumsum(arriving, 1, dtype=torch.int32) - arriving  # exclusive over directions
    base_at_src = base[dest, dcol]

    halo_src = torch.full((C + 1,), C, dtype=torch.int32, device=dev)
    halo_overflow = torch.zeros((), dtype=torch.int32, device=dev)
    for di, m in enumerate(members):
        mr = m.reshape(NB, PATCH_SLOTS).to(torch.int32)
        rank = (torch.cumsum(mr, 1, dtype=torch.int32) - mr).reshape(C)
        off = torch.repeat_interleave(base_at_src[:, di], PATCH_SLOTS) + rank
        odp = torch.repeat_interleave(o_dest[:, di], PATCH_SLOTS)
        leaving = m & (odp < NB)
        valid = leaving & (off < PATCH_SLOTS)
        halo_overflow = halo_overflow + torch.sum(leaving & ~valid).to(torch.int32)
        hs = torch.where(valid, odp * PATCH_SLOTS + off, C)
        halo_src.scatter_(0, hs.long(), iota)
    return halo_src[:C], halo_overflow


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


def window_ranges(cfg: TileConfig, bins: TileBins, statics_sorted, cross_only: bool = False):
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

    Patch mode: rows are patch rows and x units whole patches (P^2 contiguous
    cell ids each), since a geometric cell row is not contiguous there; the
    ranges hold padding slots, which every walk masks by h == 0. cross_only
    (patch mode, tq = PATCH_SLOTS) also empties each tile's own-level entry:
    the tiles are level-pure patches, whose same-level pairs the clique
    operator (ops/cliques.py) owns.
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
    if cross_only:
        if not cfg.patch or TQ != PATCH_SLOTS:
            raise ValueError("cross_only ranges need the patch-major layout at tq = 128")
        # each tile's own level position, the ladder snap of build_tiles from
        # the tile's largest h
        ratio_t = torch.clamp(div_const(hmax_g.amax(dim=1) * float(np.float32(cfg.mscale)),
                                        cfg.cell0), min=1.0)
        lvl_t = torch.ceil(torch.log2(ratio_t) - 1e-6).to(torch.int32)
        own_pos = torch.zeros_like(lvl_t)
        for l in cfg.populated:
            own_pos += (lvl_t > l).to(torch.int32)
        own_pos = torch.clamp(own_pos, 0, len(cfg.populated) - 1)
    metas = []
    for p, l in enumerate(cfg.populated):
        if cfg.patch:
            ny, nx = cfg.patch_dims(l)
            unit = cfg.patch * cfg.patch
            cellsz = cfg.cell(l) * cfg.patch
        else:
            ny, nx = cfg.dims(l)
            unit = 1
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
        if cross_only:
            alive_t = alive_t & (own_pos != p)
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
        a = coff + (yk * nx + xlo_k) * unit
        b = coff + (yk * nx + xhi_k + 1) * unit
        a = torch.where(row_live, a, tc)
        b = torch.where(row_live, b, tc)
        # collapse: one pair from the first row's window start to the last
        # row's window end
        reach_lo = alive_g & (cylo <= ylo_t[:, None]) & (ylo_t[:, None] <= cyhi)
        reach_hi = alive_g & (cylo <= yhi_t[:, None]) & (yhi_t[:, None] <= cyhi)
        xlo_first = torch.where(reach_lo, cxlo, ibig).amin(dim=1)
        xhi_last = torch.where(reach_hi, cxhi, -1).amax(dim=1)
        a_span = coff + (ylo_t * nx + xlo_first) * unit
        b_span = coff + (yhi_t * nx + xhi_last + 1) * unit
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
