"""Multi-level cell grids: the static geometry and the dense grid engine's slot layout.

Counterpart of adaptive_sph_tpu/ops/grid.py. The level ladder is cell0 * 2^l
over a scene-wide origin (`GridConfig`, `make_grid_config`); the tile engine
(ops/tiles.py) derives its `TileConfig` from it. The dense grid engine
(`backend="grid"`) bins particles into per-level grid tensors of
(ny_l, nx_l, mpc) slots with one sort and one scatter (`build_bins`,
`scatter_field`); a particle's candidates are the 3 x 3 cells around its
slot on every level, taken as shifted slices of those tensors, and the
cross-level windows come from power-of-two up- and downsampling
(models/grid_pairs.py). Plain torch, as the reference is XLA array code.

The integer outputs of `build_bins` equal the reference's bit for bit: the
level and the cell repeat its float operations in its order (the level's
log2 as the list backend's `_compute_levels` takes it, the division by the
constant cell0 folded into a multiply, `div_const`), and the rank inside a
cell follows a stable sort, so a full cell drops the particles JAX drops.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .numerics import div_const


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Static grid geometry."""

    origin: tuple  # (x, y) world coords of cell (0, 0) corner
    cell0: float  # finest cell size; covers the largest search radius of level 0
    levels: int  # L; level l has cell size cell0 * 2^l
    nx0: int  # finest grid dims (divisible by 2^(L-1))
    ny0: int
    mpc: int = 48  # max particles per cell (dense grid engine only)
    capacity: int = 0  # C (flat particle capacity)
    populated: tuple = ()  # levels that can hold particles
    nx_raw: int = 0  # finest dims before the 2^(L-1) rounding
    ny_raw: int = 0

    def dims(self, l: int):
        return self.ny0 >> l, self.nx0 >> l

    def cell(self, l: int) -> float:
        return self.cell0 * (2.0**l)

    @property
    def slots_per_level(self):
        return [self.dims(l)[0] * self.dims(l)[1] * self.mpc for l in range(self.levels)]

    @property
    def level_offsets(self):
        """(start slot of each level, total slots)."""
        offs, acc = [], 0
        for s in self.slots_per_level:
            offs.append(acc)
            acc += s
        return offs, acc


def make_grid_config(
    box_min,
    box_max,
    max_search_radius_factor: float,
    h_min: float,
    h_max: float,
    capacity: int,
    mpc: int = 32,
    adaptive_all_levels: bool = False,
) -> GridConfig:
    """Derive the static ladder from the scene bounds and the expected h range.

    cell0 covers the largest search radius of the smallest particles; levels
    stop where one cell covers the whole domain (larger particles then trip
    the level_overflow check)."""
    sr_min = max_search_radius_factor * h_min * 1.0001
    sr_max = max_search_radius_factor * h_max * 1.0001
    levels = max(1, int(math.ceil(math.log2(max(sr_max / sr_min, 1.0)))) + 1)
    cell0 = sr_min
    domain = max(box_max[0] - box_min[0], box_max[1] - box_min[1])
    levels_cap = max(1, int(math.ceil(math.log2(max(domain / cell0, 1.0)))) + 1)
    levels = min(levels, levels_cap)

    pad = cell0
    ox, oy = box_min[0] - pad, box_min[1] - pad
    ex = (box_max[0] + pad) - ox
    ey = (box_max[1] + pad) - oy
    align = 2 ** (levels - 1)

    def dim_raw(e):
        return int(math.ceil(e / cell0)) + 1

    def dim(e):
        n = dim_raw(e)
        return ((n + align - 1) // align) * align

    populated = tuple(range(levels)) if adaptive_all_levels else None
    return GridConfig(
        nx_raw=dim_raw(ex), ny_raw=dim_raw(ey),
        origin=(float(ox), float(oy)),
        cell0=float(cell0),
        levels=levels,
        nx0=dim(ex),
        ny0=dim(ey),
        mpc=mpc,
        capacity=capacity,
        populated=populated if populated is not None else tuple(range(levels)),
    )


@dataclasses.dataclass
class GridBins:
    """Per-step binning: which particle sits in which slot.

    slot_of[p]     : flat slot index of particle p (-1: dead or dropped)
    level_of[p]    : level of particle p (L for dead)
    slot_idx       : (total_slots,) particle in each slot (C for empty)
    slot_mask      : (total_slots,) bool
    overflow       : () int32 alive particles dropped because their cell was full
    level_overflow : () int32 alive particles whose radius exceeds the top populated level
    """

    slot_of: torch.Tensor
    level_of: torch.Tensor
    slot_idx: torch.Tensor
    slot_mask: torch.Tensor
    overflow: torch.Tensor
    level_overflow: torch.Tensor


def by_level(level, table: dict, default: int):
    """table[level] for the levels the table names, `default` elsewhere: a
    short chain of selects, so no lookup table is copied to the device."""
    out = torch.full_like(level, default)
    for lvl, v in table.items():
        out = torch.where(level == lvl, v, out)
    return out


def build_bins(position, sr, alive, cfg: GridConfig) -> GridBins:
    """Assign (level, cell, rank) per particle: one sort, one scatter.

    sr: the search radius per particle; a particle takes the smallest
    populated level whose cell covers it."""
    C = position.shape[0]
    L = cfg.levels
    dev = position.device

    ratio = torch.clamp(div_const(sr, cfg.cell0), min=1.0)
    log2 = torch.log(ratio) / torch.log(torch.tensor(2.0, dtype=ratio.dtype, device=dev))
    level = torch.ceil(log2 - float(np.float32(1e-6))).to(torch.int32)
    # snap up to the next populated level (a larger cell still covers the
    # radius); above the top one is an overflow
    pop = sorted(set(cfg.populated))
    snap = torch.zeros_like(level)
    for lvl in pop:
        snap += (level > lvl).to(torch.int32)
    level_overflow = torch.sum(alive & (snap > len(pop) - 1)).to(torch.int32)
    level = by_level(torch.clamp(snap, 0, len(pop) - 1), dict(enumerate(pop)), 0)
    level = torch.where(alive, level, L)

    # the cell at the particle's own level
    cell_size = cfg.cell0 * torch.exp2(level.to(torch.float32))
    cell_size = torch.where(level >= L, torch.full_like(cell_size, cfg.cell0), cell_size)
    cx = torch.floor((position[:, 0] - cfg.origin[0]) / cell_size).to(torch.int32)
    cy = torch.floor((position[:, 1] - cfg.origin[1]) / cell_size).to(torch.int32)
    nx_of = by_level(level, {lvl: cfg.dims(lvl)[1] for lvl in range(L)}, 1)
    ny_of = by_level(level, {lvl: cfg.dims(lvl)[0] for lvl in range(L)}, 1)
    cx = torch.minimum(torch.clamp(cx, min=0), nx_of - 1)
    cy = torch.minimum(torch.clamp(cy, min=0), ny_of - 1)
    cell_id = cx + cy * nx_of

    offsets, total = cfg.level_offsets
    mpc = cfg.mpc
    cell_base = by_level(level, {lvl: o // mpc for lvl, o in enumerate(offsets)},
                         total // mpc) + cell_id
    cell_base = torch.where(alive, cell_base, total // mpc)

    # the rank within a cell: a stable sort over the global cell numbers
    # (ties keep the particle order, as the reference's argsort does)
    sorted_cells, order = torch.sort(cell_base, stable=True)
    iota = torch.arange(C, dtype=torch.int32, device=dev)
    first = torch.searchsorted(sorted_cells, sorted_cells, right=False).to(torch.int32)
    rank = torch.empty_like(iota)
    rank[order] = iota - first

    fits = alive & (rank < mpc)
    overflow = torch.sum(alive & ~fits).to(torch.int32)
    slot_of = torch.where(fits, cell_base * mpc + rank, -1)

    # dropped particles land in one extra slot, sliced off
    slot_idx = torch.full((total + 1,), C, dtype=torch.int32, device=dev)
    slot_idx[torch.where(fits, slot_of, total).long()] = iota
    slot_idx = slot_idx[:total]
    return GridBins(slot_of=slot_of, level_of=level, slot_idx=slot_idx, slot_mask=slot_idx < C,
                    overflow=overflow, level_overflow=level_overflow)


def scatter_field(bins: GridBins, cfg: GridConfig, field):
    """Flat (C, ...) -> slot layout (total_slots, ...), empty slots 0."""
    _, total = cfg.level_offsets
    out = torch.zeros((total + 1,) + tuple(field.shape[1:]), dtype=field.dtype,
                      device=field.device)
    out[torch.where(bins.slot_of >= 0, bins.slot_of, total).long()] = field
    return out[:total]


def gather_result(bins: GridBins, cfg: GridConfig, slot_values, fill=0.0):
    """Slot layout -> flat (C, ...); dead and dropped particles get `fill`."""
    vals = slot_values[torch.clamp(bins.slot_of, min=0).long()]
    ok = (bins.slot_of >= 0).reshape((-1,) + (1,) * (vals.ndim - 1))
    return torch.where(ok, vals, torch.full_like(vals, fill))


def level_view(cfg: GridConfig, slot_array, l: int):
    """The slots of level l as a (ny_l, nx_l, mpc, ...) view."""
    offs, _ = cfg.level_offsets
    ny, nx = cfg.dims(l)
    n = ny * nx * cfg.mpc
    a = slot_array[offs[l]: offs[l] + n]
    return a.reshape((ny, nx, cfg.mpc) + tuple(a.shape[1:]))


def _shift1(a, d: int, axis: int, fill):
    n = a.shape[axis]
    if d == 0:
        return a
    out = torch.full_like(a, fill)
    m = n - abs(d)
    if m > 0:
        src = a.narrow(axis, max(d, 0), m)
        out.narrow(axis, max(-d, 0), m).copy_(src)
    return out


def shift2d(a, dy: int, dx: int, fill):
    """out[y, x] = a[y + dy, x + dx], `fill` outside the grid."""
    return _shift1(_shift1(a, dy, 0, fill), dx, 1, fill)


def upsample2d(a, factor: int):
    """Repeat each cell factor x factor (coarse -> fine resolution)."""
    if factor == 1:
        return a
    return torch.repeat_interleave(torch.repeat_interleave(a, factor, dim=0), factor, dim=1)


def _blocks(a, factor: int):
    ny, nx = a.shape[0], a.shape[1]
    return a.reshape((ny // factor, factor, nx // factor, factor) + tuple(a.shape[2:]))


def downsample_sum2d(a, factor: int):
    """Sum fine cells into their parent (fine -> coarse resolution). On the
    CPU the factor x factor children are added one by one in row-major
    order, the order of the reference's compiled reduction (so the sum is
    bit-equal to it); on the card in torch.sum's order."""
    if factor == 1:
        return a
    r = _blocks(a, factor)
    if a.device.type != "cpu":
        return torch.sum(r, dim=(1, 3))
    acc = r[:, 0, :, 0]
    for k in range(1, factor * factor):
        acc = acc + r[:, k // factor, :, k % factor]
    return acc


def downsample_max2d(a, factor: int):
    if factor == 1:
        return a
    return torch.amax(_blocks(a, factor), dim=(1, 3))


OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
