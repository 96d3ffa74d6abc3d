"""Static multi-level grid geometry: `GridConfig` and `make_grid_config`.

Counterpart of the config part of adaptive_sph_tpu/ops/grid.py. The level
ladder is cell0 * 2^l over a scene-wide origin; the tile engine
(ops/tiles.py) derives its `TileConfig` from it. The dense grid engine of the
JAX package is not ported.
"""

from __future__ import annotations

import dataclasses
import math


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
