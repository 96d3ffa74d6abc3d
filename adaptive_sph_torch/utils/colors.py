"""Attribute colouring: the 12 visualised attributes and the flag overrides.

Counterpart of adaptive_sph_tpu/utils/colors.py, on the host in numpy (the
snapshot is already there). The viridis and inferno maps are the same 32
stops the reference samples from matplotlib, kept as constants in
`colormap_tables` (scripts/torch_port_colormaps.py writes them), so the port
needs no matplotlib.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np

from ..models.state import SIZE_LARGE, SIZE_OPTIMAL, SIZE_SMALL, SIZE_TOO_LARGE, SIZE_TOO_SMALL
from ..ops import kernels
from .colormap_tables import INFERNO, VIRIDIS
from .params import SimulationParams


class VisualizedAttribute(str, enum.Enum):
    Distance = "Distance"
    SingleColor = "SingleColor"
    ParticleSizeClass = "ParticleSizeClass"
    Pressure = "Pressure"
    Density = "Density"
    Velocity = "Velocity"
    RandomColor = "RandomColor"
    Aii = "Aii"
    NeighborCount = "NeighborCount"
    MinDistanceToNeighbor = "MinDistanceToNeighbor"
    ConstantField = "ConstantField"
    SourceTerm = "SourceTerm"


@dataclasses.dataclass(frozen=True)
class VisualizationParams:
    visualized_attribute: VisualizedAttribute = VisualizedAttribute.Velocity
    draw_shape: str = "FilledCircleWithBorder"
    draw_support_radius: bool = False
    show_flag_is_fluid_surface: bool = False
    show_flag_neighborhood_reduced: bool = False
    take_data_from_stash: bool = False

    @classmethod
    def from_dict(cls, d: dict) -> "VisualizationParams":
        kw = dict(d)
        if "visualized_attribute" in kw:
            kw["visualized_attribute"] = VisualizedAttribute(kw["visualized_attribute"])
        return cls(**kw)


class ColorMap:
    """Piecewise-linear colour stops [(x, (r, g, b)), ...]."""

    def __init__(self, stops):
        self.stops = sorted(stops, key=lambda s: s[0])
        self.xs = np.asarray([s[0] for s in self.stops], np.float64)
        self.cols = np.asarray([s[1] for s in self.stops], np.float64)

    def get(self, x):
        x = np.asarray(x, np.float64)
        out = np.empty(x.shape + (3,), np.float64)
        for c in range(3):
            out[..., c] = np.interp(x, self.xs, self.cols[:, c])
        return out


def _sampled_map(table, vmin: float, vmax: float) -> ColorMap:
    ts = np.linspace(0.0, 1.0, len(table))
    return ColorMap([(vmin + (vmax - vmin) * t, rgb) for t, rgb in zip(ts, table)])


def color_map_viridis(vmin, vmax):
    return _sampled_map(VIRIDIS, vmin, vmax)


def color_map_inferno(vmin, vmax):
    return _sampled_map(INFERNO, vmin, vmax)


def get_color_map(attr: VisualizedAttribute, params: SimulationParams) -> Optional[ColorMap]:
    A = VisualizedAttribute
    if attr == A.SourceTerm:
        return color_map_viridis(-6000.0, 6000.0)
    if attr == A.Aii:
        return ColorMap([(-1.0, (1, 0, 0)), (0.0, (1, 1, 1)), (50.0, (0, 0, 1))])
    if attr == A.Distance:
        return color_map_inferno(-params.maximum_surface_distance, 0.0)
    if attr == A.Velocity:
        return color_map_viridis(0.0, 4.0)
    if attr == A.Density:
        return ColorMap([(0.9, (0, 0, 1)), (1.0, (1, 1, 1)), (1.01, (1, 0, 0))])
    if attr == A.NeighborCount:
        return ColorMap([(-4.0, (0, 0, 1)), (-2.0, (0, 1, 1)), (0.0, (0, 1, 0)),
                         (2.0, (1, 1, 0)), (4.0, (1, 0, 0))])
    if attr == A.ConstantField:
        diff = 1.05
        return ColorMap([(2.0 - diff, (0, 0, 1)), (1.0, (1, 1, 1)), (diff, (1, 0, 0))])
    if attr == A.MinDistanceToNeighbor:
        return ColorMap([(0.0, (1, 0, 0)), (0.1, (1, 1, 0)), (0.3, (0, 1, 0)),
                         (1.0, (0, 0, 1)), (1.2, (1, 0, 1))])
    return None


def get_color_map_for_pressure(max_pressure: float) -> ColorMap:
    return ColorMap([(0.0, (1, 1, 1)), (max(max_pressure, 1e-9), (1, 0, 0))])


SIZE_CLASS_COLORS = {
    SIZE_TOO_SMALL: (0.0, 0.0, 1.0),
    SIZE_SMALL: (0.5, 0.5, 1.0),
    SIZE_OPTIMAL: (1.0, 1.0, 1.0),
    SIZE_LARGE: (1.0, 0.5, 0.5),
    SIZE_TOO_LARGE: (1.0, 0.0, 0.0),
}


def _random_colors(n: int) -> np.ndarray:
    """A fixed hash of the particle index to RGB."""
    idx = np.arange(n, dtype=np.uint64)
    v = idx * np.uint64(0x9E3779B97F4A7C15)
    v ^= v >> np.uint64(29)
    v *= np.uint64(0xBF58476D1CE4E5B9)
    r = (v & np.uint64(0xFF)).astype(np.float64) / 255.0
    g = ((v >> np.uint64(8)) & np.uint64(0xFF)).astype(np.float64) / 255.0
    b = ((v >> np.uint64(16)) & np.uint64(0xFF)).astype(np.float64) / 255.0
    return np.stack([r, g, b], -1)


def colors_for_particles(snapshot: dict, params: SimulationParams, viz: VisualizationParams,
                         max_pressure: Optional[float] = None) -> np.ndarray:
    """(n, 3) float64 RGB in [0, 1] of the snapshot's alive particles
    (`utils.snapshot.take_snapshot`)."""
    A = VisualizedAttribute
    attr = viz.visualized_attribute
    n = snapshot["mass"].shape[0]

    if attr == A.Aii:
        out = get_color_map(attr, params).get(snapshot["aii"])
    elif attr == A.Distance:
        if viz.take_data_from_stash:
            dist = snapshot["stash"]
        else:
            dist = np.where(snapshot["has_level"], snapshot["level"],
                            -params.maximum_surface_distance)
        out = get_color_map(attr, params).get(dist)
    elif attr == A.Pressure:
        mp = max_pressure if max_pressure is not None else float(snapshot["pressure"].max())
        out = get_color_map_for_pressure(mp).get(snapshot["pressure"])
    elif attr == A.Velocity:
        out = get_color_map(attr, params).get(np.linalg.norm(snapshot["velocity"], axis=-1))
    elif attr == A.Density:
        out = get_color_map(attr, params).get(snapshot["density"] / params.rest_density)
    elif attr == A.NeighborCount:
        baseline = kernels.optimal_neighbor_number(2)
        out = get_color_map(attr, params).get(snapshot["neighbor_count"] - baseline)
    elif attr == A.RandomColor:
        out = _random_colors(n)
    elif attr == A.ConstantField:
        out = get_color_map(attr, params).get(snapshot["constant_field"])
    elif attr == A.MinDistanceToNeighbor:
        out = get_color_map(attr, params).get(snapshot["min_dist_to_neighbor"])
    elif attr == A.ParticleSizeClass:
        table = np.asarray([SIZE_CLASS_COLORS[k] for k in range(5)], np.float64)
        out = table[np.clip(snapshot["size_class"], 0, 4)]
    elif attr == A.SingleColor:
        out = np.tile(np.asarray([80 / 255.0, 140 / 255.0, 1.0]), (n, 1))
    elif attr == A.SourceTerm:
        out = get_color_map(attr, params).get(snapshot["ppe_source_term"])
    else:
        raise ValueError(attr)

    # flag overrides
    if viz.show_flag_neighborhood_reduced and "flag_neighborhood_reduced" in snapshot:
        out = np.where(snapshot["flag_neighborhood_reduced"][:, None], [[0.0, 1.0, 0.0]], out)
    if viz.show_flag_is_fluid_surface and "flag_is_fluid_surface" in snapshot:
        out = np.where(snapshot["flag_is_fluid_surface"][:, None], [[1.0, 0.0, 0.0]], out)
        if "flag_insufficient_neighs" in snapshot:
            out = np.where(snapshot["flag_insufficient_neighs"][:, None], [[0.0, 1.0, 0.0]],
                           out)
    return out
