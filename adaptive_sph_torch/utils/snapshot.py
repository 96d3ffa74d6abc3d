"""Host-side snapshot: FluidState -> dict of numpy arrays of the alive particles.

Counterpart of adaptive_sph_tpu/utils/snapshot.py. The fields come off the
device in one transfer (packed as float64 columns, which hold every float32,
int32 and bool value exactly) and keep the state's dtypes on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.state import FluidState
from .params import ParticleSizes, SimulationParams

FLOAT_FIELDS = ("position", "velocity", "pressure_accel", "mass", "density", "pressure", "aii",
                "ppe_source_term", "density_error", "h", "level", "stash", "constant_field")
INT_FIELDS = ("neighbor_count", "size_class")
BOOL_FIELDS = ("has_level", "flag_is_fluid_surface", "flag_neighborhood_reduced",
               "flag_insufficient_neighs", "alive")
DTYPES = {**{k: np.float32 for k in FLOAT_FIELDS}, **{k: np.int32 for k in INT_FIELDS},
          **{k: np.bool_ for k in BOOL_FIELDS}}


def take_snapshot(state: FluidState, params: SimulationParams = None) -> dict:
    """The alive particles' fields, "time" and "n"; with params also
    "min_dist_to_neighbor"."""
    C = state.capacity
    names = FLOAT_FIELDS + INT_FIELDS + BOOL_FIELDS
    cols = [getattr(state, k).reshape(C, -1).to(torch.float64) for k in names]
    packed = torch.cat([torch.cat(cols, dim=1).reshape(-1),
                        state.time.reshape(1).to(torch.float64)]).cpu().numpy()
    table, t = packed[:-1].reshape(C, -1), float(packed[-1])
    out, col = {}, 0
    for k, c in zip(names, cols):
        w = c.shape[1]
        a = table[:, col:col + w].astype(DTYPES[k])
        out[k] = a if w > 1 else a[:, 0]
        col += w
    alive = out.pop("alive")
    out = {k: v[alive] for k, v in out.items()}
    out["time"] = float(np.float32(t))
    out["n"] = int(alive.sum())
    if params is not None:
        out["min_dist_to_neighbor"] = min_dist_to_neighbor(out, params)
    return out


def min_dist_to_neighbor(snapshot: dict, params: SimulationParams) -> np.ndarray:
    """Nearest-neighbour distance / smoothing length, capped at 2.0."""
    from scipy.spatial import cKDTree

    pos = snapshot["position"]
    if len(pos) < 2:
        return np.full(len(pos), 2.0)
    d, _ = cKDTree(pos).query(pos, k=2)
    nearest = d[:, 1]
    if params.particle_sizes == ParticleSizes.Uniform:
        h = np.full(len(pos), params.h)
    else:
        h = snapshot["h"]
    return np.minimum(nearest / np.maximum(h, 1e-12), 2.0)
