"""Per-step function for the tile backend.

Counterpart of `make_step_fn` in adaptive_sph_tpu/models/simulation.py for
tile_cfg only. There is no jit: the returned function runs one step eagerly.
Resampling (share/merge/split) is not ported, so the step is the physics step.
"""

from __future__ import annotations

from ..utils.params import SimulationParams
from .state import FluidState
from .tile_step import single_step_tiles


def make_step_fn(params: SimulationParams, boundary_handler, tile_cfg):
    """step(state) -> (state, diag) on the sorted-tile backend."""

    def step(state: FluidState):
        state, _dt, diag = single_step_tiles(state, params, tile_cfg, boundary_handler)
        return state, diag

    return step
