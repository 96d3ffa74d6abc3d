"""Per-step function for the tile backend.

Counterpart of `make_step_fn` in adaptive_sph_tpu/models/simulation.py for
tile_cfg only. There is no jit: the returned function runs one step eagerly.
With adaptive sizes and resampling on, the physics step is followed by the
adaptivity step (share, then merge or split), whose partner matching runs on
the tile layout.
"""

from __future__ import annotations

from ..utils.params import ParticleSizes, SimulationParams
from . import adaptivity as adapt
from .state import FluidState
from .tile_step import single_step_tiles


def make_step_fn(params: SimulationParams, boundary_handler, tile_cfg, split_patterns=None):
    """step(state, step_number) -> (state, diag) on the sorted-tile backend.
    step_number: the host's count of steps once this one is done (the value
    the state's step_number reaches), so its parity is known without a read."""
    resampling = params.particle_sizes == ParticleSizes.Adaptive and (
        params.sharing or params.merging or params.splitting)

    def step(state: FluidState, step_number: int):
        state, dt, diag = single_step_tiles(state, params, tile_cfg, boundary_handler)
        if resampling:
            def partner_fn(st, cls, mode):
                return adapt.find_partners_tiles(st, tile_cfg, cls, dt, params, mode)

            state, adiag = adapt.single_step_adaptivity(state, dt, params, split_patterns,
                                                        partner_fn, step_number)
            diag.update(adiag)
        return state, diag

    return step
