"""The tile backend's per-step functions (a frozen copy of the port's
models/simulation.py, its list and grid steps cut): the physics step of
models/tile_step.py, then, with adaptive sizes and resampling on, share and
merge or split with partner matching on the tile layout."""

from __future__ import annotations

import torch

from ..utils.params import (
    LevelEstimationMethod,
    ParticleSizes,
    SimulationParams,
    SupportLengthEstimation,
)
from . import adaptivity as adapt
from .state import FluidState
from .tile_step import single_step_tiles, timer_section


def make_two_phase_step_fns(params: SimulationParams, boundary_handler, split_patterns,
                            tile_cfg, timer=None):
    """Physics-only step and a separate adaptivity step (the image exporter's
    order: physics step, the frames of the step's window, then resampling, so
    that the census never changes inside an interpolation window).

    physics_fn(state, emit_prev_pos=True) -> (state, diag); diag carries "dt"
        and, with emit_prev_pos, "pos_prev" (start-of-step positions in the
        returned order);
    adaptivity_fn(state, dt, step_number) -> (state, adiag); step_number: the
        host's count of steps taken, the physics step included (its parity
        picks merge or split without a read). Without resampling it returns
        the state unchanged and no diagnostics.

    timer: the section profiler of utils/profiling.py, or None."""
    resampling = params.particle_sizes == ParticleSizes.Adaptive and (
        params.sharing or params.merging or params.splitting)

    def physics_fn(state: FluidState, emit_prev_pos: bool = True):
        state, _, diag = single_step_tiles(state, params, tile_cfg, boundary_handler,
                                           emit_prev_pos=emit_prev_pos, timer=timer)
        return state, diag

    def adaptivity_fn(state: FluidState, dt, step_number: int):
        if not resampling:
            return state, {}

        def partner_fn(st, cls, mode):
            return adapt.find_partners_tiles(st, tile_cfg, cls, dt, params, mode)

        return adapt.single_step_adaptivity(state, dt, params, split_patterns, partner_fn,
                                            step_number)

    return physics_fn, adaptivity_fn


def make_step_fn(params: SimulationParams, boundary_handler, tile_cfg, split_patterns=None,
                 timer=None):
    """step(state, step_number) -> (state, diag): the two phases fused.
    step_number: the host's count of steps once this one is done (the value
    the state's step_number reaches), so its parity is known without a read.
    timer: the section profiler of utils/profiling.py (the physics step's
    sections and "adaptivity"), or None."""
    physics_fn, adaptivity_fn = make_two_phase_step_fns(params, boundary_handler,
                                                        split_patterns, tile_cfg, timer)

    def step(state: FluidState, step_number: int):
        state, diag = physics_fn(state, emit_prev_pos=False)
        with timer_section(timer, "adaptivity"):
            state, adiag = adaptivity_fn(state, diag["dt"], step_number)
        diag.update(adiag)
        return state, diag

    return step
