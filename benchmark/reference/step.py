"""The reference's interface: the initial state of a scene and one step from a
given state, on the tile step of `plainsph` with every pair operation in its
plain twin (plain torch, on any device).

States cross this interface as dicts of numpy arrays keyed by the field
names of `plainsph.models.state.FluidState`, so that nothing of the program
under test reaches the reference but the values it is judged by.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .plainsph.models import scene as scene_mod
from .plainsph.models import tile_physics
from .plainsph.models.simulation import make_step_fn
from .plainsph.models.solver import DENSITY_ERROR, DIVERGENCE_ERROR
from .plainsph.models.state import FluidState, h_from_mass_np
from .plainsph.models.tile_step import max_scale
from .plainsph.ops import kernels
from .plainsph.ops.grid import make_grid_config
from .plainsph.ops.tiles import TileConfig
from .plainsph.utils import params as params_mod
from .plainsph.utils.params import ParticleSizes, SimulationParams
from .plainsph.utils.split_patterns import load_default_patterns

FIELDS = tuple(f.name for f in dataclasses.fields(FluidState))


def _resampling(params: SimulationParams) -> bool:
    return params.particle_sizes == ParticleSizes.Adaptive and (
        params.splitting or params.merging or params.sharing)


def grid_config_for(params: SimulationParams, scene, mass, alive, capacity: int):
    """The multi-level grid over the scene box for the h range of the alive
    masses: with resampling widened to the sizing band (every level
    populated), without it only the levels of the present h values."""
    w2, hh2 = scene.boundary_width / 2.0, scene.boundary_height / 2.0
    if params.particle_sizes == ParticleSizes.Uniform:
        return make_grid_config((-w2, -hh2), (w2, hh2), max_scale(params), params.h, params.h,
                                capacity, mpc=32)
    masses = mass[alive]
    h_min = float(h_from_mass_np(float(masses.min()), params.rest_density, 2))
    h_max = float(h_from_mass_np(float(masses.max()), params.rest_density, 2))
    if _resampling(params):
        h_min = min(h_min, kernels.ETA * params.particle_radius_fine * 0.6)
        h_max = max(h_max, kernels.ETA * params.particle_radius_base * 1.6)
    g = make_grid_config((-w2, -hh2), (w2, hh2), max_scale(params), h_min, h_max, capacity,
                         mpc=32)
    if _resampling(params):
        return g
    hs = np.unique(np.asarray(h_from_mass_np(masses, params.rest_density, 2), np.float32))
    lv = np.clip(np.ceil(np.log2(np.maximum(hs * max_scale(params) / g.cell0, 1.0)) - 1e-6)
                 .astype(int), 0, g.levels - 1)
    return dataclasses.replace(g, populated=tuple(sorted(set(int(x) for x in lv))))


def tile_width(capacity: int) -> int:
    """The widest query tile that divides the capacity (at least two tiles)."""
    for tq in (128, 64, 32, 16):
        if capacity % tq == 0 and capacity >= 2 * tq:
            return tq
    return 16


class Reference:
    """params_dict: the simulation parameters by the reference's field names;
    scene_dict: the scene as its YAML reads."""

    def __init__(self, params_dict: dict, scene_dict: dict, device="cpu"):
        self.device = torch.device(device)
        self.scene = scene_mod.scene_from_dict(scene_dict)
        params = params_mod.params_from_dict(params_dict)
        b0 = self.scene.blocks[0]
        self.params = params_mod.init_h_for_uniform(params, b0.spacing, b0.volume_fill_ratio)
        self.boundary = scene_mod.make_boundary_handler(self.scene, self.params)
        self.patterns = None
        if self.params.particle_sizes == ParticleSizes.Adaptive and self.params.splitting:
            pos, counts = load_default_patterns()
            self.patterns = (torch.as_tensor(pos, device=self.device),
                             np.asarray(counts, np.int32))

    def initial_state(self) -> dict:
        """The scene's lattice at its default capacity, as numpy arrays."""
        st = scene_mod.init_fluid_state(self.scene, self.params, device="cpu")
        return to_numpy(st)

    def step(self, state: dict, step_number: int, follow: dict = None):
        """One step (physics, then share and merge or split where the
        parameters ask for them) from `state`; step_number is the count of
        steps once this one is done. Returns (state after, diag) as numpy
        arrays and Python numbers, the particles in the step's own order.

        follow: {"density_iterations": n, "div_iterations": m}: stop each
        solve after the given sweep count instead of at its own exit test
        (a solve whose average error crosses its tolerance within rounding
        may stop one sweep apart on two summation orders)."""
        st = from_numpy(state, self.device)
        g = grid_config_for(self.params, self.scene, state["mass"], state["alive"], st.capacity)
        tcfg = TileConfig.from_grid(g, max_scale(self.params), tq=tile_width(st.capacity))
        fn = make_step_fn(self.params, self.boundary, tcfg, self.patterns)
        follow = follow or {}
        for key, kind in (("density_iterations", DENSITY_ERROR),
                          ("div_iterations", DIVERGENCE_ERROR)):
            if follow.get(key) is not None:
                tile_physics.FOLLOW_ITERATIONS[kind] = int(follow[key])
        try:
            with torch.no_grad():
                new, diag = fn(st, int(step_number))
        finally:
            tile_physics.FOLLOW_ITERATIONS.clear()
        out = {}
        for k, v in diag.items():
            vals = v if isinstance(v, tuple) else (v,)
            vals = [float(x) if isinstance(x, torch.Tensor) else x for x in vals]
            out[k] = tuple(vals) if isinstance(v, tuple) else vals[0]
        return to_numpy(new), out


def to_numpy(st: FluidState) -> dict:
    return {k: getattr(st, k).detach().cpu().numpy() for k in FIELDS}


def from_numpy(d: dict, device) -> FluidState:
    return FluidState(**{k: torch.as_tensor(np.asarray(d[k])).to(device) for k in FIELDS})
