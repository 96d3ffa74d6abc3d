"""High-level runner: params + scene + boundary + step function on one device.

Counterpart of adaptive_sph_tpu/runner.py for the tile backend: owns the
state, runs the step eagerly, reads the step's diagnostics in one transfer and
raises on the reference's failure conditions; grows the capacity when splits
were deferred for lack of free slots. `create_simulation(params, scene,
device=...)` is the entry point; it runs on the card unless the caller asks
for the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from .convert import split_patterns_from_numpy
from .models import scene as scene_mod
from .models.simulation import make_step_fn
from .models.state import FIELDS, FluidState, h_from_mass_np, resolve_device
from .models.tile_step import max_scale
from .ops import kernels
from .ops.grid import make_grid_config
from .ops.tiles import GW, TileConfig
from .utils import params as params_mod
from .utils.params import (
    InitBoundaryHandlerType,
    LevelEstimationMethod,
    ParticleSizes,
    PressureSolverMethod,
    SimulationParams,
    SupportLengthEstimation,
    ViscosityType,
)
from .utils.split_patterns import load_default_patterns
from .utils.stats import Counters


class SimulationFailed(RuntimeError):
    pass


def check_supported(params: SimulationParams):
    """Raise NotImplementedError for any setting outside the ported slice."""
    bad = []
    ported = (PressureSolverMethod.HybridDFSPH, PressureSolverMethod.IISPH,
              PressureSolverMethod.IISPH2, PressureSolverMethod.OnlyDivergence)
    if params.pressure_solver_method not in ported:
        bad.append(f"pressure_solver_method={params.pressure_solver_method.value} "
                   "(HybridDFSPH, IISPH, IISPH2 and OnlyDivergence are ported)")
    adaptive = params.particle_sizes == ParticleSizes.Adaptive
    if adaptive and params.support_length_estimation != SupportLengthEstimation.FromMass:
        bad.append(f"support_length_estimation={params.support_length_estimation.value} "
                   "(only FromMass is ported)")
    if params.level_estimation_active():
        if params.level_estimation_method != LevelEstimationMethod.EmptyAngle:
            bad.append(f"level_estimation_method={params.level_estimation_method.value} "
                       "(only EmptyAngle is ported)")
        if params.level_estimation_after_advection:
            bad.append("level_estimation_after_advection=True is not ported")
    if params.fill_stash_with is not None:
        bad.append("fill_stash_with is not ported")
    if params.viscosity_type == ViscosityType.XSPH and float(params.viscosity) != 0.0:
        bad.append(f"viscosity_type={params.viscosity_type.value} (ApproxLaplace and WCSPH "
                   "are ported)")
    if params.init_boundary_handler == InitBoundaryHandlerType.Particles:
        bad.append("init_boundary_handler=Particles is not ported")
    for flag in ("check_aii", "check_neighborhood", "constrain_neighborhood_count",
                 "force_diagnostic_fields", "profile_stages"):
        if getattr(params, flag):
            bad.append(f"{flag}=True is not ported")
    if bad:
        raise NotImplementedError("adaptive_sph_torch: " + "; ".join(bad))


@dataclasses.dataclass
class Simulation:
    params: SimulationParams
    scene: scene_mod.SceneConfig
    state: FluidState
    step_fn: object
    boundary_handler: object
    counters: Counters
    tile_cfg: TileConfig
    split_patterns: object = None  # ((P, MAXC, 2) tensor on the device, (P,) numpy counts)
    step_number: int = 0  # the host's copy of state.step_number: steps taken

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def time(self) -> float:
        return float(self.state.time)

    @property
    def num_fluid_particles(self) -> int:
        return int(self.state.n)

    def step(self, _retries: int = 2):
        """One simulation step; raises SimulationFailed on the reference's panic
        conditions. Returns the diagnostics as Python numbers.

        A row or cell overflow below the top level is recoverable: the state
        has not advanced, so the capacity grows and the step runs again.
        Deferred splits grow the capacity after the step (they run on the
        next split step)."""
        t0 = time.perf_counter()
        new_state, diag = self.step_fn(self.state, self.step_number + 1)
        # the one transfer; waits for the step
        diag = _read_diag({**diag, "particle_count": new_state.n})
        elapsed = time.perf_counter() - t0

        ro, co, lo = diag["neighbor_overflow"]
        if (ro > 0 or co > 0) and lo == 0 and _retries > 0:
            self.grow_capacity()
            return self.step(_retries=_retries - 1)
        if diag["negative_aii"] > 0:
            raise SimulationFailed(
                f"AII should not be negative! ({diag['negative_aii']} particles)")
        if ro > 0 or co > 0 or lo > 0:
            raise SimulationFailed(
                f"neighbor structure overflow: rows={ro} cell={co} level={lo}")
        if not np.isfinite(diag["dt"]):
            raise SimulationFailed("non-finite dt")
        if "mass_conservation_error" in diag and not diag["mass_conservation_error"] < 0.005:
            raise SimulationFailed(
                f"mass not conserved after adaptivity: {diag['mass_conservation_error']}")

        self.state = new_state
        self.step_number += 1
        # capacity growth re-pads self.state, so it runs after the state swap
        if "split_missing_pattern" in diag:
            if self.params.fail_on_missing_split_pattern and diag["split_missing_pattern"] > 0:
                raise SimulationFailed(f"Missing split pattern for "
                                       f"{diag['split_missing_pattern']} particles "
                                       "(fail_on_missing_split_pattern)")
            if diag["split_deferred"] > 0:
                self.grow_capacity()
        self.counters.add_time("simulation-step", elapsed)
        self.counters.add_value("particle-count", float(diag["particle_count"]))
        self.counters.add_value("dt", diag["dt"])
        # IISPH has no divergence solve, OnlyDivergence no density solve
        if diag.get("div_iterations", 0) > 0:
            self.counters.add_value("div-iterations", float(diag["div_iterations"]))
        if diag.get("density_iterations", 0) > 0:
            self.counters.add_value("density-iterations", float(diag["density_iterations"]))
        return diag

    def grow_capacity(self, factor: int = 2):
        """Re-pad the state to `factor` x the capacity (rounded up to 1024) and
        rebuild the tile configuration and the step for it."""
        old = self.state
        new_cap = ((old.capacity * factor + 1023) // 1024) * 1024
        self.state = pad_state_to(old, new_cap)
        self.tile_cfg, self.step_fn = _build_step(self.params, self.scene, self.state,
                                                  self.boundary_handler, self.split_patterns)
        self.counters.add_value("capacity-growth", float(new_cap))

    def step_chunk(self, n: int):
        """n steps as a Python loop; returns {name: per-step values}."""
        out = {}
        for _ in range(n):
            d = self.step()
            for k, v in d.items():
                out.setdefault(k, []).append(v)
        return out

    def run_until(self, t_end: float, max_steps: int = 10**9):
        steps = 0
        while self.time < t_end and steps < max_steps:
            self.step()
            steps += 1
        return steps


def _read_diag(diag: dict) -> dict:
    """Every tensor of the step's diagnostics in ONE device-to-host transfer;
    tuples keep their shape, integer tensors come back as ints."""
    items = [(k, i, x) for k, v in diag.items()
             for i, x in enumerate(v if isinstance(v, tuple) else (v,))
             if isinstance(x, torch.Tensor)]
    vals = torch.stack([x.reshape(()).double() for *_, x in items]).tolist() if items else []
    out = {k: list(v) if isinstance(v, tuple) else [v] for k, v in diag.items()}
    for (k, i, x), val in zip(items, vals):
        out[k][i] = val if x.dtype.is_floating_point else int(val)
    return {k: tuple(out[k]) if isinstance(diag[k], tuple) else out[k][0] for k in diag}


def _tile_tq(capacity: int) -> int:
    """The widest query tile that divides the capacity (at least two tiles).
    ASPH_TQ overrides it, as in the reference (adaptive_sph_tpu/runner.py
    `_tile_tq`, an experiment knob); a width the port's layout does not take
    (one that does not divide the capacity, or above GW and not a multiple
    of GW, the hull groups of ops/tiles.py) raises NotImplementedError."""
    force = os.environ.get("ASPH_TQ")
    if force:
        tq = int(force)
        if tq < 1 or capacity % tq or (tq > GW and tq % GW):
            raise NotImplementedError(f"ASPH_TQ={tq}: the port's tile layout takes widths that "
                                      f"divide the capacity ({capacity}) and are at most {GW} "
                                      f"or a multiple of {GW}")
        return tq
    for tq in (128, 64, 32, 16):
        if capacity % tq == 0 and capacity >= 2 * tq:
            return tq
    return 16


def pad_state_to(state: FluidState, new_cap: int) -> FluidState:
    """Every per-particle tensor of `state` zero-padded to `new_cap` rows."""
    C = state.capacity

    def pad(a):
        if a.ndim == 0 or a.shape[0] != C:
            return a
        out = torch.zeros((new_cap,) + tuple(a.shape[1:]), dtype=a.dtype, device=a.device)
        out[:C] = a
        return out

    return state.replace(**{k: pad(getattr(state, k)) for k in FIELDS})


def _resampling(params: SimulationParams) -> bool:
    return params.particle_sizes == ParticleSizes.Adaptive and (
        params.splitting or params.merging or params.sharing)


def grid_config_for(params: SimulationParams, scene: scene_mod.SceneConfig, host: dict,
                    capacity: int):
    """Static grid geometry from the scene box and the h range of the alive
    masses. With resampling the h band widens to the sizing targets' band and
    every level stays populated; without it masses never change, so only the
    levels of the present h values are populated (two on the stress scene).
    host: numpy "mass" and "alive" of the state."""
    w2, hh2 = scene.boundary_width / 2.0, scene.boundary_height / 2.0
    if params.particle_sizes == ParticleSizes.Uniform:
        return make_grid_config((-w2, -hh2), (w2, hh2), max_scale(params), params.h, params.h,
                                capacity, mpc=32)
    masses = host["mass"][host["alive"]]
    h_min = float(h_from_mass_np(float(masses.min()), params.rest_density, 2))
    h_max = float(h_from_mass_np(float(masses.max()), params.rest_density, 2))
    if _resampling(params):
        # resampling keeps masses within the classification band around the
        # sizing targets; widen by the band plus a margin
        h_min = min(h_min, kernels.ETA * params.particle_radius_fine * 0.6)
        h_max = max(h_max, kernels.ETA * params.particle_radius_base * 1.6)
    gcfg = make_grid_config((-w2, -hh2), (w2, hh2), max_scale(params), h_min, h_max,
                            capacity, mpc=32)
    if _resampling(params):
        return gcfg
    hs = np.unique(np.asarray(h_from_mass_np(masses, params.rest_density, 2), np.float32))
    lv = np.clip(
        np.ceil(np.log2(np.maximum(hs * max_scale(params) / gcfg.cell0, 1.0)) - 1e-6).astype(int),
        0, gcfg.levels - 1)
    return dataclasses.replace(gcfg, populated=tuple(sorted(set(int(x) for x in lv))))


def _build_step(params, scene, state, boundary_handler, split_patterns):
    """(TileConfig, step function) for the state's capacity and masses."""
    if state.capacity % 64:
        raise ValueError("the tile backend needs capacity % 64 == 0")
    host = {"mass": state.mass.cpu().numpy(), "alive": state.alive.cpu().numpy()}
    gcfg = grid_config_for(params, scene, host, state.capacity)
    tile_cfg = TileConfig.from_grid(gcfg, max_scale(params), tq=_tile_tq(state.capacity))
    return tile_cfg, make_step_fn(params, boundary_handler, tile_cfg, split_patterns)


def create_simulation(
    params: SimulationParams,
    scene: scene_mod.SceneConfig,
    capacity: Optional[int] = None,
    counters_enabled: bool = True,
    device="cuda",
    split_patterns=None,
) -> Simulation:
    """Initial state, boundary handler and tile-backend step function on
    `device`: the card unless the caller asks for the CPU; without a CUDA
    device only device="cpu" runs. split_patterns: (positions, counts) numpy
    table as `utils.split_patterns.to_padded_table` returns it; the default
    table when splitting and None.

    Raises NotImplementedError for settings outside the ported slice."""
    check_supported(params)
    device = resolve_device(device)
    if device.type == "cuda":
        # float32 products stay full float32 (no TF32 anywhere in the step)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    params = params_mod.init_h_for_uniform(
        params, scene.blocks[0].spacing, scene.blocks[0].volume_fill_ratio)
    state = scene_mod.init_fluid_state(scene, params, capacity, device=device)
    boundary_handler = scene_mod.make_boundary_handler(scene, params)
    if params.particle_sizes == ParticleSizes.Adaptive and params.splitting:
        split_patterns = split_patterns_from_numpy(
            split_patterns if split_patterns is not None else load_default_patterns(), device)
    tile_cfg, step_fn = _build_step(params, scene, state, boundary_handler, split_patterns)
    return Simulation(
        params=params,
        scene=scene,
        state=state,
        step_fn=step_fn,
        boundary_handler=boundary_handler,
        counters=Counters(enabled=counters_enabled),
        tile_cfg=tile_cfg,
        split_patterns=split_patterns,
        step_number=int(state.step_number),
    )
