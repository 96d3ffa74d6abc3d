"""High-level runner: params + scene + boundary + step function on one device.

Counterpart of adaptive_sph_tpu/runner.py: owns the state, runs the step
eagerly, reads the step's diagnostics in one transfer and raises on the
reference's failure conditions; grows the capacity when splits were deferred
for lack of free slots. `create_simulation(params, scene, device=...,
backend=...)` is the entry point; it runs on the card unless the caller asks
for the CPU. Three backends: "tiles" (models/tile_step.py, the CUDA
kernels), "lists" (the reference's neighbour-list step, plain torch) and
"grid" (the dense grid engine of models/grid_step.py, plain torch); "auto"
takes the tile backend wherever the reference's `supports_tile_backend` does,
else the list backend, and never the grid engine.

The tile backend takes the patch-major (clique) layout where the reference
does (`_tile_patch`, under ASPH_CLIQUE=1 or force; off by default). A halo
overflow there makes the runner rebuild the step on the packed layout and
run the step again (the "clique-fallback" counter), and a step that still
overflows once the retries are spent raises. Unlike the reference, which
checks only under `check_invariants`, the port always checks.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional

import numpy as np
import torch

from . import spans
from .convert import split_patterns_from_numpy
from .models import scene as scene_mod
from .models.simulation import (
    make_grid_step_fn,
    make_list_step_fn,
    make_step_fn,
    make_two_phase_step_fns,
)
from .models.state import FIELDS, FluidState, h_from_mass_np, resolve_device
from .models.tile_step import max_scale
from .ops import kernels
from .ops.grid import GridConfig, make_grid_config
from .ops.neighbors import NeighborConfig
from .ops.tiles import GW, HALO_DIRS, TileConfig
from .utils import params as params_mod
from .utils.params import (
    LevelEstimationMethod,
    OperatorDiscretization,
    ParticleSizes,
    PressureSolverMethod,
    SimulationParams,
    ViscosityType,
)
from .utils.split_patterns import load_default_patterns
from .utils.stats import Counters


class SimulationFailed(RuntimeError):
    pass


def check_supported(params: SimulationParams, backend: str):
    """Raise NotImplementedError for the settings the port refuses: CenterDiff
    levels before advection (the reference refuses it too); on the tile
    engine (`backend`, as resolve_backend returns it), XSPH with a nonzero
    viscosity; on the grid engine, the settings the reference's grid step
    drops without a word (the neighbourhood constraint, check_aii,
    check_neighborhood, levels after advection). The list and grid backends
    run XSPH with a zero viscosity, as the reference's physics does."""
    bad = []
    ported = (PressureSolverMethod.HybridDFSPH, PressureSolverMethod.IISPH,
              PressureSolverMethod.IISPH2, PressureSolverMethod.OnlyDivergence)
    if params.pressure_solver_method not in ported:
        bad.append(f"pressure_solver_method={params.pressure_solver_method.value} "
                   "(HybridDFSPH, IISPH, IISPH2 and OnlyDivergence are ported)")
    if params.level_estimation_active() and not params.level_estimation_after_advection:
        if params.level_estimation_method == LevelEstimationMethod.CenterDiff:
            # the reference asserts against it: CenterDiff needs the
            # post-advection densities
            bad.append("level_estimation_method=CenterDiff needs "
                       "level_estimation_after_advection=True")
    if (backend == "tiles" and params.viscosity_type == ViscosityType.XSPH
            and float(params.viscosity) != 0.0):
        bad.append(f"viscosity_type={params.viscosity_type.value} (ApproxLaplace and WCSPH "
                   "are ported)")
    if backend == "grid":
        dropped = [name for name in ("constrain_neighborhood_count", "check_aii",
                                     "check_neighborhood") if getattr(params, name)]
        if params.level_estimation_active() and params.level_estimation_after_advection:
            dropped.append("level_estimation_after_advection")
        bad += [f"{name} on backend='grid' (the reference's grid step ignores it; "
                "backend='tiles' or 'lists' runs it)" for name in dropped]
    if bad:
        raise NotImplementedError("adaptive_sph_torch: " + "; ".join(bad))


def supports_tile_backend(params: SimulationParams) -> bool:
    """The reference's routing (adaptive_sph_tpu/models/tile_step.py
    `supports_tile_backend`): the tile engine runs everything but level
    estimation after advection over the stale pre-advection pair set (levels
    after advection without the extended range), which the list backend
    serves."""
    return not (params.level_estimation_active() and params.level_estimation_after_advection
                and not params.use_extended_range_for_level_estimation)


BACKENDS = ("tiles", "lists", "grid")


def resolve_backend(params: SimulationParams, backend: str) -> str:
    """"tiles", "lists" or "grid" for the `backend` argument of
    create_simulation: "auto" picks "lists" exactly where
    supports_tile_backend is false, else "tiles" (never "grid", as in the
    reference). There is no SMEM budget on the card, so the reference's
    fallback from tiles to lists for grids beyond its TPU scalar memory has
    no counterpart. Raises NotImplementedError for "tiles" on the stale-pair
    setting (the reference's tile engine refuses it too)."""
    if backend == "auto":
        return "tiles" if supports_tile_backend(params) else "lists"
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: 'auto', 'tiles', 'lists' or 'grid'")
    if backend == "tiles" and not supports_tile_backend(params):
        raise NotImplementedError("adaptive_sph_torch: level_estimation_after_advection without "
                                  "use_extended_range_for_level_estimation runs on "
                                  "backend='lists' (or 'auto'), not on the tile engine")
    return backend


@dataclasses.dataclass
class Simulation:
    params: SimulationParams
    scene: scene_mod.SceneConfig
    state: FluidState
    step_fn: object
    boundary_handler: object
    counters: Counters
    tile_cfg: Optional[TileConfig]  # None on the list and grid backends
    split_patterns: object = None  # ((P, MAXC, 2) tensor on the device, (P,) numpy counts)
    step_number: int = 0  # the host's copy of state.step_number: steps taken
    phase_fns: tuple = None  # (physics_fn, adaptivity_fn) of the two-phase step (tiles)
    backend: str = "tiles"  # "tiles", "lists" or "grid"
    ncfg: Optional[NeighborConfig] = None  # the list structure (lists; grid's resampling)
    row_width: Optional[int] = None  # the list rows' width, as asked for (None: default)
    grid_cfg: Optional[GridConfig] = None  # the dense grid engine's geometry (grid only)
    clique_disabled: bool = False  # a halo overflow moved the run to the packed layout

    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def time(self) -> float:
        return float(self.state.time)

    @property
    def num_fluid_particles(self) -> int:
        return int(self.state.n)

    def step(self):
        """One simulation step; raises SimulationFailed on the reference's panic
        conditions. Returns the diagnostics as Python numbers.

        On the tile backend a row or cell overflow below the top level is
        recoverable: the state has not advanced, so the capacity grows and
        the step runs again; on the list and grid backends, as in the
        reference, every overflow raises. Deferred splits grow the capacity
        after the step (they run on the next split step)."""
        return self._advance(lambda: self.step_fn(self.state, self.step_number + 1), True)

    def step_physics(self):
        """The physics half of the two-phase step (the image exporter's): the
        step without resampling, under the same checks and growth as `step`.
        diag["pos_prev"] stays a tensor on the device: the start-of-step
        positions in the returned state's order. `step_adaptivity(diag["dt"])`
        completes the step. Tile backend only."""
        self._need_phases()
        return self._advance(lambda: self.phase_fns[0](self.state), True)

    def step_adaptivity(self, dt: float):
        """The adaptivity half of the two-phase step (share, merge or split by
        the parity of the steps taken), after `step_physics` returned dt; the
        mass-conservation and split checks and growth as in `step`. Without
        resampling it does nothing."""
        self._need_phases()
        dt = torch.tensor(dt, dtype=torch.float32, device=self.device)
        return self._advance(lambda: self.phase_fns[1](self.state, dt, self.step_number), False)

    def _need_phases(self):
        if self.phase_fns is None:
            raise NotImplementedError("the two-phase step runs on the tile backend; the list "
                                      "backend steps fused (Simulation.step)")

    def _advance(self, run, physics: bool, _retries: int = 2):
        """Runs run() -> (state, diag) under the step's span and its record
        (adaptive_sph_torch/spans.py) and adds the step's host reads to the
        counters as "host-reads"."""
        reads0 = sum(spans.reads.values())
        spans.open_step(self.step_number + 1 if physics else self.step_number)
        diag = None
        try:
            with spans.span("simulation-step"):
                diag = self._attempt(run, physics, _retries)
        finally:
            spans.close_step(diag)
        self.counters.add_value("host-reads", float(sum(spans.reads.values()) - reads0))
        return diag

    def _attempt(self, run, physics: bool, _retries: int = 2):
        """Runs run() -> (state, diag) and holds its diagnostics to the
        reference's panic conditions before the state is taken; a physics
        step advances the step count."""
        t0 = time.perf_counter()
        new_state, diag = run()
        pos_prev = diag.pop("pos_prev", None)
        # the one transfer; waits for the step
        with spans.span("diag-read"):
            diag = _read_diag({**diag, "particle_count": new_state.n})
        elapsed = time.perf_counter() - t0

        if physics:
            if diag.get("clique_overflow", 0) > 0:
                # the halo ring overflowed: same-level pairs were dropped, so
                # the step is invalid; rebuild on the packed layout and run it
                # again (the state has not advanced)
                if _retries == 0:
                    raise SimulationFailed(f"clique halo overflow: {diag['clique_overflow']} "
                                           "ring particles without a halo slot")
                self._disable_clique()
                return self._attempt(run, physics, _retries - 1)
            ro, co, lo = diag["neighbor_overflow"]
            if (ro > 0 or co > 0) and lo == 0 and self.backend == "tiles" and _retries > 0:
                self.grow_capacity()
                return self._attempt(run, physics, _retries - 1)
            if diag["negative_aii"] > 0:
                raise SimulationFailed(
                    f"AII should not be negative! ({diag['negative_aii']} particles)")
            if (ro > 0 or co > 0 or lo > 0) and self.backend == "lists":
                raise SimulationFailed(
                    f"neighbor structure overflow: rows over by {ro}, cell={co}, level={lo} "
                    "(raise NeighborConfig.row_width / max_per_cell / levels)")
            if (ro > 0 or lo > 0) and self.backend == "grid":
                raise SimulationFailed(
                    f"neighbor structure overflow: cell={ro} (particles in full grid cells, "
                    f"mpc {self.grid_cfg.mpc}), level={lo}")
            if ro > 0 or co > 0 or lo > 0:
                raise SimulationFailed(
                    f"neighbor structure overflow: rows={ro} cell={co} level={lo}")
            if not np.isfinite(diag["dt"]):
                raise SimulationFailed("non-finite dt")
            if diag.get("neighborhood_check_mismatch", 0) > 0:
                raise SimulationFailed(f"check_neighborhood: "
                                       f"{diag['neighborhood_check_mismatch']} pair-count "
                                       "mismatches against the brute-force count")
            if "aii_deviation" in diag and not diag["aii_deviation"] < 0.01:
                raise SimulationFailed(
                    f"a_ii check failed: max deviation {diag['aii_deviation']}")
        if "mass_conservation_error" in diag and not diag["mass_conservation_error"] < 0.005:
            raise SimulationFailed(
                f"mass not conserved after adaptivity: {diag['mass_conservation_error']}")

        self.state = new_state
        if physics:
            self.step_number += 1
        # capacity growth re-pads self.state, so it runs after the state swap
        if "split_missing_pattern" in diag:
            if self.params.fail_on_missing_split_pattern and diag["split_missing_pattern"] > 0:
                raise SimulationFailed(f"Missing split pattern for "
                                       f"{diag['split_missing_pattern']} particles "
                                       "(fail_on_missing_split_pattern)")
            if diag["split_deferred"] > 0:
                self.grow_capacity()
        if not physics:
            self.counters.add_time("adaptivity", elapsed)
            return diag
        self.counters.add_time("simulation-step", elapsed)
        self.counters.add_value("particle-count", float(diag["particle_count"]))
        self.counters.add_value("dt", diag["dt"])
        # IISPH has no divergence solve, OnlyDivergence no density solve
        if diag.get("div_iterations", 0) > 0:
            self.counters.add_value("div-iterations", float(diag["div_iterations"]))
        if diag.get("density_iterations", 0) > 0:
            self.counters.add_value("density-iterations", float(diag["density_iterations"]))
        if pos_prev is not None:
            diag["pos_prev"] = pos_prev
        return diag

    def grow_capacity(self, factor: int = 2):
        """Re-pad the state to `factor` x the capacity (rounded up to 1024) and
        rebuild the backend's configuration and the step for it."""
        old = self.state
        new_cap = ((old.capacity * factor + 1023) // 1024) * 1024
        with spans.span("step-build"):
            self.state = pad_state_to(old, new_cap)
            self._install(self._build(self.params))
        self.counters.add_value("capacity-growth", float(new_cap))

    def _disable_clique(self):
        """The fallback after a halo overflow: the step rebuilt on the packed
        layout (patch 0), which the run keeps from then on."""
        self.clique_disabled = True
        with spans.span("step-build"):
            self._install(self._build(self.params))
        self.counters.add_value("clique-fallback", 1.0)

    def update_params(self, params: SimulationParams):
        """Swap the parameters of a running simulation and rebuild its step
        (the reference's live tuning, `run --watch-config`). The scene and the
        boundary handler stay; the same normalisation as create_simulation
        applies, and self.params changes only once the new step is built."""
        check_supported(params, resolve_backend(params, self.backend))
        params = params_mod.init_h_for_uniform(
            params, self.scene.blocks[0].spacing, self.scene.blocks[0].volume_fill_ratio)
        built = self._build(params)
        self.params = params
        self._install(built)

    def _build(self, params: SimulationParams):
        return _build_step(params, self.scene, self.state, self.boundary_handler,
                           self.split_patterns, self.backend, self.row_width,
                           no_patch=self.clique_disabled)

    def _install(self, built: dict):
        for k, v in built.items():
            setattr(self, k, v)

    def load_state(self, state: FluidState):
        """Continue from `state` (a checkpoint's, `utils.checkpoint.load_state`):
        its step count and a step built for its capacity and masses."""
        self.state = state
        self.step_number = int(state.step_number)
        self._install(self._build(self.params))

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
    vals = []
    if items:
        spans.reads["diag"] += 1
        vals = torch.stack([x.reshape(()).double() for *_, x in items]).tolist()
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


PATCH_SIDES = (8, 6, 5, 4, 3, 2)  # tried in this order, the largest that fits first
PATCH_HEADROOM = 1.3  # margin over the initial occupancies


def _alive_h(host: dict, params: SimulationParams):
    """(positions, h) of the alive particles, h as the step takes it."""
    pos = host["position"][host["alive"]]
    if params.particle_sizes == ParticleSizes.Uniform:
        return pos, np.full(len(pos), params.h, np.float32)
    return pos, h_from_mass_np(host["mass"][host["alive"]], params.rest_density, 2)


def patch_occupancy(pos, h, params: SimulationParams, gcfg: GridConfig, P: int):
    """The per-patch and per-ring occupancies of patch side P on the host:
    {(level, px, py): particles} and {(level, px, py): ring particles of
    that occupied patch}, ring membership as tiles.build_halo decides it
    (the edge cell toward the patch and within 0.5 mscale (h + the level's
    h max) of its rectangle), in float64 on the unclipped cells."""
    scale = max_scale(params)
    level = np.clip(np.ceil(np.log2(np.maximum(h * scale / gcfg.cell0, 1.0)) - 1e-6).astype(int),
                    0, gcfg.levels - 1)

    def counts(lvl, px, py):
        keys, n = np.unique(np.stack([px, py], 1), axis=0, return_counts=True)
        return {(lvl, int(x), int(y)): int(c) for (x, y), c in zip(keys, n)}

    patches, rings = {}, {}
    for lvl in np.unique(level).tolist():
        sel = level == lvl
        cell = gcfg.cell(lvl)
        fx = (pos[sel, 0] - gcfg.origin[0]) / cell
        fy = (pos[sel, 1] - gcfg.origin[1]) / cell
        cx, cy = np.floor(fx).astype(np.int64), np.floor(fy).astype(np.int64)
        px, py = cx // P, cy // P
        patches.update(counts(lvl, px, py))
        hl = h[sel]
        rad_c = 0.5 * scale * (hl + hl.max()) / cell
        for dy, dx in HALO_DIRS:
            m = np.ones(len(hl), bool)
            if dx < 0:
                m &= cx % P == 0
            elif dx > 0:
                m &= cx % P == P - 1
            if dy < 0:
                m &= cy % P == 0
            elif dy > 0:
                m &= cy % P == P - 1
            gapx = np.zeros(len(hl)) if dx == 0 else (
                (px + 1) * P - fx if dx > 0 else fx - px * P)
            gapy = np.zeros(len(hl)) if dy == 0 else (
                (py + 1) * P - fy if dy > 0 else fy - py * P)
            m &= gapx * gapx + gapy * gapy < rad_c * rad_c
            for k, c in counts(lvl, px[m] + dx, py[m] + dy).items():
                if k in patches:
                    rings[k] = rings.get(k, 0) + c
    return patches, rings


def _tile_patch(host: dict, params: SimulationParams, gcfg: GridConfig, capacity: int, tq: int):
    """The clique layout's patch side (the reference's `_tile_patch`):
    (P, need), P = 0 where the layout is off or no side fits, need the
    padded slots it wants (the caller compares the capacity with it).

    ASPH_CLIQUE (read here, at every build of the step): unset or "0" keeps
    the packed layout; any other value takes the patch-major one where its
    gates pass: tq = 128 dividing the capacity, not Winchenbach2020, no
    resident solver (the flag or ASPH_RESIDENT_SOLVER=1), not
    ASPH_NO_WCACHE=1, and no resampling unless the value is "force". P is
    the largest of PATCH_SIDES whose fullest patch and fullest ring, times
    PATCH_HEADROOM, fit 128 slots; need is 1.1 x 128 slots per occupied
    patch in multiples of 1024."""
    mode = os.environ.get("ASPH_CLIQUE", "0")
    if mode == "0" or tq != 128 or capacity % 128 != 0:
        return 0, 0
    if params.operator_discretization == OperatorDiscretization.Winchenbach2020:
        return 0, 0
    if params.resident_solver or os.environ.get("ASPH_RESIDENT_SOLVER") == "1":
        return 0, 0
    if os.environ.get("ASPH_NO_WCACHE") == "1":
        return 0, 0
    if _resampling(params) and mode != "force":
        return 0, 0
    pos, h = _alive_h(host, params)
    if len(pos) == 0:
        return 0, 0
    for P in PATCH_SIDES:
        patches, rings = patch_occupancy(pos, h, params, gcfg, P)
        if max(patches.values()) * PATCH_HEADROOM > 128:
            continue
        if rings and max(rings.values()) * PATCH_HEADROOM > 128:
            continue
        return P, int(np.ceil(len(patches) * 128 * 1.1 / 1024) * 1024)
    return 0, 0


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


def _initial_max_occupancy(host: dict, params: SimulationParams, gcfg: GridConfig) -> int:
    """The most alive particles in one cell of the state's own levels."""
    pos, h = _alive_h(host, params)
    sr = h * max_scale(params)
    level = np.clip(np.ceil(np.log2(np.maximum(sr / gcfg.cell0, 1.0)) - 1e-6).astype(int),
                    0, gcfg.levels - 1)
    occ = 0
    for lvl in np.unique(level):
        sel = level == lvl
        cell = gcfg.cell(int(lvl))
        cx = np.floor((pos[sel, 0] - gcfg.origin[0]) / cell).astype(np.int64)
        cy = np.floor((pos[sel, 1] - gcfg.origin[1]) / cell).astype(np.int64)
        _, counts = np.unique(cx + (cy << 24), return_counts=True)
        occ = max(occ, int(counts.max()))
    return occ


def grid_config_for(params: SimulationParams, scene: scene_mod.SceneConfig, host: dict,
                    capacity: int, mpc: Optional[int] = 32):
    """Static grid geometry from the scene box and the h range of the alive
    masses. With resampling the h band widens to the sizing targets' band and
    every level stays populated; without it masses never change, so only the
    levels of the present h values are populated (two on the stress scene).
    host: numpy "mass" and "alive" of the state ("position" too for
    mpc=None). mpc: the slots per cell (the tile engine reads none of it);
    None sizes it as the reference does for the dense grid engine: the
    state's largest cell occupancy x 2.5 in multiples of 8, at least 32 with
    resampling and 16 without."""
    gcfg = _grid_geometry(params, scene, host, capacity)
    if mpc is None:
        occ = _initial_max_occupancy(host, params, gcfg)
        mpc = max(32 if _resampling(params) else 16, int(np.ceil(occ * 2.5 / 8.0) * 8))
    return dataclasses.replace(gcfg, mpc=mpc)


def _grid_geometry(params: SimulationParams, scene: scene_mod.SceneConfig, host: dict,
                   capacity: int):
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


def neighbor_config_for(params: SimulationParams, capacity: int, row_width: Optional[int] = None,
                        mass_range: Optional[tuple] = None) -> NeighborConfig:
    """The list backend's static shape, as the reference sizes it: one level
    under uniform sizes; without resampling (masses constant) the levels the
    initial size ratio needs (h ~ sqrt(m) in 2D); else the levels of the
    sizing range. Rows: twice the optimal neighbour count, times the extended
    range's area ratio, in multiples of 16, at least 96 under adaptive
    sizes; 48 slots per cell."""
    if params.particle_sizes == ParticleSizes.Uniform:
        levels = 1
    elif mass_range is not None and not (params.splitting or params.merging or params.sharing):
        ratio = float(np.sqrt(mass_range[1] / max(mass_range[0], 1e-30)))
        levels = max(1, int(np.ceil(np.log2(max(ratio, 1.0)))) + 1)
    else:
        levels = params_mod.num_levels_for(params)
    if row_width is None:
        base = kernels.optimal_neighbor_number(2)
        ext = max(1.0, (params.level_estimation_range / (kernels.ETA * 2.0)) ** 2)
        row_width = int(np.ceil(base * ext * 2.0 / 16.0) * 16)
        if params.particle_sizes == ParticleSizes.Adaptive:
            row_width = max(row_width, 96)
    return NeighborConfig(capacity=capacity, row_width=row_width, levels=levels, max_per_cell=48)


def _build_step(params, scene, state, boundary_handler, split_patterns, backend: str,
                row_width: Optional[int] = None, no_patch: bool = False) -> dict:
    """The Simulation fields of `backend` for the state's capacity, masses
    and (grid, and the tile engine's patch side) positions: tile_cfg, ncfg,
    grid_cfg, step_fn and phase_fns (None where the backend has none).
    no_patch keeps the tile engine on the packed layout; so does a patch
    layout that would need more slots than the capacity (create_simulation
    grows the capacity for it beforehand; later builds do not)."""
    host = {"mass": state.mass.cpu().numpy(), "alive": state.alive.cpu().numpy()}
    out = {"tile_cfg": None, "ncfg": None, "grid_cfg": None, "phase_fns": None}
    if backend in ("lists", "grid"):
        masses = host["mass"][host["alive"]]
        mass_range = (float(masses.min()), float(masses.max())) if masses.size else None
        out["ncfg"] = ncfg = neighbor_config_for(params, state.capacity, row_width,
                                                 mass_range=mass_range)
        if backend == "lists":
            out["step_fn"] = make_list_step_fn(params, boundary_handler, ncfg, split_patterns)
            return out
        host["position"] = state.position.cpu().numpy()
        out["grid_cfg"] = gcfg = grid_config_for(params, scene, host, state.capacity, mpc=None)
        out["step_fn"] = make_grid_step_fn(params, boundary_handler, gcfg, ncfg, split_patterns)
        return out
    if state.capacity % 64:
        raise ValueError("the tile backend needs capacity % 64 == 0")
    gcfg = grid_config_for(params, scene, host, state.capacity)
    tq = _tile_tq(state.capacity)
    patch = 0
    if not no_patch:
        host["position"] = state.position.cpu().numpy()
        patch, need = _tile_patch(host, params, gcfg, state.capacity, tq)
        if need > state.capacity:
            patch = 0
    out["tile_cfg"] = tile_cfg = TileConfig.from_grid(gcfg, max_scale(params), tq=tq,
                                                      patch=patch)
    out["step_fn"] = make_step_fn(params, boundary_handler, tile_cfg, split_patterns)
    out["phase_fns"] = make_two_phase_step_fns(params, boundary_handler, split_patterns, tile_cfg)
    return out


def create_simulation(
    params: SimulationParams,
    scene: scene_mod.SceneConfig,
    capacity: Optional[int] = None,
    counters_enabled: bool = True,
    device="cuda",
    split_patterns=None,
    backend: str = "auto",
    row_width: Optional[int] = None,
) -> Simulation:
    """Initial state, boundary handler and step function on `device`: the
    card unless the caller asks for the CPU; without a CUDA device only
    device="cpu" runs. split_patterns: (positions, counts) numpy table as
    `utils.split_patterns.to_padded_table` returns it; the default table
    when splitting and None. backend: "tiles" (the sorted-tile engine and
    its kernels), "lists" (the neighbour-list step, plain torch), "grid"
    (the dense grid engine, plain torch), or "auto" (tiles wherever the
    reference takes them, else lists, see `resolve_backend`);
    row_width: the list rows' width (default: `neighbor_config_for`'s).

    Raises NotImplementedError for settings outside the ported slice."""
    backend = resolve_backend(params, backend)
    check_supported(params, backend)
    device = resolve_device(device)
    if device.type == "cuda":
        # float32 products stay full float32 (no TF32 anywhere in the step)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    params = params_mod.init_h_for_uniform(
        params, scene.blocks[0].spacing, scene.blocks[0].volume_fill_ratio)
    state = scene_mod.init_fluid_state(scene, params, capacity, device=device)
    boundary_handler = scene_mod.make_boundary_handler(scene, params)
    if backend == "tiles" and capacity is None:
        # the patch-major layout pads each occupied patch to 128 slots: where
        # it almost fits, grow the capacity once here, as the reference does
        host = {k: getattr(state, k).cpu().numpy() for k in ("mass", "position", "alive")}
        gcfg = grid_config_for(params, scene, host, state.capacity)
        patch, need = _tile_patch(host, params, gcfg, state.capacity, _tile_tq(state.capacity))
        if patch and state.capacity < need <= 3 * state.capacity:
            state = pad_state_to(state, need)
    if params.particle_sizes == ParticleSizes.Adaptive and params.splitting:
        split_patterns = split_patterns_from_numpy(
            split_patterns if split_patterns is not None else load_default_patterns(), device)
    built = _build_step(params, scene, state, boundary_handler, split_patterns, backend,
                        row_width)
    return Simulation(
        params=params,
        scene=scene,
        state=state,
        boundary_handler=boundary_handler,
        counters=Counters(enabled=counters_enabled),
        split_patterns=split_patterns,
        step_number=int(state.step_number),
        backend=backend,
        row_width=row_width,
        **built,
    )
