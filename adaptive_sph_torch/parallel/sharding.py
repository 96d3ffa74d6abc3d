"""The particle-sharded step over torch.distributed: the list backend's
multi-device fallback.

Counterpart of adaptive_sph_tpu/parallel/sharding.py, which shards every
(C, ...) state array over a 1-D device mesh and lets GSPMD place the
collectives; because the neighbour gathers make it all-gather the particle
arrays, its own docstring calls it replicated compute with sharded storage.
Here that is written out: each rank owns a contiguous block of C / world
rows; every step the ranks all-gather the state (one collective per dtype:
the float32, int32 and bool columns), every rank runs the same one-device
list step (models/simulation.py `make_list_step_fn`) on the whole state, and
keeps its own rows. The step is deterministic, so the ranks hold one
trajectory, equal to the one-device run's. The scene's scalars (n, time,
step_number) and the diagnostics are the same on every rank.

The slab decomposition (parallel/tile_sharding.py) is the scaling path; this
one serves the configurations the tile engine refuses, at fallback cost.
The capacity is fixed (a multiple of the rank count): deferred splits raise
instead of growing it.

Ranks are spawned by `multichip.run_ranks(ShardedListJob(...), ranks,
backend, device)`: "gloo" on the CPU or with ranks sharing one card; "nccl"
is written (one card per rank) but has never run on several cards.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from .. import convert
from ..models import scene as scene_mod
from ..models.simulation import make_list_step_fn
from ..models.state import FIELDS, FluidState
from ..ops import pair_ops
from ..runner import SimulationFailed, _read_diag, create_simulation
from .tile_sharding import SlabComm

_GROUPS = (torch.float32, torch.int32, torch.bool)


def row_block(capacity: int, world: int, rank: int) -> tuple:
    """[lo, hi) of the rows `rank` owns."""
    if capacity % world:
        raise ValueError(f"capacity {capacity} is not a multiple of {world} ranks")
    per = capacity // world
    return rank * per, (rank + 1) * per


def _row_fields(state: FluidState) -> list:
    return [k for k in FIELDS if getattr(state, k).ndim >= 1]


def local_rows(state: FluidState, world: int, rank: int) -> FluidState:
    """The rank's block of every per-particle field; scalars as they are."""
    lo, hi = row_block(state.capacity, world, rank)
    return state.replace(**{k: getattr(state, k)[lo:hi].clone() for k in _row_fields(state)})


def gather_state(local: FluidState, comm: SlabComm) -> FluidState:
    """The whole state from every rank's block, in rank order: the columns
    of each dtype packed into one (rows, width) tensor and all-gathered."""
    names = _row_fields(local)
    out = {}
    for dtype in _GROUPS:
        group = [k for k in names if getattr(local, k).dtype == dtype]
        if not group:
            continue
        cols = [getattr(local, k) for k in group]
        widths = [1 if c.ndim == 1 else c.shape[1] for c in cols]
        packed = torch.cat([c.reshape(c.shape[0], -1) for c in cols], dim=1)
        full = torch.cat(comm.all_gather(packed.to(torch.uint8) if dtype == torch.bool
                                         else packed), dim=0)
        if dtype == torch.bool:
            full = full.to(torch.bool)
        for k, c, piece in zip(group, cols, torch.split(full, widths, dim=1)):
            out[k] = piece.reshape((-1,) + tuple(c.shape[1:])).contiguous()
    missing = [k for k in names if k not in out]
    if missing:
        raise TypeError(f"fields of no gathered dtype: {missing}")
    return local.replace(**out)


class ShardedListSimulation:
    """One rank's side of the particle-sharded list step. `local` is the
    rank's block of the state; step() gathers, steps, keeps the block and
    raises SimulationFailed on the reference's list-step failures."""

    def __init__(self, params, boundary_handler, ncfg, state: FluidState, comm: SlabComm,
                 split_patterns=None):
        self.params = params
        self.comm = comm
        self.ncfg = ncfg
        self.step_fn = make_list_step_fn(params, boundary_handler, ncfg, split_patterns)
        self.local = local_rows(state, comm.world, comm.rank)
        self.step_number = int(state.step_number)
        self.gathers = 0

    @classmethod
    def from_simulation(cls, sim, comm: SlabComm) -> "ShardedListSimulation":
        if sim.backend != "lists":
            raise ValueError("the particle-sharded step runs the list backend")
        return cls(sim.params, sim.boundary_handler, sim.ncfg, sim.state, comm,
                   sim.split_patterns)

    @property
    def time(self) -> float:
        return float(self.local.time)

    def gather(self) -> FluidState:
        self.gathers += 1
        return gather_state(self.local, self.comm)

    def step(self) -> dict:
        full = self.gather()
        new, diag = self.step_fn(full, self.step_number + 1)
        diag = _read_diag({**diag, "particle_count": new.n})
        ro, co, lo = diag["neighbor_overflow"]
        if diag["negative_aii"] > 0:
            raise SimulationFailed(f"AII should not be negative! ({diag['negative_aii']} "
                                   "particles)")
        if ro > 0 or co > 0 or lo > 0:
            raise SimulationFailed(
                f"neighbor structure overflow: rows over by {ro}, cell={co}, level={lo} "
                "(raise NeighborConfig.row_width / max_per_cell / levels)")
        if not np.isfinite(diag["dt"]):
            raise SimulationFailed("non-finite dt")
        if "mass_conservation_error" in diag and not diag["mass_conservation_error"] < 0.005:
            raise SimulationFailed(
                f"mass not conserved after adaptivity: {diag['mass_conservation_error']}")
        if diag.get("split_deferred", 0) > 0:
            raise SimulationFailed(f"{diag['split_deferred']} splits deferred: the sharded "
                                   "step keeps its capacity; start with a larger one")
        self.local = local_rows(new, self.comm.world, self.comm.rank)
        self.step_number += 1
        return diag


@dataclasses.dataclass
class ShardedListJob:
    """What every rank runs: `steps` particle-sharded list steps of the scene
    (params: `convert.params_to_dict`; scene: the scene dictionary) at
    `capacity` (a multiple of the rank count). Rank 0 returns the final
    global state as numpy arrays ("final"), every rank its diagnostics,
    step times and kernel launches; with profile_steps, the last so many
    steps run under torch.profiler (CUDA only) and "profile" holds their
    wall and device seconds and host synchronisations."""

    params: dict
    scene: dict
    steps: int
    capacity: Optional[int] = None
    split_patterns: Optional[tuple] = None
    profile_steps: int = 0

    def run(self, comm: SlabComm, hooks=None) -> dict:
        params = convert.params_from_dict(self.params)
        scene = scene_mod.scene_from_dict(self.scene)
        sim = create_simulation(params, scene, capacity=self.capacity, counters_enabled=False,
                                device=comm.device, split_patterns=self.split_patterns,
                                backend="lists")
        ssim = ShardedListSimulation.from_simulation(sim, comm)
        out = {"diags": [], "step_s": []}
        pair_ops.reset_launches()
        t_run = time.perf_counter()
        for k in range(self.steps - self.profile_steps):
            t0 = time.perf_counter()
            with (hooks.around_step(comm.rank, k) if hooks is not None
                  else contextlib.nullcontext()):
                d = ssim.step()
            out["step_s"].append(time.perf_counter() - t0)
            out["diags"].append(d)
        if self.profile_steps:
            from ..multichip import _profile_window

            out["profile"] = _profile_window(lambda: out["diags"].append(ssim.step()),
                                             self.profile_steps)
        out["run_s"] = time.perf_counter() - t_run
        out["launches"] = dict(pair_ops.launches)
        out["comm"] = {"gathers": ssim.gathers}
        final = convert.state_to_numpy(ssim.gather())
        if comm.rank == 0:
            out["final"] = final
        return out
