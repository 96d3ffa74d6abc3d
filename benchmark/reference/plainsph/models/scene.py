"""Scene construction: YAML scene -> initial FluidState + boundary handler.

Counterpart of adaptive_sph_tpu/models/scene.py: fluid blocks grid-filled at
their spacing (mass = spacing^2 * fill * rho0), a box boundary centred on the
origin (SDF planes or polygon, or boundary particles on its edges), and the
lean capacity pad for scenes that cannot split.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import yaml

from ..ops import sdf as sdf_mod
from ..utils.params import InitBoundaryHandlerType, ParticleSizes, SimulationParams
from . import boundary as bnd
from .state import FluidState, default_capacity, init_state

INIT_REST_DENSITY = 1.0


@dataclasses.dataclass(frozen=True)
class SceneFluidBlock:
    pos: tuple
    size: tuple
    spacing: float
    volume_fill_ratio: float
    velocity: tuple


@dataclasses.dataclass(frozen=True)
class SceneConfig:
    boundary_type: str
    boundary_width: float
    boundary_height: float
    blocks: tuple


def load_scene(path: str) -> SceneConfig:
    with open(path) as f:
        d = yaml.safe_load(f)
    return scene_from_dict(d)


def scene_from_dict(d: dict) -> SceneConfig:
    blocks = tuple(
        SceneFluidBlock(
            pos=tuple(float(x) for x in b["pos"]),
            size=tuple(float(x) for x in b["size"]),
            spacing=float(b["spacing"]),
            volume_fill_ratio=float(b["volume_fill_ratio"]),
            velocity=tuple(float(x) for x in b["velocity"]),
        )
        for b in d["blocks"]
    )
    return SceneConfig(
        boundary_type=str(d["boundary"]["type"]),
        boundary_width=float(d["boundary"]["width"]),
        boundary_height=float(d["boundary"]["height"]),
        blocks=blocks,
    )


def add_fluid_block(block: SceneFluidBlock):
    """Grid-fill one block: a lattice at `spacing` from `pos`."""
    particle_volume = block.spacing * block.spacing * block.volume_fill_ratio
    particle_mass = particle_volume * INIT_REST_DENSITY

    nx = int(np.floor(block.size[0] / block.spacing))
    ny = int(np.floor(block.size[1] / block.spacing))
    xs = np.arange(nx, dtype=np.float32) * block.spacing + block.pos[0]
    ys = np.arange(ny, dtype=np.float32) * block.spacing + block.pos[1]
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    positions = np.stack([gx.ravel(), gy.ravel()], axis=-1)
    masses = np.full(positions.shape[0], particle_mass, dtype=np.float32)
    velocities = np.tile(np.asarray(block.velocity, np.float32), (positions.shape[0], 1))
    return positions, masses, velocities


def make_boundary_handler(scene: SceneConfig, params: SimulationParams):
    """Boundary handler for the scene box (centred on (0, 0))."""
    w2, h2 = scene.boundary_width / 2.0, scene.boundary_height / 2.0
    bmin, bmax = (-w2, -h2), (w2, h2)

    t = params.init_boundary_handler
    if t == InitBoundaryHandlerType.NoBoundary:
        return bnd.NoBoundaryHandler()
    if t == InitBoundaryHandlerType.AnalyticOverestimate:
        return bnd.WinchenbachBoundary(sdfs=tuple(sdf_mod.boundary_box_planes(bmin, bmax)))
    if t == InitBoundaryHandlerType.AnalyticUnderestimate:
        return bnd.WinchenbachBoundary(sdfs=(sdf_mod.boundary_box_polygon(bmin, bmax),))
    if t == InitBoundaryHandlerType.Particles:
        # the box edges sampled at the smallest block spacing, counter-clockwise
        # from (min x, min y): each edge's points as float64, the table float32
        spacing = min(b.spacing for b in scene.blocks)
        nh = int(np.floor(scene.boundary_width / spacing))
        nv = int(np.floor(scene.boundary_height / spacing))
        bw, bh = nh * spacing, nv * spacing
        minx, miny, maxx, maxy = -bw / 2.0, -bh / 2.0, bw / 2.0, bh / 2.0
        edges = (((minx, miny), (spacing, 0.0), nh), ((maxx, miny), (0.0, spacing), nv),
                 ((maxx, maxy), (-spacing, 0.0), nh), ((minx, maxy), (0.0, -spacing), nv))
        pts = [(start[0] + d[0] * i, start[1] + d[1] * i)
               for start, d, n in edges for i in range(n)]
        return bnd.build_particle_boundary(np.asarray(pts, np.float32), params)
    raise ValueError(t)


def init_fluid_state(
    scene: SceneConfig, params: SimulationParams, capacity: Optional[int] = None,
    device="cuda",
) -> FluidState:
    """Blocks -> particles -> padded FluidState on `device` (the card unless
    the caller asks for the CPU)."""
    parts = [add_fluid_block(b) for b in scene.blocks]
    positions = np.concatenate([p[0] for p in parts], axis=0)
    masses = np.concatenate([p[1] for p in parts], axis=0)
    velocities = np.concatenate([p[2] for p in parts], axis=0)
    adaptive = params.particle_sizes == ParticleSizes.Adaptive
    if capacity is None:
        # only splitting can grow the particle count, so the 2x headroom is
        # kept for splitting configs and everything else takes the lean pad
        capacity = default_capacity(positions.shape[0], adaptive and params.splitting)
    return init_state(
        positions, velocities, masses, capacity,
        uniform_sizes=not adaptive, rest_density=INIT_REST_DENSITY, device=device,
    )
