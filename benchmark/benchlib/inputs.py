"""A cell's inputs: the simulation parameters and the scene from the
configuration file and the traffic mix, and the seeded jitter of the initial
positions. Both sides, the program and the reference, get these same
inputs."""

from __future__ import annotations

import hashlib
import math

import torch


def params_dict(config: dict, overrides: dict = None) -> dict:
    """The published parameters: the base configuration with the export
    entry's update_attributes over it (as the upstream image export loads
    them), then `overrides` (the control's lower precision)."""
    return {**config["config"], **config["update_attributes"], **(overrides or {})}


def scene_dict(config: dict, traffic: dict) -> dict:
    """The configuration's scene, its blocks tiled `replicas` times side by
    side: copy k shifted by 2 k - (replicas - 1) in x, in a box 2 x replicas
    wide (no interior walls)."""
    scene = config["scene"]
    n = int(traffic.get("replicas", 1))
    if n == 1:
        return scene
    width = float(scene["boundary"]["width"])
    blocks = []
    for k in range(n):
        off = width * k - width * (n - 1) / 2.0
        for b in scene["blocks"]:
            blocks.append({**b, "pos": [b["pos"][0] + off, b["pos"][1]]})
    return {"boundary": {**scene["boundary"], "width": width * n}, "blocks": blocks}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named random stream of a run."""
    h = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(h[:8], "little") & ((1 << 63) - 1)


def jitter(mass: torch.Tensor, alive: torch.Tensor, rest_density: float, amplitude: float,
           seed: int) -> torch.Tensor:
    """(C, 2) float32 position offsets on mass's device: per particle and
    axis a uniform draw in [-amplitude, amplitude] times the particle's
    radius sqrt(m / (pi rho0)), zero on free slots; drawn by a generator of
    that device, seeded with a hash of `seed` (every bit of the seed moves
    the draw, also where a generator keeps only 32 bits of its seed)."""
    g = torch.Generator(device=mass.device)
    g.manual_seed(stream_seed(seed, "jitter"))
    u = torch.rand((mass.shape[0], 2), generator=g, device=mass.device, dtype=torch.float32)
    radius = torch.sqrt(torch.clamp(mass, min=0.0) / (math.pi * rest_density))
    return (2.0 * u - 1.0) * (amplitude * radius * alive.to(torch.float32))[:, None]
