"""FluidState: the fixed-capacity SoA particle store as a dataclass of tensors.

Counterpart of adaptive_sph_tpu/models/state.py: the same per-particle arrays
at a fixed capacity C, an alive mask, the alive count `n`, and the clock. All
tensors of one state live on one device. `dataclasses.replace` builds the next
state; nothing updates a state in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import kernels


@dataclasses.dataclass
class FluidState:
    # core physical state
    mass: torch.Tensor  # (C,)
    position: torch.Tensor  # (C, D)
    velocity: torch.Tensor  # (C, D)
    pressure_accel: torch.Tensor  # (C, D)
    density: torch.Tensor  # (C,)
    ppe_source_term: torch.Tensor  # (C,)
    pressure: torch.Tensor  # (C,)
    pressure_div: torch.Tensor  # (C,) last divergence-solve pressure (warm starts)
    aii: torch.Tensor  # (C,)
    density_error: torch.Tensor  # (C,)
    omega: torch.Tensor  # (C,)  IISPH2 Omega correction

    # per-particle smoothing lengths
    h: torch.Tensor  # (C,)
    h_next: torch.Tensor  # (C,)

    # level estimation (surface distance field)
    level: torch.Tensor  # (C,)
    has_level: torch.Tensor  # (C,) bool
    level_old: torch.Tensor  # (C,)

    # adaptivity
    size_class: torch.Tensor  # (C,) int32
    constant_field: torch.Tensor  # (C,)
    stash: torch.Tensor  # (C,)

    # flags + counts
    flag_neighborhood_reduced: torch.Tensor  # (C,) bool
    flag_is_fluid_surface: torch.Tensor  # (C,) bool
    flag_insufficient_neighs: torch.Tensor  # (C,) bool
    neighbor_count: torch.Tensor  # (C,) int32

    # liveness
    alive: torch.Tensor  # (C,) bool
    n: torch.Tensor  # () int32 number of alive particles

    # simulation clock
    time: torch.Tensor  # () f32
    step_number: torch.Tensor  # () int32

    @property
    def capacity(self) -> int:
        return self.position.shape[0]

    @property
    def dim(self) -> int:
        return self.position.shape[1]

    @property
    def device(self) -> torch.device:
        return self.position.device

    def replace(self, **kw) -> "FluidState":
        return dataclasses.replace(self, **kw)


FIELDS = tuple(f.name for f in dataclasses.fields(FluidState))


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. The entry points default to "cuda"
    and never fall back: without a CUDA device, only an explicit "cpu" runs."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("adaptive_sph_torch: no CUDA device is available; pass "
                           "device='cpu' (CLI: --device cpu) to run on the CPU")
    return device

# ParticleSizeClass encoding
SIZE_TOO_SMALL = 0
SIZE_SMALL = 1
SIZE_OPTIMAL = 2
SIZE_LARGE = 3
SIZE_TOO_LARGE = 4


def init_state(
    positions: np.ndarray,
    velocities: np.ndarray,
    masses: np.ndarray,
    capacity: int,
    uniform_sizes: bool,
    rest_density: float = 1.0,
    device="cuda",
) -> FluidState:
    """Initial state: h from mass in adaptive mode, zero in uniform mode (the
    global params.h is used instead). On the card unless `device` says
    otherwise (see `resolve_device`)."""
    device = resolve_device(device)
    n = positions.shape[0]
    dim = positions.shape[1]
    assert n <= capacity, f"{n} particles exceed capacity {capacity}"

    def pad(a, shape, dtype=np.float32, fill=0):
        out = np.full(shape, fill, dtype=dtype)
        out[:n] = a
        return torch.from_numpy(out).to(device)

    if uniform_sizes:
        h_init = np.zeros(n, dtype=np.float32)
    else:
        h_init = np.asarray(
            h_from_mass_np(np.asarray(masses, np.float64), rest_density, dim),
            dtype=np.float32,
        )

    def zeros(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    alive = np.zeros(capacity, dtype=bool)
    alive[:n] = True

    return FluidState(
        mass=pad(masses, (capacity,)),
        position=pad(positions, (capacity, dim)),
        velocity=pad(velocities, (capacity, dim)),
        pressure_accel=zeros(capacity, dim),
        density=zeros(capacity),
        ppe_source_term=zeros(capacity),
        pressure=zeros(capacity),
        pressure_div=zeros(capacity),
        aii=zeros(capacity),
        density_error=zeros(capacity),
        omega=torch.ones(capacity, dtype=torch.float32, device=device),
        h=pad(h_init, (capacity,)),
        h_next=pad(h_init, (capacity,)),
        level=zeros(capacity),
        has_level=zeros(capacity, dtype=torch.bool),
        level_old=zeros(capacity),
        size_class=torch.full((capacity,), SIZE_OPTIMAL, dtype=torch.int32, device=device),
        constant_field=zeros(capacity),
        stash=zeros(capacity),
        flag_neighborhood_reduced=zeros(capacity, dtype=torch.bool),
        flag_is_fluid_surface=zeros(capacity, dtype=torch.bool),
        flag_insufficient_neighs=zeros(capacity, dtype=torch.bool),
        neighbor_count=zeros(capacity, dtype=torch.int32),
        alive=torch.from_numpy(alive).to(device),
        n=torch.tensor(n, dtype=torch.int32, device=device),
        time=torch.tensor(0.0, dtype=torch.float32, device=device),
        step_number=torch.tensor(0, dtype=torch.int32, device=device),
    )


def h_from_mass_np(mass, rest_density, dim: int = 2):
    """Host-side h = ETA * volume_to_radius(m / rho0) in numpy."""
    v = np.asarray(mass) / rest_density
    if dim == 2:
        r = np.sqrt(v / np.pi)
    else:
        r = (v * (3.0 / (4.0 * np.pi))) ** (1.0 / 3.0)
    return kernels.ETA * r


def default_capacity(n: int, adaptive: bool, headroom: float = 1.125) -> int:
    """Capacity rounded up to a multiple of 1024: a small numerical slack for
    non-splitting scenes, 2x for scenes that can split."""
    target = int(n * (headroom if not adaptive else max(headroom, 2.0)))
    return max(1024, ((target + 1023) // 1024) * 1024)
