"""Carry states and parameters between the JAX package and the port.

Both directions go through plain numpy arrays and dictionaries, so this
module imports neither jax nor the JAX package:

- `state_from_numpy(arrays, device="cuda")`: a FluidState from the JAX FluidState's
  fields as numpy arrays (e.g. `{k: np.asarray(getattr(s, k)) for k in FIELDS}`).
- `state_to_numpy(state)`: the inverse.
- `params_from_dict(d)`: SimulationParams from `dataclasses.asdict` of the
  JAX SimulationParams (its enum members are read by value).
- `params_to_dict(params)`: plain values that the JAX package's
  `params_from_dict` accepts.
- `split_patterns_from_numpy((positions, counts), device)`: the splitter's
  pattern table (either package's `to_padded_table`) on `device`.
- `particle_boundary_from_numpy(static)`: the particle boundary handler from
  the fields of the JAX ParticleBoundaryStatic (`dataclasses.asdict`), so
  that both packages step with the same boundary arrays.
- `grid_config_from_dict(d)` / `slab_config_from_dict(d)`: the port's
  GridConfig / SlabConfig from `dataclasses.asdict` of the JAX package's
  (the tile config keeps the fields the port's has).
- `slab_states_from_numpy(arrays, scfg, device)`: a JAX slab-blocked state
  (ndev * c_dev rows, as numpy arrays) split into the ranks' local states;
  `alive_from_slab_states(states)`: the ranks' states back into one
  `gather_alive` dictionary.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from .models import boundary as bnd
from .models.state import FIELDS, FluidState, resolve_device
from .ops.grid import GridConfig
from .ops.tiles import TileConfig
from .utils import params as params_mod
from .utils.params import SimulationParams

_DTYPES = {
    "has_level": torch.bool, "flag_neighborhood_reduced": torch.bool,
    "flag_is_fluid_surface": torch.bool, "flag_insufficient_neighs": torch.bool,
    "alive": torch.bool, "size_class": torch.int32, "neighbor_count": torch.int32,
    "n": torch.int32, "step_number": torch.int32,
}


def state_from_numpy(arrays: dict, device="cuda") -> FluidState:
    device = resolve_device(device)
    missing = [k for k in FIELDS if k not in arrays]
    if missing:
        raise KeyError(f"state_from_numpy: missing fields {missing}")
    kw = {}
    for k in FIELDS:
        a = np.asarray(arrays[k])
        dtype = _DTYPES.get(k, torch.float32)
        kw[k] = torch.as_tensor(a).to(device=device, dtype=dtype).clone()
    return FluidState(**kw)


def state_to_numpy(state: FluidState) -> dict:
    return {k: getattr(state, k).detach().cpu().numpy() for k in FIELDS}


def params_from_dict(d: dict) -> SimulationParams:
    plain = {}
    for k, v in d.items():
        if isinstance(v, enum.Enum):
            v = v.value
        plain[k] = v
    return params_mod.params_from_dict(plain)


def params_to_dict(params: SimulationParams) -> dict:
    out = {}
    for f in dataclasses.fields(params):
        v = getattr(params, f.name)
        out[f.name] = v.value if isinstance(v, enum.Enum) else v
    return out


def split_patterns_from_numpy(table, device="cuda"):
    """((P, MAXC, 2) float32 positions on `device`, (P,) int32 numpy counts)."""
    pos, counts = table
    return (torch.as_tensor(np.array(pos, np.float32), device=resolve_device(device)),
            np.asarray(counts, np.int32))


def particle_boundary_from_numpy(static: dict) -> "bnd.ParticleBoundaryHandler":
    """ParticleBoundaryHandler over the given positions, pseudo-masses and
    static cell grid (the fields of ParticleBoundaryStatic)."""
    arrays = {"positions": np.float32, "psi": np.float32, "sorted_cell_ids": np.int32,
              "order": np.int32, "dom_min": np.float32}
    kw = {k: np.asarray(static[k], dt) for k, dt in arrays.items()}
    kw.update(width=int(static["width"]), cell=float(static["cell"]), kb=int(static["kb"]),
              max_per_cell=int(static["max_per_cell"]))
    return bnd.ParticleBoundaryHandler(static=bnd.ParticleBoundaryStatic(**kw))


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, (list, tuple)) else v


def grid_config_from_dict(d: dict) -> GridConfig:
    names = {f.name for f in dataclasses.fields(GridConfig)}
    return GridConfig(**{k: _tuples(v) for k, v in d.items() if k in names})


def slab_config_from_dict(d: dict):
    from .parallel import tile_sharding

    names = {f.name for f in dataclasses.fields(TileConfig)}
    tcfg = TileConfig(**{k: _tuples(v) for k, v in d["tcfg"].items() if k in names})
    return tile_sharding.SlabConfig(
        ndev=int(d["ndev"]), c_dev=int(d["c_dev"]), strip=int(d["strip"]),
        halo_w=float(d["halo_w"]), edges=tuple(float(e) for e in d["edges"]),
        oy=float(d["oy"]), tcfg=tcfg)


def slab_states_from_numpy(arrays: dict, scfg, device="cuda") -> list:
    from .parallel import tile_sharding

    device = resolve_device(device)
    return [tile_sharding.local_state(arrays, scfg, r, device) for r in range(scfg.ndev)]


def alive_from_slab_states(states) -> dict:
    from .parallel import tile_sharding

    host = [state_to_numpy(s) for s in states]
    blocked = {k: (host[0][k] if host[0][k].ndim == 0
                   else np.concatenate([h[k] for h in host])) for k in FIELDS}
    return tile_sharding.gather_alive(blocked)
