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
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np
import torch

from .models.state import FIELDS, FluidState, resolve_device
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
