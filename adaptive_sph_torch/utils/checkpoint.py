"""Checkpoint and resume: the whole FluidState in one .npz.

Counterpart of adaptive_sph_tpu/utils/checkpoint.py with the same file
format: one array per state field under the field's name (the two packages'
FluidState fields are the same), alive rows first. So a checkpoint written
by the JAX package resumes in the port, and one written here loads in the
JAX package.
"""

from __future__ import annotations

import numpy as np

from ..convert import state_from_numpy, state_to_numpy
from ..models.state import FluidState


def save_state(path: str, state: FluidState):
    arrays = state_to_numpy(state)
    # the alive rows first, in their order: the state's own order has holes
    # (the sorted tile layout), and load_state's shrink keeps the first rows
    alive = arrays["alive"]
    idx = np.arange(len(alive))
    order = np.argsort(np.where(alive, idx, len(alive) + idx), kind="stable")
    for k, a in arrays.items():
        if a.ndim >= 1 and a.shape[0] == len(alive):
            arrays[k] = a[order]
    np.savez_compressed(path, **arrays)


def load_state(path: str, capacity: int = None, device="cuda") -> FluidState:
    """The checkpoint's state on `device`, its rows zero-padded or cut to
    `capacity` (default: the checkpoint's own); raises when its particles do
    not fit."""
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files}
    cur_cap = arrays["position"].shape[0]
    capacity = capacity or cur_cap
    n = int(arrays["n"])
    if n > capacity:
        raise ValueError(f"{path}: {n} particles do not fit a capacity of {capacity}")

    def fit(a):
        if a.ndim == 0 or a.shape[0] != cur_cap or capacity == cur_cap:
            return a
        out = np.zeros((capacity,) + a.shape[1:], a.dtype)
        m = min(capacity, cur_cap)
        out[:m] = a[:m]
        return out

    return state_from_numpy({k: fit(a) for k, a in arrays.items()}, device=device)
