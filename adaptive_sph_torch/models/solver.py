"""Solver constants and the result record of one pressure solve.

Counterpart of the constants and `SolveResult` of
adaptive_sph_tpu/models/solver.py.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

DENSITY_ERROR = 0
DIVERGENCE_ERROR = 1

SINGULAR_AII_EPS = 1e-3  # |a_ii| below this is treated as singular


class SolveResult(NamedTuple):
    pressure: torch.Tensor
    pressure_accel: tuple  # (ax (C,), ay (C,))
    density_error: torch.Tensor
    iterations: int  # the reference's returned iteration count
    avg_error: torch.Tensor  # () f32, last sweep, per-normal-particle average
    max_error: torch.Tensor  # () f32
    normal_count: torch.Tensor
    singular_count: torch.Tensor
    negative_count: torch.Tensor
