"""Float32 helpers that keep the port bit-compatible with the reference's arithmetic.

Three places where a plain torch expression rounds differently from the JAX
reference as compiled by XLA:

- `x / c` with a Python constant `c`: XLA folds it into `x * f32(1 / f32(c))`.
  The tile layout's integer cell coordinates depend on that rounding, so the
  port multiplies by the same folded reciprocal (`div_const`).
- `c / x` with a Python constant `c`: torch evaluates it as `reciprocal(x) * c`,
  two roundings instead of one (`rdiv` divides exactly).
- `torch.sqrt` on a CPU float32 tensor is not correctly rounded in every lane
  (vectorised approximation); XLA's and CUDA's are. On the CPU `sqrt` goes
  through float64, which rounds back to the correctly rounded float32 result.
"""

from __future__ import annotations

import numpy as np
import torch


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as the reference computes it: x * f32(1 / f32(c))."""
    return x * float(np.float32(1.0) / np.float32(c))


def rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """f32(c) / x with one rounding."""
    return torch.full_like(x, c) / x


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device."""
    if x.device.type == "cpu" and x.dtype == torch.float32:
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)
