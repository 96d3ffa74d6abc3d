"""Float32 helpers that keep the port bit-compatible with the reference's arithmetic.

Four places where a plain torch expression rounds differently from the JAX
reference as compiled by XLA:

- `x / c` with a Python constant `c`: XLA folds it into `x * f32(1 / f32(c))`.
  The tile layout's integer cell coordinates depend on that rounding, so the
  port multiplies by the same folded reciprocal (`div_const`).
- `c / x` with a Python constant `c`: torch evaluates it as `reciprocal(x) * c`,
  two roundings instead of one (`rdiv` divides exactly).
- `torch.sqrt` on a CPU float32 tensor is not correctly rounded in every lane
  (vectorised approximation); XLA's and CUDA's are. On the CPU `sqrt` goes
  through float64, which rounds back to the correctly rounded float32 result.
- XLA's CPU backend contracts `a * b + c` inside a fusion into one fused
  multiply-add (one rounding); torch rounds the product and the sum
  separately. Which products it contracts depends on the fusion, so the
  port mirrors only two: the split children's positions (p + q * s, one
  way to contract) and the resampling transfer's mass-weighted mean (the
  order measured closest to the reference), through `fma`.
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


def fma(a, b, c) -> torch.Tensor:
    """float32 a * b + c with one rounding, as a fused multiply-add: the
    product is exact in float64, and the float64 sum rounds to the same
    float32 except in ties of probability ~2^-29. a, b or c may be a Python
    float, which is taken as float32 first."""
    def f64(x):
        if isinstance(x, torch.Tensor):
            return x.double()
        return float(np.float32(x))

    ref = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
    return (f64(a) * f64(b) + f64(c)).to(ref.dtype)
