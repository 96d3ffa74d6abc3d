"""SPH cubic-spline kernels and dimension utilities on torch tensors.

Counterpart of adaptive_sph_tpu/ops/kernels.py (same formulas, same evaluation
order): support radius 2h, 2D norm 10/(7 pi h^2), 3D norm 1/(pi h^3),
h_ij = (h_i + h_j)/2, h = ETA * volume_to_radius(m / rho0).

Every function takes tensors or Python floats; a Python float in gives a
Python float out where the formula allows it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .numerics import div_const, fma, rdiv, sqrt

PI = float(math.pi)

SUPPORT_RADIUS_BY_SMOOTHING_LENGTH = 2.0

ETA = 1.9


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(x, dtype=torch.float32)


def cubic_kernel_unnormalized(q):
    """Un-normalized cubic spline, piecewise on q = r / (2h). The inner piece
    rounds as XLA's CPU backend evaluates the reference's
    6 (q q q - q q) + 1: fma(6, fma(q q, q, -q q), 1)."""
    q = _t(q)
    v = 1.0 - q
    qq = q * q
    inner = fma(6.0, fma(qq, q, -qq), 1.0)
    outer = 2.0 * v * v * v
    zero = torch.zeros_like(q)
    return torch.where(q < 0.5, inner, torch.where(q < 1.0, outer, zero))


def cubic_kernel_unnormalized_deriv(q):
    """d/dq of the un-normalized cubic spline. The inner piece rounds as XLA's
    CPU backend evaluates the reference's 18 q q - 12 q: fma(18 q, q, -12 q)."""
    q = _t(q)
    v = 1.0 - q
    inner = fma(18.0 * q, q, -(12.0 * q))
    outer = -6.0 * v * v
    zero = torch.zeros_like(q)
    return torch.where(q < 0.5, inner, torch.where(q < 1.0, outer, zero))


def kernel_norm_factor(h, dim: int):
    """Normalization so the kernel integrates to one over R^dim."""
    if isinstance(h, torch.Tensor):
        if dim == 2:
            return rdiv(10.0, (7.0 * PI) * (h * h))
        if dim == 3:
            return rdiv(1.0, PI * (h * h * h))
    else:
        if dim == 2:
            return 10.0 / (7.0 * PI * (h * h))
        if dim == 3:
            return 1.0 / (PI * (h * h * h))
    raise ValueError(f"unsupported dimension {dim}")


def kernel_w(r, h, dim: int = 2):
    """W(r, h) with support radius 2h."""
    r = _t(r)
    return kernel_norm_factor(h, dim) * cubic_kernel_unnormalized(r / (2.0 * h))


def kernel_w_np(q: np.ndarray, h: float, dim: int = 2) -> np.ndarray:
    """W on the host from float32 q = r / 2h: numpy float32, one rounding per
    operation in the reference's order (its host-side evaluations run op by
    op, uncontracted)."""
    f32 = np.float32
    v = f32(1.0) - q
    inner = f32(6.0) * (q * q * q - q * q) + f32(1.0)
    outer = f32(2.0) * v * v * v
    return f32(kernel_norm_factor(float(h), dim)) * np.where(
        q < 0.5, inner, np.where(q < 1.0, outer, f32(0.0)))


def kernel_grad(diff, h, dim: int = 2):
    """dW/dx for W = W(|diff|, h); diff has a trailing axis of size dim.

    Zero for q <= 1e-5. `h` broadcasts against diff[..., 0]."""
    diff = _t(diff)
    r2 = torch.sum(diff * diff, dim=-1)
    r = sqrt(torch.clamp(r2, min=1e-30))
    q = r / (2.0 * h)
    safe = q > 1.0e-5
    direction = diff / r[..., None]
    mag = kernel_norm_factor(h, dim) * cubic_kernel_unnormalized_deriv(q) / (2.0 * h)
    grad = mag[..., None] * direction
    return torch.where(safe[..., None], grad, torch.zeros_like(grad))


def kernel_dw_dH(d, H, dim: int = 2):
    """Derivative of W with respect to the support radius H (= 2h) at distance d."""
    assert dim == 2, "the Omega correction is defined for 2D only"
    d = _t(d)
    H = _t(H)
    cd = 40.0 / (7.0 * PI)
    q = d / H
    w = cubic_kernel_unnormalized(q)
    wd = cubic_kernel_unnormalized_deriv(q)
    return rdiv(cd * (-float(dim)), H * H * H) * w + rdiv(cd, H * H) * wd * (-d / (H * H))


def sphere_volume_to_radius(volume, dim: int = 2):
    """2D: area -> circle radius; 3D: volume -> sphere radius."""
    if not isinstance(volume, torch.Tensor):
        if dim == 2:
            # the reference takes this square root in float32 (jnp.sqrt of a
            # Python float), and init_h_for_uniform keeps that rounding
            return float(np.sqrt(np.float32(volume / PI)))
        if dim == 3:
            return (volume * (3.0 / (4.0 * PI))) ** (1.0 / 3.0)
        raise ValueError(f"unsupported dimension {dim}")
    if dim == 2:
        return sqrt(div_const(volume, PI))
    if dim == 3:
        return (volume * (3.0 / (4.0 * PI))) ** (1.0 / 3.0)
    raise ValueError(f"unsupported dimension {dim}")


def radius_to_sphere_volume(r, dim: int = 2):
    """Inverse of sphere_volume_to_radius."""
    if dim == 2:
        return PI * r * r
    if dim == 3:
        return 4.0 * PI / 3.0 * r * r * r
    raise ValueError(f"unsupported dimension {dim}")


def smoothing_length_from_volume(volume, dim: int = 2):
    """h = ETA * volume_to_radius(V)."""
    return ETA * sphere_volume_to_radius(volume, dim)


def smoothing_length_from_mass(mass, rest_density, dim: int = 2):
    """h = ETA * volume_to_radius(m / rho0)."""
    if isinstance(mass, torch.Tensor):
        return smoothing_length_from_volume(div_const(mass, rest_density), dim)
    return smoothing_length_from_volume(mass / rest_density, dim)


def optimal_neighbor_number(dim: int = 2):
    """(ETA * 2)^D, approx 14.44 in 2D."""
    return (ETA * SUPPORT_RADIUS_BY_SMOOTHING_LENGTH) ** dim


def pair_smoothing_length(h_i, h_j):
    """Symmetrized h_ij = (h_i + h_j) / 2."""
    return (h_i + h_j) * 0.5
