"""Semi-analytic boundary integrals lambda(d) / dlambda(d) for the 2D cubic kernel.

Counterpart of adaptive_sph_tpu/ops/boundary_lambda.py. lambda(d) is the
fraction of a particle's kernel volume behind a plane boundary at signed
distance d (support-radius units, d in [-1, 1]). The closed forms and the
tables built from them are evaluated in float64 numpy on the host (identical
code to the reference); per-particle evaluation is float32 torch.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from .numerics import div_const


def _lambda2_nonnegative(d: np.ndarray) -> np.ndarray:
    """Closed-form lambda for d >= 0 (plane_numerics.rs:30-61). Vectorized f64 numpy."""
    d = np.asarray(d, dtype=np.float64)
    out = np.zeros_like(d)

    # d < 0.5 branch
    m1 = (d >= 1e-9) & (d < 0.5)
    x = np.clip(d, 1e-12, 0.5 - 1e-18)
    s12 = np.sqrt(np.clip(1.0 - 2.0 * x, 0.0, None)) * np.sqrt(2.0 * x + 1.0)
    s11 = np.sqrt(np.clip(1.0 - x, 0.0, None)) * np.sqrt(x + 1.0)
    v1 = (
        ((-48.0 * x**5) - 80.0 * x**3) * np.log(s12 + 1.0)
        + (12.0 * x**5 + 80.0 * x**3) * np.log(s11 + 1.0)
        - np.arccos(np.clip(2.0 * x, -1.0, 1.0))
        + 36.0 * np.log(x) * x**5
        + 48.0 * np.log(2.0) * x**5
        + s12 * (68.0 * x**3 + 8.0 * x)
        + 80.0 * np.log(2.0) * x**3
        + s11 * ((-68.0 * x**3) - 32.0 * x)
        + 8.0 * np.arccos(np.clip(x, -1.0, 1.0))
    ) / (7.0 * np.pi)
    out = np.where(m1, v1, out)

    # 0.5 <= d < 1 branch
    m2 = (d >= 0.5) & (d < 1.0)
    y = np.clip(d, 0.5, 1.0 - 1e-18)
    t11 = np.sqrt(np.clip(1.0 - y, 0.0, None)) * np.sqrt(y + 1.0)
    v2 = -(
        ((-12.0 * y**5) - 80.0 * y**3) * np.log(t11 + 1.0)
        + np.log(y) * (12.0 * y**5 + 80.0 * y**3)
        + t11 * (68.0 * y**3 + 32.0 * y)
        - 8.0 * np.arccos(np.clip(y, -1.0, 1.0))
    ) / (7.0 * np.pi)
    out = np.where(m2, v2, out)

    # d ~ 0
    out = np.where(d < 1e-9, 0.5, out)
    # d >= 1
    out = np.where(d >= 1.0, 0.0, out)
    return out


def lambda2(d) -> np.ndarray:
    """lambda(d) for the 2D cubic kernel, d in support-radius units. plane_numerics.rs:19-25."""
    d = np.asarray(d, dtype=np.float64)
    return np.where(d >= 0.0, _lambda2_nonnegative(d), 1.0 - _lambda2_nonnegative(-d))


def _dlambda2_nonnegative(d: np.ndarray) -> np.ndarray:
    """Closed-form dlambda/dd for d >= 0 (plane_numerics.rs:77-152). Vectorized f64 numpy."""
    d = np.asarray(d, dtype=np.float64)
    out = np.zeros_like(d)

    ln = np.log
    # branch d < 0.5 (undefined exactly at 0.5; the reference evaluates the open interval)
    m1 = (d >= 1e-10) & (d < 0.5)
    x = np.clip(d, 1e-12, 0.5 - 1e-12)
    s_12 = np.sqrt(np.clip(1.0 - 2.0 * x, 0.0, None))
    s_21 = np.sqrt(2.0 * x + 1.0)
    s_11 = np.sqrt(np.clip(1.0 - x, 0.0, None))
    s_p1 = np.sqrt(x + 1.0)
    l12 = ln(s_12 * s_21 + 1.0)
    l11 = ln(s_11 * s_p1 + 1.0)
    lx = ln(x)
    l2 = ln(2.0)
    num = (
        s_21
        * (
            s_12
            * (
                (240.0 * x**2 - 240.0 * x**6) * l12
                + (60.0 * x**6 + 180.0 * x**4 - 240.0 * x**2) * l11
                + lx * (180.0 * x**6 - 180.0 * x**4)
                + (240.0 * l2 - 1040.0) * x**6
                + 1000.0 * x**4
                + (10.0 - 240.0 * l2) * x**2
                + 30.0
            )
            + s_12
            * s_11
            * s_p1
            * (
                (240.0 * x**4 + 240.0 * x**2) * l12
                + ((-60.0 * x**4) - 240.0 * x**2) * l11
                - 180.0 * lx * x**4
                + (780.0 - 240.0 * l2) * x**4
                - 240.0 * l2 * x**2
                + 30.0
            )
        )
        + s_11
        * s_p1
        * (
            ((-960.0 * x**6) - 720.0 * x**4 + 240.0 * x**2) * l12
            + (240.0 * x**6 + 900.0 * x**4 - 240.0 * x**2) * l11
            + lx * (720.0 * x**6 - 180.0 * x**4)
            + (960.0 * l2 + 1040.0) * x**6
            + (720.0 * l2 - 100.0) * x**4
            + ((-240.0 * l2) - 160.0) * x**2
            + 30.0
        )
        + (960.0 * x**8 - 240.0 * x**6 - 960.0 * x**4 + 240.0 * x**2) * l12
        + ((-240.0 * x**8) - 660.0 * x**6 + 1140.0 * x**4 - 240.0 * x**2) * l11
        - 960.0 * l2 * x**8
        + lx * ((-720.0 * x**8) + 900.0 * x**6 - 180.0 * x**4)
        + 240.0 * l2 * x**6
        + (960.0 * l2 + 120.0) * x**4
        + ((-240.0 * l2) - 150.0) * x**2
        + 30.0
    )
    den = (
        28.0 * np.pi * x**4
        + s_21 * (s_12 * (7.0 * np.pi - 7.0 * np.pi * x**2) + 7.0 * np.pi * s_12 * s_11 * s_p1)
        + s_11 * s_p1 * (7.0 * np.pi - 28.0 * np.pi * x**2)
        - 35.0 * np.pi * x**2
        + 7.0 * np.pi
    )
    out = np.where(m1, -(1.0 * num) / den, out)

    # branch 0.5 <= d < 1
    m2 = (d >= 0.5) & (d < 1.0)
    y = np.clip(d, 0.5, 1.0 - 1e-12)
    t11 = np.sqrt(np.clip(1.0 - y, 0.0, None)) * np.sqrt(y + 1.0)
    l11y = ln(t11 + 1.0)
    lny = ln(y)
    num2 = (
        t11
        * (
            (60.0 * y**4 + 240.0 * y**2) * l11y
            + 260.0 * y**4
            + lny * ((-60.0 * y**4) - 240.0 * y**2)
            - 220.0 * y**2
            - 40.0
        )
        + ((-60.0 * y**6) - 180.0 * y**4 + 240.0 * y**2) * l11y
        + lny * (60.0 * y**6 + 180.0 * y**4 - 240.0 * y**2)
        + 260.0 * y**4
        - 220.0 * y**2
        - 40.0
    )
    den2 = (-7.0 * np.pi * y**2) + 7.0 * np.pi * t11 + 7.0 * np.pi
    out = np.where(m2, num2 / den2, out)

    # d ~ 0 limit (plane_numerics.rs:80-81)
    out = np.where(d < 1e-10, -1.36418522650196, out)
    out = np.where(d >= 1.0, 0.0, out)
    return out


def dlambda2(d) -> np.ndarray:
    """dlambda/dd for the 2D cubic kernel; even extension for d<0. plane_numerics.rs:66-72."""
    d = np.asarray(d, dtype=np.float64)
    return np.where(d >= 0.0, _dlambda2_nonnegative(d), _dlambda2_nonnegative(-d))


LUT_STEPS = 10000  # boundary_winchenbach2020.rs:34
LUT_MIN = -1.0
LUT_MAX = 1.0


@lru_cache(maxsize=1)
def _lut_tables_np():
    """Build the (steps+1,) f32 tables on the host in f64, once per process."""
    xs = np.arange(LUT_STEPS + 1, dtype=np.float64) / LUT_STEPS * (LUT_MAX - LUT_MIN) + LUT_MIN
    lam = lambda2(xs).astype(np.float32)
    dlam = dlambda2(xs).astype(np.float32)
    assert np.all(np.isfinite(lam)) and np.all(np.isfinite(dlam))
    return lam, dlam


def lut_tables(device="cpu"):
    """(lambda_table, dlambda_table) float32 tensors on `device`."""
    lam, dlam = _lut_tables_np()
    return torch.from_numpy(lam).to(device), torch.from_numpy(dlam).to(device)


def lut_lookup(table, x):
    """Linear interpolation of a (LUT_STEPS+1,) table at x, x clamped into
    [LUT_MIN, LUT_MAX) (callers guard d <= -1 separately)."""
    x = torch.clamp(x, LUT_MIN, LUT_MAX - 1e-7)
    fidx = div_const(x - LUT_MIN, LUT_MAX - LUT_MIN) * LUT_STEPS
    idx = torch.floor(fidx)
    interp = fidx - idx
    i0 = idx.long()
    i1 = torch.clamp(i0 + 1, max=LUT_STEPS)
    return table[i0] * (1.0 - interp) + table[i1] * interp


# Piecewise polynomials fitted to the same float64 closed forms the LUT is
# built from: 32 segments of degree 7 over [-1, 1]. The per-element result is
# the same Horner evaluation as the reference's masked 32-segment sweep; here
# each element gathers its segment's coefficients instead.

_POLY_SEGS = 32
_POLY_DEG = 7


@lru_cache(maxsize=1)
def _poly_tables_np():
    """(segs, deg+1) float64 coefficient tables for lambda and dlambda over [-1, 1]."""
    width = (LUT_MAX - LUT_MIN) / _POLY_SEGS
    lam_c = np.zeros((_POLY_SEGS, _POLY_DEG + 1))
    dlam_c = np.zeros((_POLY_SEGS, _POLY_DEG + 1))
    for s in range(_POLY_SEGS):
        a = LUT_MIN + s * width
        xs = np.linspace(a, a + width, 600)
        t = (xs - a) / width * 2.0 - 1.0  # normalized to [-1, 1] per segment
        lam_c[s] = np.polyfit(t, lambda2(xs), _POLY_DEG)
        dlam_c[s] = np.polyfit(t, dlambda2(xs), _POLY_DEG)
    return lam_c, dlam_c


_poly_cache = {}


def _poly_tables(device):
    key = str(device)
    if key not in _poly_cache:
        lam_c, dlam_c = _poly_tables_np()
        both = np.stack([lam_c, dlam_c], axis=-1).astype(np.float32)  # (S, K, 2)
        _poly_cache[key] = torch.from_numpy(both).to(device)
    return _poly_cache[key]


def lambda_dlambda_poly(x):
    """(lambda(x), dlambda(x)) from the fitted segments; matches the LUT to ~1e-6.

    Same clamping contract as lut_lookup: callers guard d <= -1 and mask d >= 1."""
    table = _poly_tables(x.device)
    x = torch.clamp(x, LUT_MIN, LUT_MAX - 1e-7)
    width = (LUT_MAX - LUT_MIN) / _POLY_SEGS
    fseg = div_const(x - LUT_MIN, width)
    seg = torch.clamp(torch.floor(fseg), 0, _POLY_SEGS - 1)
    t = (fseg - seg) * 2.0 - 1.0
    c = table[seg.long()]  # (..., K, 2)
    acc_l = c[..., 0, 0]
    acc_d = c[..., 0, 1]
    for k in range(1, _POLY_DEG + 1):
        acc_l = acc_l * t + c[..., k, 0]
        acc_d = acc_d * t + c[..., k, 1]
    return acc_l, acc_d
