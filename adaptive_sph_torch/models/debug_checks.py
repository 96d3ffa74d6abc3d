"""Opt-in verification of the pair walk (check_neighborhood).

Counterpart of `bruteforce_neighbor_count` in
adaptive_sph_tpu/models/debug_checks.py: the neighbour count of every
particle over all particles, without the tile layout, for comparison with
the walk's COUNT sweep. Plain torch, evaluated in blocks of rows so the
dense pair mask never reaches (C, C).
"""

from __future__ import annotations

import torch

from ..ops.numerics import fma


def bruteforce_neighbor_count(position, h_eff, alive, scale: float, block: int = 1 << 24):
    """(C,) int32 counts of |x_ij| < scale (h_i + h_j) / 2 over live j, self
    included; 0 for dead rows. r^2 = fma(dx, dx, dy dy), as the walk's mask
    computes it, so a count differs from the walk's only if the walk missed
    or invented a pair. Rows go in blocks of at most `block` pairs."""
    C = position.shape[0]
    chunk = max(1, block // max(C, 1))
    h = torch.where(alive, h_eff, torch.zeros_like(h_eff))
    x, y = position[:, 0], position[:, 1]
    out = torch.empty(C, dtype=torch.int32, device=position.device)
    for a in range(0, C, chunk):
        b = min(a + chunk, C)
        dx = x[a:b, None] - x[None, :]
        dy = y[a:b, None] - y[None, :]
        rad = scale * (0.5 * (h[a:b, None] + h[None, :]))
        m = (fma(dx, dx, dy * dy) < rad * rad) & (h[None, :] > 0.0) & (h[a:b, None] > 0.0)
        out[a:b] = m.sum(dim=1).to(torch.int32)
    return out
