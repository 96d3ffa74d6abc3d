"""Signed-distance-field geometry, vectorized over particle batches (torch).

Counterpart of adaptive_sph_tpu/ops/sdf.py: half-space planes with their exact
gradient, the box of four planes (AnalyticOverestimate), the closed polygon
with the pseudo-normal sign test and central finite-difference gradient
(AnalyticUnderestimate). Geometry is static per scene; `probe(x)` takes an
(N, 2) float32 tensor.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence

import numpy as np
import torch

from .numerics import sqrt


@dataclasses.dataclass(frozen=True)
class SdfPlane:
    """Half space: probe(x) = dot(dir, x) + delta (negative inside the solid)."""

    direction: tuple  # (D,)
    delta: float

    def probe(self, x):
        # elementwise dot (no BLAS call); exact for the axis-aligned box planes
        d = [float(v) for v in np.asarray(self.direction, dtype=np.float32)]
        dot = x[..., 0] * d[0]
        for k in range(1, len(d)):
            dot = dot + x[..., k] * d[k]
        return dot + float(np.float32(self.delta))

    def gradient(self, x, eps: float):
        g = torch.empty_like(x)
        for k, v in enumerate(np.asarray(self.direction, dtype=np.float32)):
            g[..., k] = float(v)
        return g


def boundary_box_planes(box_min, box_max) -> list:
    """4 half-spaces enclosing [min, max] (corners counted once per plane)."""
    (minx, miny), (maxx, maxy) = box_min, box_max
    return [
        SdfPlane((1.0, 0.0), -minx),
        SdfPlane((-1.0, 0.0), maxx),
        SdfPlane((0.0, 1.0), -miny),
        SdfPlane((0.0, -1.0), maxy),
    ]


@dataclasses.dataclass(frozen=True)
class SdfPolygon2D:
    """Closed polygon; air on the left of each directed edge (i -> i+1 mod n)."""

    points: tuple

    def probe(self, x):
        """Exact signed distance; negative inside the solid (right side).

        The winner is the first strict minimum of the squared distance over
        [line_0, corner_0, line_1, corner_1, ...] (line candidates valid only
        when the projection falls strictly inside the segment)."""
        pts_t, ld, ll2, ln, pn = _polygon_geometry(
            tuple(tuple(float(c) for c in p) for p in self.points), x.device)
        x = torch.atleast_2d(x)
        pd = x[:, None, :] - pts_t[None, :, :]
        proj = torch.einsum("npd,pd->np", pd, ld)
        line_valid = (proj > 0.0) & (proj * proj < ll2[None, :])
        line_dist = torch.einsum("npd,pd->np", pd, ln)
        inf = torch.full_like(line_dist, float("inf"))
        line_key = torch.where(line_valid, line_dist * line_dist, inf)

        corner_key = torch.sum(pd * pd, dim=-1)
        sgn = torch.einsum("npd,pd->np", pd, pn) >= 0.0
        corner_dist = torch.where(sgn, 1.0, -1.0) * sqrt(corner_key)

        keys = torch.stack([line_key, corner_key], dim=-1).reshape(x.shape[0], -1)
        vals = torch.stack([line_dist, corner_dist], dim=-1).reshape(x.shape[0], -1)
        winner = torch.argmin(keys, dim=-1)  # first occurrence on ties
        return torch.take_along_dim(vals, winner[:, None], dim=-1)[:, 0]

    def gradient(self, x, eps: float):
        """Central finite differences; not normalized."""
        inv_2eps = 1.0 / (2.0 * eps)
        ex = torch.tensor([eps, 0.0], dtype=x.dtype, device=x.device)
        ey = torch.tensor([0.0, eps], dtype=x.dtype, device=x.device)
        gx = (self.probe(x + ex) - self.probe(x - ex)) * inv_2eps
        gy = (self.probe(x + ey) - self.probe(x - ey)) * inv_2eps
        return torch.stack([gx, gy], dim=-1)

    def draw_lines(self):
        """(start, end) vertex pairs of the closed outline, for rendering."""
        pts = np.asarray(self.points, dtype=np.float32)
        nxt = np.roll(pts, -1, axis=0)
        return list(zip(pts.tolist(), nxt.tolist()))


@functools.lru_cache(maxsize=None)
def _polygon_geometry(points: tuple, device: torch.device):
    """A polygon's float32 geometry on `device`: vertices, unit edge
    directions, squared edge lengths, left normals and the corners'
    pseudo-normals. Built once per polygon and device: a boundary update
    probes the polygon five times (the distance and the four finite
    differences of its gradient)."""
    pts = np.asarray(points, dtype=np.float32)  # (P, 2)
    nxt = np.roll(pts, -1, axis=0)
    line_dir = nxt - pts
    line_len = np.linalg.norm(line_dir, axis=-1)
    assert np.all(line_len > 1e-5)
    line_dir = line_dir / line_len[:, None]
    left = np.stack([-line_dir[:, 1], line_dir[:, 0]], axis=-1)
    prev_left = np.roll(left, 1, axis=0)
    pseudo_normal = prev_left + left
    assert np.all(np.sum(pseudo_normal**2, axis=-1) > 1e-5)
    return tuple(torch.as_tensor(np.asarray(a, np.float32), device=device)
                 for a in (pts, line_dir, line_len**2, left, pseudo_normal))


def boundary_box_polygon(box_min, box_max) -> SdfPolygon2D:
    """Single-polygon box; the 'AnalyticUnderestimate' decomposition."""
    (minx, miny), (maxx, maxy) = box_min, box_max
    return SdfPolygon2D(points=((minx, miny), (maxx, miny), (maxx, maxy), (minx, maxy)))


def probe_all(sdfs: Sequence, x):
    """Stack probes of every shape: (N, S)."""
    return torch.stack([s.probe(x) for s in sdfs], dim=-1)


def gradient_all(sdfs: Sequence, x, eps: float):
    """Stack (un-normalized) gradients of every shape: (N, S, 2)."""
    return torch.stack([s.gradient(x, eps) for s in sdfs], dim=-2)
