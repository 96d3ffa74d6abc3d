"""Per-step edge cache of the list backend: the geometry and kernel values of
every forward edge, computed once per neighbourhood.

Counterpart of adaptive_sph_tpu/ops/edge_cache.py. Within a step only the
pressure and the acceleration field change, so the Jacobi sweeps and the
other pair sums reuse the distances, W, grad W and the gathered masses (and,
once they exist, densities). A reversed edge reuses its forward entry:
grad W_ji = -grad W_ij, |x_ji| = |x_ij|, h_ij symmetric. `reduce_edges`
(ops/pairwise.py, importable from here as in the reference) sums the
contributions of both directions.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import kernels
from .neighbors import Neighborhood, r2
from .numerics import sqrt
from .pairwise import reduce_edges  # noqa: F401  (the reference's home of it)


@dataclasses.dataclass
class EdgeCache:
    diff: torch.Tensor  # (C, K, 2) x_i - x_j
    r: torch.Tensor  # (C, K)
    h_ij: torch.Tensor  # (C, K)
    w: torch.Tensor  # (C, K) W_ij
    grad: torch.Tensor  # (C, K, 2) grad_i W_ij
    mass_j: torch.Tensor  # (C, K)
    rho_j: Optional[torch.Tensor] = None  # (C, K), once the densities exist

    def replace(self, **kw) -> "EdgeCache":
        return dataclasses.replace(self, **kw)


def build_edge_cache(nb: Neighborhood, position, h, mass) -> EdgeCache:
    diff = position[:, None, :] - position[nb.idx]
    r = sqrt(r2(diff) + 1e-30)
    h_ij = 0.5 * (h[:, None] + h[nb.idx])
    return EdgeCache(diff=diff, r=r, h_ij=h_ij, w=kernels.kernel_w(r, h_ij, dim=2),
                     grad=kernels.kernel_grad(diff, h_ij, dim=2), mass_j=mass[nb.idx])


def with_density(cache: EdgeCache, nb: Neighborhood, density) -> EdgeCache:
    return cache.replace(rho_j=density[nb.idx])

