"""Opt-in runtime verification: check_neighborhood and, on the list
backend, check_aii.

Counterpart of adaptive_sph_tpu/models/debug_checks.py.
`bruteforce_neighbor_count` is the neighbour count of every particle over
all particles, without any pair structure, for comparison with the tile
walk's COUNT sweep or the list backend's `sym_sum` count. Plain torch,
evaluated in blocks of rows so the dense pair mask never reaches (C, C).
`check_aii_deviation` holds the list backend's closed-form a_ii against the
divergence of the unit-pressure acceleration field.
"""

from __future__ import annotations

import torch

from ..ops import kernels
from ..ops.neighbors import Neighborhood
from ..ops.numerics import fma
from ..ops.pairwise import sym_sum
from ..utils.params import OperatorDiscretization, SimulationParams
from . import boundary as bnd


def check_aii_deviation(nb: Neighborhood, bt, position, mass, density, h, aii, alive,
                        params: SimulationParams):
    """() max over alive particles of |a_ii - div_i(a^(i))|, where a^(i) is
    the pressure acceleration of the unit pressure field p = delta_i; that
    field is nonzero only on i and its neighbours, so one extra field pass
    (S_a = sum_b m_b grad W_ab) and per-edge terms give every particle's
    ground truth at once."""
    def s_edge(vi, vj):
        gw = kernels.kernel_grad(vi["pos"] - vj["pos"], 0.5 * (vi["h"] + vj["h"]), dim=2)
        return vj["mass"][..., None] * gw

    S = sym_sum(nb, {"pos": position, "mass": mass, "h": h}, s_edge)
    od = params.operator_discretization
    # the boundary acceleration of i under its own unit pressure
    bacc_unit = bnd.boundary_pressure_accel(bt, position, h, torch.ones_like(mass), density,
                                            params)
    acc_self = -S / (density * density)[:, None] + bacc_unit

    # div at i: sum_j w_j (acc_j - acc_i) . grad W_ij + the boundary's, with
    # acc_j = (m_i / rho_i^2) grad W_ij for j != i
    def div_edge(vi, vj):
        gw = kernels.kernel_grad(vi["pos"] - vj["pos"], 0.5 * (vi["h"] + vj["h"]), dim=2)
        acc_j = (vi["mass"] / (vi["rho"] * vi["rho"]))[..., None] * gw
        acc_j = torch.where((vi["idx"] == vj["idx"])[..., None], vj["acc_self"], acc_j)
        d = torch.sum((acc_j - vi["acc_self"]) * gw, -1)
        if od == OperatorDiscretization.Winchenbach2020:
            return vj["mass"] / vj["rho"] * d
        return vj["mass"] * d

    vals = {"pos": position, "mass": mass, "rho": density, "h": h, "acc_self": acc_self,
            "idx": torch.arange(position.shape[0], device=position.device)}
    fluid_div = sym_sum(nb, vals, div_edge)
    if od != OperatorDiscretization.Winchenbach2020:
        fluid_div = fluid_div / density
    bdiv = bnd.boundary_divergence(bt, acc_self, torch.zeros(2, dtype=torch.float32,
                                                             device=position.device),
                                   position, h, density, params)
    dev = torch.where(alive, torch.abs(fluid_div + bdiv - aii), torch.zeros_like(aii))
    return torch.max(dev)


def list_neighbor_count(nb: Neighborhood, position, h_eff):
    """(C,) int32 pair count of the list structure through sym_sum, the
    count check_neighborhood holds against the brute-force one."""
    return sym_sum(nb, {"pos": position, "h": h_eff},
                   lambda vi, vj: torch.ones_like(vi["h"])).to(torch.int32)


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
