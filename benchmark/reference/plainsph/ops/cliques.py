"""The clique operator: same-level pair sums as dense batched products per patch.

Counterpart of adaptive_sph_tpu/ops/cliques.py, on the patch-major layout of
ops/tiles.py (TileConfig.patch > 0, taken under ASPH_CLIQUE). Every occupied
patch owns PATCH_SLOTS sorted slots, and `tiles.build_halo` lists up to
PATCH_SLOTS same-level ring particles of it, so a patch's whole same-level
candidate set is [own 128 slots | 128 halo slots]:

- `clique_build`, one vectorised pair pass over all patches, gives the
  same-level pair weights w_ij = m_j grad W_ij as two dense blocks wx, wy of
  shape (C / 128, 256, 128), stored as float32 or bfloat16, with the a_ii
  gradient sums and the density's fluid sum;
- `clique_visc` gives the same-level viscosity sums (ApproxLaplace or WCSPH)
  once the density exists;
- `CliqueOperator` applies the blocks in each Jacobi sweep as batched
  products (the reference's einsum bsl,bs->bl) after one halo row gather per
  operand, in float32 whatever the storage.

The cross-level pairs are not converted into blocks (the reference's
`cross_pack` packs its TPU block format): they are the PairCSR list that K1
(pair_ops.pair_build) walks over the cross_only window ranges, and their
share of each product is K2 (pair_matvec) on that list.

Like the reference's, this is array code, not a hand kernel: the products
are torch.bmm and the pair pass elementwise torch. The per-pair terms are
rounded as XLA's CPU backend compiles the reference's, bit for bit (probed
pair by pair with scripts/torch_port_clique_roundings.py): r^2, |w|^2, the
viscosity's x_ij . v_ij and r^2 + c h^2 as fused multiply-adds, the
gradient factor as norm W'(q) / (2h r), ApproxLaplace's two divisions as
one and WCSPH's 2 nu c folded in float32. The sums over the 256 candidates
are not in its order.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import pair_ops
from .kernels import cubic_kernel_unnormalized, cubic_kernel_unnormalized_deriv, kernel_norm_factor
from .numerics import fma, rdiv, sqrt
from .tiles import PATCH_SLOTS

PS = PATCH_SLOTS


def halo_rows(halo_src, table):
    """Row s of the result is the sorted table's row halo_src[s] (patch s //
    128's halo entry s % 128), zeros where the entry is absent."""
    C = table.shape[0]
    out = table[torch.clamp(halo_src, max=C - 1).long()]
    return torch.where((halo_src < C)[:, None], out, torch.zeros_like(out))


def _cand(halo_src, cols):
    """Candidate values (NB, 256) [own | halo] of each (C,) column."""
    C = cols[0].shape[0]
    NB = C // PS
    tab = torch.stack([c.to(torch.float32) for c in cols], dim=1)
    hal = halo_rows(halo_src, tab)
    return [torch.cat([tab[:, k].reshape(NB, PS), hal[:, k].reshape(NB, PS)], dim=1)
            for k in range(len(cols))]


def _bmm(w, v):
    """sum_s w[b, s, l] v[b, s]: (NB, 256, 128) x (NB, 256) -> (C,), float32."""
    return torch.bmm(v[:, None, :], w.float()).reshape(-1)


@dataclasses.dataclass
class CliqueOperator:
    """Same-level blocks, and the cross-level pair list (None with one level)."""

    wx: torch.Tensor  # (NB, 256, 128) float32 or bfloat16
    wy: torch.Tensor
    halo_src: torch.Tensor  # (C,) int32, tiles.build_halo
    cross: Optional[pair_ops.PairCSR] = None

    def matvec2(self, u):
        """(sum_j wx_ij u_j, sum_j wy_ij u_j) for u (C,)."""
        (uc,) = _cand(self.halo_src, [u])
        mvx, mvy = _bmm(self.wx, uc), _bmm(self.wy, uc)
        if self.cross is not None:
            cx, cy = pair_ops.pair_matvec(self.cross, u, k_out=2)
            mvx, mvy = mvx + cx, mvy + cy
        return mvx, mvy

    def matvec_div(self, tx, ty):
        """sum_j (wx_ij tx_j + wy_ij ty_j)."""
        txc, tyc = _cand(self.halo_src, [tx, ty])
        s = _bmm(self.wx, txc) + _bmm(self.wy, tyc)
        if self.cross is not None:
            s = s + pair_ops.pair_matvec(self.cross, (tx, ty), k_out=1)
        return s


def _pair_terms(halo_src, st, scale):
    """The geometry of one clique pair pass: query columns (NB, 1, 128),
    candidate columns (NB, 256, 1), their (NB, 256, 128) pair terms."""
    C = st.shape[0]
    NB = C // PS
    hal = halo_rows(halo_src, st[:, 0:4])

    def q_(col):
        return st[:, col].reshape(NB, 1, PS)

    def c_(col):
        return torch.cat([st[:, col].reshape(NB, PS), hal[:, col].reshape(NB, PS)],
                         dim=1).reshape(NB, 2 * PS, 1)

    qh, ch = q_(2), c_(2)
    h_ij = torch.clamp(0.5 * (qh + ch), min=1e-6)
    dx = q_(0) - c_(0)
    dy = q_(1) - c_(1)
    r2 = fma(dx, dx, dy * dy)
    rad = float(np.float32(scale)) * h_ij
    valid = (r2 < rad * rad) & (ch > 0.0) & (qh > 0.0)
    return dict(dx=dx, dy=dy, r2=r2, h_ij=h_ij, valid=valid, cm=c_(3), C=C, NB=NB)


def _w_and_gmag(r2, h_ij):
    """W and the gradient factor |grad W| / r of each pair. The reference's
    (norm W'(q) / 2h) / r compiles to one division, norm W'(q) / (2h r)."""
    r = sqrt(torch.clamp(r2, min=1e-30))
    two_h = 2.0 * h_ij
    q = r / two_h
    norm = kernel_norm_factor(h_ij, 2)
    w = norm * cubic_kernel_unnormalized(q)
    gmag = (norm * cubic_kernel_unnormalized_deriv(q)) / (two_h * r)
    return w, torch.where(q > 1.0e-5, gmag, torch.zeros_like(r))


def clique_build(halo_src, st, scale: float, wdtype=torch.float32):
    """One pair pass over all patches: (wx, wy, s1x, s1y, s1sq, den), the
    same-level blocks (NB, 256, 128) in wdtype and the float32 sums (C,) in
    sorted-slot order: sum w, sum |w|^2 / m_j, sum m_j W_ij.

    st: the sorted statics (C, >= 4) [x, y, h, m]; halo_src from build_halo."""
    g = _pair_terms(halo_src, st, scale)
    w_val, gmag = _w_and_gmag(g["r2"], g["h_ij"])
    zero = torch.zeros_like(w_val)
    den_t = torch.where(g["valid"], g["cm"] * w_val, zero)
    gg = torch.where(g["valid"], g["cm"] * gmag, zero)
    wx = gg * g["dx"]
    wy = gg * g["dy"]
    inv_m = rdiv(1.0, torch.clamp(g["cm"], min=1e-30))
    t2 = fma(wx, wx, wy * wy) * inv_m
    C = g["C"]
    return (wx.to(wdtype), wy.to(wdtype), wx.sum(1).reshape(C), wy.sum(1).reshape(C),
            t2.sum(1).reshape(C), den_t.sum(1).reshape(C))


def clique_visc(halo_src, st, vx, vy, rho, scale: float, visc_mode: str, viscosity: float):
    """Same-level viscosity accelerations (ax, ay), (C,) float32 in sorted
    order: visc_mode "wcsph" or "laplace" (ApproxLaplace), the density rho
    of this step."""
    g = _pair_terms(halo_src, st, scale)
    NB, C = g["NB"], g["C"]
    cvx, cvy, crho = (c.reshape(NB, 2 * PS, 1) for c in _cand(halo_src, [vx, vy, rho]))
    dvx = vx.reshape(NB, 1, PS) - cvx
    dvy = vy.reshape(NB, 1, PS) - cvy
    qrho = rho.reshape(NB, 1, PS)
    dot = fma(g["dx"], dvx, g["dy"] * dvy)
    h_ij, r2 = g["h_ij"], g["r2"]
    zero = torch.zeros_like(r2)
    gg = torch.where(g["valid"], g["cm"] * _w_and_gmag(r2, h_ij)[1], zero)
    nu = np.float32(viscosity)
    if visc_mode == "wcsph":
        # 2 nu c folded in float32; -pi_ab
        vt = float(np.float32(2.0 * nu) * np.float32(88.0)) * h_ij / torch.clamp(qrho + crho,
                                                                                  min=1e-30)
        coef = vt * dot / fma(0.001 * h_ij, h_ij, r2)
    elif visc_mode == "laplace":
        # nu 2 (d + 2) dot / (r^2 + 0.01 h^2) / rho_ij, the two divisions as one
        rho_ij = torch.clamp((qrho + crho) * 0.5, min=1e-30)
        coef = float(nu) * (8.0 * dot / (fma(0.01 * h_ij, h_ij, r2) * rho_ij))
    else:
        raise ValueError(f"visc_mode {visc_mode!r}: 'wcsph' or 'laplace'")
    coef = torch.where(dot < 0.0, coef, zero)
    return ((coef * gg * g["dx"]).sum(1).reshape(C), (coef * gg * g["dy"]).sum(1).reshape(C))
