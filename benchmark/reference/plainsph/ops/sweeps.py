"""Generic pair sweeps over the sorted-tile layout: one reduction per query.

Counterpart of adaptive_sph_tpu/ops/pallas_sweeps.py (`PairCtx`, `SweepOp`,
`run_sweep`). A sweep visits every pair (i, j) of the tile walk with

    |x_i - x_j| < scale * h_ij,   h_ij = max((h_i + h_j) / 2, 1e-6),   h_i, h_j > 0

(self pairs included), plus the op's own mask, and reduces the op's n_out
per-pair values into (C, n_out) by sum or max (max starts from the op's fill).
Inputs: statics (C, 4) float32 sorted [x, y, h, mass] and dyn (C, D) float32
sorted channels, D <= 8, named by the op.

An op carries one definition for both routes: its CUDA op id and by-value
scalars (`SweepParams`) for the kernel in csrc/pair_sweep.cu, and a Python
`emit` for the plain version. `pair_sweep` runs the plain walk only for CPU
tensors; for CUDA tensors it launches the kernel or raises, and counts the
launch in `pair_ops.launches["pair_sweep"]`.

Every discrete decision (the radius mask, an op's mask, a comparison inside
emit) is taken on float32 values that the kernel computes with the same
operations in the same order, so kernel and plain version select the same
pairs and give the same counts and maxima. The squared distance is the one
fused multiply-add, fma(dx, dx, dy * dy), as the reference's sweep computes
it on the CPU (ops/numerics.py). The sweep-only step's ops
(models/tile_physics.py) also take the squared gradient norm, the dot
products and r^2 + c h^2 as FMAs and the gradient factor with one division
(`PairCtx.gmag1`), as the reference's compiled sweep rounds them; nothing
else is fused.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import _native
from .kernels import cubic_kernel_unnormalized, cubic_kernel_unnormalized_deriv, kernel_norm_factor
from .numerics import fma, sqrt
from .pair_ops import _check, _device_kind, _ptr, _stream, launches, walk_pairs
from .tiles import WM_STRIDE

NEG_BIG = -3.0e38
MAX_DYN = 8
MAX_OUT = 8

# op ids of the CUDA functors (csrc/pair_sweep.cu, enum SweepOpId)
OP_COUNT, OP_NORMAL, OP_CONE, OP_WAVEFRONT, OP_SMOOTH = 0, 1, 2, 3, 4
OP_ADAPT_CNT0, OP_ADAPT_CNT1, OP_ADAPT_EDGE = 5, 6, 7
OP_DENSITY = 8
OP_VISC_LAPLACE, OP_VISC_WCSPH, OP_OMEGA = 9, 10, 11
OP_H_W_SUM, OP_H_VW_SUM, OP_CONSTANT_FIELD = 12, 13, 14
OP_CONE_RANGE, OP_WAVEFRONT_RANGE, OP_CENTERDIFF = 15, 16, 17
OP_FRINGE_COUNT, OP_CHECK_AII, OP_CHECK_AII_W2020 = 18, 19, 20
OP_PREP_LAPLACE, OP_PREP_WCSPH, OP_PREP_XSPH, OP_AII_SUMS = 21, 22, 23, 24
OP_ACCEL, OP_DIV, OP_DIV_W2020 = 25, 26, 27
# the ops whose launches pair_ops.launches also counts by mode
_MODE_KEYS = {OP_VISC_LAPLACE: "pair_sweep:visc", OP_VISC_WCSPH: "pair_sweep:visc",
              OP_OMEGA: "pair_sweep:omega", OP_H_W_SUM: "pair_sweep:h_w_sum",
              OP_H_VW_SUM: "pair_sweep:h_vw_sum", OP_CONSTANT_FIELD: "pair_sweep:constant_field",
              OP_CONE_RANGE: "pair_sweep:cone_range",
              OP_WAVEFRONT_RANGE: "pair_sweep:wavefront_range",
              OP_CENTERDIFF: "pair_sweep:centerdiff", OP_FRINGE_COUNT: "pair_sweep:fringe_count",
              OP_CHECK_AII: "pair_sweep:check_aii",
              OP_CHECK_AII_W2020: "pair_sweep:check_aii_w2020",
              OP_PREP_LAPLACE: "pair_sweep:prep", OP_PREP_WCSPH: "pair_sweep:prep",
              OP_PREP_XSPH: "pair_sweep:prep", OP_AII_SUMS: "pair_sweep:aii_sums",
              OP_ACCEL: "pair_sweep:accel", OP_DIV: "pair_sweep:div",
              OP_DIV_W2020: "pair_sweep:div"}
# dyn channels each functor reads
OP_DYN = {OP_COUNT: 0, OP_NORMAL: 0, OP_CONE: 2, OP_WAVEFRONT: 2, OP_SMOOTH: 4,
          OP_ADAPT_CNT0: 5, OP_ADAPT_CNT1: 6, OP_ADAPT_EDGE: 7, OP_DENSITY: 0,
          OP_VISC_LAPLACE: 3, OP_VISC_WCSPH: 3, OP_OMEGA: 0, OP_H_W_SUM: 0, OP_H_VW_SUM: 0,
          OP_CONSTANT_FIELD: 1, OP_CONE_RANGE: 2, OP_WAVEFRONT_RANGE: 2, OP_CENTERDIFF: 0,
          OP_FRINGE_COUNT: 1, OP_CHECK_AII: 3, OP_CHECK_AII_W2020: 3, OP_PREP_LAPLACE: 3,
          OP_PREP_WCSPH: 3, OP_PREP_XSPH: 3, OP_AII_SUMS: 1, OP_ACCEL: 2, OP_DIV: 3,
          OP_DIV_W2020: 3}


class PairCtx:
    """Per-pair geometry of the tested pairs, with lazily computed kernel terms
    in the reference's operation order. Every field is a 1-D float32 tensor
    over the pairs."""

    def __init__(self, dx, dy, r2, h_ij):
        self.dx, self.dy, self.r2, self.h_ij = dx, dy, r2, h_ij
        self._r = self._w = self._gmag = None

    @property
    def r(self):
        if self._r is None:
            self._r = sqrt(torch.clamp(self.r2, min=1e-30))
        return self._r

    @property
    def w(self):
        """W(r, h_ij), the 2D cubic spline."""
        if self._w is None:
            self._w = kernel_norm_factor(self.h_ij, 2) * cubic_kernel_unnormalized(
                self.r / (2.0 * self.h_ij))
        return self._w

    @property
    def gmag(self):
        """grad W = gmag * (dx, dy); zero for q <= 1e-5."""
        if self._gmag is None:
            two_h = 2.0 * self.h_ij
            q = self.r / two_h
            mag = kernel_norm_factor(self.h_ij, 2) * cubic_kernel_unnormalized_deriv(q) / two_h
            self._gmag = torch.where(q > 1.0e-5, mag / self.r, torch.zeros_like(q))
        return self._gmag

    @property
    def gmag1(self):
        """gmag as the reference's compiled sweep rounds it: XLA's simplifier
        turns (norm W'(q) / 2h) / r into norm W'(q) / (2h r), one division.
        The sweep-only step's ops take it; the older ops keep `gmag`, the
        rounding their fixtures and long runs were built on."""
        two_h = 2.0 * self.h_ij
        q = self.r / two_h
        num = kernel_norm_factor(self.h_ij, 2) * cubic_kernel_unnormalized_deriv(q)
        return torch.where(q > 1.0e-5, num / (two_h * self.r), torch.zeros_like(q))

    @property
    def gx(self):
        return self.gmag * self.dx

    @property
    def gy(self):
        return self.gmag * self.dy


@dataclasses.dataclass(frozen=True)
class SweepOp:
    """A pair sweep: emit(q, c, ctx) returns n_out per-pair values.

    q and c map a channel name to the query's and the candidate's value per
    pair: statics x, y, h, mass always, then dyn_names in column order.
    reduce: "sum" or "max" (from `fill`). mask_fn(q, c, ctx) -> bool, an extra
    pair mask. op_id and params select and configure the CUDA functor."""

    name: str
    op_id: int
    n_out: int
    emit: Callable
    dyn_names: tuple = ()
    reduce: str = "sum"
    fill: float = 0.0
    mask_fn: Optional[Callable] = None
    params: dict = dataclasses.field(default_factory=dict)

    def native_params(self) -> _native.SweepParams:
        p = self.params
        return _native.SweepParams(
            float(p.get("inv_rest", 1.0)), float(p.get("cone_thr", 0.0)),
            float(p.get("max_dist", 0.0)), float(p.get("mass_base", 0.0)),
            int(p.get("merge", 0)), int(p.get("allow_optimal", 0)),
            int(p.get("allow_size_difference", 0)), int(p.get("allow_too_small", 0)),
            float(p.get("visc", 0.0)), float(p.get("max_range", 0.0)),
            float(p.get("inv_pi", 0.0)))


def _as_dyn(dyn, C, dev):
    if dyn is None:
        return torch.zeros(C, 0, dtype=torch.float32, device=dev)
    return dyn[:, None] if dyn.ndim == 1 else dyn


def pair_sweep_ref(cell_starts, wm, statics, dyn, op: SweepOp, scale: float, tq: int):
    """Plain version: the tested pairs of `pair_ops.walk_pairs`, masked, emitted
    and reduced with index_add_ (sum) or scatter_reduce_ amax (max). A row's
    values are added in the kernel's walk order."""
    C = statics.shape[0]
    dev = statics.device
    dyn = _as_dyn(dyn, C, dev)
    f32 = np.float32
    scale32 = float(f32(scale))
    out = torch.full((C, op.n_out), 0.0 if op.reduce == "sum" else op.fill,
                     dtype=torch.float32, device=dev)
    for qi, cj in walk_pairs(cell_starts, wm, statics[:, 2] > 0.0, tq):
        sq, sc = statics[qi], statics[cj]
        h_ij = torch.clamp(0.5 * (sq[:, 2] + sc[:, 2]), min=1e-6)
        dx = sq[:, 0] - sc[:, 0]
        dy = sq[:, 1] - sc[:, 1]
        r2 = fma(dx, dx, dy * dy)
        rad = scale32 * h_ij
        valid = (r2 < rad * rad) & (sc[:, 2] > 0.0)
        q = {"x": sq[:, 0], "y": sq[:, 1], "h": sq[:, 2], "mass": sq[:, 3]}
        c = {"x": sc[:, 0], "y": sc[:, 1], "h": sc[:, 2], "mass": sc[:, 3]}
        if op.dyn_names:
            dq, dc = dyn[qi], dyn[cj]
            for k, name in enumerate(op.dyn_names):
                q[name], c[name] = dq[:, k], dc[:, k]
        if op.mask_fn is not None:
            valid = valid & op.mask_fn(q, c, PairCtx(dx, dy, r2, h_ij))
        keep = torch.nonzero(valid).reshape(-1)
        if keep.numel() == 0:
            continue
        q = {k: v[keep] for k, v in q.items()}
        c = {k: v[keep] for k, v in c.items()}
        ctx = PairCtx(dx[keep], dy[keep], r2[keep], h_ij[keep])
        rows = qi[keep]
        for k, e in enumerate(op.emit(q, c, ctx)):
            if op.reduce == "sum":
                out[:, k].index_add_(0, rows, e)
            else:
                out[:, k].scatter_reduce_(0, rows, e, "amax", include_self=True)
    return out


def pair_sweep(cell_starts, wm, statics, dyn, op: SweepOp, scale: float, tq: int):
    """One pair sweep over the tile layout; (C, n_out) float32 in sorted order.

    cell_starts: (cells+1,) int32; wm: (NT*NL*WM_STRIDE,) int32 window meta;
    statics: (C, 4) float32 [x, y, h, mass]; dyn: (C, D) float32, (C,) or None.
    """
    if op.n_out > MAX_OUT or len(op.dyn_names) > MAX_DYN:
        raise ValueError(f"{op.name}: at most {MAX_OUT} outputs and {MAX_DYN} dyn channels")
    if _device_kind(statics) == "cpu":
        return pair_sweep_ref(cell_starts, wm, statics, dyn, op, scale, tq)
    dev = statics.device
    C = statics.shape[0]
    if C % tq:
        raise ValueError(f"capacity {C} is not a multiple of tq={tq}")
    NT = C // tq
    if wm.numel() % (NT * WM_STRIDE):
        raise ValueError(f"window meta of {wm.numel()} entries does not fit {NT} tiles")
    NL = wm.numel() // (NT * WM_STRIDE)
    D = OP_DYN.get(op.op_id)
    if D is None or D != len(op.dyn_names):
        raise ValueError(f"{op.name}: CUDA op {op.op_id} reads {D} dyn channels, the op "
                         f"names {len(op.dyn_names)}")
    dyn = _as_dyn(dyn, C, dev)
    _check(statics, "statics", torch.float32, (C, 4), dev)
    _check(dyn, "dyn", torch.float32, (C, D), dev)
    _check(cell_starts, "cell_starts", torch.int32, device=dev)
    _check(wm, "wm", torch.int32, device=dev)
    out = torch.empty(C, op.n_out, dtype=torch.float32, device=dev)
    _native.check(_native.load().asph_pair_sweep(
        op.op_id, _ptr(cell_starts), _ptr(wm), NT, NL, tq, _ptr(statics),
        _ptr(dyn) if D else None, D, float(scale), op.native_params(), _ptr(out), op.n_out,
        _stream(dev)), f"pair_sweep {op.name}")
    launches["pair_sweep"] += 1
    mode = _MODE_KEYS.get(op.op_id)
    if mode:
        launches[mode] += 1
    return out
