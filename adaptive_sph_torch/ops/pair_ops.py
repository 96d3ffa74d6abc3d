"""The step's pair operator: a CSR pair list built once per step, streamed per sweep.

Within one step the geometry is frozen, so the pair weights w_ij = m_j grad
W_ij (the only pair term of both Jacobi sweeps) and the rho-free viscosity
pair factors are computed once by `pair_build` and read back by `pair_matvec`
and `pair_visc` (and by the whole-solve kernels of ops/jacobi.py):

  accel_i = -(p_i/rho_i^2) S1_i - sum_j w_ij u_j + boundary,   u_j = p_j/rho_j^2
  div_i   = (sum_j w_ij . t_j - t_i . S1_i) / rho_i + boundary

Layout: per query row (sorted slot) a compact list of its pairs in ascending
candidate slot, row_ptr (C+1,) int32, col (P,) int32, w and s (2, P) in
float32 or bfloat16. The reference's TPU block format (64-candidate windows,
~2% valid) is a Mosaic workaround and is not reproduced; the pair set, the
weights and the sums are.

Scalar-g storage (`pair_build(..., scalar=True)`, the reference's v7 scalar
blocks, taken under ASPH_SCALAR_BLOCKS=1): the list stores g = m_j |grad
W_ij| / r (P,) and sg = B g (P,) instead of w and s, and keeps the table it
was walked from; `pair_matvec_scalar` and `pair_visc_scalar` rebuild
wx = g (x_i - x_j), wy = g (y_i - y_j) per pair, in float32 exactly K1's
stored w. `pair_weights` is the weights-only walk (the reference's
build_weight_cache): w in float32, no prep sums; only the timing module
calls it.

The viscosity pair factors are ApproxLaplace's, or WCSPH's (`pair_build(...,
wcsph=True)`): the stream factor B = 2 nu c h_ij (x_ij . v_ij) / (r^2 +
0.001 h_ij^2) on attracting pairs (c = SPEED_OF_SOUND), and in the classic
mode the inline -pi_ab over max(rho_i + rho_j, 1e-30).

Each operation has a CUDA kernel (csrc/pair_ops.cu, built by ops/_native.py)
and a plain PyTorch twin (`*_ref`). The wrapper runs the twin only for CPU
tensors; for CUDA tensors it launches the kernel or raises. `launches` counts
kernel launches per wrapper.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import spans
from . import _native
from .kernels import PI, cubic_kernel_unnormalized, cubic_kernel_unnormalized_deriv
from .numerics import fma, rdiv, sqrt
from .tiles import RL, WM_STRIDE

# pair storage types the kernels read (f32 accumulation either way)
STORAGE_DTYPES = (torch.float32, torch.bfloat16)
# tested pairs per chunk of the CPU twin's walk (bounds its memory)
_CHUNK_PAIRS = 1 << 21

# kernel launches per wrapper, pair_sweep (ops/sweeps.py), the whole-solve
# kernels (ops/jacobi.py) and the probe kernels (ops/probes.py) included; the
# CPU twins do not count. "kernel:mode" keys count the launches of a kernel
# in one of its modes as well (K1 with the WCSPH viscosity, the viscosity and
# Omega sweeps, the Winchenbach2020 solves, and the sweeps of the distribution
# h, the diagnostic fields, the range-limited levels, CenterDiff, the
# neighbourhood constraint and check_aii, and the sweep-only step's prep,
# aii_sums, accel and div sweeps)
MODE_KEYS = ("pair_build:wcsph", "pair_sweep:visc", "pair_sweep:omega", "pair_jacobi:w2020",
             "pair_hybrid:w2020", "pair_sweep:h_w_sum", "pair_sweep:h_vw_sum",
             "pair_sweep:constant_field", "pair_sweep:cone_range", "pair_sweep:wavefront_range",
             "pair_sweep:centerdiff", "pair_sweep:fringe_count", "pair_sweep:check_aii",
             "pair_sweep:check_aii_w2020", "pair_sweep:prep", "pair_sweep:aii_sums",
             "pair_sweep:accel", "pair_sweep:div")
launches = {"pair_build": 0, "pair_matvec": 0, "pair_visc": 0, "pair_sweep": 0,
            "pair_jacobi": 0, "pair_hybrid": 0, "pair_weights": 0, "pair_matvec_scalar": 0,
            "pair_visc_scalar": 0, "block_sweep": 0, "window_sum": 0, "pair_stream": 0,
            "pair_matvec_probe": 0, "pair_matvec_scalar_probe": 0, **{k: 0 for k in MODE_KEYS}}


def reset_launches():
    for k in launches:
        launches[k] = 0


@dataclasses.dataclass
class PairCSR:
    """One step's pair list and its row sums.

    row_ptr : (C+1,) int32; row i's pairs are [row_ptr[i], row_ptr[i+1])
    col     : (P,) int32 candidate slot j, ascending within a row
    w       : (2, P) m_j grad W_ij, x row then y row (None: scalar storage)
    s       : (2, P) viscosity pair factors B_ij * w_ij (mega mode with
              viscosity and two-row storage; else None)
    prep    : float32 row sums. Mega mode (4, C): sum wx, sum wy,
              sum |w|^2 / m_j, sum m_j W_ij. Classic mode (8, C): the first
              three, the same three over w / rho_j (s2x, s2y, s2sq), and the
              ApproxLaplace viscosity acceleration (visc_x, visc_y).
              None for the weights-only walk
    g, sg   : scalar storage: (P,) m_j |grad W_ij| / r_ij and B_ij g_ij (sg
              None without viscosity)
    table   : scalar storage: the (C, F) float32 table the list was walked
              from; columns 0 and 1 are the sorted x and y
    """

    row_ptr: torch.Tensor
    col: torch.Tensor
    w: Optional[torch.Tensor]
    s: Optional[torch.Tensor]
    prep: Optional[torch.Tensor]
    g: Optional[torch.Tensor] = None
    sg: Optional[torch.Tensor] = None
    table: Optional[torch.Tensor] = None

    @property
    def num_pairs(self) -> int:
        return self.col.shape[0]

    @property
    def scalar(self) -> bool:
        return self.g is not None


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type in ("cpu", "cuda"):
        return t.device.type
    raise RuntimeError(f"pair_ops: unsupported device {t.device}")


def _check(t, name, dtype, shape=None, device=None):
    """dtype: one dtype or a tuple of the accepted ones."""
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _ptr(t):
    return t.data_ptr() if t is not None else None


# ---------------------------------------------------------------------------
# K1: the pair walk


def _w_and_gmag(r2, h_ij):
    """Kernel value W and gradient magnitude factor, sharing the norm and q terms."""
    r = sqrt(torch.clamp(r2, min=1e-30))
    two_h = 2.0 * h_ij
    q = r / two_h
    norm = rdiv(10.0, (7.0 * PI) * (h_ij * h_ij))
    w = norm * cubic_kernel_unnormalized(q)
    mag = norm * cubic_kernel_unnormalized_deriv(q) / two_h
    return w, torch.where(q > 1.0e-5, mag / r, torch.zeros_like(r))


def _pair_terms(flat, qi, cj, scale, viscosity, visc, classic, wcsph=False):
    """Mask and per-pair terms for query slots qi against candidate slots cj.
    flat: [x, y, h, m, vx, vy], or [x, y, h, m, rho, vx, vy] when classic.
    wcsph: the WCSPH viscosity instead of ApproxLaplace (module docstring)."""
    q = flat[qi]
    c = flat[cj]
    qh, ch = q[:, 2], c[:, 2]
    h_ij = torch.clamp(0.5 * (qh + ch), min=1e-6)
    dx = q[:, 0] - c[:, 0]
    dy = q[:, 1] - c[:, 1]
    r2 = fma(dx, dx, dy * dy)  # one rounding, as XLA's CPU backend contracts it
    rad = scale * h_ij
    valid = (r2 < rad * rad) & (ch > 0.0) & (qh > 0.0)
    qi, cj, q, c = qi[valid], cj[valid], q[valid], c[valid]
    h_ij, dx, dy, r2, cm = h_ij[valid], dx[valid], dy[valid], r2[valid], c[:, 3]
    w_val, gmag = _w_and_gmag(r2, h_ij)
    g = cm * gmag
    wx = g * dx
    wy = g * dy
    t2 = (wx * wx + wy * wy) * rdiv(1.0, torch.clamp(cm, min=1e-30))
    terms = {"wx": wx, "wy": wy, "t2": t2}
    vx = 5 if classic else 4
    if classic or visc:
        dvx = q[:, vx] - c[:, vx]
        dvy = q[:, vx + 1] - c[:, vx + 1]
        dot = dx * dvx + dy * dvy
        attract = dot < 0.0
    terms["g"] = g
    if classic:
        inv_rho = rdiv(1.0, torch.clamp(c[:, 4], min=1e-30))
        terms.update(s2x=wx * inv_rho, s2y=wy * inv_rho, s2sq=t2 * inv_rho)
        if wcsph:
            # WCSPH inline: -pi_ab = 2 nu h_ij c dot / max(rho_i + rho_j) / (r2 + 0.001 h^2)
            vt = (wcsph_coef(viscosity, classic) * h_ij * SPEED_OF_SOUND
                  / torch.clamp(q[:, 4] + c[:, 4], min=1e-30))
            coef = -(-vt * dot / (r2 + 0.001 * h_ij * h_ij))
        else:
            # ApproxLaplace inline: nu 2(D+2) dot / (r2 + 0.01 h^2) / rho_ij
            rho_ij = torch.clamp((q[:, 4] + c[:, 4]) * 0.5, min=1e-30)
            coef = viscosity * (8.0 * dot / (r2 + 0.01 * h_ij * h_ij) / rho_ij)
        coef = torch.where(attract, coef, torch.zeros_like(coef))
        terms.update(vx=coef * wx, vy=coef * wy)
    else:
        terms["den"] = cm * w_val
        if visc:
            if wcsph:
                B = wcsph_coef(viscosity, classic) * h_ij * dot / (r2 + 0.001 * h_ij * h_ij)
            else:
                B = (2.0 * viscosity * 8.0) * dot / (r2 + 0.01 * h_ij * h_ij)
            B = torch.where(attract, B, torch.zeros_like(B))
            terms["sx"] = B * wx
            terms["sy"] = B * wy
            terms["sg"] = B * g
    return qi, cj, terms


def walk_pairs(cell_starts, wm, qvalid, tq: int, chunk_pairs: int = _CHUNK_PAIRS):
    """The tested (query, candidate) slot pairs of the tile walk, in chunks.

    Expands each tile's window ranges (wm) into candidate slots with
    repeat_interleave and crosses them with the tile's live queries (qvalid,
    (C,) bool). Yields (qi, cj) int64 pairs, about `chunk_pairs` per chunk, in
    the kernels' walk order: tile, level, range, candidate slot, query. Every
    query's candidates therefore come in the ascending slot order in which
    its kernel walk visits them."""
    dev = qvalid.device
    C = qvalid.shape[0]
    NT = C // tq
    NL = wm.numel() // (NT * WM_STRIDE)
    wm3 = wm.reshape(NT, NL, WM_STRIDE).long()
    cnt = wm3[:, :, 0]
    a = wm3[:, :, 1::2]  # (NT, NL, RL)
    b = wm3[:, :, 2::2]
    live = torch.arange(RL, device=dev)[None, None, :] < cnt[:, :, None]
    lo = cell_starts.long()[a]
    hi = cell_starts.long()[b]
    n = torch.where(live, torch.clamp(hi - lo, min=0), torch.zeros_like(lo)).reshape(-1)
    lo = lo.reshape(-1)
    tile = torch.arange(NT, device=dev)[:, None, None].expand(NT, NL, RL).reshape(-1)

    # candidates: every slot of every range, grouped by tile in walk order
    tot = int(n.sum())
    first = torch.cumsum(n, 0) - n
    cand = (torch.arange(tot, device=dev) - torch.repeat_interleave(first, n)
            + torch.repeat_interleave(lo, n))
    cand_tile = torch.repeat_interleave(tile, n)

    # each tile's live queries, ascending
    qv = qvalid.reshape(NT, tq)
    nvq = qv.sum(1)
    vq = torch.nonzero(qv.reshape(-1)).reshape(-1)
    vq_off = torch.cumsum(nvq, 0) - nvq

    reps = nvq[cand_tile]
    cum = torch.cumsum(reps, 0)
    start = 0
    while start < tot:
        base = int(cum[start - 1]) if start else 0
        stop = int(torch.searchsorted(cum, base + chunk_pairs, right=True))
        stop = max(stop, start + 1)
        ct, cs, rp = cand_tile[start:stop], cand[start:stop], reps[start:stop]
        npair = int(rp.sum())
        if npair:
            pc = torch.repeat_interleave(cs, rp)
            pt = torch.repeat_interleave(ct, rp)
            k = torch.arange(npair, device=dev) - torch.repeat_interleave(torch.cumsum(rp, 0) - rp, rp)
            yield vq[vq_off[pt] + k], pc
        start = stop


# the kernels' row split (csrc/tile_walk.cuh): WALK_PIECES warps per row; a
# row whose tile holds more than WALK_SPLIT_MIN candidates is cut into that
# many contiguous pieces of its candidate sequence, one per warp
WALK_PIECES = 2
WALK_SPLIT_MIN = 2048


def tile_candidates(cell_starts, wm, NT: int):
    """(NT,) int64: the candidates each query tile's window ranges hold."""
    w3 = wm.reshape(NT, -1, WM_STRIDE).long()
    live = torch.arange(RL, device=wm.device)[None, None, :] < w3[:, :, :1]
    cs = cell_starts.long()
    return torch.where(live, cs[w3[:, :, 2::2]] - cs[w3[:, :, 1::2]], 0).sum((1, 2))


def walk_plan(cell_starts, wm, NT: int):
    """The kernels' pieces of each tile's candidate sequence (its window
    ranges in walk order, concatenated): (NT, WALK_PIECES + 1) int64
    bounds, piece k is [b[k], b[k + 1]). A tile of at most WALK_SPLIT_MIN
    candidates has one piece, [0, n), walked by the row's first warp."""
    n = tile_candidates(cell_starts, wm, NT)[:, None]
    k = torch.arange(WALK_PIECES + 1, device=n.device)[None, :]
    whole = torch.where(k == 0, torch.zeros_like(n), n)
    return torch.where(n > WALK_SPLIT_MIN, n * k // WALK_PIECES, whole)


# prep rows of the two modes, in the reference's prep_op column order
PREP_MEGA = ("wx", "wy", "t2", "den")
PREP_CLASSIC = ("wx", "wy", "t2", "s2x", "s2y", "s2sq", "vx", "vy")
# build modes of csrc/pair_ops.cu (enum BuildMode)
_MODE_MEGA, _MODE_MEGA_VISC, _MODE_CLASSIC, _MODE_WEIGHTS = 0, 1, 2, 3
_MODE_MEGA_VISC_WCSPH, _MODE_CLASSIC_WCSPH = 4, 5
# the WCSPH viscosity's speed of sound
SPEED_OF_SOUND = 88.0


def wcsph_coef(viscosity: float, classic: bool) -> float:
    """The float32 factor the WCSPH pair term starts from, rounded as the
    reference rounds it: 2 nu (classic: then times h_ij, times c) or (2 nu) c
    (the mega walk's stream factor: then times h_ij)."""
    two_nu = np.float32(2.0) * np.float32(viscosity)
    return float(two_nu if classic else np.float32(two_nu * np.float32(SPEED_OF_SOUND)))


def scalar_blocks_supported(tq: int) -> bool:
    """The reference's gate of its scalar-g blocks (pallas_matvec.py:498), a
    TPU lane-width rule copied so the port stores scalars exactly when the
    reference does: query tiles of 128."""
    return tq == 128


def _check_mode(visc: bool, classic: bool, width: int, scalar: bool = False):
    if classic and visc:
        raise ValueError("pair_build: the classic mode has no viscosity stream")
    if classic and scalar:
        raise ValueError("pair_build: scalar-g storage exists in the mega mode only")
    want = 7 if classic else 6
    if width != want:
        raise ValueError(f"pair_build: the {'classic' if classic else 'mega'} mode takes a "
                         f"(C, {want}) candidate table, got {width} columns")


def _walk_ref(cell_starts, wm, flat, tq, scale, viscosity, visc, classic, names, wcsph=False):
    """The masked pairs of `walk_pairs` sorted by (row, col): (row_ptr, row,
    col, {name: per-pair term})."""
    dev = flat.device
    C = flat.shape[0]
    rows, cols, parts = [], [], []
    for pq, pc in walk_pairs(cell_starts, wm, flat[:, 2] > 0.0, tq):
        qi, cj, terms = _pair_terms(flat, pq, pc, scale, viscosity, visc, classic, wcsph)
        rows.append(qi)
        cols.append(cj)
        parts.append(terms)
    if rows:
        row = torch.cat(rows)
        col = torch.cat(cols)
        vals = {k: torch.cat([p[k] for p in parts]) for k in names}
    else:
        row = col = torch.zeros(0, dtype=torch.long, device=dev)
        vals = {k: torch.zeros(0, dtype=torch.float32, device=dev) for k in names}
    order = torch.argsort(row * C + col)
    row, col = row[order], col[order]
    vals = {k: v[order] for k, v in vals.items()}
    counts = torch.bincount(row, minlength=C)
    row_ptr = torch.zeros(C + 1, dtype=torch.int32, device=dev)
    row_ptr[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return row_ptr, row, col.to(torch.int32), vals


def pair_build_ref(cell_starts, wm, flat, tq: int, scale: float, viscosity: float,
                   visc: bool, wdtype=torch.float32, classic: bool = False,
                   scalar: bool = False, wcsph: bool = False) -> PairCSR:
    """Plain PyTorch twin of K1: the tested pairs of `walk_pairs`, masked and
    sorted by (row, col)."""
    _check_mode(visc, classic, flat.shape[1], scalar)
    C = flat.shape[0]
    prep_names = PREP_CLASSIC if classic else PREP_MEGA
    if scalar:
        names = prep_names + (("g", "sg") if visc else ("g",))
    else:
        names = prep_names + (("sx", "sy") if visc else ())
    row_ptr, row, col, vals = _walk_ref(cell_starts, wm, flat, tq, scale, viscosity, visc,
                                        classic, names, wcsph)
    prep = torch.zeros(len(prep_names), C, dtype=torch.float32, device=flat.device)
    for k, name in enumerate(prep_names):
        prep[k].index_add_(0, row, vals[name])
    if scalar:
        return PairCSR(row_ptr=row_ptr, col=col, w=None, s=None, prep=prep,
                       g=vals["g"].to(wdtype), sg=vals["sg"].to(wdtype) if visc else None,
                       table=flat)
    w = torch.stack([vals["wx"], vals["wy"]]).to(wdtype)
    s = torch.stack([vals["sx"], vals["sy"]]).to(wdtype) if visc else None
    return PairCSR(row_ptr=row_ptr, col=col, w=w, s=s, prep=prep)


def _tiles(cell_starts, wm, flat, tq: int):
    """(C, NT, NL) of a walk, after checking its operands."""
    dev = flat.device
    C = flat.shape[0]
    if C % tq:
        raise ValueError(f"capacity {C} is not a multiple of tq={tq}")
    NT = C // tq
    if wm.numel() % (NT * WM_STRIDE):
        raise ValueError(f"window meta of {wm.numel()} entries does not fit {NT} tiles")
    _check(flat, "flat", torch.float32, (C, flat.shape[1]))
    _check(cell_starts, "cell_starts", torch.int32, device=dev)
    _check(wm, "wm", torch.int32, device=dev)
    return C, NT, wm.numel() // (NT * WM_STRIDE)


def _count(cell_starts, wm, flat, tq, NT, NL, mode, scale):
    """K1's count pass and the row pointers; returns (row_ptr, P, pieces),
    pieces the per-piece pair counts of the rows the walk splits, which the
    fill pass reads."""
    dev = flat.device
    C = flat.shape[0]
    lib = _native.load()
    counts = torch.empty(C, dtype=torch.int32, device=dev)
    pieces = torch.empty(C * lib.asph_pair_pieces(), dtype=torch.int32, device=dev)
    _native.check(lib.asph_pair_count(_ptr(cell_starts), _ptr(wm), NT, NL, tq, _ptr(flat), mode,
                                      float(scale), _ptr(counts), _ptr(pieces), _stream(dev)),
                  "pair_build count")
    row_ptr = torch.zeros(C + 1, dtype=torch.int32, device=dev)
    torch.cumsum(counts, 0, dtype=torch.int32, out=row_ptr[1:])
    # the one host read of the walk: sizes the outputs exactly, so the pair
    # list cannot overflow (the reference's wcache_overflow is always 0 here)
    spans.reads["pair-count"] += 1
    return row_ptr, int(row_ptr[C]), pieces


def pair_build(cell_starts, wm, flat, tq: int, scale: float, viscosity: float,
               visc: bool, wdtype=torch.float32, classic: bool = False,
               scalar: bool = False, wcsph: bool = False) -> PairCSR:
    """K1: the step's one pair walk.

    cell_starts: (cells+1,) int32 CSR from build_tiles; wm: (NT*NL*WM_STRIDE,)
    int32 window meta; flat: sorted candidate table, (C, 6) float32 [x, y, h,
    m, vx, vy] in the mega mode, (C, 7) [x, y, h, m, rho, vx, vy] in the
    classic mode. Returns the CSR pair list with w = m_j grad W_ij, s =
    viscosity pair factors (mega mode with `visc`) stored as `wdtype`, and
    the float32 prep sums: 4 rows (mega) or 8 rows (classic; see PairCSR).
    scalar (mega mode): store g and sg = B g instead of w and s, and keep
    `flat` as the list's position table. wcsph: the viscosity (the classic
    mode's inline rows, the mega mode's stream factors) is WCSPH's instead of
    ApproxLaplace's.
    """
    _check_mode(visc, classic, flat.shape[1], scalar)
    if _device_kind(flat) == "cpu":
        return pair_build_ref(cell_starts, wm, flat, tq, scale, viscosity, visc, wdtype, classic,
                              scalar, wcsph)
    dev = flat.device
    C, NT, NL = _tiles(cell_starts, wm, flat, tq)
    if wdtype not in STORAGE_DTYPES:
        raise TypeError(f"pair storage dtype {wdtype} not supported")
    if classic and wcsph:
        mode, vcoef = _MODE_CLASSIC_WCSPH, wcsph_coef(viscosity, True)
    elif classic:
        mode, vcoef = _MODE_CLASSIC, float(viscosity)
    elif visc and wcsph:
        mode, vcoef = _MODE_MEGA_VISC_WCSPH, wcsph_coef(viscosity, False)
    elif visc:
        mode, vcoef = _MODE_MEGA_VISC, float(2.0 * viscosity * 8.0)
    else:
        mode, vcoef = _MODE_MEGA, 0.0
    row_ptr, P, pieces = _count(cell_starts, wm, flat, tq, NT, NL, mode, scale)
    col = torch.empty(P, dtype=torch.int32, device=dev)
    rows = () if scalar else (2,)
    w = torch.empty(*rows, P, dtype=wdtype, device=dev)
    s = torch.empty(*rows, P, dtype=wdtype, device=dev) if visc else None
    prep = torch.empty(len(PREP_CLASSIC if classic else PREP_MEGA), C, dtype=torch.float32,
                       device=dev)
    _native.check(_native.load().asph_pair_fill(
        _ptr(cell_starts), _ptr(wm), NT, NL, tq, _ptr(flat), mode, int(scalar), float(scale),
        vcoef, int(wdtype == torch.bfloat16), _ptr(pieces), _ptr(row_ptr), _ptr(col), _ptr(w),
        _ptr(s), P, _ptr(prep), _stream(dev)), "pair_build fill")
    launches["pair_build"] += 1
    if wcsph:
        launches["pair_build:wcsph"] += 1
    if scalar:
        return PairCSR(row_ptr=row_ptr, col=col, w=None, s=None, prep=prep, g=w, sg=s, table=flat)
    return PairCSR(row_ptr=row_ptr, col=col, w=w, s=s, prep=prep)


def _check_statics(statics):
    if statics.shape[1] != 4:
        raise ValueError(f"pair_weights: takes a (C, 4) table [x, y, h, m], got "
                         f"{statics.shape[1]} columns")


def pair_weights_ref(cell_starts, wm, statics, tq: int, scale: float) -> PairCSR:
    """Plain twin of K1's weights-only mode."""
    _check_statics(statics)
    row_ptr, _, col, vals = _walk_ref(cell_starts, wm, statics, tq, scale, 0.0, False, False,
                                      ("wx", "wy"))
    return PairCSR(row_ptr=row_ptr, col=col, w=torch.stack([vals["wx"], vals["wy"]]), s=None,
                   prep=None)


def pair_weights(cell_starts, wm, statics, tq: int, scale: float) -> PairCSR:
    """K1's weights-only mode, the reference's build_weight_cache: the pair
    list of the (C, 4) sorted table [x, y, h, m] with w = m_j grad W_ij in
    float32 (bit for bit mega mode's w) and no prep sums."""
    _check_statics(statics)
    if _device_kind(statics) == "cpu":
        return pair_weights_ref(cell_starts, wm, statics, tq, scale)
    dev = statics.device
    _, NT, NL = _tiles(cell_starts, wm, statics, tq)
    row_ptr, P, pieces = _count(cell_starts, wm, statics, tq, NT, NL, _MODE_WEIGHTS, scale)
    col = torch.empty(P, dtype=torch.int32, device=dev)
    w = torch.empty(2, P, dtype=torch.float32, device=dev)
    _native.check(_native.load().asph_pair_fill(
        _ptr(cell_starts), _ptr(wm), NT, NL, tq, _ptr(statics), _MODE_WEIGHTS, 0, float(scale),
        0.0, 0, _ptr(pieces), _ptr(row_ptr), _ptr(col), _ptr(w), None, P, None, _stream(dev)),
        "pair_weights fill")
    launches["pair_weights"] += 1
    return PairCSR(row_ptr=row_ptr, col=col, w=w, s=None, prep=None)


# ---------------------------------------------------------------------------
# K2 / K3: streams over the pair list

# the launch shapes of K2, K3 and their instances, as csrc/pair_ops.cu's
# asph_stream_shape reports them (chip_smoke.py phase 1 checks the two
# agree): STREAM_K pairs' loads in flight per lane, and per shape (G lanes
# per CSR row, threads per block, most blocks per SM): SmallList, for lists
# that one wave of it covers, then LargeList. A block walks chunks of 32 / G
# rows, THREADS / G rows at a time, its own group first, then every grid-th
# one after it.
STREAM_K = 4
STREAM_SHAPES = ((8, 256, 8), (4, 512, 4))


def stream_launch(C: int, sms: int) -> tuple:
    """(shape, grid) of a K2 / K3 launch over C rows on `sms` SMs: the
    small-list shape while one wave of it (a block per group of THREADS / G
    rows, BLOCKS_PER_SM per SM) covers the list, else the large-list shape,
    whose grid is capped at one wave too; at least one block."""
    def groups(shape):
        G, threads, _ = STREAM_SHAPES[shape]
        return -(-C // (threads // G))

    shape = 0 if groups(0) <= sms * STREAM_SHAPES[0][2] else 1
    return shape, max(1, min(groups(shape), sms * STREAM_SHAPES[shape][2]))


def stream_row_groups(C: int, shape: int, grid: int) -> list:
    """The row ranges [lo, hi) that block b of a K2 / K3 launch walks, in
    its order: groups b, b + grid, ... of THREADS / G rows (the kernel's
    for_stream_rows)."""
    G, threads, _ = STREAM_SHAPES[shape]
    rows = threads // G
    n = -(-C // rows)
    return [[(g * rows, min((g + 1) * rows, C)) for g in range(b, n, grid)]
            for b in range(grid)]


def _stream_launch_on(dev, C: int) -> tuple:
    from .jacobi import solve_device  # the device's SM count, asked once

    return stream_launch(C, solve_device(dev)[0])


def _rows(csr: PairCSR):
    C = csr.row_ptr.shape[0] - 1
    counts = (csr.row_ptr[1:] - csr.row_ptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(C, device=csr.row_ptr.device), counts)


def _row_sum(row, vals, C):
    return torch.zeros(C, dtype=vals.dtype, device=vals.device).index_add_(0, row, vals)


def _scalar_pairs(csr: PairCSR, v):
    """(row, col, x factor, y factor) of scalar storage v (g or sg): v (x_i -
    x_j) and v (y_i - y_j), rounded as K1 rounded its stored w."""
    row = _rows(csr)
    col = csr.col.long()
    x, y = csr.table[:, 0], csr.table[:, 1]
    v = v.float()
    return row, col, v * (x[row] - x[col]), v * (y[row] - y[col])


def pair_matvec_ref(csr: PairCSR, t, k_out: int):
    """Plain twin of K2. k_out=2: t is u (C,), returns (sum wx u_j, sum wy u_j).
    k_out=1: t is (tx, ty), returns sum (wx tx_j + wy ty_j)."""
    C = csr.row_ptr.shape[0] - 1
    row = _rows(csr)
    col = csr.col.long()
    return _matvec_sums(row, col, csr.w[0].float(), csr.w[1].float(), t, k_out, C)


def _matvec_sums(row, col, wx, wy, t, k_out, C):
    if k_out == 2:
        u = t[col]
        return _row_sum(row, wx * u, C), _row_sum(row, wy * u, C)
    tx, ty = t
    return _row_sum(row, wx * tx[col] + wy * ty[col], C)


def _check_k_out(k_out, t):
    if k_out not in (1, 2):
        raise ValueError(f"k_out must be 1 or 2, got {k_out}")
    return (t, None) if k_out == 2 else t


def _check_list(csr: PairCSR, C, P, dev):
    _check(csr.row_ptr, "row_ptr", torch.int32, (C + 1,), dev)
    _check(csr.col, "col", torch.int32, (P,), dev)


def matvec_operands(csr: PairCSR, t0, t1, k_out: int):
    """Check a K2 / K2s launch's list and operands on t0's device; returns
    (C, P, out0, out1, (shape, grid)), the outputs allocated (out1 None in
    div mode) and the launch's shape and blocks."""
    dev = t0.device
    C = csr.row_ptr.shape[0] - 1
    P = csr.num_pairs
    if csr.scalar:
        _check_scalar(csr, csr.g, "g", C, P, dev)
    else:
        _check_list(csr, C, P, dev)
        _check(csr.w, "w", STORAGE_DTYPES, (2, P), dev)
    _check(t0, "t", torch.float32, (C,), dev)
    if t1 is not None:
        _check(t1, "ty", torch.float32, (C,), dev)
    out0 = torch.empty(C, dtype=torch.float32, device=dev)
    out1 = torch.empty(C, dtype=torch.float32, device=dev) if k_out == 2 else None
    return C, P, out0, out1, _stream_launch_on(dev, C)


def pair_matvec(csr: PairCSR, t, k_out: int):
    """K2: pair-weight products in float32 whatever the storage type.

    k_out=2 (accel mode): t = u (C,) float32 -> (sum_j wx_ij u_j, sum_j wy_ij u_j).
    k_out=1 (div mode): t = (tx, ty) -> sum_j (wx_ij tx_j + wy_ij ty_j).
    """
    t0, t1 = _check_k_out(k_out, t)
    if csr.w is None:
        raise ValueError("pair_matvec: the list stores scalars; use pair_matvec_scalar")
    if _device_kind(t0) == "cpu":
        return pair_matvec_ref(csr, t, k_out)
    C, P, out0, out1, launch = matvec_operands(csr, t0, t1, k_out)
    _native.check(_native.load().asph_pair_matvec(
        _ptr(csr.row_ptr), _ptr(csr.col), _ptr(csr.w), int(csr.w.dtype == torch.bfloat16), P, C,
        _ptr(t0), _ptr(t1), int(k_out == 1), _ptr(out0), _ptr(out1), *launch,
        _stream(t0.device)),
        "pair_matvec")
    launches["pair_matvec"] += 1
    return (out0, out1) if k_out == 2 else out0


def pair_matvec_scalar_ref(csr: PairCSR, t, k_out: int):
    """Plain twin of K2s: K2 with wx, wy rebuilt from g and the positions."""
    C = csr.row_ptr.shape[0] - 1
    row, col, wx, wy = _scalar_pairs(csr, csr.g)
    return _matvec_sums(row, col, wx, wy, t, k_out, C)


def _check_scalar(csr: PairCSR, v, name, C, P, dev):
    _check_list(csr, C, P, dev)
    _check(v, name, STORAGE_DTYPES, (P,), dev)
    _check(csr.table, "table", torch.float32, (C, csr.table.shape[1]), dev)
    if csr.table.shape[1] < 2:
        raise ValueError("the position table needs x and y columns")


def pair_matvec_scalar(csr: PairCSR, t, k_out: int):
    """K2s: K2 on a scalar-storage list; wx = g (x_i - x_j), wy = g (y_i - y_j)
    per pair from the list's position table. Same modes and results as K2
    (bit for bit in float32)."""
    t0, t1 = _check_k_out(k_out, t)
    if not csr.scalar:
        raise ValueError("pair_matvec_scalar: the list stores two weight rows; use pair_matvec")
    if _device_kind(t0) == "cpu":
        return pair_matvec_scalar_ref(csr, t, k_out)
    C, _, out0, out1, launch = matvec_operands(csr, t0, t1, k_out)
    _native.check(_native.load().asph_pair_matvec_scalar(
        _ptr(csr.row_ptr), _ptr(csr.col), _ptr(csr.g), int(csr.g.dtype == torch.bfloat16), C,
        _ptr(csr.table), csr.table.shape[1], _ptr(t0), _ptr(t1), int(k_out == 1), _ptr(out0),
        _ptr(out1), *launch, _stream(t0.device)), "pair_matvec_scalar")
    launches["pair_matvec_scalar"] += 1
    return (out0, out1) if k_out == 2 else out0


def _visc_sums(row, col, sx, sy, rho, C):
    inv = rdiv(1.0, torch.clamp(rho[col] + rho[row], min=1e-30))
    return _row_sum(row, sx * inv, C), _row_sum(row, sy * inv, C)


def pair_visc_ref(csr: PairCSR, rho):
    """Plain twin of K3."""
    C = csr.row_ptr.shape[0] - 1
    return _visc_sums(_rows(csr), csr.col.long(), csr.s[0].float(), csr.s[1].float(), rho, C)


def pair_visc(csr: PairCSR, rho):
    """K3: viscosity acceleration sum_j s_ij / max(rho_i + rho_j, 1e-30), per axis."""
    if csr.s is None:
        raise ValueError("pair_visc: the pair list has no two-row viscosity factors")
    if _device_kind(rho) == "cpu":
        return pair_visc_ref(csr, rho)
    dev = rho.device
    C = csr.row_ptr.shape[0] - 1
    P = csr.num_pairs
    _check_list(csr, C, P, dev)
    _check(csr.s, "s", STORAGE_DTYPES, (2, P), dev)
    _check(rho, "rho", torch.float32, (C,), dev)
    out0 = torch.empty(C, dtype=torch.float32, device=dev)
    out1 = torch.empty(C, dtype=torch.float32, device=dev)
    _native.check(_native.load().asph_pair_visc(
        _ptr(csr.row_ptr), _ptr(csr.col), _ptr(csr.s), int(csr.s.dtype == torch.bfloat16), P, C,
        _ptr(rho), _ptr(out0), _ptr(out1), *_stream_launch_on(dev, C), _stream(dev)),
        "pair_visc")
    launches["pair_visc"] += 1
    return out0, out1


def pair_visc_scalar_ref(csr: PairCSR, rho):
    """Plain twin of K3s: ((B g) (x_i - x_j)) / max(rho_i + rho_j, 1e-30)."""
    C = csr.row_ptr.shape[0] - 1
    row, col, sx, sy = _scalar_pairs(csr, csr.sg)
    return _visc_sums(row, col, sx, sy, rho, C)


def pair_visc_scalar(csr: PairCSR, rho):
    """K3s: K3 on a scalar-storage list, sx = (B g) (x_i - x_j) per pair (the
    reference's association; not bit-equal to K3's B (g dx))."""
    if csr.sg is None:
        raise ValueError("pair_visc_scalar: the pair list has no scalar viscosity factors")
    if _device_kind(rho) == "cpu":
        return pair_visc_scalar_ref(csr, rho)
    dev = rho.device
    C = csr.row_ptr.shape[0] - 1
    P = csr.num_pairs
    _check_scalar(csr, csr.sg, "sg", C, P, dev)
    _check(rho, "rho", torch.float32, (C,), dev)
    out0 = torch.empty(C, dtype=torch.float32, device=dev)
    out1 = torch.empty(C, dtype=torch.float32, device=dev)
    _native.check(_native.load().asph_pair_visc_scalar(
        _ptr(csr.row_ptr), _ptr(csr.col), _ptr(csr.sg), int(csr.sg.dtype == torch.bfloat16), C,
        _ptr(csr.table), csr.table.shape[1], _ptr(rho), _ptr(out0), _ptr(out1),
        *_stream_launch_on(dev, C), _stream(dev)), "pair_visc_scalar")
    launches["pair_visc_scalar"] += 1
    return out0, out1
