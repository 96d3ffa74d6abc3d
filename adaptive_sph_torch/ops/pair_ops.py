"""The step's pair operator: a CSR pair list built once per step, streamed per sweep.

Within one step the geometry is frozen, so the pair weights w_ij = m_j grad
W_ij (the only pair term of both Jacobi sweeps) and the rho-free viscosity
pair factors are computed once by `pair_build` and read back by `pair_matvec`
and `pair_visc`:

  accel_i = -(p_i/rho_i^2) S1_i - sum_j w_ij u_j + boundary,   u_j = p_j/rho_j^2
  div_i   = (sum_j w_ij . t_j - t_i . S1_i) / rho_i + boundary

Layout: per query row (sorted slot) a compact list of its pairs in ascending
candidate slot, row_ptr (C+1,) int32, col (P,) int32, w and s (2, P) in
float32 or bfloat16. The reference's TPU block format (64-candidate windows,
~2% valid) is a Mosaic workaround and is not reproduced; the pair set, the
weights and the sums are.

Each operation has a CUDA kernel (csrc/pair_ops.cu, built by ops/_native.py)
and a plain PyTorch twin (`*_ref`). The wrapper runs the twin only for CPU
tensors; for CUDA tensors it launches the kernel or raises. `launches` counts
kernel launches per wrapper.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from . import _native
from .kernels import PI, cubic_kernel_unnormalized, cubic_kernel_unnormalized_deriv
from .numerics import rdiv, sqrt
from .tiles import RL, WM_STRIDE

# pair storage types the kernels read (f32 accumulation either way)
STORAGE_DTYPES = (torch.float32, torch.bfloat16)
# tested pairs per chunk of the CPU twin's walk (bounds its memory)
_CHUNK_PAIRS = 1 << 21

# kernel launches per wrapper, pair_sweep (ops/sweeps.py) included; the CPU
# twins do not count
launches = {"pair_build": 0, "pair_matvec": 0, "pair_visc": 0, "pair_sweep": 0}


def reset_launches():
    for k in launches:
        launches[k] = 0


@dataclasses.dataclass
class PairCSR:
    """One step's pair list and its row sums.

    row_ptr : (C+1,) int32; row i's pairs are [row_ptr[i], row_ptr[i+1])
    col     : (P,) int32 candidate slot j, ascending within a row
    w       : (2, P) m_j grad W_ij, x row then y row
    s       : (2, P) viscosity pair factors B_ij * w_ij (None without viscosity)
    prep    : (4, C) float32 row sums: sum wx, sum wy, sum |w|^2 / m_j, sum m_j W_ij
    """

    row_ptr: torch.Tensor
    col: torch.Tensor
    w: torch.Tensor
    s: Optional[torch.Tensor]
    prep: torch.Tensor

    @property
    def num_pairs(self) -> int:
        return self.col.shape[0]


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


def _pair_terms(flat, qi, cj, scale, viscosity, visc):
    """Mask and per-pair terms for query slots qi against candidate slots cj."""
    q = flat[qi]
    c = flat[cj]
    qh, ch = q[:, 2], c[:, 2]
    h_ij = torch.clamp(0.5 * (qh + ch), min=1e-6)
    dx = q[:, 0] - c[:, 0]
    dy = q[:, 1] - c[:, 1]
    r2 = dx * dx + dy * dy
    rad = scale * h_ij
    valid = (r2 < rad * rad) & (ch > 0.0) & (qh > 0.0)
    qi, cj = qi[valid], cj[valid]
    h_ij, dx, dy, r2, cm = h_ij[valid], dx[valid], dy[valid], r2[valid], c[valid, 3]
    w_val, gmag = _w_and_gmag(r2, h_ij)
    g = cm * gmag
    wx = g * dx
    wy = g * dy
    terms = {"wx": wx, "wy": wy, "den": cm * w_val,
             "t2": (wx * wx + wy * wy) * rdiv(1.0, torch.clamp(cm, min=1e-30))}
    if visc:
        dvx = q[valid, 4] - c[valid, 4]
        dvy = q[valid, 5] - c[valid, 5]
        dot = dx * dvx + dy * dvy
        B = (2.0 * viscosity * 8.0) * dot / (r2 + 0.01 * h_ij * h_ij)
        B = torch.where(dot < 0.0, B, torch.zeros_like(B))
        terms["sx"] = B * wx
        terms["sy"] = B * wy
    return qi, cj, terms


def walk_pairs(cell_starts, wm, qvalid, tq: int, chunk_pairs: int = _CHUNK_PAIRS):
    """The tested (query, candidate) slot pairs of the tile walk, in chunks.

    Expands each tile's window ranges (wm) into candidate slots with
    repeat_interleave and crosses them with the tile's live queries (qvalid,
    (C,) bool). Yields (qi, cj) int64 pairs, about `chunk_pairs` per chunk, in
    the kernels' walk order: tile, level, range, candidate slot, query. Every
    query's candidates therefore come in the order its kernel thread visits
    them."""
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


def pair_build_ref(cell_starts, wm, flat, tq: int, scale: float, viscosity: float,
                   visc: bool, wdtype=torch.float32) -> PairCSR:
    """Plain PyTorch twin of K1: the tested pairs of `walk_pairs`, masked and
    sorted by (row, col)."""
    dev = flat.device
    C = flat.shape[0]
    rows, cols, parts = [], [], []
    for pq, pc in walk_pairs(cell_starts, wm, flat[:, 2] > 0.0, tq):
        qi, cj, terms = _pair_terms(flat, pq, pc, scale, viscosity, visc)
        rows.append(qi)
        cols.append(cj)
        parts.append(terms)

    names = ["wx", "wy", "den", "t2"] + (["sx", "sy"] if visc else [])
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
    prep = torch.zeros(4, C, dtype=torch.float32, device=dev)
    for k, name in enumerate(("wx", "wy", "t2", "den")):
        prep[k].index_add_(0, row, vals[name])
    w = torch.stack([vals["wx"], vals["wy"]]).to(wdtype)
    s = torch.stack([vals["sx"], vals["sy"]]).to(wdtype) if visc else None
    return PairCSR(row_ptr=row_ptr, col=col.to(torch.int32), w=w, s=s, prep=prep)


def pair_build(cell_starts, wm, flat, tq: int, scale: float, viscosity: float,
               visc: bool, wdtype=torch.float32) -> PairCSR:
    """K1: the step's one pair walk.

    cell_starts: (cells+1,) int32 CSR from build_tiles; wm: (NT*NL*WM_STRIDE,)
    int32 window meta; flat: (C, 6) float32 sorted [x, y, h, m, vx, vy].
    Returns the CSR pair list with w = m_j grad W_ij, s = viscosity pair
    factors (when `visc`) stored as `wdtype`, and the float32 prep sums.
    """
    if _device_kind(flat) == "cpu":
        return pair_build_ref(cell_starts, wm, flat, tq, scale, viscosity, visc, wdtype)
    dev = flat.device
    C = flat.shape[0]
    if C % tq:
        raise ValueError(f"capacity {C} is not a multiple of tq={tq}")
    NT = C // tq
    if wm.numel() % (NT * WM_STRIDE):
        raise ValueError(f"window meta of {wm.numel()} entries does not fit {NT} tiles")
    NL = wm.numel() // (NT * WM_STRIDE)
    _check(flat, "flat", torch.float32, (C, 6))
    _check(cell_starts, "cell_starts", torch.int32, device=dev)
    _check(wm, "wm", torch.int32, device=dev)
    if wdtype not in STORAGE_DTYPES:
        raise TypeError(f"pair storage dtype {wdtype} not supported")
    lib = _native.load()
    stream = _stream(dev)
    counts = torch.empty(C, dtype=torch.int32, device=dev)
    _native.check(lib.asph_pair_count(_ptr(cell_starts), _ptr(wm), NT, NL, tq, _ptr(flat),
                                      float(scale), _ptr(counts), stream), "pair_build count")
    row_ptr = torch.zeros(C + 1, dtype=torch.int32, device=dev)
    torch.cumsum(counts, 0, dtype=torch.int32, out=row_ptr[1:])
    # the one host read of the walk: sizes the outputs exactly, so the pair
    # list cannot overflow (the reference's wcache_overflow is always 0 here)
    P = int(row_ptr[C])
    col = torch.empty(P, dtype=torch.int32, device=dev)
    w = torch.empty(2, P, dtype=wdtype, device=dev)
    s = torch.empty(2, P, dtype=wdtype, device=dev) if visc else None
    prep = torch.empty(4, C, dtype=torch.float32, device=dev)
    _native.check(lib.asph_pair_fill(
        _ptr(cell_starts), _ptr(wm), NT, NL, tq, _ptr(flat), float(scale), int(visc),
        float(2.0 * viscosity * 8.0), int(wdtype == torch.bfloat16), _ptr(row_ptr), _ptr(col),
        _ptr(w), _ptr(s), P, _ptr(prep), stream), "pair_build fill")
    launches["pair_build"] += 1
    return PairCSR(row_ptr=row_ptr, col=col, w=w, s=s, prep=prep)


# ---------------------------------------------------------------------------
# K2 / K3: streams over the pair list


def _rows(csr: PairCSR):
    C = csr.row_ptr.shape[0] - 1
    counts = (csr.row_ptr[1:] - csr.row_ptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(C, device=csr.row_ptr.device), counts)


def _row_sum(row, vals, C):
    return torch.zeros(C, dtype=torch.float32, device=vals.device).index_add_(0, row, vals)


def pair_matvec_ref(csr: PairCSR, t, k_out: int):
    """Plain twin of K2. k_out=2: t is u (C,), returns (sum wx u_j, sum wy u_j).
    k_out=1: t is (tx, ty), returns sum (wx tx_j + wy ty_j)."""
    C = csr.row_ptr.shape[0] - 1
    row = _rows(csr)
    col = csr.col.long()
    wx, wy = csr.w[0].float(), csr.w[1].float()
    if k_out == 2:
        u = t[col]
        return _row_sum(row, wx * u, C), _row_sum(row, wy * u, C)
    tx, ty = t
    return _row_sum(row, wx * tx[col] + wy * ty[col], C)


def pair_matvec(csr: PairCSR, t, k_out: int):
    """K2: pair-weight products in float32 whatever the storage type.

    k_out=2 (accel mode): t = u (C,) float32 -> (sum_j wx_ij u_j, sum_j wy_ij u_j).
    k_out=1 (div mode): t = (tx, ty) -> sum_j (wx_ij tx_j + wy_ij ty_j).
    """
    if k_out not in (1, 2):
        raise ValueError(f"k_out must be 1 or 2, got {k_out}")
    t0, t1 = (t, None) if k_out == 2 else t
    if _device_kind(t0) == "cpu":
        return pair_matvec_ref(csr, t, k_out)
    dev = t0.device
    C = csr.row_ptr.shape[0] - 1
    P = csr.num_pairs
    _check(csr.row_ptr, "row_ptr", torch.int32, (C + 1,), dev)
    _check(csr.col, "col", torch.int32, (P,), dev)
    _check(csr.w, "w", STORAGE_DTYPES, (2, P), dev)
    _check(t0, "t", torch.float32, (C,), dev)
    if t1 is not None:
        _check(t1, "ty", torch.float32, (C,), dev)
    out0 = torch.empty(C, dtype=torch.float32, device=dev)
    out1 = torch.empty(C, dtype=torch.float32, device=dev) if k_out == 2 else None
    _native.check(_native.load().asph_pair_matvec(
        _ptr(csr.row_ptr), _ptr(csr.col), _ptr(csr.w), int(csr.w.dtype == torch.bfloat16), P, C,
        _ptr(t0), _ptr(t1), int(k_out == 1), _ptr(out0), _ptr(out1), _stream(dev)), "pair_matvec")
    launches["pair_matvec"] += 1
    return (out0, out1) if k_out == 2 else out0


def pair_visc_ref(csr: PairCSR, rho):
    """Plain twin of K3."""
    C = csr.row_ptr.shape[0] - 1
    row = _rows(csr)
    col = csr.col.long()
    inv = rdiv(1.0, torch.clamp(rho[col] + rho[row], min=1e-30))
    return (_row_sum(row, csr.s[0].float() * inv, C),
            _row_sum(row, csr.s[1].float() * inv, C))


def pair_visc(csr: PairCSR, rho):
    """K3: viscosity acceleration sum_j s_ij / max(rho_i + rho_j, 1e-30), per axis."""
    if csr.s is None:
        raise ValueError("pair_visc: the pair list was built without viscosity factors")
    if _device_kind(rho) == "cpu":
        return pair_visc_ref(csr, rho)
    dev = rho.device
    C = csr.row_ptr.shape[0] - 1
    P = csr.num_pairs
    _check(csr.row_ptr, "row_ptr", torch.int32, (C + 1,), dev)
    _check(csr.col, "col", torch.int32, (P,), dev)
    _check(csr.s, "s", STORAGE_DTYPES, (2, P), dev)
    _check(rho, "rho", torch.float32, (C,), dev)
    out0 = torch.empty(C, dtype=torch.float32, device=dev)
    out1 = torch.empty(C, dtype=torch.float32, device=dev)
    _native.check(_native.load().asph_pair_visc(
        _ptr(csr.row_ptr), _ptr(csr.col), _ptr(csr.s), int(csr.s.dtype == torch.bfloat16), P, C,
        _ptr(rho), _ptr(out0), _ptr(out1), _stream(dev)), "pair_visc")
    launches["pair_visc"] += 1
    return out0, out1
