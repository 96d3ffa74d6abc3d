"""The probe kernels of `python -m adaptive_sph_torch.probe` and their plain twins.

The port's counterparts of the kernels in the TPU probe scripts (each
function that reaches `pl.pallas_call` there). No step path calls them:

- `block_sweep` (scripts/proto_pallas.py::kernel, the block-list sweep
  prototype): a work list of items (query tile, candidate chunk, column
  range) sorted by tile; each query sums m_c exp(-r^2 / h_ij^2) over the
  chunk's candidates in the range and inside scale h_ij. Queries (NT 8, 4)
  and candidates (NC 64, 4) are rows [x, y, h, m], the script's logical
  inputs rather than its (NT, 4, 8) / (NC, 4, 64) TPU blocks.
- `window_sum` (scripts/proto_v8.py::_kernel): out[k] = sum over the anchors,
  in order, of v[a + k]; the kernel stages WINDOW_STAGE anchors' windows at
  a time into shared memory with asynchronous copies (a double-buffered
  ring beyond one stage) and adds them in anchor order.
- `pair_stream` (scripts/matvec_probe.py::dma_variant): the first n elements
  of a pair array (the list's w or g) streamed by a persistent grid (one
  block per SM, `stream_grid`), each block through its own shared-memory
  ring of `nbuf` stages of `grp` 1 KB chunks filled by TMA bulk copies;
  (8, 128) zeros out, as the reference's, and per block the XOR of the
  32-bit words it landed, which `stream_folds` computes from the array
  itself.
- `pair_matvec_probe` (scripts/matvec_probe.py::make_kernel): K2 with an
  ablation. "base" is K2's function (the reference's base, divbase, accvpu
  and divvpu all compute these sums); "nogather" reads t at the row's own
  slot instead of t[col] (its noslice: the operand gather isolated);
  "nomul" sums the weights with no t (its nodot). Its nostore and noswitch
  have no counterpart: they time a TPU accumulator kept across blocks and
  stored on every block, while a CSR row's segment of lanes holds the row's
  sums in registers and writes them once.
- `pair_matvec_scalar_probe` (scripts/matvec_probe2.py::_scalar_kernel): K2s
  with `wh` in {32, 64, 128, 256} pairs of a warp in flight per loop step
  (wh / 32 per lane), the card's counterpart of the script's window height
  (32 pair_ops.STREAM_K: the step's K2s). Every wh gives K2s's bits.

The kernels are csrc/pair_probe.cu (the first three) and template instances
of K2's kernel in csrc/pair_ops.cu (the last two). As in ops/pair_ops.py the
wrapper runs the twin (`*_ref`) only for CPU tensors; for CUDA tensors it
launches the kernel or raises, and counts the launch in
`pair_ops.launches` under its own name.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _native
from .pair_ops import (STORAGE_DTYPES, PairCSR, _check, _check_k_out, _device_kind, _matvec_sums,
                       _ptr, _row_sum, _rows, _stream, launches, matvec_operands,
                       pair_matvec_ref, pair_matvec_scalar_ref)

TQ = 8   # queries per tile of block_sweep (proto_pallas.py's TQ)
WK = 64  # candidates per chunk (its WK)
SWEEP_WARPS = 8  # warps per block of the block_sweep kernel (csrc/pair_probe.cu)
SWEEP_MIN_BLOCKS_PER_SM = 1  # below this, a tile gets more than one warp
VARIANTS = ("base", "nogather", "nomul")  # csrc/pair_ops.cu enum MatvecAblation
WINDOW_HEIGHTS = (32, 64, 128, 256)
STREAM_NBUF = (4, 8)
CHUNK_BYTES = 1024        # a pair_stream ring chunk
WINDOW_STAGE = 64         # anchors' windows per stage of window_sum's ring
MAX_RING_BYTES = 232448   # the shared memory one block can use


# ---------------------------------------------------------------------------
# block_sweep


def _check_work_list(q, c, qt, ck, lo, hi):
    """(NT, NC) after checking the tables and the work list; raises unless
    qt is non-decreasing and every tile and chunk index is in range."""
    dev = q.device
    if q.dim() != 2 or q.shape[0] % TQ or c.dim() != 2 or c.shape[0] % WK:
        raise ValueError(f"block_sweep: takes q (NT*{TQ}, 4) and c (NC*{WK}, 4), got "
                         f"{tuple(q.shape)} and {tuple(c.shape)}")
    if c.shape[0] >= 2**31:
        raise ValueError(f"block_sweep: the kernel indexes candidate rows in 32 bits, c has "
                         f"{c.shape[0]}")
    _check(q, "q", torch.float32, (q.shape[0], 4))
    _check(c, "c", torch.float32, (c.shape[0], 4), dev)
    E = qt.shape[0]
    for name, a in (("qt", qt), ("ck", ck), ("lo", lo), ("hi", hi)):
        _check(a, name, torch.int32, (E,), dev)
    NT, NC = q.shape[0] // TQ, c.shape[0] // WK
    if E:
        bad = torch.stack([(qt[1:] < qt[:-1]).any(), qt.min() < 0, qt.max() >= NT,
                           ck.min() < 0, ck.max() >= NC]).tolist()
        if bad[0]:
            raise ValueError("block_sweep: the work list must be sorted by query tile (qt "
                             "non-decreasing)")
        if any(bad[1:]):
            raise ValueError(f"block_sweep: a tile index outside [0, {NT}) or a chunk index "
                             f"outside [0, {NC})")
    return NT, NC


def block_sweep_ref(q, c, qt, ck, lo, hi, scale: float):
    """Plain twin of block_sweep: every item's (8, 64) pair block at once,
    summed per item, added into its tile's queries."""
    NT = q.shape[0] // TQ
    dev = q.device
    qi = qt.long()[:, None] * TQ + torch.arange(TQ, device=dev)  # (E, 8)
    cj = ck.long()[:, None] * WK + torch.arange(WK, device=dev)  # (E, 64)
    Q = q[qi][:, :, None, :]  # (E, 8, 1, 4)
    Cc = c[cj][:, None, :, :]  # (E, 1, 64, 4)
    h_ij = torch.clamp(0.5 * (Q[..., 2] + Cc[..., 2]), min=1e-6)
    dx = Q[..., 0] - Cc[..., 0]
    dy = Q[..., 1] - Cc[..., 1]
    r2 = dx * dx + dy * dy
    rad = scale * h_ij
    in_range = (cj >= lo.long()[:, None]) & (cj < hi.long()[:, None])
    valid = in_range[:, None, :] & (r2 < rad * rad)
    w = torch.exp(-r2 / (h_ij * h_ij))
    sums = torch.where(valid, Cc[..., 3] * w, torch.zeros_like(w)).sum(-1)  # (E, 8)
    out = torch.zeros(NT * TQ, dtype=torch.float32, device=dev)
    return out.index_add_(0, qi.reshape(-1), sums.reshape(-1))


def tile_item_ptr(qt, NT: int):
    """(NT + 1,) int32 CSR of the sorted tile list: tile t's items are
    [item_ptr[t], item_ptr[t + 1]). One search on the device, no host read."""
    tiles = torch.arange(NT + 1, dtype=torch.int32, device=qt.device)
    return torch.searchsorted(qt, tiles, out_int32=True)


def sweep_tiles_per_block(NT: int, sms: int) -> int:
    """Tiles per block of the block_sweep kernel: SWEEP_WARPS (one warp per
    tile) while that gives every SM SWEEP_MIN_BLOCKS_PER_SM blocks, else
    halved until it does (each tile's candidates shared by SWEEP_WARPS /
    tiles warps), at least 1."""
    tpb = SWEEP_WARPS
    while tpb > 1 and -(-NT // tpb) < SWEEP_MIN_BLOCKS_PER_SM * sms:
        tpb //= 2
    return tpb


def block_sweep(q, c, qt, ck, lo, hi, scale: float):
    """The block-list sweep: out (NT*8,) float32, out[i] = sum over the items
    e of tile qt[e] = i // 8 of sum over candidates j of chunk ck[e] with lo[e]
    <= j < hi[e] and r_ij^2 < (scale h_ij)^2 of m_j exp(-r_ij^2 / h_ij^2),
    h_ij = max((h_i + h_j) / 2, 1e-6). A tile with no item gets 0."""
    NT, _ = _check_work_list(q, c, qt, ck, lo, hi)
    if _device_kind(q) == "cpu":
        return block_sweep_ref(q, c, qt, ck, lo, hi, scale)
    dev = q.device
    item_ptr = tile_item_ptr(qt, NT)
    out = torch.empty(NT * TQ, dtype=torch.float32, device=dev)
    tpb = sweep_tiles_per_block(NT, torch.cuda.get_device_properties(dev).multi_processor_count)
    _native.check(_native.load().asph_block_sweep(
        _ptr(q), _ptr(c), NT, tpb, _ptr(item_ptr), _ptr(ck), _ptr(lo), _ptr(hi), float(scale),
        _ptr(out), _stream(dev)), "block_sweep")
    launches["block_sweep"] += 1
    return out


# ---------------------------------------------------------------------------
# window_sum


def _check_windows(v, anchors, width: int):
    if v.dim() != 1:
        raise ValueError(f"window_sum: v must be 1-D, got {tuple(v.shape)}")
    _check(v, "v", torch.float32)
    _check(anchors, "anchors", torch.int32, (anchors.shape[0],), v.device)
    if width < 1:
        raise ValueError(f"window_sum: width must be positive, got {width}")
    if anchors.numel():
        lo, hi = torch.stack([anchors.min(), anchors.max()]).tolist()
        if lo < 0 or hi + width > v.shape[0]:
            raise ValueError(f"window_sum: an anchor's window [a, a + {width}) leaves v "
                             f"(anchors in [{lo}, {hi}], len(v) = {v.shape[0]})")


def window_sum_ref(v, anchors, width: int = 128):
    """Plain twin of window_sum: the windows added one after another, in
    anchor order, as the reference's fori_loop adds them."""
    win = v[anchors.long()[:, None] + torch.arange(width, device=v.device)]
    acc = torch.zeros(width, dtype=torch.float32, device=v.device)
    for row in win:
        acc = acc + row
    return acc


@functools.lru_cache(maxsize=None)
def _window_setup(device_index: int):
    """Once per device: raise window_sum's shared memory limit to its ring."""
    with torch.cuda.device(device_index):
        _native.check(_native.load().asph_window_sum_setup(), "window_sum")


def window_sum(v, anchors, width: int = 128):
    """out (width,) float32: out[k] = sum over the anchors a, in order, of
    v[a + k]; raises on an anchor whose window leaves v."""
    _check_windows(v, anchors, width)
    if _device_kind(v) == "cpu":
        return window_sum_ref(v, anchors, width)
    if anchors.shape[0] > WINDOW_STAGE:
        _window_setup(v.device.index)
    out = torch.empty(width, dtype=torch.float32, device=v.device)
    _native.check(_native.load().asph_window_sum(
        _ptr(v), _ptr(anchors), anchors.shape[0], width, _ptr(out), _stream(v.device)),
        "window_sum")
    launches["window_sum"] += 1
    return out


# ---------------------------------------------------------------------------
# pair_stream


def _check_stream(x, n: int, grp: int, nbuf: int):
    _check(x, "x", STORAGE_DTYPES)
    if not 0 <= n <= x.numel():
        raise ValueError(f"pair_stream: n = {n} outside [0, {x.numel()}]")
    if nbuf not in STREAM_NBUF or grp < 1 or nbuf * grp * CHUNK_BYTES > MAX_RING_BYTES:
        raise ValueError(f"pair_stream: nbuf must be one of {STREAM_NBUF} and nbuf * grp * "
                         f"{CHUNK_BYTES} B at most {MAX_RING_BYTES} B (got grp {grp}, nbuf {nbuf})")


def _xor_last(a):
    """XOR-reduce the last dimension of an int32 tensor (a tree of halvings)."""
    if a.shape[-1] == 0:
        return torch.zeros(a.shape[:-1], dtype=a.dtype, device=a.device)
    while a.shape[-1] > 1:
        if a.shape[-1] % 2:
            a = torch.cat([a, torch.zeros_like(a[..., :1])], -1)
        a = a[..., 0::2] ^ a[..., 1::2]
    return a[..., 0]


def stream_folds(x, n: int, grp: int, grid: int):
    """The folds pair_stream writes: (grid,) int32, entry b the XOR of the
    32-bit words of the stages b, b + grid, ... of x's first n elements'
    bytes (stages of grp KB, the last padded with zeros)."""
    data = x.reshape(-1)[:n].view(torch.uint8)
    stage = grp * CHUNK_BYTES
    nstage = -(-data.numel() // stage)
    blocks = -(-max(nstage, 1) // grid) * grid
    padded = torch.zeros(blocks * stage, dtype=torch.uint8, device=x.device)
    padded[:data.numel()] = data
    per_stage = _xor_last(padded.view(torch.int32).view(blocks, stage // 4))
    return _xor_last(per_stage.view(blocks // grid, grid).T)


def pair_stream_ref(x, n: int, grp: int = 8, nbuf: int = 4, grid: int = 1):
    """Plain twin of pair_stream on `grid` blocks: the zeros, the byte
    count and the blocks' folds."""
    return (torch.zeros(8, 128, dtype=torch.float32, device=x.device), n * x.element_size(),
            stream_folds(x, n, grp, grid))


@functools.lru_cache(maxsize=None)
def _stream_setup(device_index: int, nbuf: int):
    """Once per device and nbuf instance: raise the kernel's shared memory
    limit; returns (the largest ring it takes in bytes, the device's SMs)."""
    max_ring = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _native.check(_native.load().asph_pair_stream_setup(nbuf, ctypes.byref(max_ring)),
                      "pair_stream")
    return max_ring.value, torch.cuda.get_device_properties(device_index).multi_processor_count


def stream_grid(x, n: int, grp: int = 8, nbuf: int = 4) -> int:
    """The blocks pair_stream runs on: 1 for a CPU tensor, else one per SM
    (a persistent grid), at most one per stage and at least 1."""
    if _device_kind(x) == "cpu":
        return 1
    nstage = -(-n * x.element_size() // (grp * CHUNK_BYTES))
    return max(1, min(_stream_setup(x.device.index, nbuf)[1], nstage))


def pair_stream(x, n: int, grp: int = 8, nbuf: int = 4):
    """Stream the first n elements of the pair array x (float32 or bfloat16,
    flat order) in stages of grp 1 KB chunks, each block of the persistent
    grid through its own ring of nbuf stages in shared memory. Returns ((8,
    128) float32 zeros, bytes streamed, (grid,) int32 folds of what each
    block landed: `stream_folds(x, n, grp, grid)`)."""
    _check_stream(x, n, grp, nbuf)
    if _device_kind(x) == "cpu":
        return pair_stream_ref(x, n, grp, nbuf)
    if x.data_ptr() % 16:
        raise ValueError("pair_stream: x must start on a 16-byte boundary")
    max_ring = _stream_setup(x.device.index, nbuf)[0]
    if nbuf * grp * CHUNK_BYTES > max_ring:
        raise ValueError(f"pair_stream: a ring of {nbuf * grp * CHUNK_BYTES} B exceeds the "
                         f"{max_ring} B of shared memory a block can take on this card")
    grid = stream_grid(x, n, grp, nbuf)
    out = torch.empty(8, 128, dtype=torch.float32, device=x.device)
    folds = torch.empty(grid, dtype=torch.int32, device=x.device)
    nbytes = n * x.element_size()
    # the stream's raw handle: building a torch.cuda.Stream would take a
    # large share of this short launch's host time
    stream = torch._C._cuda_getCurrentRawStream(x.device.index)
    _native.check(_native.load().asph_pair_stream(_ptr(x), nbytes, grp, nbuf, grid, _ptr(out),
                                                  _ptr(folds), stream), "pair_stream")
    launches["pair_stream"] += 1
    return out, nbytes, folds


# ---------------------------------------------------------------------------
# K2 / K2s probes


def _variant_code(variant: str) -> int:
    if variant not in VARIANTS:
        raise ValueError(f"pair_matvec_probe: variant must be one of {VARIANTS}, got {variant!r}")
    return VARIANTS.index(variant)


def pair_matvec_probe_ref(csr: PairCSR, t, k_out: int, variant: str = "base"):
    """Plain twin of pair_matvec_probe."""
    _variant_code(variant)
    if variant == "base":
        return pair_matvec_ref(csr, t, k_out)
    C = csr.row_ptr.shape[0] - 1
    row = _rows(csr)
    wx, wy = csr.w[0].float(), csr.w[1].float()
    if variant == "nogather":
        return _matvec_sums(row, row, wx, wy, t, k_out, C)
    if k_out == 2:
        return _row_sum(row, wx, C), _row_sum(row, wy, C)
    return _row_sum(row, wx + wy, C)


def pair_matvec_probe(csr: PairCSR, t, k_out: int, variant: str = "base"):
    """K2 with a probe ablation. "base": K2 (the same kernel instance).
    "nogather": t read at the row's own slot i instead of t[col]. "nomul":
    no t; accel mode (sum wx, sum wy), div mode sum (wx + wy)."""
    t0, t1 = _check_k_out(k_out, t)
    code = _variant_code(variant)
    if csr.w is None:
        raise ValueError("pair_matvec_probe: the list stores scalars")
    if _device_kind(t0) == "cpu":
        return pair_matvec_probe_ref(csr, t, k_out, variant)
    C, P, out0, out1, launch = matvec_operands(csr, t0, t1, k_out)
    _native.check(_native.load().asph_pair_matvec_probe(
        _ptr(csr.row_ptr), _ptr(csr.col), _ptr(csr.w), int(csr.w.dtype == torch.bfloat16), P, C,
        _ptr(t0), _ptr(t1), int(k_out == 1), code, _ptr(out0), _ptr(out1), *launch,
        _stream(t0.device)), "pair_matvec_probe")
    launches["pair_matvec_probe"] += 1
    return (out0, out1) if k_out == 2 else out0


def _check_wh(wh: int):
    if wh not in WINDOW_HEIGHTS:
        raise ValueError(f"pair_matvec_scalar_probe: wh must be one of {WINDOW_HEIGHTS}, got {wh}")


def pair_matvec_scalar_probe_ref(csr: PairCSR, t, k_out: int, wh: int = 32):
    """Plain twin of pair_matvec_scalar_probe: K2s's function, whatever wh."""
    _check_wh(wh)
    return pair_matvec_scalar_ref(csr, t, k_out)


def pair_matvec_scalar_probe(csr: PairCSR, t, k_out: int, wh: int = 32):
    """K2s with wh pairs of a warp in flight per loop step (wh / 32 per lane,
    loaded before their products); every wh gives K2s's bits."""
    t0, t1 = _check_k_out(k_out, t)
    _check_wh(wh)
    if not csr.scalar:
        raise ValueError("pair_matvec_scalar_probe: the list stores two weight rows")
    if _device_kind(t0) == "cpu":
        return pair_matvec_scalar_probe_ref(csr, t, k_out, wh)
    C, _, out0, out1, launch = matvec_operands(csr, t0, t1, k_out)
    _native.check(_native.load().asph_pair_matvec_scalar_probe(
        _ptr(csr.row_ptr), _ptr(csr.col), _ptr(csr.g), int(csr.g.dtype == torch.bfloat16), C,
        _ptr(csr.table), csr.table.shape[1], _ptr(t0), _ptr(t1), int(k_out == 1), wh,
        _ptr(out0), _ptr(out1), *launch, _stream(t0.device)), "pair_matvec_scalar_probe")
    launches["pair_matvec_scalar_probe"] += 1
    return (out0, out1) if k_out == 2 else out0
