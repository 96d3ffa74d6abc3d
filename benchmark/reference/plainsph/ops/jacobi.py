"""Whole-solve relaxed-Jacobi kernels: a pressure solve in ONE kernel launch.

Counterpart of adaptive_sph_tpu/ops/pallas_jacobi.py (`jacobi_solve`,
`hybrid_solve`, `resident_supported`, the stats indices). The streamed path
(models/tile_physics.py::tile_jacobi) launches two pair_matvec kernels and
reads the exit flag on the host every iteration; here the whole loop (sweeps,
statistics, the exit test, the final acceleration) runs inside one
cooperative CUDA kernel (csrc/pair_jacobi.cu) over the step's CSR pair list
(ops/pair_ops.py), and the iteration count stays on the device.

Inputs, struct-of-arrays (the reference's (C, 16|20) lane tables are a VMEM
padding workaround and are not reproduced):
  csr   : the step's PairCSR (row_ptr, col, w in float32 or bfloat16)
  table : (T_ROWS, C) float32, one row per T_* column below
  scal  : (4,) float32 on the solve's device. jacobi_solve: [dt, tol, rest
          density, 0]; hybrid_solve: [dt, tol_div, tol_den, rest density]
Outputs: M (M_ROWS, C) float32 (rows M_*), stats (8,) or (16,) float32
(S_* at offset 0; hybrid_solve: density solve at 0, divergence solve at 8).

The divergence a solve walks (`w2020`): the default is (sum_j w_ij . a_j -
a_i . S1_i) / rho_i - a_i . (T_BDX, T_BDY)_i; under the Winchenbach2020
discretization it is sum_j w_ij . t_j - a_i . S2_i - a_i . (T_BDX, T_BDY)_i
over t = a / rho, which the kernel publishes beside a in each accel phase
(M_TX, M_TY), and the caller builds T_BDX / T_BDY without the rho0 / rho_i
factor.

`jacobi_solve_ref` and `hybrid_solve_ref` are the plain PyTorch versions
(the same phases over pair_matvec_ref, a Python loop with a host-side exit
test). The wrappers run them only for CPU tensors; for CUDA tensors they
launch the kernel or raise, and count the launch in
`pair_ops.launches["pair_jacobi" | "pair_hybrid"]`.

The launch (csrc/pair_jacobi.cu): `solve_grid` blocks (one per SM), block b
owning the rows [row_ranges[b], row_ranges[b + 1]) and holding their
columns in `solve_smem_bytes` of shared memory; a launch that needs more
than the device gives a block raises. `synthetic_inputs` makes a solve's
inputs from a seed with any row lengths (the kernel tests and chip_smoke.py
hold the kernels to their plain versions on long rows and at the gate's
largest capacity with it).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _native
from .pair_ops import (STORAGE_DTYPES, PairCSR, _check, _device_kind, _ptr, _stream, launches,
                       pair_matvec_ref)

# table rows: the complete source (or its velocity-independent part), omega /
# a_ii, 1 - singular, 1 / rho, the boundary premultiplications, S1, alive, the
# warm starts, rho, the initial velocities, 1 / Omega and S2 (the rho_j-weighted
# gradient sums of the Winchenbach2020 divergence)
(T_SRC, T_WAII, T_NSING, T_RINV, T_GXP, T_GYP, T_S1X, T_S1Y, T_BDX, T_BDY, T_ALIVE, T_P0,
 T_RHO, T_P0DIV, T_VX0, T_VY0, T_OMGI, T_S2X, T_S2Y) = range(19)
T_ROWS = 19
# output rows: pressure, p / rho^2, pressure acceleration, predicted density
# error, source, post-divergence-solve velocities, divergence pressure, and
# t = a / rho, the field the Winchenbach2020 divergence walks (zeros otherwise)
M_P, M_U, M_AX, M_AY, M_PERR, M_SRC, M_VX, M_VY, M_PDIV, M_TX, M_TY = range(11)
M_ROWS = 11
# stats entries of one solve; S_GRID: the kernel's cooperative grid in blocks
# (0 in the plain versions)
S_ITERS, S_AVG, S_MAX, S_NORMAL, S_NEG = range(5)
S_GRID = 7

# the kernels' launch shape, as csrc/pair_jacobi.cu's asph_solve_shape
# reports it (chip_smoke.py phase 1 checks the two agree): blocks of
# SOLVE_THREADS threads, SOLVE_BLOCKS_PER_SM per SM, a segment of SOLVE_G
# lanes per CSR row; a block holds SOLVE_COLS floats per owned row
# (SOLVE_COLS_W2020 in the Winchenbach2020 instances, which add S2), its row
# pointers and _SOLVE_FIXED_WORDS words of statistics in shared memory
SOLVE_THREADS = 1024
SOLVE_G = 4
SOLVE_BLOCKS_PER_SM = 1
SOLVE_COLS = 17
SOLVE_COLS_W2020 = 19
_SOLVE_FIXED_WORDS = SOLVE_THREADS // 32 * 4 + 4

# The reference kernels' VMEM budget (pallas_jacobi.py:70-93), copied so the
# port takes the resident path for the same configurations. It is a TPU
# budget; over the H100's 132 SMs the CUDA kernels' shared memory per block
# (`solve_smem_bytes`) stays under the 227 KB a block may take for every
# capacity it admits (at its largest, 92,416 rows in bf16: 51,008 B, and
# 56,624 B in the Winchenbach2020 instances).
_VMEM_BUDGET = 100 * 1024 * 1024
_TILE, _GRP, _NBUF = 64, 8, 4


def resident_supported(capacity: int, tq: int, wdtype) -> bool:
    """The reference's capacity gate of the resident solver (wdtype: float32
    or bfloat16)."""
    wbytes = torch.tensor([], dtype=wdtype).element_size()
    block = _TILE * max(2 * tq, 128) * wbytes
    nt = capacity // tq
    fixed = (2 * capacity * 128 * 4 + 2 * nt * 8 * tq * 4 + _NBUF * _GRP * block + (1 << 20))
    return fixed + 64 * block <= _VMEM_BUDGET


def solve_grid(C: int, sms: int) -> int:
    """The cooperative grid of a launch over C rows: SOLVE_BLOCKS_PER_SM
    blocks per SM, at most one block per row."""
    return max(1, min(sms * SOLVE_BLOCKS_PER_SM, C))


def row_ranges(C: int, grid: int) -> list:
    """Block b owns rows [r[b], r[b + 1]) for the whole launch (the kernel's
    row_begin)."""
    return [b * C // grid for b in range(grid + 1)]


def solve_smem_bytes(C: int, grid: int, w2020: bool = False) -> int:
    """Dynamic shared memory per block (the kernel's smem_bytes): the fixed
    words, SOLVE_COLS (w2020: SOLVE_COLS_W2020) columns and the row pointers
    of ceil(C / grid) rows, in 16-byte units."""
    rows = -(-C // grid)
    cols = SOLVE_COLS_W2020 if w2020 else SOLVE_COLS
    words = _SOLVE_FIXED_WORDS + cols * rows + rows + 1
    return (words * 4 + 15) // 16 * 16


_devices = {}  # device index -> (SM count, most dynamic shared memory per block)


def solve_device(dev) -> tuple:
    """(SMs, most dynamic shared memory a block of the kernels may take) of
    a CUDA device, asked of the library once per device."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    if idx not in _devices:
        sms, smem = ctypes.c_int(), ctypes.c_int()
        with torch.cuda.device(idx):
            _native.check(_native.load().asph_solve_device(ctypes.byref(sms),
                                                           ctypes.byref(smem)), "solve_device")
        _devices[idx] = (sms.value, smem.value)
    return _devices[idx]


def synthetic_inputs(lengths, seed: int, wdtype=torch.float32, device="cpu", hybrid=False):
    """(csr, table, scal) of a synthetic solve, made with numpy from `seed`:
    row i holds lengths[i] pairs with random columns and weights of |sum| at
    most 0.5 per row and component, a compressive density source, 5% of the
    rows singular and 5% dead, small initial velocities; tolerances 0, so a
    solve runs to its max_iters."""
    from .pair_ops import PairCSR

    rng = np.random.default_rng(seed)
    lengths = np.asarray(lengths, np.int64)
    C = len(lengths)
    row_ptr = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    P = int(row_ptr[-1])
    col = rng.integers(0, C, P).astype(np.int32)
    w = rng.uniform(-1.0, 1.0, (2, P)) * np.repeat(0.5 / np.maximum(lengths, 1), lengths)
    T = np.zeros((T_ROWS, C), np.float32)
    T[T_SRC] = rng.uniform(1.0, 2.0, C)
    T[T_WAII] = rng.uniform(0.02, 0.05, C)
    T[T_NSING] = rng.random(C) > 0.05
    T[T_RINV] = rng.uniform(0.5, 1.5, C)
    T[[T_GXP, T_GYP, T_BDX, T_BDY]] = rng.uniform(-0.1, 0.1, (4, C))
    T[[T_S1X, T_S1Y]] = rng.uniform(-0.2, 0.2, (2, C))
    T[T_ALIVE] = rng.random(C) > 0.05
    T[[T_P0, T_P0DIV]] = rng.uniform(0.0, 1.0, (2, C))
    T[T_RHO] = rng.uniform(900.0, 1100.0, C)
    T[[T_VX0, T_VY0]] = rng.normal(0.0, 1e-4, (2, C))
    T[T_OMGI] = rng.uniform(0.8, 1.2, C)
    T[[T_S2X, T_S2Y]] = rng.uniform(-2e-4, 2e-4, (2, C))
    dt, rest = 1e-3, 1000.0
    scal = [dt, 0.0, 0.0, rest] if hybrid else [dt, 0.0, rest, 0.0]
    def t(a):
        return torch.from_numpy(a).to(device)

    csr = PairCSR(t(row_ptr), t(col), t(w.astype(np.float32)).to(wdtype), None, None)
    return csr, t(T), t(np.asarray(scal, np.float32))


def synthetic_streams(lengths, seed: int, wdtype=torch.float32, device="cpu"):
    """(two, scalar, rho): K2 / K3 / K2s / K3s operands on the list of
    `synthetic_inputs(lengths, seed, wdtype)`. `two` stores its w and, as the
    viscosity factors s, w with its rows swapped; `scalar` stores w's rows as
    g and sg, with a position table of (C, 2) drawn from the seed; rho is the
    solve table's T_RHO row."""
    from .pair_ops import PairCSR

    csr, T, _ = synthetic_inputs(lengths, seed, wdtype, device)
    C = T.shape[1]
    two = PairCSR(csr.row_ptr, csr.col, csr.w, csr.w.flip(0).contiguous(), None)
    pos = np.random.default_rng(seed + 1).uniform(-1.0, 1.0, (C, 2)).astype(np.float32)
    scalar = PairCSR(csr.row_ptr, csr.col, None, None, None, g=csr.w[0].contiguous(),
                     sg=csr.w[1].contiguous(), table=torch.from_numpy(pos).to(device))
    return two, scalar, T[T_RHO].contiguous()


def stream_scales(csr: PairCSR, u, tx, ty, rho) -> dict:
    """{"accel", "div", "visc": the largest sum over a row of |term_ij|} of
    K2 accel (u), K2 div (tx, ty) and K3 (rho) on `csr`, two-row or scalar:
    the size of the products a row adds, which bounds what the order of a
    float32 sum can change (a row whose terms cancel has a small sum but not
    a small scale)."""
    from .pair_ops import _row_sum, _rows, _scalar_pairs

    C = csr.row_ptr.shape[0] - 1
    row, col = _rows(csr), csr.col.long()
    if csr.scalar:
        wx, wy = (v.abs() for v in _scalar_pairs(csr, csr.g)[2:])
        sx, sy = (v.abs() for v in _scalar_pairs(csr, csr.sg)[2:])
    else:
        wx, wy = csr.w.float().abs()
        sx, sy = csr.s.float().abs()
    inv = 1.0 / torch.clamp(rho[col] + rho[row], min=1e-30)
    au, atx, aty = u[col].abs(), tx[col].abs(), ty[col].abs()

    def top(*terms):
        return max(float(_row_sum(row, t, C).max()) if C else 0.0 for t in terms)

    return {"accel": top(wx * au, wy * au), "div": top(wx * atx + wy * aty),
            "visc": top(sx * inv, sy * inv)}


class _Plain:
    """The kernels' phases in plain PyTorch, operation for operation, in the
    table's dtype (float32; float64 for a reference solve)."""

    def __init__(self, csr: PairCSR, table, mp: float, w2020: bool):
        self.csr, self.T, self.mp, self.w2020 = csr, table, mp, w2020
        self.M = torch.zeros(M_ROWS, table.shape[1], dtype=table.dtype, device=table.device)

    def div_at(self, x, y, t=None):
        """The divergence of the field (x, y). Winchenbach2020: sum_j w_ij .
        t_j - (x, y)_i . S2_i + boundary over t = (x, y) / rho (`t` given, or
        taken here); else (sum_j w_ij . (x, y)_j - (x, y)_i . S1_i) / rho_i +
        boundary."""
        T = self.T
        bdiv = -(x * T[T_BDX] + y * T[T_BDY])
        if self.w2020:
            tx, ty = t if t is not None else (x * T[T_RINV], y * T[T_RINV])
            td = pair_matvec_ref(self.csr, (tx, ty), 1)
            return td - (x * T[T_S2X] + y * T[T_S2Y]) + bdiv
        td = pair_matvec_ref(self.csr, (x, y), 1)
        return (td - (x * T[T_S1X] + y * T[T_S1Y])) * T[T_RINV] + bdiv

    def init_pressure(self, k):
        p, ri = self.T[k], self.T[T_RINV]
        self.M[M_P] = p
        self.M[M_U] = p * ri * ri

    def accel(self):
        T, M = self.T, self.M
        sx, sy = pair_matvec_ref(self.csr, M[M_U], 2)
        u = M[M_U]
        coeff = -(u + self.mp * M[M_P])
        M[M_AX] = -u * T[T_S1X] - sx + T[T_GXP] * coeff
        M[M_AY] = -u * T[T_S1Y] - sy + T[T_GYP] * coeff
        if self.w2020:
            M[M_TX] = M[M_AX] * T[T_RINV]
            M[M_TY] = M[M_AY] * T[T_RINV]

    def solve(self, src, dt, tol, rest, density_type: bool, write_perr: bool, max_iters: int,
              stats, off: int):
        T, M = self.T, self.M
        zero, one = torch.zeros_like(src), torch.ones_like(src)
        an = T[T_ALIVE] * T[T_NSING]
        iters = 0
        while True:
            self.accel()
            r = src - self.div_at(M[M_AX], M[M_AY], (M[M_TX], M[M_TY]))
            p1 = (M[M_P] + T[T_WAII] * r) * T[T_NSING]
            pred = T[T_RHO] * (dt * dt) * r if density_type else dt * r
            clamped = p1 <= 0.0
            p2 = torch.where(clamped, zero, p1)
            normal = an * torch.where(clamped, zero, one)
            M[M_P] = p2
            M[M_U] = p2 * T[T_RINV] * T[T_RINV]
            if write_perr:
                M[M_PERR] = pred
            nn = torch.sum(normal)
            sp = torch.sum(torch.where(normal > 0.0, pred, zero))
            mx = torch.max(torch.where(normal > 0.0, torch.abs(pred), zero))
            ng = torch.sum(an * torch.where(clamped, one, zero))
            avg = sp / torch.clamp(nn, min=1.0) if nn > 0 else torch.full_like(sp, float("nan"))
            ok = torch.abs(avg / rest) < tol if density_type else torch.abs(avg) < tol / dt
            if ((nn == 0 or bool(ok)) and iters > 1) or iters == max_iters:
                break
            iters += 1
        self.accel()
        stats[off + S_ITERS] = float(iters)
        stats[off + S_AVG] = avg
        stats[off + S_MAX] = mx
        stats[off + S_NORMAL] = nn
        stats[off + S_NEG] = ng


def jacobi_solve_ref(csr: PairCSR, table, scal, *, density_type: bool, max_iters: int,
                     mp: float, write_perr: bool, src_from_div: bool, w2020: bool = False):
    """Plain version of `jacobi_solve`."""
    S = _Plain(csr, table, mp, w2020)
    T, M = table, S.M
    dt, tol, rest = scal[0], scal[1], scal[2]
    S.init_pressure(T_P0)
    if src_from_div:
        M[M_SRC] = T[T_SRC] - S.div_at(T[T_VX0], T[T_VY0]) * T[T_OMGI] / dt
    else:
        M[M_SRC] = T[T_SRC]
    stats = torch.zeros(8, dtype=torch.float32, device=table.device)
    S.solve(M[M_SRC], dt, tol, rest, density_type, write_perr, max_iters, stats, 0)
    return M, stats


def hybrid_solve_ref(csr: PairCSR, table, scal, *, max_iters: int, mp: float,
                     den_with_div: bool, w2020: bool = False):
    """Plain version of `hybrid_solve`."""
    S = _Plain(csr, table, mp, w2020)
    T, M = table, S.M
    dt, tol_div, tol_den, rest = scal[0], scal[1], scal[2], scal[3]
    stats = torch.zeros(16, dtype=torch.float32, device=table.device)
    M[M_VX], M[M_VY] = T[T_VX0], T[T_VY0]
    S.init_pressure(T_P0DIV)
    M[M_SRC] = -S.div_at(T[T_VX0], T[T_VY0]) / dt
    S.solve(M[M_SRC], dt, tol_div, rest, False, False, max_iters, stats, 8)
    M[M_VX] = M[M_VX] + dt * M[M_AX]
    M[M_VY] = M[M_VY] + dt * M[M_AY]
    M[M_PDIV] = M[M_P]
    S.init_pressure(T_P0)
    if den_with_div:
        M[M_SRC] = T[T_SRC] - S.div_at(M[M_VX], M[M_VY]) / dt
    else:
        M[M_SRC] = T[T_SRC]
    S.solve(M[M_SRC], dt, tol_den, rest, True, True, max_iters, stats, 0)
    return M, stats


def _launch(kind: str, csr: PairCSR, table, scal, n_stats: int, mp: float, max_iters: int,
            w2020: bool, flags):
    dev = table.device
    C = table.shape[1]
    P = csr.num_pairs
    _check(table, "table", torch.float32, (T_ROWS, C), dev)
    _check(scal, "scal", torch.float32, (4,), dev)
    _check(csr.row_ptr, "row_ptr", torch.int32, (C + 1,), dev)
    _check(csr.col, "col", torch.int32, (P,), dev)
    _check(csr.w, "w", STORAGE_DTYPES, (2, P), dev)
    sms, smem_max = solve_device(dev)
    grid = solve_grid(C, sms)
    smem = solve_smem_bytes(C, grid, w2020)
    if smem > smem_max:
        raise RuntimeError(f"{kind}: {C} rows over {grid} blocks need {smem} bytes of shared "
                           f"memory per block, more than the device's {smem_max}")
    # zeros: a solve leaves the rows it does not use (jacobi_solve: M_VX, M_VY,
    # M_PDIV) as the plain version does
    M = torch.zeros(M_ROWS, C, dtype=torch.float32, device=dev)
    part = torch.empty(grid, 4, dtype=torch.float32, device=dev)
    stats = torch.empty(n_stats, dtype=torch.float32, device=dev)
    lib = _native.load()
    fn = lib.asph_pair_jacobi if kind == "pair_jacobi" else lib.asph_pair_hybrid
    _native.check(fn(_ptr(csr.row_ptr), _ptr(csr.col), _ptr(csr.w),
                     int(csr.w.dtype == torch.bfloat16), P, C, _ptr(table), _ptr(M), _ptr(part),
                     grid, smem, _ptr(stats), _ptr(scal), float(mp), int(max_iters), int(w2020),
                     *flags, _stream(dev)), kind)
    launches[kind] += 1
    if w2020:
        launches[kind + ":w2020"] += 1
    return M, stats


def jacobi_solve(csr: PairCSR, table, scal, *, density_type: bool, max_iters: int, mp: float,
                 write_perr: bool = True, src_from_div: bool = False, w2020: bool = False):
    """One whole relaxed-Jacobi pressure solve and its final acceleration.

    density_type: the density-error residual (else the divergence error);
    write_perr: keep the predicted density error in M_PERR; src_from_div: the
    source is T_SRC - div(T_VX0, T_VY0) * T_OMGI / dt, computed in the solve
    (else T_SRC); w2020: the Winchenbach2020 divergence (module docstring).
    Returns (M, stats (8,))."""
    if _device_kind(table) == "cpu":
        return jacobi_solve_ref(csr, table, scal, density_type=density_type,
                                max_iters=max_iters, mp=mp, write_perr=write_perr,
                                src_from_div=src_from_div, w2020=w2020)
    return _launch("pair_jacobi", csr, table, scal, 8, mp, max_iters, w2020,
                   (int(density_type), int(write_perr), int(src_from_div)))


def hybrid_solve(csr: PairCSR, table, scal, *, max_iters: int, mp: float, den_with_div: bool,
                 w2020: bool = False):
    """The whole HybridDFSPH solver section: divergence source -div(v0)/dt,
    divergence solve from T_P0DIV, v += dt a, density source T_SRC [-
    div(v)/dt], density solve from T_P0. Returns (M, stats (16,)): M_P, M_AX,
    M_AY, M_PERR of the density solve, M_PDIV the divergence pressure, M_VX,
    M_VY the post-divergence velocities, M_SRC the density source; w2020: the
    Winchenbach2020 divergence."""
    if _device_kind(table) == "cpu":
        return hybrid_solve_ref(csr, table, scal, max_iters=max_iters, mp=mp,
                                den_with_div=den_with_div, w2020=w2020)
    return _launch("pair_hybrid", csr, table, scal, 16, mp, max_iters, w2020,
                   (int(den_with_div),))
