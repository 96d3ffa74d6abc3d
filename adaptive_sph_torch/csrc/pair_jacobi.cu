// Whole-solve relaxed-Jacobi kernels over the CSR pair list, written for
// Hopper (sm_90a): one cooperative launch runs a whole pressure solve.
//
// pair_jacobi (asph_pair_jacobi) replaces
//   adaptive_sph_tpu/ops/pallas_jacobi.py::jacobi_solve -> _jacobi_kernel:
//   one relaxed-Jacobi solve (optionally with its source computed in the
//   kernel as src0 - div(v0) / Omega / dt), its exit test, and the final
//   pressure acceleration.
// pair_hybrid (asph_pair_hybrid) replaces
//   pallas_jacobi.py::hybrid_solve -> _hybrid_kernel: the whole HybridDFSPH
//   solver section. Divergence source -div(v)/dt, divergence solve, velocity
//   kick v += dt a, density source (src0 [- div(v)/dt]), density solve.
//
// Semantics are those of models/tile_physics.py::tile_jacobi without momentum
// (the reference kernel has none): at least two sweeps, at most max_iters + 1
// (the reported count stops at max_iters), the clamp to p >= 0, singular rows
// pinned to zero, avg = NaN when no row is normal, statistics masked with
// selects (never multiplied by a 0/1 mask).
//
// Layout (ops/jacobi.py): T (T_ROWS, C) read-only per-row columns, M
// (M_ROWS, C) the mutable and output columns, scal (4,) float32 on the device
// ([dt, tol, rest, 0] or [dt, tol_div, tol_den, rest]: dt is never read on
// the host), the CSR list row_ptr / col / w (2, P) in float32 or bfloat16
// (sums in float32), part (grid, 4) per-block statistics, stats (8 or 16;
// stats[S_GRID] is the launch's cooperative grid in blocks).
//
// Design. The TPU kernel keeps the pair weights resident in VMEM and loops
// inside one kernel; here one cooperative launch holds every block resident
// on the card and phases are separated by cooperative_groups grid syncs. The
// CSR list (~1.9 MB float32 on the stress scene) and the per-row columns
// (~1 MB) stay in the 50 MB L2 across sweeps, which plays the part of VMEM.
// Each phase walks rows grid-stride, one warp per CSR row as in K2: lanes
// stride the row's pairs, gather the operand at col (read through L2 with
// __ldcg: the operands change between phases, so no non-coherent or L1 copy
// may be read), and reduce with warp shuffles; lane 0 finishes the row. A
// Jacobi iteration is two phases (accel, then div + pressure update +
// statistics), two grid syncs, and the exit test: after the second sync
// every block reduces the same per-block partials in the same fixed order and
// takes the same branch. No float atomics, so the iteration count does not
// change from call to call. Elementwise arithmetic uses _rn intrinsics in the
// plain version's order (no contraction into FMAs).
//
// What bounds it on the H100: per sweep the function needs each pair once
// (4 B col + 4-8 B w, and one gathered float per component) and ~8 float32
// operations per pair: ~2-3 MB per sweep from L2, far under a microsecond at
// the HBM rate. What it costs instead: the grid syncs (two per iteration) and
// the longest row, whose warp walks it serially (a coarse particle's row of
// thousands of pairs on the stress scene) while the other warps wait at the
// next sync. Splitting long rows across warps is the known next step.
//
// Every entry point launches on the given stream, allocates nothing, does not
// synchronise, and returns the launch status (0 on success; a
// cudaErrorCooperativeLaunchTooLarge or cudaErrorNotSupported is returned, never
// worked around).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 8;  // warps per block; one CSR row per warp
constexpr int THREADS = 32 * WARPS;
constexpr int NPART = 4;  // per-block statistics: normal, sum pred, max |pred|, negative

// rows of T and M, and stats indices (ops/jacobi.py)
enum {
  T_SRC, T_WAII, T_NSING, T_RINV, T_GXP, T_GYP, T_S1X, T_S1Y, T_BDX, T_BDY,
  T_ALIVE, T_P0, T_RHO, T_P0DIV, T_VX0, T_VY0, T_OMGI, T_ROWS
};
enum { M_P, M_U, M_AX, M_AY, M_PERR, M_SRC, M_VX, M_VY, M_PDIV, M_ROWS };
enum { S_ITERS, S_AVG, S_MAX, S_NORMAL, S_NEG, S_GRID = 7 };

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float load_w(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_w(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

__device__ __forceinline__ float warp_allsum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

struct Args {
  const int* row_ptr;
  const int* col;
  const void* w;
  long long P;
  int C;
  const float* T;      // (T_ROWS, C)
  float* M;            // (M_ROWS, C)
  float* part;         // (gridDim.x, NPART)
  float* stats;        // (8) or (16)
  const float* scal;   // (4)
  float mp;            // boundary mirror coefficient (0 on the ported path)
  int max_iters;
  int density_type;    // jacobi: 1 density error, 0 divergence error
  int write_perr;      // jacobi: write the predicted density error
  int src_from_div;    // jacobi: src = T_SRC - div(v0) * T_OMGI / dt
  int den_with_div;    // hybrid: density source minus div(v) / dt
};

template <typename W>
struct Solver {
  const Args a;
  const W* w;
  int lane, gwarp, nwarps;

  __device__ Solver(const Args& args)
      : a(args), w(static_cast<const W*>(args.w)) {
    lane = threadIdx.x & 31;
    gwarp = blockIdx.x * WARPS + (threadIdx.x >> 5);
    nwarps = gridDim.x * WARPS;
  }

  __device__ const float* t(int k) const { return a.T + (size_t)k * a.C; }
  __device__ float* m(int k) const { return a.M + (size_t)k * a.C; }
  __device__ float tv(int k, int i) const { return a.T[(size_t)k * a.C + i]; }
  __device__ float mv(int k, int i) const { return __ldcg(a.M + (size_t)k * a.C + i); }

  // (sum_j wx_ij u_j, sum_j wy_ij u_j) over row i; every lane gets the sums
  __device__ void row_accel(int i, const float* u, float& sx, float& sy) const {
    const int beg = a.row_ptr[i], end = a.row_ptr[i + 1];
    float x = 0.0f, y = 0.0f;
    for (int e = beg + lane; e < end; e += 32) {
      const float uj = __ldcg(u + a.col[e]);
      x += load_w(w, e) * uj;
      y += load_w(w, a.P + e) * uj;
    }
    sx = warp_allsum(x);
    sy = warp_allsum(y);
  }

  // sum_j (wx_ij tx_j + wy_ij ty_j) over row i
  __device__ float row_div(int i, const float* tx, const float* ty) const {
    const int beg = a.row_ptr[i], end = a.row_ptr[i + 1];
    float s = 0.0f;
    for (int e = beg + lane; e < end; e += 32) {
      const int j = a.col[e];
      s += load_w(w, e) * __ldcg(tx + j) + load_w(w, a.P + e) * __ldcg(ty + j);
    }
    return warp_allsum(s);
  }

  // the divergence operator at row i of the field (tx, ty):
  // (sum_j w_ij . t_j - t_i . S1_i) / rho_i - t_i . (bdx, bdy)_i
  __device__ float div_at(int i, const float* tx, const float* ty) const {
    const float td = row_div(i, tx, ty);
    const float x = __ldcg(tx + i), y = __ldcg(ty + i);
    const float bdiv = -add(mul(x, tv(T_BDX, i)), mul(y, tv(T_BDY, i)));
    const float self = add(mul(x, tv(T_S1X, i)), mul(y, tv(T_S1Y, i)));
    return add(mul(sub(td, self), tv(T_RINV, i)), bdiv);
  }

  // p and u = p / rho^2 from the warm start in T row k
  __device__ void init_pressure_row(int i, int k) const {
    const float p = tv(k, i), ri = tv(T_RINV, i);
    m(M_P)[i] = p;
    m(M_U)[i] = mul(mul(p, ri), ri);
  }

  // ax = -u S1x - sum_j wx_ij u_j + gxp * (-(u + mp p)), the same for y
  __device__ void accel_phase() const {
    for (int i = gwarp; i < a.C; i += nwarps) {
      float sx, sy;
      row_accel(i, m(M_U), sx, sy);
      if (lane == 0) {
        const float u = mv(M_U, i), p = mv(M_P, i);
        const float coeff = -add(u, mul(a.mp, p));
        m(M_AX)[i] = add(sub(mul(-u, tv(T_S1X, i)), sx), mul(tv(T_GXP, i), coeff));
        m(M_AY)[i] = add(sub(mul(-u, tv(T_S1Y, i)), sy), mul(tv(T_GYP, i), coeff));
      }
    }
  }

  // div(a), the pressure update and this block's statistics in part
  __device__ void update_phase(const float* src, float dt, bool density_type,
                               bool write_perr, float (*sh)[NPART]) const {
    float nn = 0.0f, sp = 0.0f, mx = 0.0f, ng = 0.0f;
    for (int i = gwarp; i < a.C; i += nwarps) {
      const float ap = div_at(i, m(M_AX), m(M_AY));
      if (lane == 0) {
        const float r = sub(__ldcg(src + i), ap);
        const float nsing = tv(T_NSING, i), alive = tv(T_ALIVE, i), ri = tv(T_RINV, i);
        const float p1 = mul(add(mv(M_P, i), mul(tv(T_WAII, i), r)), nsing);
        const float pred = density_type ? mul(mul(tv(T_RHO, i), mul(dt, dt)), r) : mul(dt, r);
        const bool clamped = p1 <= 0.0f;
        const float p2 = clamped ? 0.0f : p1;
        const float normal = mul(mul(alive, nsing), clamped ? 0.0f : 1.0f);
        m(M_P)[i] = p2;
        m(M_U)[i] = mul(mul(p2, ri), ri);
        if (write_perr) m(M_PERR)[i] = pred;
        nn += normal;
        sp += normal > 0.0f ? pred : 0.0f;
        mx = fmaxf(mx, normal > 0.0f ? fabsf(pred) : 0.0f);
        ng += mul(mul(alive, nsing), clamped ? 1.0f : 0.0f);
      }
    }
    // block partials: warps in order, no atomics
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
      sh[warp][0] = nn;
      sh[warp][1] = sp;
      sh[warp][2] = mx;
      sh[warp][3] = ng;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float b0 = 0.0f, b1 = 0.0f, b2 = 0.0f, b3 = 0.0f;
      for (int k = 0; k < WARPS; ++k) {
        b0 += sh[k][0];
        b1 += sh[k][1];
        b2 = fmaxf(b2, sh[k][2]);
        b3 += sh[k][3];
      }
      float* o = a.part + (size_t)blockIdx.x * NPART;
      o[0] = b0;
      o[1] = b1;
      o[2] = b2;
      o[3] = b3;
    }
    __syncthreads();
  }

  // the grid totals of part, reduced in one fixed order by every block
  __device__ void totals(float (*red)[NPART], float out[NPART]) const {
    float r0 = 0.0f, r1 = 0.0f, r2 = 0.0f, r3 = 0.0f;
    for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS) {
      const float* p = a.part + (size_t)b * NPART;
      r0 += __ldcg(p);
      r1 += __ldcg(p + 1);
      r2 = fmaxf(r2, __ldcg(p + 2));
      r3 += __ldcg(p + 3);
    }
    red[threadIdx.x][0] = r0;
    red[threadIdx.x][1] = r1;
    red[threadIdx.x][2] = r2;
    red[threadIdx.x][3] = r3;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
      if ((int)threadIdx.x < s) {
        red[threadIdx.x][0] += red[threadIdx.x + s][0];
        red[threadIdx.x][1] += red[threadIdx.x + s][1];
        red[threadIdx.x][2] = fmaxf(red[threadIdx.x][2], red[threadIdx.x + s][2]);
        red[threadIdx.x][3] += red[threadIdx.x + s][3];
      }
      __syncthreads();
    }
    for (int k = 0; k < NPART; ++k) out[k] = red[0][k];
    __syncthreads();  // red is reused by the next call
  }

  // the Jacobi loop from the current M_P / M_U, then the final accel phase;
  // writes stats[off + S_*] from block 0. Ends after the final accel phase
  // (no trailing grid sync).
  __device__ void solve(cg::grid_group& grid, const float* src, float dt, float tol, float rest,
                        bool density_type, bool write_perr, int off, float (*sh)[NPART],
                        float (*red)[NPART]) const {
    int iters = 0;
    float tot[NPART];
    float avg;
    for (;;) {
      accel_phase();
      grid.sync();
      update_phase(src, dt, density_type, write_perr, sh);
      grid.sync();
      totals(red, tot);
      const float nn = tot[0];
      avg = nn > 0.0f ? dvd(tot[1], fmaxf(nn, 1.0f)) : __int_as_float(0x7fc00000);
      const bool ok = density_type ? fabsf(dvd(avg, rest)) < tol : fabsf(avg) < dvd(tol, dt);
      const bool conv = (nn == 0.0f) || ok;
      if ((conv && iters > 1) || iters == a.max_iters) break;
      ++iters;
    }
    accel_phase();  // the final pressure acceleration from the converged p
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      a.stats[off + S_ITERS] = (float)iters;
      a.stats[off + S_AVG] = avg;
      a.stats[off + S_MAX] = tot[2];
      a.stats[off + S_NORMAL] = tot[0];
      a.stats[off + S_NEG] = tot[3];
    }
  }
};

template <typename W>
__global__ void __launch_bounds__(THREADS) pair_jacobi_kernel(Args args) {
  __shared__ float sh[WARPS][NPART];
  __shared__ float red[THREADS][NPART];
  cg::grid_group grid = cg::this_grid();
  const Solver<W> S(args);
  const Args& a = S.a;
  const float dt = a.scal[0], tol = a.scal[1], rest = a.scal[2];

  for (int i = S.gwarp; i < a.C; i += S.nwarps) {
    if (S.lane == 0) {
      S.init_pressure_row(i, T_P0);
      S.m(M_PERR)[i] = 0.0f;
      if (!a.src_from_div) S.m(M_SRC)[i] = S.tv(T_SRC, i);
    }
    if (a.src_from_div) {
      // src = T_SRC - div(v0) * (1 / Omega) / dt (IISPH, OnlyDivergence)
      const float ap = S.div_at(i, S.t(T_VX0), S.t(T_VY0));
      if (S.lane == 0)
        S.m(M_SRC)[i] = sub(S.tv(T_SRC, i), dvd(mul(ap, S.tv(T_OMGI, i)), dt));
    }
  }
  grid.sync();
  S.solve(grid, S.m(M_SRC), dt, tol, rest, a.density_type != 0, a.write_perr != 0, 0, sh, red);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.stats[5] = a.stats[6] = 0.0f;
    a.stats[S_GRID] = (float)gridDim.x;
  }
}

template <typename W>
__global__ void __launch_bounds__(THREADS) pair_hybrid_kernel(Args args) {
  __shared__ float sh[WARPS][NPART];
  __shared__ float red[THREADS][NPART];
  cg::grid_group grid = cg::this_grid();
  const Solver<W> S(args);
  const Args& a = S.a;
  const float dt = a.scal[0], tol_div = a.scal[1], tol_den = a.scal[2], rest = a.scal[3];

  // velocities, divergence warm start, divergence source -div(v)/dt
  for (int i = S.gwarp; i < a.C; i += S.nwarps) {
    const float ap = S.div_at(i, S.t(T_VX0), S.t(T_VY0));
    if (S.lane == 0) {
      S.m(M_VX)[i] = S.tv(T_VX0, i);
      S.m(M_VY)[i] = S.tv(T_VY0, i);
      S.m(M_PERR)[i] = 0.0f;
      S.init_pressure_row(i, T_P0DIV);
      S.m(M_SRC)[i] = dvd(-ap, dt);
    }
  }
  grid.sync();
  S.solve(grid, S.m(M_SRC), dt, tol_div, rest, false, false, 8, sh, red);
  grid.sync();
  // v += dt a_div; keep the divergence pressure; density warm start
  for (int i = S.gwarp * 32 + S.lane; i < a.C; i += S.nwarps * 32) {
    S.m(M_VX)[i] = add(S.mv(M_VX, i), mul(dt, S.mv(M_AX, i)));
    S.m(M_VY)[i] = add(S.mv(M_VY, i), mul(dt, S.mv(M_AY, i)));
    S.m(M_PDIV)[i] = S.mv(M_P, i);
    S.init_pressure_row(i, T_P0);
    if (!a.den_with_div) S.m(M_SRC)[i] = S.tv(T_SRC, i);
  }
  grid.sync();
  if (a.den_with_div) {
    // density source: src0 - div(v)/dt
    for (int i = S.gwarp; i < a.C; i += S.nwarps) {
      const float ap = S.div_at(i, S.m(M_VX), S.m(M_VY));
      if (S.lane == 0) S.m(M_SRC)[i] = sub(S.tv(T_SRC, i), dvd(ap, dt));
    }
    grid.sync();
  }
  S.solve(grid, S.m(M_SRC), dt, tol_den, rest, true, true, 0, sh, red);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int k = 5; k < 16; ++k)
      if (k < 8 || k > 12) a.stats[k] = 0.0f;
    a.stats[S_GRID] = (float)gridDim.x;
  }
}

// the most blocks of `kernel` resident at once on the current device (the
// cooperative-launch attribute checked), or a CUDA error code in err
struct Residency {
  int err;
  int blocks;
};

Residency query_residency(const void* kernel) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorCooperativeLaunchTooLarge;
  return {static_cast<int>(e), per_sm * sms};
}

// queried at the first launch of each kernel and kept: the port runs on one
// device, and the residency does not depend on the launch's sizes
template <bool HYBRID, typename W>
int launch(Args& args, int part_blocks, void* stream) {
  const void* kernel = HYBRID ? reinterpret_cast<const void*>(pair_hybrid_kernel<W>)
                              : reinterpret_cast<const void*>(pair_jacobi_kernel<W>);
  static const Residency res = query_residency(kernel);
  if (res.err != 0) return res.err;
  if (args.C == 0) return 0;
  const int rows = (args.C + WARPS - 1) / WARPS;
  const int grid = res.blocks < rows ? res.blocks : rows;
  if (grid > part_blocks) return static_cast<int>(cudaErrorInvalidValue);
  void* params[] = {&args};
  cudaError_t r = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(THREADS), params, 0,
                                              static_cast<cudaStream_t>(stream));
  if (r != cudaSuccess) return static_cast<int>(r);
  return static_cast<int>(cudaGetLastError());
}

Args make_args(const int* row_ptr, const int* col, const void* w, long long P, int C,
               const float* T, float* M, float* part, float* stats, const float* scal, float mp,
               int max_iters) {
  Args a{};
  a.row_ptr = row_ptr;
  a.col = col;
  a.w = w;
  a.P = P;
  a.C = C;
  a.T = T;
  a.M = M;
  a.part = part;
  a.stats = stats;
  a.scal = scal;
  a.mp = mp;
  a.max_iters = max_iters;
  return a;
}

}  // namespace

extern "C" {

// part_blocks: rows of the (part_blocks, 4) partials scratch, at least the
// cooperative grid (ceil(C / 8) always suffices)
int asph_pair_jacobi(const int* row_ptr, const int* col, const void* w, int wbf16, long long P,
                     int C, const float* T, float* M, float* part, int part_blocks, float* stats,
                     const float* scal, float mp, int max_iters, int density_type,
                     int write_perr, int src_from_div, void* stream) {
  Args a = make_args(row_ptr, col, w, P, C, T, M, part, stats, scal, mp, max_iters);
  a.density_type = density_type;
  a.write_perr = write_perr;
  a.src_from_div = src_from_div;
  if (wbf16) return launch<false, __nv_bfloat16>(a, part_blocks, stream);
  return launch<false, float>(a, part_blocks, stream);
}

int asph_pair_hybrid(const int* row_ptr, const int* col, const void* w, int wbf16, long long P,
                     int C, const float* T, float* M, float* part, int part_blocks, float* stats,
                     const float* scal, float mp, int max_iters, int den_with_div,
                     void* stream) {
  Args a = make_args(row_ptr, col, w, P, C, T, M, part, stats, scal, mp, max_iters);
  a.den_with_div = den_with_div;
  if (wbf16) return launch<true, __nv_bfloat16>(a, part_blocks, stream);
  return launch<true, float>(a, part_blocks, stream);
}

}  // extern "C"
