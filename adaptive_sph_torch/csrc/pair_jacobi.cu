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
// Design. The TPU kernel keeps the pair weights and its per-row state
// resident in VMEM and loops inside one kernel. Here one cooperative launch
// holds BLOCKS_PER_SM blocks of THREADS threads on each SM, and block b owns
// the contiguous rows [b C / grid, (b + 1) C / grid) for the whole launch:
// prologue, every phase and epilogue. A block keeps its rows' read-only
// columns (NCOL below), their p, u, acceleration, source and predicted error
// and their row pointers in shared memory, loaded once per launch; only u,
// ax, ay (and the hybrid's v), which other blocks gather, are published in M
// and read back with __ldcg. The CSR list is read-only for the whole launch
// and is loaded with __ldg, so a block's slice may stay in its SM's L1
// across sweeps. A row is walked by a segment of G lanes: each lane takes
// the row's pairs G apart, K at a time with all their loads (col, w, then
// the gathered operands) in flight together, and the segment reduces with
// __shfl_xor_sync inside itself, so every lane holds the sums; the row's
// epilogue then reads shared memory (one broadcast serves the warp's 32 / G
// rows) and its stores are split over the segment's lanes. A phase walks
// the block's rows in passes of one row per segment. Rows of any length
// work; the stress scene's are 10.6 pairs long on average, 13 at most.
//
// A Jacobi iteration is an update phase (div(a), the pressure update, the
// block's statistics in part), a grid sync, an accel phase, the exit test,
// and a grid sync unless the solve ends. Both branches of the exit test run
// the accel phase (the next sweep's, or the final acceleration), so every
// block starts it right after the sync, in warps 1 and up, while warp 0
// reduces the grid's partials (lane l adds blocks l, l + 32, ... in order,
// then a butterfly). Every block reduces them in the same order and so
// takes the same branch; the partials are rewritten only after the next
// grid sync, which no block reaches before it has read them. No float
// atomics: the iteration count and every output are the same from launch to
// launch. Elementwise arithmetic uses _rn intrinsics in the plain version's
// order (no contraction into FMAs).
//
// What bounds it on the H100: per sweep the function needs each pair once
// (4 B col + 4-8 B w, one gathered float per component) and 8 float32
// operations per pair: at the stress scene's 151,409 pairs ~1.8 MB (0.5 us
// at the HBM rate, less from L2) and 1.2 MFLOP. What it costs instead: two
// grid syncs and the exit test, ~3.8 us per sweep on an empty list, and per
// phase a block's passes of dependent loads (row pointer from shared
// memory, col, then the gathered operand from L2).
//
// The shape was chosen by editing the constants below one at a time in a
// copy and timing each copy with scripts/torch_port_walk_times.py --solves
// against the tree of the moment in one call (device us per sweep: the
// 200-iteration synthetic solve on the stress scene at x1 / x4 and the
// impact scene's solves; NVIDIA H100 80GB HBM3, 700.00 W; PERF.md §6):
//   before K (one pair per lane in flight), warp 0 walking accel rows:
//     G = 8, 1,024 threads, 1 block per SM              7.1 / 16.4-16.6 / 6.1
//     G = 4                                              7.0 / 11.9 / 6.7-6.9
//     G = 16                                             7.4 / 16.6 / 4.9-5.0
//     512 threads                                        8.8 / 22.3 / 5.8-6.0
//     2 blocks of 512 per SM                             7.7 / 16.6 / 6.5-6.7
//     4 blocks of 256 per SM (528 blocks)                8.9 / 18.2 / 7.4-7.8
//   with K, warp 0 reducing during accel:
//     G = 8, K = 2                                  5.4 / 11.0-11.1 / 4.4-4.6
//     G = 4, K = 4                                        5.2 / 8.8 / 4.8-5.0
//     G = 4, K = 2                                       6.0 / 11.5 / 5.8-6.4
//     G = 8, K = 4                                       5.6 / 13.0 / 4.8-5.0
//     G = 16, K = 1                                      6.8 / 16.3 / 4.4-4.5
//     G = 16, K = 2                                      6.9 / 16.7 / 4.5-4.6
//   as below (G = 4, K = 4, 1,024 threads, 1 per SM):
//                                           5.05-5.09 / 8.63-8.72 / 4.66-4.80
//     2 blocks of 512 per SM                              5.5 / 8.6 / 5.2-5.4
//     512 threads, 1 block per SM                    5.2-5.3 / 12.0 / 4.5-4.9
//     an arrive/wait barrier (red.release,
//       ld.acquire on a counter) for grid.sync   4.95 / 8.61-8.91 / 4.29-4.53
//   the parent (a warp per row, 528-660 blocks)    18.4 / 38.2-38.3 / 5.2-5.6
// Short rows favour few lanes with many loads in flight; more rows in
// flight per pass (G = 4) is what x4 (411 rows per block) needs. The
// hand-written barrier gains 2% at x1 and nothing at x4, and would need a
// counter zeroed before each launch, so grid_group::sync stays. At 1,024
// threads a thread has 64 registers: ptxas spills 136 B in pair_jacobi (its
// runtime flags), none in pair_hybrid; the 512-thread build spills nothing
// (128 registers) and is no faster at x1, so the spills cost nothing
// measurable.
//
// Every entry point launches on the given stream, allocates nothing, does not
// synchronise, and returns the launch status (0 on success; a launch that
// needs more shared memory than the device gives a block, or more blocks
// than can be resident, is refused with its CUDA error, never worked around).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;  // threads per block
constexpr int BLOCKS_PER_SM = 1;  // the cooperative grid: this many blocks per SM
constexpr int G = 4;  // lanes per CSR row
constexpr int K = 4;  // pairs per lane whose loads are in flight together
constexpr int WARPS = THREADS / 32;
constexpr int NPART = 4;  // per-block statistics: normal, sum pred, max |pred|, negative
constexpr unsigned FULL = 0xffffffffu;
static_assert(G == 4 || G == 8 || G == 16, "a row's segment is 4, 8 or 16 lanes");
static_assert(THREADS % 32 == 0 && WARPS >= 2 && WARPS <= 32,
              "warp 0 reduces one partial per warp while the others walk rows");

// rows of T and M, and stats indices (ops/jacobi.py)
enum {
  T_SRC, T_WAII, T_NSING, T_RINV, T_GXP, T_GYP, T_S1X, T_S1Y, T_BDX, T_BDY,
  T_ALIVE, T_P0, T_RHO, T_P0DIV, T_VX0, T_VY0, T_OMGI, T_ROWS
};
enum { M_P, M_U, M_AX, M_AY, M_PERR, M_SRC, M_VX, M_VY, M_PDIV, M_ROWS };
enum { S_ITERS, S_AVG, S_MAX, S_NORMAL, S_NEG, S_GRID = 7 };
// the block's shared-memory columns, one float per owned row each
enum {
  C_S1X, C_S1Y, C_GXP, C_GYP, C_BDX, C_BDY, C_RINV, C_NSING, C_ALIVE, C_WAII, C_RHO,
  C_P, C_U, C_AX, C_AY, C_SRC, C_PERR, NCOL
};
// shared words before the columns: per-warp partials and the exit flag
constexpr int FIXED_WORDS = WARPS * NPART + 4;

// rows per block (the column stride), and block b's first row
__host__ __device__ __forceinline__ int rows_per_block(int C, int grid) {
  return (C + grid - 1) / grid;
}
__host__ __device__ __forceinline__ int row_begin(int C, int grid, int b) {
  return static_cast<int>(static_cast<long long>(b) * C / grid);
}
// dynamic shared memory of a launch: the fixed words, NCOL columns and the
// row pointers of rows_per_block rows, in 16-byte units
long long smem_bytes(int C, int grid) {
  const long long rows = rows_per_block(C, grid);
  const long long words = FIXED_WORDS + NCOL * rows + rows + 1;
  return (words * 4 + 15) / 16 * 16;
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float dvd(float a, float b) { return __fdiv_rn(a, b); }

__device__ __forceinline__ float load_w(const float* p, long long i) { return __ldg(p + i); }
__device__ __forceinline__ float load_w(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(__ldg(p + i));
}

// a gathered operand: read-only T through the non-coherent path, M (written
// by other blocks in this launch) through L2
template <bool RO>
__device__ __forceinline__ float gather(const float* p, int j) {
  return RO ? __ldg(p + j) : __ldcg(p + j);
}

// the sum over a row's segment of G lanes; every lane of the segment gets it
__device__ __forceinline__ float seg_sum(float v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off, G);
  return v;
}

// the sum over the segments' first lanes (the others hold 0), in lane 0
__device__ __forceinline__ float leaders_sum(float v) {
#pragma unroll
  for (int off = 16; off >= G; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float leaders_max(float v) {
#pragma unroll
  for (int off = 16; off >= G; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
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
  float* sh;    // (WARPS, NPART) per-warp partials
  int* flag;    // the exit test's outcome
  float* sc;    // NCOL columns of `rows` floats
  int* rp;      // row_ptr of the owned rows and the one after
  int lo, n, rows, lane, sl;

  __device__ Solver(const Args& args, float* smem)
      : a(args), w(static_cast<const W*>(args.w)) {
    rows = rows_per_block(a.C, gridDim.x);
    lo = row_begin(a.C, gridDim.x, blockIdx.x);
    n = row_begin(a.C, gridDim.x, blockIdx.x + 1) - lo;
    sh = smem;
    flag = reinterpret_cast<int*>(smem + WARPS * NPART);
    sc = smem + FIXED_WORDS;
    rp = reinterpret_cast<int*>(sc + NCOL * rows);
    lane = threadIdx.x & 31;
    sl = lane & (G - 1);
  }

  __device__ float& s(int k, int r) const { return sc[k * rows + r]; }
  __device__ const float* t(int k) const { return a.T + (size_t)k * a.C; }
  __device__ float tv(int k, int i) const { return __ldg(a.T + (size_t)k * a.C + i); }
  __device__ float* m(int k) const { return a.M + (size_t)k * a.C; }

  // f(r, active) for the owned rows r, one segment per row, in passes of
  // the segments of warps FIRST and up. The trip count is the same for all
  // segments of a warp, so every lane reaches the segment shuffles inside
  // f; a segment past the last row is inactive.
  template <int FIRST = 0, typename F>
  __device__ void for_rows(F&& f) const {
    const int warp = threadIdx.x >> 5;
    if (warp < FIRST) return;
    for (int r0 = (warp - FIRST) * (32 / G); r0 < n; r0 += (WARPS - FIRST) * (32 / G)) {
      const int r = r0 + lane / G;
      f(r, r < n);
    }
  }

  // the CSR range of row r (empty for an inactive segment)
  __device__ void range(int r, bool act, int& beg, int& end) const {
    beg = act ? rp[r] : 0;
    end = act ? rp[r + 1] : 0;
  }

  // this lane's next K pairs of a row from e0 on (stride G): columns (-1
  // past the row's end) and weights, all loads issued together
  __device__ void batch(int e0, int end, int (&j)[K], float (&wx)[K], float (&wy)[K]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e = e0 + k * G;
      j[k] = e < end ? __ldg(a.col + e) : -1;
      wx[k] = e < end ? load_w(w, e) : 0.0f;
      wy[k] = e < end ? load_w(w, a.P + e) : 0.0f;
    }
  }

  // the owned rows' columns, row pointers and warm start from T row `warm`
  // (u published in M_U), predicted error 0; ends with a block barrier
  __device__ void load_rows(int warm) const {
    for (int r = threadIdx.x; r < n; r += THREADS) {
      const int i = lo + r;
      s(C_S1X, r) = tv(T_S1X, i);
      s(C_S1Y, r) = tv(T_S1Y, i);
      s(C_GXP, r) = tv(T_GXP, i);
      s(C_GYP, r) = tv(T_GYP, i);
      s(C_BDX, r) = tv(T_BDX, i);
      s(C_BDY, r) = tv(T_BDY, i);
      s(C_NSING, r) = tv(T_NSING, i);
      s(C_ALIVE, r) = tv(T_ALIVE, i);
      s(C_WAII, r) = tv(T_WAII, i);
      s(C_RHO, r) = tv(T_RHO, i);
      const float ri = tv(T_RINV, i);
      s(C_RINV, r) = ri;
      warm_start(r, warm, ri);
      s(C_PERR, r) = 0.0f;
      m(M_PERR)[i] = 0.0f;
    }
    for (int r = threadIdx.x; r <= n; r += THREADS) rp[r] = __ldg(a.row_ptr + lo + r);
    __syncthreads();
  }

  // p and u = p / rho^2 of row r from T row `warm`; u published in M_U
  __device__ void warm_start(int r, int warm, float ri) const {
    const float p = tv(warm, lo + r);
    const float u = mul(mul(p, ri), ri);
    s(C_P, r) = p;
    s(C_U, r) = u;
    m(M_U)[lo + r] = u;
  }

  // the source of row r (all lanes call; lane 0 of the segment stores)
  __device__ void put_src(int r, float src) const {
    if (sl == 0) {
      s(C_SRC, r) = src;
      m(M_SRC)[lo + r] = src;
    }
  }

  // sum_j (wx_ij tx_j + wy_ij ty_j) over row r; every lane of the segment
  // gets the sum (an inactive segment walks no pairs)
  template <bool RO>
  __device__ float row_div(int r, bool act, const float* tx, const float* ty) const {
    int beg, end;
    range(r, act, beg, end);
    float acc = 0.0f;
    for (int e0 = beg + sl; e0 < end; e0 += K * G) {
      int j[K];
      float wx[K], wy[K], gx[K], gy[K];
      batch(e0, end, j, wx, wy);
#pragma unroll
      for (int k = 0; k < K; ++k) {
        gx[k] = j[k] >= 0 ? gather<RO>(tx, j[k]) : 0.0f;
        gy[k] = j[k] >= 0 ? gather<RO>(ty, j[k]) : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (j[k] >= 0) acc += wx[k] * gx[k] + wy[k] * gy[k];
    }
    return seg_sum(acc);
  }

  // the divergence operator at row r from the walked sum td and the row's
  // own field value (x, y): (td - t_i . S1_i) / rho_i - t_i . (bdx, bdy)_i
  __device__ float div_at(int r, float td, float x, float y) const {
    const float bdiv = -add(mul(x, s(C_BDX, r)), mul(y, s(C_BDY, r)));
    const float self = add(mul(x, s(C_S1X, r)), mul(y, s(C_S1Y, r)));
    return add(mul(sub(td, self), s(C_RINV, r)), bdiv);
  }

  // ax = -u S1x - sum_j wx_ij u_j + gxp * (-(u + mp p)), the same for y;
  // lane 0 of the segment finishes x, lane 1 y. Warp 0 walks no rows: it is
  // free for the exit test's reduction meanwhile.
  __device__ void accel_phase() const {
    const float* u = m(M_U);
    for_rows<1>([&](int r, bool act) {
      int beg, end;
      range(r, act, beg, end);
      float x = 0.0f, y = 0.0f;
      for (int e0 = beg + sl; e0 < end; e0 += K * G) {
        int j[K];
        float wx[K], wy[K], uj[K];
        batch(e0, end, j, wx, wy);
#pragma unroll
        for (int k = 0; k < K; ++k) uj[k] = j[k] >= 0 ? __ldcg(u + j[k]) : 0.0f;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          if (j[k] < 0) continue;
          x += wx[k] * uj[k];
          y += wy[k] * uj[k];
        }
      }
      x = seg_sum(x);
      y = seg_sum(y);
      if (!act || sl > 1) return;
      const float ui = s(C_U, r);
      const float coeff = -add(ui, mul(a.mp, s(C_P, r)));
      const int k = sl == 0 ? C_AX : C_AY;
      const float acc = add(sub(mul(-ui, s(sl == 0 ? C_S1X : C_S1Y, r)), sl == 0 ? x : y),
                            mul(s(sl == 0 ? C_GXP : C_GYP, r), coeff));
      s(k, r) = acc;
      m(sl == 0 ? M_AX : M_AY)[lo + r] = acc;
    });
  }

  // div(a), the pressure update, and this block's statistics in part
  __device__ void update_phase(float dt, bool density_type) const {
    float nn = 0.0f, sp = 0.0f, mx = 0.0f, ng = 0.0f;
    for_rows([&](int r, bool act) {
      const float td = row_div<false>(r, act, m(M_AX), m(M_AY));
      float p2 = 0.0f, pred = 0.0f, an = 0.0f;
      bool clamped = false;
      if (act) {
        const float res = sub(s(C_SRC, r), div_at(r, td, s(C_AX, r), s(C_AY, r)));
        const float nsing = s(C_NSING, r);
        const float p1 = mul(add(s(C_P, r), mul(s(C_WAII, r), res)), nsing);
        pred = density_type ? mul(mul(s(C_RHO, r), mul(dt, dt)), res) : mul(dt, res);
        clamped = p1 <= 0.0f;
        p2 = clamped ? 0.0f : p1;
        an = mul(s(C_ALIVE, r), nsing);
      }
      __syncwarp();  // the segment has read p before it is overwritten
      if (!act) return;
      if (sl == 0) {
        s(C_P, r) = p2;
        s(C_PERR, r) = pred;
        const float normal = mul(an, clamped ? 0.0f : 1.0f);
        nn += normal;
        sp += normal > 0.0f ? pred : 0.0f;
        mx = fmaxf(mx, normal > 0.0f ? fabsf(pred) : 0.0f);
        ng += mul(an, clamped ? 1.0f : 0.0f);
      } else if (sl == 1) {
        const float ri = s(C_RINV, r);
        const float u2 = mul(mul(p2, ri), ri);
        s(C_U, r) = u2;
        m(M_U)[lo + r] = u2;
      }
    });
    // block partials: the segments' first lanes within each warp, then warp
    // 0 over the warps; no atomics
    const int warp = threadIdx.x >> 5;
    nn = leaders_sum(nn);
    sp = leaders_sum(sp);
    mx = leaders_max(mx);
    ng = leaders_sum(ng);
    if (lane == 0) {
      sh[warp * NPART + 0] = nn;
      sh[warp * NPART + 1] = sp;
      sh[warp * NPART + 2] = mx;
      sh[warp * NPART + 3] = ng;
    }
    __syncthreads();
    if (warp == 0) {
      const bool has = lane < WARPS;
      const float b0 = warp_sum(has ? sh[lane * NPART + 0] : 0.0f);
      const float b1 = warp_sum(has ? sh[lane * NPART + 1] : 0.0f);
      const float b2 = warp_max(has ? sh[lane * NPART + 2] : 0.0f);
      const float b3 = warp_sum(has ? sh[lane * NPART + 3] : 0.0f);
      if (lane == 0) reinterpret_cast<float4*>(a.part)[blockIdx.x] = make_float4(b0, b1, b2, b3);
    }
  }

  // warp 0: the grid totals of part, lane l adding blocks l, l + 32, ... in
  // order, then the butterfly; every lane of the warp gets them
  __device__ float4 totals() const {
    const float4* p = reinterpret_cast<const float4*>(a.part);
    float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
    for (int b = lane; b < (int)gridDim.x; b += 32) {
      const float4 v = __ldcg(p + b);
      t.x += v.x;
      t.y += v.y;
      t.z = fmaxf(t.z, v.z);
      t.w += v.w;
    }
    return make_float4(warp_sum(t.x), warp_sum(t.y), warp_max(t.z), warp_sum(t.w));
  }

  // the Jacobi loop from the warm start in C_P / C_U (u published), ending
  // after the final accel phase and a block barrier (no trailing grid sync);
  // block 0 writes stats[off + S_*]
  __device__ void solve(cg::grid_group& grid, float dt, float tol, float rest, bool density_type,
                        int off) const {
    accel_phase();
    grid.sync();
    for (int iters = 0;; ++iters) {
      update_phase(dt, density_type);
      grid.sync();
      // the next sweep's accel phase or the final one (both branches run it)
      // in warps 1 and up, the exit test's reduction in warp 0
      accel_phase();
      if (threadIdx.x < 32) {
        const float4 tot = totals();
        const float nn = tot.x;
        const float avg = nn > 0.0f ? dvd(tot.y, fmaxf(nn, 1.0f)) : __int_as_float(0x7fc00000);
        const bool ok = density_type ? fabsf(dvd(avg, rest)) < tol : fabsf(avg) < dvd(tol, dt);
        const bool conv = (nn == 0.0f) || ok;
        const bool done = (conv && iters > 1) || iters == a.max_iters;
        if (lane == 0) {
          *flag = done;
          if (done && blockIdx.x == 0) {
            a.stats[off + S_ITERS] = (float)iters;
            a.stats[off + S_AVG] = avg;
            a.stats[off + S_MAX] = tot.z;
            a.stats[off + S_NORMAL] = nn;
            a.stats[off + S_NEG] = tot.w;
          }
        }
      }
      __syncthreads();
      if (*flag) break;
      grid.sync();
    }
  }

  // the owned rows' pressure (and predicted error) to M row k
  __device__ void store_pressure(int k, bool perr) const {
    for (int r = threadIdx.x; r < n; r += THREADS) {
      m(k)[lo + r] = s(C_P, r);
      if (perr) m(M_PERR)[lo + r] = s(C_PERR, r);
    }
  }
};

template <typename W>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) pair_jacobi_kernel(Args args) {
  extern __shared__ float4 smem[];
  cg::grid_group grid = cg::this_grid();
  const Solver<W> S(args, reinterpret_cast<float*>(smem));
  const Args& a = S.a;
  const float dt = a.scal[0], tol = a.scal[1], rest = a.scal[2];

  S.load_rows(T_P0);
  if (a.src_from_div) {
    // src = T_SRC - div(v0) * (1 / Omega) / dt (IISPH, OnlyDivergence)
    S.for_rows([&](int r, bool act) {
      const float td = S.template row_div<true>(r, act, S.t(T_VX0), S.t(T_VY0));
      if (!act) return;
      const int i = S.lo + r;
      const float ap = S.div_at(r, td, S.tv(T_VX0, i), S.tv(T_VY0, i));
      S.put_src(r, sub(S.tv(T_SRC, i), dvd(mul(ap, S.tv(T_OMGI, i)), dt)));
    });
  } else {
    for (int r = threadIdx.x; r < S.n; r += THREADS) {
      S.s(C_SRC, r) = S.tv(T_SRC, S.lo + r);
      S.m(M_SRC)[S.lo + r] = S.s(C_SRC, r);
    }
  }
  grid.sync();
  S.solve(grid, dt, tol, rest, a.density_type != 0, 0);
  S.store_pressure(M_P, a.write_perr != 0);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    a.stats[5] = a.stats[6] = 0.0f;
    a.stats[S_GRID] = (float)gridDim.x;
  }
}

template <typename W>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM) pair_hybrid_kernel(Args args) {
  extern __shared__ float4 smem[];
  cg::grid_group grid = cg::this_grid();
  const Solver<W> S(args, reinterpret_cast<float*>(smem));
  const Args& a = S.a;
  const float dt = a.scal[0], tol_div = a.scal[1], tol_den = a.scal[2], rest = a.scal[3];

  // velocities, divergence warm start, divergence source -div(v)/dt
  for (int r = threadIdx.x; r < S.n; r += THREADS) {
    S.m(M_VX)[S.lo + r] = S.tv(T_VX0, S.lo + r);
    S.m(M_VY)[S.lo + r] = S.tv(T_VY0, S.lo + r);
  }
  S.load_rows(T_P0DIV);
  S.for_rows([&](int r, bool act) {
    const float td = S.template row_div<true>(r, act, S.t(T_VX0), S.t(T_VY0));
    if (!act) return;
    const int i = S.lo + r;
    const float ap = S.div_at(r, td, S.tv(T_VX0, i), S.tv(T_VY0, i));
    if (S.sl == 0) S.s(C_SRC, r) = dvd(-ap, dt);
  });
  grid.sync();
  S.solve(grid, dt, tol_div, rest, false, 8);
  grid.sync();  // other blocks' final accel phases still gather M_U
  // v += dt a_div; keep the divergence pressure; density warm start
  for (int r = threadIdx.x; r < S.n; r += THREADS) {
    const int i = S.lo + r;
    S.m(M_VX)[i] = add(S.tv(T_VX0, i), mul(dt, S.s(C_AX, r)));
    S.m(M_VY)[i] = add(S.tv(T_VY0, i), mul(dt, S.s(C_AY, r)));
    S.m(M_PDIV)[i] = S.s(C_P, r);
    S.warm_start(r, T_P0, S.s(C_RINV, r));
    if (!a.den_with_div) {
      S.s(C_SRC, r) = S.tv(T_SRC, i);
      S.m(M_SRC)[i] = S.s(C_SRC, r);
    }
  }
  grid.sync();
  if (a.den_with_div) {
    // density source: src0 - div(v)/dt
    S.for_rows([&](int r, bool act) {
      const float td = S.template row_div<false>(r, act, S.m(M_VX), S.m(M_VY));
      if (!act) return;
      const int i = S.lo + r;
      const float ap = S.div_at(r, td, __ldcg(S.m(M_VX) + i), __ldcg(S.m(M_VY) + i));
      S.put_src(r, sub(S.tv(T_SRC, i), dvd(ap, dt)));
    });
  }
  S.solve(grid, dt, tol_den, rest, true, 0);
  S.store_pressure(M_P, true);
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    for (int k = 5; k < 16; ++k)
      if (k < 8 || k > 12) a.stats[k] = 0.0f;
    a.stats[S_GRID] = (float)gridDim.x;
  }
}

// the device's SMs and the most dynamic shared memory a block of these
// kernels may take, queried once (the port runs on one device)
struct Device {
  int err;
  int sms;
  int smem_max;
};

const void* kernel_of(bool hybrid, bool bf16) {
  if (hybrid)
    return bf16 ? reinterpret_cast<const void*>(pair_hybrid_kernel<__nv_bfloat16>)
                : reinterpret_cast<const void*>(pair_hybrid_kernel<float>);
  return bf16 ? reinterpret_cast<const void*>(pair_jacobi_kernel<__nv_bfloat16>)
              : reinterpret_cast<const void*>(pair_jacobi_kernel<float>);
}

Device query_device() {
  int dev = 0, coop = 0, sms = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && !coop) e = cudaErrorNotSupported;
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  int smem_max = optin;
  for (int k = 0; k < 4 && e == cudaSuccess; ++k) {
    cudaFuncAttributes fa;
    const void* kernel = kernel_of(k & 1, k & 2);
    e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) break;
    const int dyn = optin - static_cast<int>(fa.sharedSizeBytes);
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    smem_max = dyn < smem_max ? dyn : smem_max;
  }
  return {static_cast<int>(e), sms, smem_max};
}

const Device& device() {
  static const Device d = query_device();
  return d;
}

// the cooperative launch over `grid` blocks with `smem` bytes each (both
// from the wrapper, checked here); refused unless every block can be
// resident at once
template <bool HYBRID, typename W>
int launch(Args& args, int grid, long long smem, void* stream) {
  const void* kernel = kernel_of(HYBRID, sizeof(W) == 2);
  const Device& d = device();
  if (d.err != 0) return d.err;
  if (args.C == 0) return 0;
  if (grid < 1 || grid > args.C || smem < smem_bytes(args.C, grid) || smem > d.smem_max)
    return static_cast<int>(cudaErrorInvalidValue);
  // blocks per SM at this smem, kept for the last smem asked
  static long long last_smem = -1;
  static int per_sm = 0;
  if (smem != last_smem) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                                  static_cast<size_t>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    last_smem = smem;
  }
  if (per_sm * d.sms < grid) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  void* params[] = {&args};
  cudaError_t r = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(THREADS), params,
                                              static_cast<size_t>(smem),
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

// the launch shape: [THREADS, G, BLOCKS_PER_SM, NCOL, FIXED_WORDS]
// (ops/jacobi.py mirrors it to size the grid and the shared memory)
void asph_solve_shape(int* out) {
  out[0] = THREADS;
  out[1] = G;
  out[2] = BLOCKS_PER_SM;
  out[3] = NCOL;
  out[4] = FIXED_WORDS;
}

// the current device's SM count and the most dynamic shared memory a block
// of the solve kernels may take; returns a CUDA error code
int asph_solve_device(int* sms, int* smem_max) {
  const Device& d = device();
  *sms = d.sms;
  *smem_max = d.smem_max;
  return d.err;
}

// grid: the cooperative grid in blocks, at most C (part holds grid rows of
// 4); smem: the dynamic shared memory per block, at least smem_bytes(C, grid)
int asph_pair_jacobi(const int* row_ptr, const int* col, const void* w, int wbf16, long long P,
                     int C, const float* T, float* M, float* part, int grid, long long smem,
                     float* stats, const float* scal, float mp, int max_iters, int density_type,
                     int write_perr, int src_from_div, void* stream) {
  Args a = make_args(row_ptr, col, w, P, C, T, M, part, stats, scal, mp, max_iters);
  a.density_type = density_type;
  a.write_perr = write_perr;
  a.src_from_div = src_from_div;
  if (wbf16) return launch<false, __nv_bfloat16>(a, grid, smem, stream);
  return launch<false, float>(a, grid, smem, stream);
}

int asph_pair_hybrid(const int* row_ptr, const int* col, const void* w, int wbf16, long long P,
                     int C, const float* T, float* M, float* part, int grid, long long smem,
                     float* stats, const float* scal, float mp, int max_iters, int den_with_div,
                     void* stream) {
  Args a = make_args(row_ptr, col, w, P, C, T, M, part, stats, scal, mp, max_iters);
  a.den_with_div = den_with_div;
  if (wbf16) return launch<true, __nv_bfloat16>(a, grid, smem, stream);
  return launch<true, float>(a, grid, smem, stream);
}

}  // extern "C"
