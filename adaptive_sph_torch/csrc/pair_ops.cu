// Pair kernels of the HybridDFSPH tile step, written for Hopper (sm_90a).
//
// The per-step pair set is stored as a compact CSR list per query row, in
// sorted-slot order: row_ptr (C+1) int32, col (P) int32, w (2, P) = m_j grad
// W_ij (x row, then y row) and s (2, P) = the rho-free ApproxLaplace
// viscosity pair factors B * w_ij, each in float32 or bfloat16. Sums always
// accumulate in float32.
//
// K1 pair_build (asph_pair_count + asph_pair_fill) replaces
//   adaptive_sph_tpu/ops/pallas_matvec.py::build_weight_cache_prep
//   -> _build_prep_kernel in its two modes: mega (fused density sum,
//   optional viscosity stream; prep rows s1x, s1y, s1sq, density) and classic
//   (candidate table with rho, no stream; prep rows s1x, s1y, s1sq, s2x, s2y,
//   s2sq = the same sums over w / rho_j, and the inline ApproxLaplace
//   viscosity visc_x, visc_y). The mode is a template flag of one walk.
//   The walk is csrc/tile_walk.cuh: one warp per query row, lanes on 32
//   consecutive candidate slots of the tile's window ranges at a time, each
//   testing its pair with the reference's exact mask. Two passes over the
//   same walk: the count pass writes per-row pair counts (the host turns
//   them into row_ptr and sizes the outputs exactly, so the list cannot
//   overflow and the reference's wcache_overflow is always 0); the fill pass
//   writes each group's in-radius lanes compacted by ballot rank, so a row's
//   entries stay in ascending slot order, and adds the 4 or 8 prep sums in
//   that order (ordered_sum). Cost on the H100: the function's bound is the
//   ~3 MB it writes (the ~0.15M pairs inside the radius need few
//   operations), but the walk tests every candidate of the tile's windows
//   (~6.4M on the stress scene), and the rows of the tile holding the few
//   coarse particles test the whole scene each: those rows are split in two
//   pieces (tile_walk.cuh), whose pair counts the count pass hands to the
//   fill pass, and whose prep sums are added in piece order.
//   Registers per thread (ptxas -v for sm_90a, logged by chip_smoke.py phase
//   1): 40 in the count passes, 53 in the weights-only fill, 59-64 in the
//   mega and classic fills; the two-row mega-with-viscosity and the
//   classic fills spill 12-16 B.
//
// K2 pair_matvec (asph_pair_matvec) replaces
//   pallas_matvec.py::weight_matvec -> _matvec_kernel.
//   accel mode: out = (sum_j wx_ij u_j, sum_j wy_ij u_j);
//   div mode:   out = sum_j (wx_ij tx_j + wy_ij ty_j).
//   One warp per row: lanes stride the row's segment, gather the operand at
//   col, reduce with warp shuffles. Bound: memory (8-12 bytes of pair list +
//   one gathered float per pair); a long coarse row spreads over 32 lanes
//   instead of serialising one thread. The ~3 MB list fits in the 50 MB L2.
//
// K3 pair_visc (asph_pair_visc) replaces
//   pallas_matvec.py::visc_matvec -> _visc_kernel.
//   out = (sum_j sx_ij / max(rho_i + rho_j, 1e-30), same for sy), same
//   warp-per-row shape and bound as K2.
//
// Scalar-g storage (K1's `scalar` flag, mega modes only) replaces the v7
//   scalar blocks of build_weight_cache_prep(scalar=True): the fill pass
//   stores g = m_j |grad W_ij| / r (P) and, with viscosity, sg = B g (P)
//   instead of the two rows of w and s; the prep sums are unchanged.
// K2s pair_matvec_scalar (asph_pair_matvec_scalar) replaces
//   pallas_matvec.py::_scalar_weight_matvec -> _scalar_matvec_kernel, and K3s
//   pair_visc_scalar (asph_pair_visc_scalar) replaces _scalar_visc_matvec ->
//   _scalar_visc_kernel. Warp per row as K2/K3; each pair reads g (or sg)
//   and col and gathers x_j, y_j from the sorted table K1 walked; x_i, y_i
//   are read once per row. wx = g (x_i - x_j) is rounded as K1 rounded its
//   stored wx, so in float32 K2s equals K2 bit for bit. Bound: memory, 4-6
//   bytes of pair list per pair instead of 8-12, plus an 8-byte gather from
//   a table that stays in L2; the coarse rows' serial walks are the same.
// K1's weights-only mode (asph_pair_count / asph_pair_fill with mode
//   WEIGHTS; wrapper pair_weights) replaces pallas_matvec.py::
//   build_weight_cache -> _build_kernel: the (C, 4) table [x, y, h, m], w in
//   float32 and no prep sums. Its w is mega mode's w bit for bit.
// Probe instances of K2 / K2s (python -m adaptive_sph_torch.probe):
//   asph_pair_matvec_probe replaces scripts/matvec_probe.py::make_kernel
//   (pallas_call at :237): K2 with an ablation flag (NOGATHER for its
//   noslice, NOMUL for its nodot); asph_pair_matvec_scalar_probe replaces
//   scripts/matvec_probe2.py::_scalar_kernel (:169): K2s with 32, 64, 128 or
//   256 pairs of a warp in flight per loop step, the card's counterpart of
//   the script's window height. Both are template instances of K2's one
//   kernel body; BASE at 32 pairs is the step's K2 / K2s instance itself.
//
// Every entry point launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tile_walk.cuh"

namespace {

constexpr int ROWS_PER_BLOCK = 8;  // K2/K3: one warp per row, 8 warps per block
// 7 * pi rounded once to float32, as the reference computes it
constexpr float SEVEN_PI = static_cast<float>(7.0 * 3.141592653589793);

__device__ __forceinline__ float load_w(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_w(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_w(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store_w(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float cubic(float q) {
  const float v = 1.0f - q;
  const float inner = 6.0f * (q * q * q - q * q) + 1.0f;
  const float outer = 2.0f * v * v * v;
  return q < 0.5f ? inner : (q < 1.0f ? outer : 0.0f);
}

__device__ __forceinline__ float cubic_deriv(float q) {
  const float v = 1.0f - q;
  const float inner = 18.0f * q * q - 12.0f * q;
  const float outer = -6.0f * v * v;
  return q < 0.5f ? inner : (q < 1.0f ? outer : 0.0f);
}

// K1 modes: the mega walk without or with the viscosity stream, the
// classic walk (candidate table with rho, s2 and inline viscosity rows) and
// the weights-only walk (candidate table [x, y, h, m], no prep sums)
enum BuildMode { MEGA = 0, MEGA_VISC = 1, CLASSIC = 2, WEIGHTS = 3 };

// One query row of K1 on the tile walk (tile_walk.cuh). SCALAR (mega
// modes): w holds g (P) and s holds B g (P) instead of two rows.
template <bool FILL, int MODE, bool SCALAR, typename W>
struct BuildRow {
  static_assert(!SCALAR || MODE == MEGA || MODE == MEGA_VISC, "scalar-g: mega modes only");
  // candidate columns: x, y, h, m, vx, vy (mega), x, y, h, m, rho, vx, vy
  // (classic) or x, y, h, m (weights-only)
  static constexpr int NF = MODE == CLASSIC ? 7 : (MODE == WEIGHTS ? 4 : 6);
  static constexpr int VX = MODE == CLASSIC ? 5 : 4;
  // prep sums: s1x, s1y, s1sq, then density (mega) or s2x, s2y, s2sq,
  // visc_x, visc_y (classic)
  static constexpr int NPREP = MODE == CLASSIC ? 8 : (MODE == WEIGHTS ? 0 : 4);
  struct Geo {
    float dx, dy, r2, h_ij;
  };

  const float* flat;
  float scale, visc;
  int* col;
  W* w;
  W* s;
  long long P;
  float qx, qy, qh, qvx, qvy, qrho;
  long long e = 0;  // fill pass: this row's next entry
  int n = 0;        // count pass: this row's pairs
  float acc[NPREP > 0 ? NPREP : 1] = {};

  __device__ __forceinline__ bool test(float cx, float cy, float ch, Geo& g) const {
    g.h_ij = fmaxf(0.5f * (qh + ch), 1e-6f);
    g.dx = qx - cx;
    g.dy = qy - cy;
    // the pair mask is discrete: no contraction into FMAs, so it agrees bit
    // for bit with the plain version
    g.r2 = __fadd_rn(__fmul_rn(g.dx, g.dx), __fmul_rn(g.dy, g.dy));
    const float rad = scale * g.h_ij;
    return g.r2 < __fmul_rn(rad, rad) && ch > 0.0f;
  }

  __device__ __forceinline__ void take(int cj, const Geo& gm, bool in, unsigned m) {
    if (!FILL) {
      n += __popc(m);
      return;
    }
    float v[NPREP > 0 ? NPREP : 1] = {};
    if (in) {
      const float* c = flat + (size_t)cj * NF;
      const float dx = gm.dx, dy = gm.dy, r2 = gm.r2, h_ij = gm.h_ij;
      const float cm = c[3];
      const float r = sqrtf(fmaxf(r2, 1e-30f));
      const float two_h = 2.0f * h_ij;
      const float qq = r / two_h;
      const float norm = 10.0f / (SEVEN_PI * (h_ij * h_ij));
      const float mag = norm * cubic_deriv(qq) / two_h;
      const float gmag = qq > 1.0e-5f ? mag / r : 0.0f;
      const float g = cm * gmag;
      // rounded products, not contracted into the sums: K2s rebuilds exactly
      // these from g
      const float wx = __fmul_rn(g, dx);
      const float wy = __fmul_rn(g, dy);
      const long long ei = e + tile_walk::lane_rank(m);
      col[ei] = cj;
      if (SCALAR) {
        store_w(w, ei, g);
      } else {
        store_w(w, ei, wx);
        store_w(w, P + ei, wy);
      }
      if (MODE != WEIGHTS) {
        const float inv_m = 1.0f / fmaxf(cm, 1e-30f);
        const float t2 = (wx * wx + wy * wy) * inv_m;
        v[0] = wx;
        v[1] = wy;
        v[2] = t2;
        if (MODE != CLASSIC) {
          v[3] = cm * (norm * cubic(qq));
        } else {
          const float inv_rho = 1.0f / fmaxf(c[4], 1e-30f);
          v[3] = wx * inv_rho;
          v[4] = wy * inv_rho;
          v[5] = t2 * inv_rho;
        }
        if (MODE != MEGA) {
          const float dvx = qvx - c[VX];
          const float dvy = qvy - c[VX + 1];
          const float dot = __fadd_rn(__fmul_rn(dx, dvx), __fmul_rn(dy, dvy));
          if (MODE == MEGA_VISC) {
            // rho-free factor B; the stream divides by rho_i + rho_j
            float B = visc * dot / (r2 + 0.01f * h_ij * h_ij);
            B = dot < 0.0f ? B : 0.0f;
            if (SCALAR) {
              store_w(s, ei, B * g);
            } else {
              store_w(s, ei, B * wx);
              store_w(s, P + ei, B * wy);
            }
          } else {
            // ApproxLaplace inline: nu 2(D+2) dot / (r2 + 0.01 h^2) / rho_ij
            const float rho_ij = fmaxf((qrho + c[4]) * 0.5f, 1e-30f);
            float coef = visc * (8.0f * dot / (r2 + 0.01f * h_ij * h_ij) / rho_ij);
            coef = dot < 0.0f ? coef : 0.0f;
            v[6] = coef * wx;
            v[7] = coef * wy;
          }
        }
      }
    }
    if (NPREP > 0) tile_walk::ordered_sum<NPREP>(acc, v, m);
    e += __popc(m);
  }
};

// pieces: (C, S) int32, the pair counts of a split row's pieces, written by
// the count pass and read by the fill pass (rows that are not split leave
// theirs untouched)
template <bool FILL, int MODE, bool SCALAR, typename W>
__global__ void __launch_bounds__(tile_walk::BLOCK)
    pair_build_kernel(const int* __restrict__ cell_starts, const int* __restrict__ wm, int nl,
                      int tq, int C, const float* __restrict__ flat, float scale, float visc,
                      int* __restrict__ counts, int* __restrict__ pieces,
                      const int* __restrict__ row_ptr, int* __restrict__ col, W* __restrict__ w,
                      W* __restrict__ s, long long P, float* __restrict__ prep) {
  using Row = BuildRow<FILL, MODE, SCALAR, W>;
  constexpr int NP = Row::NPREP > 0 ? Row::NPREP : 1;
  constexpr int S = tile_walk::S;
  __shared__ float part[tile_walk::WARPS][NP];
  __shared__ int part_n[tile_walk::WARPS];
  const int q = tile_walk::row();
  const bool valid = q < C;
  const float* qr = flat + (size_t)(valid ? q : 0) * Row::NF;
  Row b{flat, scale, visc, col, w, s, P, qr[0], qr[1], qr[2],
        MODE == WEIGHTS ? 0.0f : qr[Row::VX], MODE == WEIGHTS ? 0.0f : qr[Row::VX + 1],
        MODE == CLASSIC ? qr[4] : 0.0f};
  const int t = q / tq;
  const tile_walk::RowPlan plan =
      tile_walk::plan_row(cell_starts, wm, nl, t, valid && b.qh > 0.0f);
  if (plan.E > plan.A) {
    if (FILL) {
      b.e = row_ptr[q];
      if (plan.split)
        for (int k = 0; k < tile_walk::piece(); ++k) b.e += pieces[(size_t)q * S + k];
    }
    tile_walk::walk_row<Row::NF>(cell_starts, wm, nl, t, plan.A, plan.E, flat, b);
  }
  // the row's pieces, added in piece order by its first warp
  const int wi = tile_walk::warp();
  if (tile_walk::lane() == 0) {
    part_n[wi] = b.n;
#pragma unroll
    for (int k = 0; k < NP; ++k) part[wi][k] = b.acc[k];
  }
  __syncthreads();
  if (!valid || tile_walk::piece() != 0 || tile_walk::lane() != 0) return;
  int n = part_n[wi];
  float acc[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) acc[k] = part[wi][k];
  if (plan.split) {
    for (int j = 1; j < S; ++j) {
      n += part_n[wi + j];
#pragma unroll
      for (int k = 0; k < NP; ++k) acc[k] = __fadd_rn(acc[k], part[wi + j][k]);
    }
  }
  if (FILL) {
#pragma unroll
    for (int k = 0; k < Row::NPREP; ++k) prep[k * (size_t)C + q] = acc[k];
  } else {
    counts[q] = n;
    if (plan.split)
      for (int j = 0; j < S; ++j) pieces[(size_t)q * S + j] = part_n[wi + j];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// The pair weights of entry e of a row: read from the two stored rows (K2,
// K3) or rebuilt from the stored scalar and the sorted positions (K2s, K3s)
template <typename W>
struct StoredPair {
  const W* v;  // (2, P)
  long long P;
  __device__ __forceinline__ void begin(int) {}
  __device__ __forceinline__ void at(long long e, int, float& x, float& y) const {
    x = load_w(v, e);
    y = load_w(v, P + e);
  }
};

template <typename W>
struct ScalarPair {
  const W* v;          // (P,) g or B g
  const float* table;  // the table K1 walked, (C, F), x and y first
  int F;
  float xi, yi;
  __device__ __forceinline__ void begin(int row) {
    xi = table[(size_t)row * F];
    yi = table[(size_t)row * F + 1];
  }
  // K1's rounding: g * (x_i - x_j), one rounded subtraction and product
  __device__ __forceinline__ void at(long long e, int j, float& x, float& y) const {
    const float g = load_w(v, e);
    x = __fmul_rn(g, __fsub_rn(xi, table[(size_t)j * F]));
    y = __fmul_rn(g, __fsub_rn(yi, table[(size_t)j * F + 1]));
  }
};

// K2 probe ablations (adaptive_sph_torch.probe; K2 itself is BASE):
// NOGATHER reads t at the row's own slot instead of t[col] (isolates the
// gather), NOMUL sums the weights with no t (isolates the operand reads and
// products). Both still load col, so the pair list streams as in BASE.
enum MatvecAblation { BASE = 0, NOGATHER = 1, NOMUL = 2 };

// K2 / K2s. The sums are written with explicit fused operations so that
// both storages accumulate the same products in the same way. D pairs per
// lane are in flight per loop step: their loads are issued first, then
// their products summed in the order of e (beg + lane, +32, +64, ...), so
// every D gives the same bits. The step's K2 and K2s are <BASE, 1>; the
// probe's `wh` is 32 D.
template <bool DIV, int ABL, int D, typename Pair>
__global__ void pair_matvec_kernel(const int* __restrict__ row_ptr,
                                   const int* __restrict__ col, Pair pw, int C,
                                   const float* __restrict__ t0,
                                   const float* __restrict__ t1,
                                   float* __restrict__ out0,
                                   float* __restrict__ out1) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= C) return;  // whole warps leave together
  const int beg = row_ptr[row], end = row_ptr[row + 1];
  pw.begin(row);
  float a0 = 0.0f, a1 = 0.0f;
  for (int e0 = beg + lane; e0 < end; e0 += 32 * D) {
    float wx[D], wy[D], v0[D], v1[D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const int e = e0 + 32 * k;
      wx[k] = wy[k] = v0[k] = v1[k] = 0.0f;
      if (D == 1 || e < end) {
        const int j = col[e];
        if (ABL != BASE) asm volatile("" : : "r"(j));  // keep the col load
        pw.at(e, j, wx[k], wy[k]);
        const int src = ABL == NOGATHER ? row : j;
        if (ABL != NOMUL) {
          v0[k] = t0[src];
          if (DIV) v1[k] = t1[src];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < D; ++k) {
      if (D > 1 && e0 + 32 * k >= end) break;
      if (ABL == NOMUL) {
        if (DIV) {
          a0 = __fadd_rn(a0, __fadd_rn(wx[k], wy[k]));
        } else {
          a0 = __fadd_rn(a0, wx[k]);
          a1 = __fadd_rn(a1, wy[k]);
        }
      } else if (DIV) {
        a0 = __fadd_rn(a0, __fmaf_rn(wx[k], v0[k], __fmul_rn(wy[k], v1[k])));
      } else {
        a0 = __fmaf_rn(wx[k], v0[k], a0);
        a1 = __fmaf_rn(wy[k], v0[k], a1);
      }
    }
  }
  a0 = warp_sum(a0);
  if (!DIV) a1 = warp_sum(a1);
  if (lane == 0) {
    out0[row] = a0;
    if (!DIV) out1[row] = a1;
  }
}

// K3 / K3s: (s_ij or (B g)_ij (x_i - x_j)) times 1 / max(rho_i + rho_j, 1e-30)
template <typename Pair>
__global__ void pair_visc_kernel(const int* __restrict__ row_ptr,
                                 const int* __restrict__ col, Pair pw, int C,
                                 const float* __restrict__ rho,
                                 float* __restrict__ out0,
                                 float* __restrict__ out1) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= C) return;
  const int beg = row_ptr[row], end = row_ptr[row + 1];
  pw.begin(row);
  const float ri = rho[row];
  float a0 = 0.0f, a1 = 0.0f;
  for (int e = beg + lane; e < end; e += 32) {
    const int j = col[e];
    const float inv = 1.0f / fmaxf(rho[j] + ri, 1e-30f);
    float sx, sy;
    pw.at(e, j, sx, sy);
    a0 = __fmaf_rn(sx, inv, a0);
    a1 = __fmaf_rn(sy, inv, a1);
  }
  a0 = warp_sum(a0);
  a1 = warp_sum(a1);
  if (lane == 0) {
    out0[row] = a0;
    out1[row] = a1;
  }
}

template <int ABL = BASE, int D = 1, typename Pair>
void launch_matvec(Pair pw, const int* row_ptr, const int* col, int C, const float* t0,
                   const float* t1, int div, float* out0, float* out1, cudaStream_t st) {
  const int grid = (C + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, block = 32 * ROWS_PER_BLOCK;
  if (div)
    pair_matvec_kernel<true, ABL, D>
        <<<grid, block, 0, st>>>(row_ptr, col, pw, C, t0, t1, out0, out1);
  else
    pair_matvec_kernel<false, ABL, D>
        <<<grid, block, 0, st>>>(row_ptr, col, pw, C, t0, t1, out0, out1);
}

// the probe's K2 ablation (MatvecAblation) at one pair per lane
template <typename Pair>
int launch_matvec_probe(int variant, Pair pw, const int* row_ptr, const int* col, int C,
                        const float* t0, const float* t1, int div, float* out0, float* out1,
                        cudaStream_t st) {
  if (variant == BASE)
    launch_matvec<BASE>(pw, row_ptr, col, C, t0, t1, div, out0, out1, st);
  else if (variant == NOGATHER)
    launch_matvec<NOGATHER>(pw, row_ptr, col, C, t0, t1, div, out0, out1, st);
  else if (variant == NOMUL)
    launch_matvec<NOMUL>(pw, row_ptr, col, C, t0, t1, div, out0, out1, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// the probe's K2s with wh = 32 D pairs of a warp in flight per loop step
template <typename Pair>
int launch_matvec_wh(int wh, Pair pw, const int* row_ptr, const int* col, int C,
                     const float* t0, const float* t1, int div, float* out0, float* out1,
                     cudaStream_t st) {
  if (wh == 32)
    launch_matvec<BASE, 1>(pw, row_ptr, col, C, t0, t1, div, out0, out1, st);
  else if (wh == 64)
    launch_matvec<BASE, 2>(pw, row_ptr, col, C, t0, t1, div, out0, out1, st);
  else if (wh == 128)
    launch_matvec<BASE, 4>(pw, row_ptr, col, C, t0, t1, div, out0, out1, st);
  else if (wh == 256)
    launch_matvec<BASE, 8>(pw, row_ptr, col, C, t0, t1, div, out0, out1, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename Pair>
void launch_visc(Pair pw, const int* row_ptr, const int* col, int C, const float* rho,
                 float* out0, float* out1, cudaStream_t st) {
  const int grid = (C + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK, block = 32 * ROWS_PER_BLOCK;
  pair_visc_kernel<<<grid, block, 0, st>>>(row_ptr, col, pw, C, rho, out0, out1);
}

template <bool FILL, int MODE, bool SCALAR, typename W>
void launch_build(const int* cs, const int* wm, int nt, int nl, int tq, const float* flat,
                  float scale, float visc, int* counts, int* pieces, const int* row_ptr,
                  int* col, void* w, void* s, long long P, float* prep, cudaStream_t st) {
  const int C = nt * tq;
  if (C == 0) return;
  pair_build_kernel<FILL, MODE, SCALAR, W><<<tile_walk::grid(C), tile_walk::BLOCK, 0, st>>>(
      cs, wm, nl, tq, C, flat, scale, visc, counts, pieces, row_ptr, col, static_cast<W*>(w),
      static_cast<W*>(s), P, prep);
}

template <bool SCALAR, typename W>
void launch_fill(int mode, const int* cs, const int* wm, int nt, int nl, int tq,
                 const float* flat, float scale, float visc, int* pieces, const int* row_ptr,
                 int* col, void* w, void* s, long long P, float* prep, cudaStream_t st) {
  if (mode == MEGA_VISC)
    launch_build<true, MEGA_VISC, SCALAR, W>(cs, wm, nt, nl, tq, flat, scale, visc, nullptr,
                                             pieces, row_ptr, col, w, s, P, prep, st);
  else
    launch_build<true, MEGA, SCALAR, W>(cs, wm, nt, nl, tq, flat, scale, visc, nullptr,
                                        pieces, row_ptr, col, w, s, P, prep, st);
}

}  // namespace

extern "C" {

// mode: 0 mega, 1 mega with the viscosity stream, 2 classic, 3 weights-only
// (BuildMode); visc: 2 nu 8 (the stream's factor) or nu (classic), unused in
// modes 0 and 3. pieces: (C, PIECES) int32 scratch that the count pass hands
// to the fill pass. The walk's split: asph_pair_pieces() = PIECES warps per
// row, and a row is split when its tile holds more than asph_pair_split_min()
// candidates
int asph_pair_pieces() { return tile_walk::S; }

int asph_pair_split_min() { return tile_walk::SPLIT_MIN; }

int asph_pair_count(const int* cell_starts, const int* wm, int nt, int nl, int tq,
                    const float* flat, int mode, float scale, int* counts, int* pieces,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == CLASSIC)
    launch_build<false, CLASSIC, false, float>(cell_starts, wm, nt, nl, tq, flat, scale, 0.0f,
                                               counts, pieces, nullptr, nullptr, nullptr, nullptr,
                                               0, nullptr, st);
  else if (mode == WEIGHTS)
    launch_build<false, WEIGHTS, false, float>(cell_starts, wm, nt, nl, tq, flat, scale, 0.0f,
                                               counts, pieces, nullptr, nullptr, nullptr, nullptr,
                                               0, nullptr, st);
  else
    launch_build<false, MEGA, false, float>(cell_starts, wm, nt, nl, tq, flat, scale, 0.0f,
                                            counts, pieces, nullptr, nullptr, nullptr, nullptr, 0,
                                            nullptr, st);
  return static_cast<int>(cudaGetLastError());
}

// scalar: store g and B g (P each) instead of w and s (2, P each); mega
// modes only. The weights-only mode stores float32 w only.
int asph_pair_fill(const int* cell_starts, const int* wm, int nt, int nl, int tq,
                   const float* flat, int mode, int scalar, float scale, float visc, int wbf16,
                   int* pieces, const int* row_ptr, int* col, void* w, void* s, long long P,
                   float* prep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode < MEGA || mode > WEIGHTS) return static_cast<int>(cudaErrorInvalidValue);
  if (scalar && mode != MEGA && mode != MEGA_VISC)
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode == WEIGHTS) {
    if (wbf16) return static_cast<int>(cudaErrorInvalidValue);
    launch_build<true, WEIGHTS, false, float>(cell_starts, wm, nt, nl, tq, flat, scale, visc,
                                              nullptr, pieces, row_ptr, col, w, s, P, prep, st);
  } else if (mode == CLASSIC) {
    if (wbf16)
      launch_build<true, CLASSIC, false, __nv_bfloat16>(cell_starts, wm, nt, nl, tq, flat, scale,
                                                        visc, nullptr, pieces, row_ptr, col, w,
                                                        s, P, prep, st);
    else
      launch_build<true, CLASSIC, false, float>(cell_starts, wm, nt, nl, tq, flat, scale, visc,
                                                nullptr, pieces, row_ptr, col, w, s, P, prep,
                                                st);
  } else if (scalar) {
    if (wbf16)
      launch_fill<true, __nv_bfloat16>(mode, cell_starts, wm, nt, nl, tq, flat, scale, visc,
                                       pieces, row_ptr, col, w, s, P, prep, st);
    else
      launch_fill<true, float>(mode, cell_starts, wm, nt, nl, tq, flat, scale, visc, pieces,
                               row_ptr, col, w, s, P, prep, st);
  } else {
    if (wbf16)
      launch_fill<false, __nv_bfloat16>(mode, cell_starts, wm, nt, nl, tq, flat, scale, visc,
                                        pieces, row_ptr, col, w, s, P, prep, st);
    else
      launch_fill<false, float>(mode, cell_starts, wm, nt, nl, tq, flat, scale, visc, pieces,
                                row_ptr, col, w, s, P, prep, st);
  }
  return static_cast<int>(cudaGetLastError());
}

int asph_pair_matvec(const int* row_ptr, const int* col, const void* w, int wbf16,
                     long long P, int C, const float* t0, const float* t1, int div,
                     float* out0, float* out1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 0) return 0;
  if (wbf16)
    launch_matvec(StoredPair<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(w), P}, row_ptr,
                  col, C, t0, t1, div, out0, out1, st);
  else
    launch_matvec(StoredPair<float>{static_cast<const float*>(w), P}, row_ptr, col, C, t0, t1,
                  div, out0, out1, st);
  return static_cast<int>(cudaGetLastError());
}

// table: the (C, F) float32 table the pair list was built from (x, y first)
int asph_pair_matvec_scalar(const int* row_ptr, const int* col, const void* g, int wbf16,
                            int C, const float* table, int F, const float* t0, const float* t1,
                            int div, float* out0, float* out1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 0) return 0;
  if (wbf16)
    launch_matvec(ScalarPair<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(g), table, F},
                  row_ptr, col, C, t0, t1, div, out0, out1, st);
  else
    launch_matvec(ScalarPair<float>{static_cast<const float*>(g), table, F}, row_ptr, col, C,
                  t0, t1, div, out0, out1, st);
  return static_cast<int>(cudaGetLastError());
}

// K2 with a probe ablation: variant 0 BASE (K2), 1 NOGATHER, 2 NOMUL
int asph_pair_matvec_probe(const int* row_ptr, const int* col, const void* w, int wbf16,
                           long long P, int C, const float* t0, const float* t1, int div,
                           int variant, float* out0, float* out1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 0) return 0;
  if (wbf16)
    return launch_matvec_probe(variant,
                               StoredPair<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(w), P},
                               row_ptr, col, C, t0, t1, div, out0, out1, st);
  return launch_matvec_probe(variant, StoredPair<float>{static_cast<const float*>(w), P}, row_ptr,
                             col, C, t0, t1, div, out0, out1, st);
}

// K2s with wh in {32, 64, 128, 256} pairs of a warp in flight per loop step
int asph_pair_matvec_scalar_probe(const int* row_ptr, const int* col, const void* g, int wbf16,
                                  int C, const float* table, int F, const float* t0,
                                  const float* t1, int div, int wh, float* out0, float* out1,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 0) return 0;
  if (wbf16)
    return launch_matvec_wh(
        wh, ScalarPair<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(g), table, F}, row_ptr,
        col, C, t0, t1, div, out0, out1, st);
  return launch_matvec_wh(wh, ScalarPair<float>{static_cast<const float*>(g), table, F}, row_ptr,
                          col, C, t0, t1, div, out0, out1, st);
}

int asph_pair_visc(const int* row_ptr, const int* col, const void* s, int wbf16, long long P,
                   int C, const float* rho, float* out0, float* out1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 0) return 0;
  if (wbf16)
    launch_visc(StoredPair<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(s), P}, row_ptr,
                col, C, rho, out0, out1, st);
  else
    launch_visc(StoredPair<float>{static_cast<const float*>(s), P}, row_ptr, col, C, rho, out0,
                out1, st);
  return static_cast<int>(cudaGetLastError());
}

int asph_pair_visc_scalar(const int* row_ptr, const int* col, const void* sg, int wbf16, int C,
                          const float* table, int F, const float* rho, float* out0, float* out1,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 0) return 0;
  if (wbf16)
    launch_visc(ScalarPair<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(sg), table, F},
                row_ptr, col, C, rho, out0, out1, st);
  else
    launch_visc(ScalarPair<float>{static_cast<const float*>(sg), table, F}, row_ptr, col, C, rho,
                out0, out1, st);
  return static_cast<int>(cudaGetLastError());
}

const char* asph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
