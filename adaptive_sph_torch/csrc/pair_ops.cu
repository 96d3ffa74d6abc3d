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
//   viscosity visc_x, visc_y). The viscosity is ApproxLaplace's or, in the
//   modes MEGA_VISC_WCSPH / CLASSIC_WCSPH, WCSPH's (the reference's
//   visc_mode "wcsph", pallas_matvec.py:948-950 and :959-965: the stream
//   factor B = 2 nu 88 h_ij (x_ij . v_ij) / (r2 + 0.001 h_ij^2), the
//   inline -pi_ab over max(rho_i + rho_j, 1e-30)). The mode is a template
//   flag of one walk.
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
//   mega and classic fills; the two-row mega-with-viscosity fills (either
//   viscosity) spill 12 B stored / 16 B loaded, the classic fills 12-16 B
//   stored / 16-40 B loaded.
//
// K2 pair_matvec (asph_pair_matvec) replaces
//   pallas_matvec.py::weight_matvec -> _matvec_kernel.
//   accel mode: out = (sum_j wx_ij u_j, sum_j wy_ij u_j);
//   div mode:   out = sum_j (wx_ij tx_j + wy_ij ty_j).
//
// K3 pair_visc (asph_pair_visc) replaces
//   pallas_matvec.py::visc_matvec -> _visc_kernel.
//   out = (sum_j sx_ij (1 / max(rho_i + rho_j, 1e-30)), same for sy).
//
// What bounds K2 / K3 on the H100: the function moves the list once (4 B
//   col and 4-8 B of weights per pair, one gathered float per operand) and
//   the row pointers and outputs, ~1.8 MB at the stress scene's 151,409
//   pairs (0.5 us at the HBM rate, less from the 50 MB L2 where it stays
//   between launches), and does 4-7 operations per pair. What a launch
//   costs instead: its fixed cost, which grows with the blocks it starts
//   (2.5 of the 3.2 us of the parent's warp-per-row K2 at 1,792 blocks on
//   an all-empty list), and per row the dependent chain row_ptr -> col / w
//   -> t[col]. The rows are short: 12-13 pairs per live row on the stress
//   scene and the dam break (23 at most), so a warp per row left 19 or more
//   of its 32 lanes idle.
// Design (for_stream_rows): a row belongs to a segment of G lanes; a warp
//   serves 32 / G consecutive rows, whose row pointers it reads in one
//   coalesced load and hands to the segments by shuffle; an empty or padding
//   row then only stores its zeros. Lane sl of a segment takes the row's
//   entries sl, sl + G, ..., STREAM_K of them per loop step with all their
//   loads (col and weights, then the gathered operands) in flight together,
//   a slot that no lane of the segment needs skipped, so a row of up to G K
//   pairs is one round trip of the chain; rows of any length work. The
//   segment reduces with __shfl_xor_sync inside itself in a fixed order: no
//   atomics, two launches give the same bits, and every K gives the same
//   bits too (each lane adds its products in the order of e). The list, the
//   weights and the operands are read-only within a launch and read through
//   __ldg; adjacent rows' segments read adjacent entries, so a warp's col
//   and w loads stay coalesced. Two launch shapes (StreamShape), chosen per
//   launch by ops/pair_ops.py::stream_launch from C: SmallList (G = 8, 256
//   threads, 8 blocks per SM) while one wave of it covers the list, so that
//   a row of up to 32 pairs (the dam break's reach 20-23) is one pass;
//   LargeList (G = 4, 512 threads, 4 blocks per SM) beyond, whose wave holds
//   twice the rows (the stress scene at x4, 54,272 rows). The grid is one
//   block per group of THREADS / G rows, capped at one wave; a block strides
//   over the groups beyond it.
// The shapes were chosen by editing the constants in a copy and timing each
//   copy with scripts/torch_port_walk_times.py --matvec against the parent
//   in one call (device us per launch, K2 accel / K2s accel, on the stress
//   scene's lists at x1 and x4 and the dam break's at step 101; NVIDIA H100
//   80GB HBM3, 700.00 W; PERF.md §6):
//                                              x1         x4          dam
//   the parent (a warp per row, C / 8 blocks)  3.2 / 3.4  8.5 / 9.2   1.94 / 2.03
//   one shape: G = 4, K = 4, 512 threads,      2.2 / 2.7  3.5 / 4.0   2.33 / 2.9
//     4 per SM
//     256 threads, 8 per SM                    2.2 / 2.8  3.5 / 4.2   2.28 / 3.1
//     128 threads, 16 per SM                   2.2 / 2.8  3.6 / 4.1   2.30 / 3.1
//     1,024 threads, 2 per SM                  2.5 / 2.7  4.3 / 5.0   2.75 / 3.3
//     1,024 threads, 1 per SM (persistent)     2.5 / 2.8  4.1 / 4.9   2.97 / -
//     chunks dealt to the blocks in turn       2.2 / 2.6  3.7 / 5.2   2.60 / 3.1
//       (512; 256, 128 and 64 threads alike
//       or slower)
//     G = 4, K = 2                             2.3 / 3.3  3.6 / 4.3   2.34 / 3.4
//     G = 8, K = 2                             2.1 / 2.3  4.3 / 4.2   2.00 / 3.2
//     G = 8, K = 4                             2.3 / 2.7  4.3 / 5.5   2.02 / 2.4
//     slots no lane needs skipped (kept)       2.1 / 2.7  3.4 / 3.9   2.29 / 3.1
//     and G = 4, K = 8                         2.3 / 3.3  4.6 / 6.2   2.17 / 3.5
//     and G = 4, K = 8, 256 threads            2.3 / 3.4  4.0 / 6.1   1.92 / 3.4
//     and G = 8, K = 4, 256 threads            2.1 / 2.6  4.3 / 5.4   1.86 / 2.4
//   two shapes, as below                       2.1 / 2.6  3.3 / 4.0   1.87 / 2.4
//     SmallList of 128 threads                 2.3 / 2.6  3.3 / 4.0   1.86 / 2.2
//     SmallList of 512 threads                 2.2 / 2.7  3.3 / 3.9   1.91 / 2.4
//     SmallList of 64 threads                  2.7 / 3.0  3.3 / 3.9   1.95 / 2.3
//   A wave of 2,048 threads per SM holds 132 x 2,048 / G rows: at x4 only
//   G = 4 fits the list in one. A row of more than G K pairs costs a second
//   round trip, which on the dam break's list (rows of up to 20-23 pairs)
//   only G K = 32 avoids; K = 8 costs registers (57-59), and so occupancy.
//   K2s on the dam break's list stays 0.2-0.4 us slower than the parent's
//   in every shape tried (PERF.md §6).
//
// Scalar-g storage (K1's `scalar` flag, mega modes only) replaces the v7
//   scalar blocks of build_weight_cache_prep(scalar=True): the fill pass
//   stores g = m_j |grad W_ij| / r (P) and, with viscosity, sg = B g (P)
//   instead of the two rows of w and s; the prep sums are unchanged.
// K2s pair_matvec_scalar (asph_pair_matvec_scalar) replaces
//   pallas_matvec.py::_scalar_weight_matvec -> _scalar_matvec_kernel, and K3s
//   pair_visc_scalar (asph_pair_visc_scalar) replaces _scalar_visc_matvec ->
//   _scalar_visc_kernel. Template instances of K2 / K3's bodies; each pair
//   reads g (or sg) and col and gathers x_j, y_j from the sorted table K1
//   walked; x_i, y_i are read once per row and lane. wx = g (x_i - x_j) is
//   rounded as K1 rounded its stored wx, so in float32 K2s equals K2 bit for
//   bit. Bound: memory, 4-6 bytes of pair list per pair instead of 8-12,
//   plus an 8-byte gather from a table that stays in L2.
// K1's weights-only mode (asph_pair_count / asph_pair_fill with mode
//   WEIGHTS; wrapper pair_weights) replaces pallas_matvec.py::
//   build_weight_cache -> _build_kernel: the (C, 4) table [x, y, h, m], w in
//   float32 and no prep sums. Its w is mega mode's w bit for bit.
// Probe instances of K2 / K2s (python -m adaptive_sph_torch.probe):
//   asph_pair_matvec_probe replaces scripts/matvec_probe.py::make_kernel
//   (pallas_call at :237): K2 with an ablation flag (NOGATHER for its
//   noslice, NOMUL for its nodot) at the step's STREAM_K and shape;
//   asph_pair_matvec_scalar_probe replaces scripts/matvec_probe2.py::
//   _scalar_kernel (:169): K2s with wh = 32, 64, 128 or 256 pairs of a warp
//   in flight per loop step (wh / 32 per lane), the card's counterpart of
//   the script's window height. Both are template instances of K2's one
//   kernel body: BASE is the step's K2 itself, wh = 32 STREAM_K the step's
//   K2s, and every wh gives K2s's bits.
//
// Every entry point launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "tile_walk.cuh"

namespace {

// K2 / K3 launch shapes (ops/pair_ops.py mirrors them as STREAM_K and
// STREAM_SHAPES; chip_smoke.py phase 1 checks that the two agree). Every
// shape keeps STREAM_K pairs' loads in flight per lane. A segment of G
// lanes serves a CSR row, a warp 32 / G rows, a block THREADS / G rows; the
// grid holds at most BLOCKS_PER_SM blocks per SM. The wrapper takes the
// small-list shape when one wave of it covers the list (C <= SMs x 2,048 /
// 8 rows), else the large-list shape, whose wave holds twice the rows.
constexpr int STREAM_K = 4;
constexpr unsigned FULL = 0xffffffffu;

template <int G_, int THREADS_, int BLOCKS_PER_SM_>
struct StreamShape {
  static constexpr int G = G_;
  static constexpr int THREADS = THREADS_;
  static constexpr int BLOCKS_PER_SM = BLOCKS_PER_SM_;
  static constexpr int SEG_ROWS = 32 / G;        // rows per warp
  static constexpr int WARPS = THREADS / 32;     // warps per block
  static_assert(G >= 2 && G <= 16 && (G & (G - 1)) == 0, "a row's segment is 2-16 lanes");
  static_assert(THREADS % 32 == 0 && THREADS <= 1024, "whole warps per block");
};
// small lists: 8 lanes per row, so one pass takes a row of up to 32 pairs
using SmallList = StreamShape<8, 256, 8>;
// large lists: 4 lanes per row, so a wave of 2,048 threads per SM holds
// 512 rows per SM
using LargeList = StreamShape<4, 512, 4>;

// 7 * pi rounded once to float32, as the reference computes it
constexpr float SEVEN_PI = static_cast<float>(7.0 * 3.141592653589793);

// a stored weight through the read-only path, as float32
__device__ __forceinline__ float load_ro(const float* p, long long i) { return __ldg(p + i); }
__device__ __forceinline__ float load_ro(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(__ldg(p + i));
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
// the weights-only walk (candidate table [x, y, h, m], no prep sums); the
// viscosity is ApproxLaplace's, or WCSPH's in the two *_WCSPH modes
enum BuildMode {
  MEGA = 0, MEGA_VISC = 1, CLASSIC = 2, WEIGHTS = 3, MEGA_VISC_WCSPH = 4, CLASSIC_WCSPH = 5
};
__host__ __device__ constexpr bool is_classic(int mode) {
  return mode == CLASSIC || mode == CLASSIC_WCSPH;
}
__host__ __device__ constexpr bool is_stream(int mode) {
  return mode == MEGA_VISC || mode == MEGA_VISC_WCSPH;
}
__host__ __device__ constexpr bool is_wcsph(int mode) {
  return mode == MEGA_VISC_WCSPH || mode == CLASSIC_WCSPH;
}
// the WCSPH viscosity's speed of sound
constexpr float SPEED_OF_SOUND = 88.0f;

// One query row of K1 on the tile walk (tile_walk.cuh). SCALAR (mega
// modes): w holds g (P) and s holds B g (P) instead of two rows.
template <bool FILL, int MODE, bool SCALAR, typename W>
struct BuildRow {
  static_assert(!SCALAR || MODE == MEGA || is_stream(MODE), "scalar-g: mega modes only");
  // candidate columns: x, y, h, m, vx, vy (mega), x, y, h, m, rho, vx, vy
  // (classic) or x, y, h, m (weights-only)
  static constexpr int NF = is_classic(MODE) ? 7 : (MODE == WEIGHTS ? 4 : 6);
  static constexpr int VX = is_classic(MODE) ? 5 : 4;
  // prep sums: s1x, s1y, s1sq, then density (mega) or s2x, s2y, s2sq,
  // visc_x, visc_y (classic)
  static constexpr int NPREP = is_classic(MODE) ? 8 : (MODE == WEIGHTS ? 0 : 4);
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
        if (!is_classic(MODE)) {
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
          if (is_stream(MODE)) {
            // rho-free factor B; the stream divides by rho_i + rho_j. visc:
            // 2 nu 2(D+2) (ApproxLaplace) or 2 nu c (WCSPH)
            float B = is_wcsph(MODE) ? visc * h_ij * dot / (r2 + 0.001f * h_ij * h_ij)
                                     : visc * dot / (r2 + 0.01f * h_ij * h_ij);
            B = dot < 0.0f ? B : 0.0f;
            if (SCALAR) {
              store_w(s, ei, B * g);
            } else {
              store_w(s, ei, B * wx);
              store_w(s, P + ei, B * wy);
            }
          } else {
            float coef;
            if (is_wcsph(MODE)) {
              // WCSPH inline: -pi_ab = 2 nu h_ij c dot / max(rho_i + rho_j) /
              // (r2 + 0.001 h^2); visc: 2 nu
              const float vt = visc * h_ij * SPEED_OF_SOUND / fmaxf(qrho + c[4], 1e-30f);
              coef = -(-vt * dot / (r2 + 0.001f * h_ij * h_ij));
            } else {
              // ApproxLaplace inline: nu 2(D+2) dot / (r2 + 0.01 h^2) / rho_ij
              const float rho_ij = fmaxf((qrho + c[4]) * 0.5f, 1e-30f);
              coef = visc * (8.0f * dot / (r2 + 0.01f * h_ij * h_ij) / rho_ij);
            }
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
        is_classic(MODE) ? qr[4] : 0.0f};
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

// a sum over a row's segment of S::G lanes (mask: the segment's lanes), in
// a fixed butterfly order; every lane of the segment gets it
template <typename S>
__device__ __forceinline__ float seg_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = S::G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(mask, v, off, S::G);
  return v;
}

// f(row, beg, end, sl, mask) for every row < C, once, by the segment that owns
// it: warp w of block b takes the chunks of S::SEG_ROWS rows c = b WARPS + w,
// then c + gridDim.x WARPS, ... (any grid >= 1 covers every row), segment s
// of a warp row s of its chunk. The chunk's SEG_ROWS + 1 row pointers come in
// one coalesced load (lane l reads row_ptr[r0 + l]) and reach the segments by
// shuffle, so a row's bounds are loaded once, not once per lane. sl: the lane
// in the segment; mask: the segment's lanes, for its own shuffles inside f.
template <typename S, typename F>
__device__ __forceinline__ void for_stream_rows(const int* __restrict__ row_ptr, int C, F&& f) {
  const int lane = threadIdx.x & 31;
  const int seg = lane / S::G;
  const unsigned mask = ((1u << S::G) - 1u) << (seg * S::G);
  const int chunks = (C + S::SEG_ROWS - 1) / S::SEG_ROWS;
  for (int c = blockIdx.x * S::WARPS + (threadIdx.x >> 5); c < chunks;
       c += gridDim.x * S::WARPS) {
    const int r0 = c * S::SEG_ROWS;
    const int v = __ldg(row_ptr + min(r0 + min(lane, S::SEG_ROWS), C));
    const int beg = __shfl_sync(FULL, v, seg);
    const int end = __shfl_sync(FULL, v, seg + 1);
    const int row = r0 + seg;
    if (row < C) f(row, beg, end, lane & (S::G - 1), mask);
  }
}

// The pair weights of entry e of a row: read from the two stored rows (K2,
// K3) or rebuilt from the stored scalar and the sorted positions (K2s, K3s).
// Every array is read-only within a launch and read through __ldg.
template <typename W>
struct StoredPair {
  const W* v;  // (2, P)
  long long P;
  __device__ __forceinline__ void begin(int) {}
  __device__ __forceinline__ void at(long long e, int, float& x, float& y) const {
    x = load_ro(v, e);
    y = load_ro(v, P + e);
  }
};

template <typename W>
struct ScalarPair {
  const W* v;          // (P,) g or B g
  const float* table;  // the table K1 walked, (C, F), x and y first
  int F;
  float xi, yi;
  __device__ __forceinline__ void begin(int row) {
    xi = __ldg(table + (size_t)row * F);
    yi = __ldg(table + (size_t)row * F + 1);
  }
  // K1's rounding: g * (x_i - x_j), one rounded subtraction and product
  __device__ __forceinline__ void at(long long e, int j, float& x, float& y) const {
    const float g = load_ro(v, e);
    x = __fmul_rn(g, __fsub_rn(xi, __ldg(table + (size_t)j * F)));
    y = __fmul_rn(g, __fsub_rn(yi, __ldg(table + (size_t)j * F + 1)));
  }
};

// K2 probe ablations (adaptive_sph_torch.probe; K2 itself is BASE):
// NOGATHER reads t at the row's own slot instead of t[col] (isolates the
// gather), NOMUL sums the weights with no t (isolates the operand reads and
// products). Both still load col, so the pair list streams as in BASE.
enum MatvecAblation { BASE = 0, NOGATHER = 1, NOMUL = 2 };

// K2 / K2s. Lane sl of a row's segment takes the row's entries beg + sl,
// beg + sl + G, ... in that order, KK at a time: the col and weight loads of
// all KK first, then the gathered operands, then the products summed in
// the order of e with explicit fused operations (both storages accumulate
// the same products in the same way), so every KK gives the same bits; the
// segment then reduces in a fixed butterfly. The step's K2 and K2s are
// <BASE, STREAM_K>; the probe's `wh` (pairs of a warp in flight per loop
// step) is 32 KK.
template <typename S, bool DIV, int ABL, int KK, typename Pair>
__global__ void __launch_bounds__(S::THREADS)
    pair_matvec_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col, Pair pw,
                       int C, const float* __restrict__ t0, const float* __restrict__ t1,
                       float* __restrict__ out0, float* __restrict__ out1) {
  for_stream_rows<S>(row_ptr, C, [&](int row, int beg, int end, int sl, unsigned mask) {
    float a0 = 0.0f, a1 = 0.0f;
    if (beg < end) {  // an empty row only stores its zeros
      Pair p = pw;
      p.begin(row);
      for (int p0 = beg; p0 < end; p0 += S::G * KK) {
        const int e0 = p0 + sl;
        int j[KK];
        float wx[KK], wy[KK], v0[KK], v1[KK];
#pragma unroll
        for (int k = 0; k < KK; ++k) {
          const int e = e0 + k * S::G;
          j[k] = 0;
          wx[k] = wy[k] = 0.0f;
          if (p0 + k * S::G < end && e < end) {
            j[k] = __ldg(col + e);
            if (ABL != BASE) asm volatile("" : : "r"(j[k]));  // keep the col load
            p.at(e, j[k], wx[k], wy[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < KK; ++k) {
          v0[k] = v1[k] = 0.0f;
          if (ABL != NOMUL && p0 + k * S::G < end && e0 + k * S::G < end) {
            const int src = ABL == NOGATHER ? row : j[k];
            v0[k] = __ldg(t0 + src);
            if (DIV) v1[k] = __ldg(t1 + src);
          }
        }
#pragma unroll
        for (int k = 0; k < KK; ++k) {
          if (e0 + k * S::G >= end) break;
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
      a0 = seg_sum<S>(a0, mask);
      if (!DIV) a1 = seg_sum<S>(a1, mask);
    }
    if (sl == 0) {
      out0[row] = a0;
      if (!DIV) out1[row] = a1;
    }
  });
}

// K3 / K3s: (s_ij or (B g)_ij (x_i - x_j)) times 1 / max(rho_i + rho_j, 1e-30),
// on K2's segments, STREAM_K pairs' loads in flight per lane
template <typename S, typename Pair>
__global__ void __launch_bounds__(S::THREADS)
    pair_visc_kernel(const int* __restrict__ row_ptr, const int* __restrict__ col, Pair pw, int C,
                     const float* __restrict__ rho, float* __restrict__ out0,
                     float* __restrict__ out1) {
  constexpr int KK = STREAM_K;
  for_stream_rows<S>(row_ptr, C, [&](int row, int beg, int end, int sl, unsigned mask) {
    float a0 = 0.0f, a1 = 0.0f;
    if (beg < end) {
      Pair p = pw;
      p.begin(row);
      const float ri = __ldg(rho + row);
      for (int p0 = beg; p0 < end; p0 += S::G * KK) {
        const int e0 = p0 + sl;
        int j[KK];
        float sx[KK], sy[KK], rj[KK];
#pragma unroll
        for (int k = 0; k < KK; ++k) {
          const int e = e0 + k * S::G;
          j[k] = 0;
          sx[k] = sy[k] = 0.0f;
          if (p0 + k * S::G < end && e < end) {
            j[k] = __ldg(col + e);
            p.at(e, j[k], sx[k], sy[k]);
          }
        }
#pragma unroll
        for (int k = 0; k < KK; ++k)
          rj[k] = p0 + k * S::G < end && e0 + k * S::G < end ? __ldg(rho + j[k]) : 0.0f;
#pragma unroll
        for (int k = 0; k < KK; ++k) {
          if (e0 + k * S::G >= end) break;
          const float inv = 1.0f / fmaxf(rj[k] + ri, 1e-30f);
          a0 = __fmaf_rn(sx[k], inv, a0);
          a1 = __fmaf_rn(sy[k], inv, a1);
        }
      }
      a0 = seg_sum<S>(a0, mask);
      a1 = seg_sum<S>(a1, mask);
    }
    if (sl == 0) {
      out0[row] = a0;
      out1[row] = a1;
    }
  });
}

// what a K2 / K3 entry point returns without launching: 0 for an empty
// list, an error for a shape or grid it does not take; -1: launch
int stream_refusal(int C, int shape, int grid) {
  if (C == 0) return 0;
  if (grid < 1 || (shape != 0 && shape != 1)) return static_cast<int>(cudaErrorInvalidValue);
  return -1;
}

// shape: 0 SmallList, 1 LargeList; grid: the blocks of the launch, at least
// 1 (ops/pair_ops.py::stream_launch chooses both)
template <int ABL = BASE, int KK = STREAM_K, typename Pair>
void launch_matvec(Pair pw, const int* row_ptr, const int* col, int C, const float* t0,
                   const float* t1, int div, float* out0, float* out1, int shape, int grid,
                   cudaStream_t st) {
  if (shape == 0 && div)
    pair_matvec_kernel<SmallList, true, ABL, KK>
        <<<grid, SmallList::THREADS, 0, st>>>(row_ptr, col, pw, C, t0, t1, out0, out1);
  else if (shape == 0)
    pair_matvec_kernel<SmallList, false, ABL, KK>
        <<<grid, SmallList::THREADS, 0, st>>>(row_ptr, col, pw, C, t0, t1, out0, out1);
  else if (div)
    pair_matvec_kernel<LargeList, true, ABL, KK>
        <<<grid, LargeList::THREADS, 0, st>>>(row_ptr, col, pw, C, t0, t1, out0, out1);
  else
    pair_matvec_kernel<LargeList, false, ABL, KK>
        <<<grid, LargeList::THREADS, 0, st>>>(row_ptr, col, pw, C, t0, t1, out0, out1);
}

// the probe's K2 ablation (MatvecAblation), at the step's STREAM_K
template <typename Pair>
int launch_matvec_probe(int variant, Pair pw, const int* row_ptr, const int* col, int C,
                        const float* t0, const float* t1, int div, float* out0, float* out1,
                        int shape, int grid, cudaStream_t st) {
  if (variant == BASE)
    launch_matvec<BASE>(pw, row_ptr, col, C, t0, t1, div, out0, out1, shape, grid, st);
  else if (variant == NOGATHER)
    launch_matvec<NOGATHER>(pw, row_ptr, col, C, t0, t1, div, out0, out1, shape, grid, st);
  else if (variant == NOMUL)
    launch_matvec<NOMUL>(pw, row_ptr, col, C, t0, t1, div, out0, out1, shape, grid, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// the probe's K2s with wh = 32 KK pairs of a warp in flight per loop step
template <typename Pair>
int launch_matvec_wh(int wh, Pair pw, const int* row_ptr, const int* col, int C,
                     const float* t0, const float* t1, int div, float* out0, float* out1,
                     int shape, int grid, cudaStream_t st) {
  if (wh == 32)
    launch_matvec<BASE, 1>(pw, row_ptr, col, C, t0, t1, div, out0, out1, shape, grid, st);
  else if (wh == 64)
    launch_matvec<BASE, 2>(pw, row_ptr, col, C, t0, t1, div, out0, out1, shape, grid, st);
  else if (wh == 128)
    launch_matvec<BASE, 4>(pw, row_ptr, col, C, t0, t1, div, out0, out1, shape, grid, st);
  else if (wh == 256)
    launch_matvec<BASE, 8>(pw, row_ptr, col, C, t0, t1, div, out0, out1, shape, grid, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

template <typename Pair>
void launch_visc(Pair pw, const int* row_ptr, const int* col, int C, const float* rho,
                 float* out0, float* out1, int shape, int grid, cudaStream_t st) {
  if (shape == 0)
    pair_visc_kernel<SmallList>
        <<<grid, SmallList::THREADS, 0, st>>>(row_ptr, col, pw, C, rho, out0, out1);
  else
    pair_visc_kernel<LargeList>
        <<<grid, LargeList::THREADS, 0, st>>>(row_ptr, col, pw, C, rho, out0, out1);
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
  else if (mode == MEGA_VISC_WCSPH)
    launch_build<true, MEGA_VISC_WCSPH, SCALAR, W>(cs, wm, nt, nl, tq, flat, scale, visc,
                                                   nullptr, pieces, row_ptr, col, w, s, P, prep,
                                                   st);
  else
    launch_build<true, MEGA, SCALAR, W>(cs, wm, nt, nl, tq, flat, scale, visc, nullptr,
                                        pieces, row_ptr, col, w, s, P, prep, st);
}

}  // namespace

extern "C" {

// mode: 0 mega, 1 mega with the viscosity stream, 2 classic, 3 weights-only,
// 4 and 5 modes 1 and 2 with the WCSPH viscosity (BuildMode); visc: 2 nu 8
// (mode 1's stream factor), nu (classic), (2 nu) 88 (mode 4) or 2 nu (mode
// 5), unused in modes 0 and 3. pieces: (C, PIECES) int32 scratch that the count pass hands
// to the fill pass. The walk's split: asph_pair_pieces() = PIECES warps per
// row, and a row is split when its tile holds more than asph_pair_split_min()
// candidates
int asph_pair_pieces() { return tile_walk::S; }

int asph_pair_split_min() { return tile_walk::SPLIT_MIN; }

int asph_pair_count(const int* cell_starts, const int* wm, int nt, int nl, int tq,
                    const float* flat, int mode, float scale, int* counts, int* pieces,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_classic(mode))
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
  if (mode < MEGA || mode > CLASSIC_WCSPH) return static_cast<int>(cudaErrorInvalidValue);
  if (scalar && mode != MEGA && !is_stream(mode)) return static_cast<int>(cudaErrorInvalidValue);
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
  } else if (mode == CLASSIC_WCSPH) {
    if (wbf16)
      launch_build<true, CLASSIC_WCSPH, false, __nv_bfloat16>(cell_starts, wm, nt, nl, tq, flat,
                                                              scale, visc, nullptr, pieces,
                                                              row_ptr, col, w, s, P, prep, st);
    else
      launch_build<true, CLASSIC_WCSPH, false, float>(cell_starts, wm, nt, nl, tq, flat, scale,
                                                      visc, nullptr, pieces, row_ptr, col, w, s,
                                                      P, prep, st);
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

// the K2 / K3 launch shapes: [STREAM_K, then G, THREADS and BLOCKS_PER_SM
// of SmallList and of LargeList]
void asph_stream_shape(int* out) {
  out[0] = STREAM_K;
  out[1] = SmallList::G;
  out[2] = SmallList::THREADS;
  out[3] = SmallList::BLOCKS_PER_SM;
  out[4] = LargeList::G;
  out[5] = LargeList::THREADS;
  out[6] = LargeList::BLOCKS_PER_SM;
}

// K2 / K3 and their instances: shape 0 (SmallList) or 1 (LargeList), grid
// (>= 1) the launch's blocks (ops/pair_ops.py::stream_launch); any grid
// covers every row

int asph_pair_matvec(const int* row_ptr, const int* col, const void* w, int wbf16,
                     long long P, int C, const float* t0, const float* t1, int div,
                     float* out0, float* out1, int shape, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const int r = stream_refusal(C, shape, grid); r >= 0) return r;
  if (wbf16)
    launch_matvec(StoredPair<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(w), P}, row_ptr,
                  col, C, t0, t1, div, out0, out1, shape, grid, st);
  else
    launch_matvec(StoredPair<float>{static_cast<const float*>(w), P}, row_ptr, col, C, t0, t1,
                  div, out0, out1, shape, grid, st);
  return static_cast<int>(cudaGetLastError());
}

// table: the (C, F) float32 table the pair list was built from (x, y first)
int asph_pair_matvec_scalar(const int* row_ptr, const int* col, const void* g, int wbf16,
                            int C, const float* table, int F, const float* t0, const float* t1,
                            int div, float* out0, float* out1, int shape, int grid,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const int r = stream_refusal(C, shape, grid); r >= 0) return r;
  if (wbf16)
    launch_matvec(ScalarPair<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(g), table, F},
                  row_ptr, col, C, t0, t1, div, out0, out1, shape, grid, st);
  else
    launch_matvec(ScalarPair<float>{static_cast<const float*>(g), table, F}, row_ptr, col, C,
                  t0, t1, div, out0, out1, shape, grid, st);
  return static_cast<int>(cudaGetLastError());
}

// K2 with a probe ablation: variant 0 BASE (K2), 1 NOGATHER, 2 NOMUL
int asph_pair_matvec_probe(const int* row_ptr, const int* col, const void* w, int wbf16,
                           long long P, int C, const float* t0, const float* t1, int div,
                           int variant, float* out0, float* out1, int shape, int grid,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const int r = stream_refusal(C, shape, grid); r >= 0) return r;
  if (wbf16)
    return launch_matvec_probe(variant,
                               StoredPair<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(w), P},
                               row_ptr, col, C, t0, t1, div, out0, out1, shape, grid, st);
  return launch_matvec_probe(variant, StoredPair<float>{static_cast<const float*>(w), P}, row_ptr,
                             col, C, t0, t1, div, out0, out1, shape, grid, st);
}

// K2s with wh in {32, 64, 128, 256} pairs of a warp in flight per loop step
int asph_pair_matvec_scalar_probe(const int* row_ptr, const int* col, const void* g, int wbf16,
                                  int C, const float* table, int F, const float* t0,
                                  const float* t1, int div, int wh, float* out0, float* out1,
                                  int shape, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const int r = stream_refusal(C, shape, grid); r >= 0) return r;
  if (wbf16)
    return launch_matvec_wh(
        wh, ScalarPair<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(g), table, F}, row_ptr,
        col, C, t0, t1, div, out0, out1, shape, grid, st);
  return launch_matvec_wh(wh, ScalarPair<float>{static_cast<const float*>(g), table, F}, row_ptr,
                          col, C, t0, t1, div, out0, out1, shape, grid, st);
}

int asph_pair_visc(const int* row_ptr, const int* col, const void* s, int wbf16, long long P,
                   int C, const float* rho, float* out0, float* out1, int shape, int grid,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const int r = stream_refusal(C, shape, grid); r >= 0) return r;
  if (wbf16)
    launch_visc(StoredPair<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(s), P}, row_ptr,
                col, C, rho, out0, out1, shape, grid, st);
  else
    launch_visc(StoredPair<float>{static_cast<const float*>(s), P}, row_ptr, col, C, rho, out0,
                out1, shape, grid, st);
  return static_cast<int>(cudaGetLastError());
}

int asph_pair_visc_scalar(const int* row_ptr, const int* col, const void* sg, int wbf16, int C,
                          const float* table, int F, const float* rho, float* out0, float* out1,
                          int shape, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (const int r = stream_refusal(C, shape, grid); r >= 0) return r;
  if (wbf16)
    launch_visc(ScalarPair<__nv_bfloat16>{static_cast<const __nv_bfloat16*>(sg), table, F},
                row_ptr, col, C, rho, out0, out1, shape, grid, st);
  else
    launch_visc(ScalarPair<float>{static_cast<const float*>(sg), table, F}, row_ptr, col, C, rho,
                out0, out1, shape, grid, st);
  return static_cast<int>(cudaGetLastError());
}

const char* asph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
