// The tile walk of K1 pair_build (pair_ops.cu) and pair_sweep
// (pair_sweep.cu), written for Hopper (sm_90a).
//
// A warp per query row, or S warps for a long one. Row q lies in query
// tile t = q / tq; the tile's window meta (WM_STRIDE ints per (tile, level):
// [count, a0, b0, ..., a15, b15]) gives its candidate slot ranges
// [cell_starts[a], cell_starts[b]), level by level, in ascending slot order.
// A block holds ROWS = WARPS / S rows and S warps per row. At its start each
// warp loads the tile's range bounds, up to 32 ranges at once (one per
// lane), and sums their lengths: the tile's candidates n. A row with
// n <= SPLIT_MIN is walked whole by its first warp; a longer one is cut
// into S contiguous pieces of its candidate sequence, one per warp, and the
// pieces' counts, sums and maxima are combined in piece order in shared
// memory by the row's first warp. Within a walk, the warp strides each range in
// groups of 32 consecutive slots, lane l on slot c0 + l, U groups' loads in
// flight per loop step. Every lane tests its candidate with the caller's
// exact mask; __ballot_sync turns a group's answers into a mask of
// in-radius lanes in slot order. The caller's per-pair body then runs on
// all 32 lanes once per group with a pair inside: a lane's place among the
// row's entries is the number of set bits below it (lane_rank), and
// `ordered_sum` adds the set lanes' values one by one, lowest lane first.
// So a row's entries come out in slot order, the plain versions' order, and
// so do its sums unless the row was split (then each piece's sum is in slot
// order and the pieces are added in order).
//
// Why (measured on an NVIDIA H100 80GB HBM3 at 700.00 W; PERF.md §6): a
// tile's rows all walk the tile's windows, and the tile holding
// the coarse particles has windows over the whole scene (11,835 candidates
// per row on the stress scene, 47,340 at x4, against a median of ~440).
// The shape below was chosen by editing these constants one at a time and
// timing K1 mega / the DENSITY sweep on the stress x1 layout (device ms, as
// chip_smoke.py phase 2f times them):
//   as below (S = 2, U = 4, WARPS = 8, last rows first)  0.0798 / 0.0310
//   S = 1: one warp per row                        0.1010-0.1015 / 0.0506
//   S = 4                                                 0.1215 / 0.0470
//   U = 8                                                 0.0875 / 0.0362
//   first rows first                        0.1097-0.1114 / 0.0458-0.0465
//   WARPS = 2, S = 1                               0.0960-0.0969 / 0.0471
// With S = 1 the coarse tile alone took 0.0478 of the sweep's 0.0506 ms:
// one warp walks an 11,835-candidate row in ~45 us whatever the loads in
// flight, so long rows are split. Two pieces beat four, whose idle warps
// on short rows cost more than the long rows gain. Rows of at most
// SPLIT_MIN candidates (every row of the default dam break, whose longest
// is ~1,000) keep the one-warp walk and its exact order. Blocks run from
// the last row to the first: tiles sort by level, so the coarse tiles,
// whose walks are longest, start first. C / ROWS blocks fill the card where
// C / tq blocks of tq threads (112 on the stress scene) left most warp
// slots empty.

#pragma once

#include <cuda_runtime.h>

namespace tile_walk {

constexpr int WM_STRIDE = 33;  // [count, a0, b0, ..., a15, b15] per (tile, level)
constexpr int RL = 16;  // ranges per (tile, level)

constexpr int WARPS = 8;  // warps per block
constexpr int S = 2;  // warps per row: the pieces of a long row
constexpr int ROWS = WARPS / S;  // rows per block
constexpr int BLOCK = 32 * WARPS;
constexpr int SPLIT_MIN = 2048;  // a row of more candidates is split
constexpr int U = 4;  // groups of 32 candidates in flight per loop step
static_assert(WARPS % S == 0 && U >= 1 && U <= 32, "a block holds whole rows");
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ int warp() { return threadIdx.x >> 5; }

__device__ __forceinline__ int lane() { return threadIdx.x & 31; }

// this warp's query row (blocks from the last rows to the first) and its
// piece of the row
__device__ __forceinline__ int row() {
  return (gridDim.x - 1 - blockIdx.x) * ROWS + warp() / S;
}

__device__ __forceinline__ int piece() { return warp() % S; }

// blocks of the launch over C rows
__host__ __device__ constexpr int grid(int C) { return (C + ROWS - 1) / ROWS; }

// set bits of m below this lane: its place among the group's pairs
__device__ __forceinline__ int lane_rank(unsigned m) {
  unsigned lt;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(lt));
  return __popc(m & lt);
}

// acc[k] += v[k] of every lane set in m, lowest lane first; warp-uniform m,
// every lane ends with the same sums
template <int N>
__device__ __forceinline__ void ordered_sum(float* acc, const float* v, unsigned m) {
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
#pragma unroll
    for (int k = 0; k < N; ++k) acc[k] = __fadd_rn(acc[k], __shfl_sync(FULL, v[k], src));
  }
}

// the slot range [lo, hi) of range i of tile t (level i / RL, entry i % RL);
// lo = hi = 0 past the level's count or the last level
__device__ __forceinline__ void range_of(const int* __restrict__ cell_starts,
                                         const int* __restrict__ wm, int nl, int t, int i, int& lo,
                                         int& hi) {
  lo = hi = 0;
  if (i >= nl * RL) return;
  const int* ent = wm + ((size_t)t * nl + i / RL) * WM_STRIDE;
  const int r = i % RL;
  const int a = ent[1 + 2 * r], b = ent[2 + 2 * r];  // read beside the count
  if (r < ent[0]) {
    lo = cell_starts[a];
    hi = cell_starts[b];
  }
}

// candidates of tile t, summed over its ranges (every lane gets the total)
__device__ __forceinline__ int tile_candidates(const int* __restrict__ cell_starts,
                                               const int* __restrict__ wm, int nl, int t) {
  int n = 0;
  for (int i0 = 0; i0 < nl * RL; i0 += 32) {
    int lo, hi;
    range_of(cell_starts, wm, nl, t, i0 + lane(), lo, hi);
    n += hi - lo;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) n += __shfl_xor_sync(FULL, n, off);
  return n;
}

// Walk slots [lo, hi) of one range. table: (C, NF) float32 with x, y, h
// first. Body provides
//   struct Geo;                                           per-pair geometry
//   bool test(float x, float y, float h, Geo&) const;     the pair mask
//                                                         (false for h = 0)
//   void take(int slot, const Geo&, bool in, unsigned m); all lanes, m != 0
// Per loop step every lane loads its U candidates, then tests all U, and
// the warp ORs the lanes' answers: a step whose candidates all lie outside
// the radius, the usual case on a long row, costs one round trip of loads
// and U tests. Groups with a pair are then taken in slot order, their
// geometry recomputed from the kept x, y, h.
template <int NF, class Body>
__device__ __forceinline__ void walk_span(int lo, int hi, const float* __restrict__ table,
                                          Body& body) {
  const int l = lane();
  for (int c0 = lo; c0 < hi; c0 += 32 * U) {
    float x[U], y[U], h[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + 32 * u + l;
      x[u] = y[u] = h[u] = 0.0f;  // past the range: h = 0, outside
      if (c < hi) {
        const float* p = table + (size_t)c * NF;
        x[u] = p[0];
        y[u] = p[1];
        h[u] = p[2];
      }
    }
    unsigned bits = 0;  // bit u: this lane's candidate of group u is a pair
#pragma unroll
    for (int u = 0; u < U; ++u) {
      typename Body::Geo g;
      if (c0 + 32 * u < hi && body.test(x[u], y[u], h[u], g)) bits |= 1u << u;
    }
    const unsigned any = __reduce_or_sync(FULL, bits);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!((any >> u) & 1u)) continue;  // warp-uniform
      const bool in = (bits >> u) & 1u;
      const unsigned m = __ballot_sync(FULL, in);
      typename Body::Geo g;
      body.test(x[u], y[u], h[u], g);
      body.take(c0 + 32 * u + l, g, in, m);
    }
  }
}

// Walk the candidates [A, E) of tile t's candidate sequence (its ranges in
// order, concatenated): the whole row, or one piece of a split row.
template <int NF, class Body>
__device__ __forceinline__ void walk_row(const int* __restrict__ cell_starts,
                                         const int* __restrict__ wm, int nl, int t, int A, int E,
                                         const float* __restrict__ table, Body& body) {
  int base = 0;  // sequence index of the next range's first slot
  for (int i0 = 0; i0 < nl * RL && base < E; i0 += 32) {
    int mlo, mhi;
    range_of(cell_starts, wm, nl, t, i0 + lane(), mlo, mhi);
    for (unsigned live = __ballot_sync(FULL, mhi > mlo); live && base < E; live &= live - 1) {
      const int j = __ffs(live) - 1;
      const int lo = __shfl_sync(FULL, mlo, j), hi = __shfl_sync(FULL, mhi, j);
      const int a = max(A - base, 0), b = min(E - base, hi - lo);
      if (a < b) walk_span<NF>(lo + a, lo + b, table, body);
      base += hi - lo;
    }
  }
}

// A row's walk: its tile's candidates n, whether it is split, and this
// warp's piece [A, E) of them (E = A: nothing to walk)
struct RowPlan {
  int n = 0;
  bool split = false;
  int A = 0, E = 0;
};

__device__ __forceinline__ RowPlan plan_row(const int* __restrict__ cell_starts,
                                            const int* __restrict__ wm, int nl, int t,
                                            bool live) {
  RowPlan p;
  if (!live) return p;
  p.n = tile_candidates(cell_starts, wm, nl, t);
  p.split = S > 1 && p.n > SPLIT_MIN;
  const int s = piece();
  if (p.split) {
    p.A = (int)((long long)p.n * s / S);
    p.E = (int)((long long)p.n * (s + 1) / S);
  } else if (s == 0) {
    p.E = p.n;
  }
  return p;
}

}  // namespace tile_walk
