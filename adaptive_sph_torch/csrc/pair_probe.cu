// Probe kernels of python -m adaptive_sph_torch.probe, written for Hopper
// (sm_90a): the card's counterparts of the kernels in the TPU probe scripts.
// Each is timed by the probe; no step path launches them.
//
// block_sweep (asph_block_sweep) replaces scripts/proto_pallas.py::kernel
//   (pallas_call at :94), the block-list pair sweep prototype. A work list
//   of E items (query tile qt, candidate chunk ck, column range [lo, hi)),
//   sorted by qt; for each query q of tile qt[e]:
//     out[q] += sum over the 64 candidates c of chunk ck[e] with lo <= c < hi
//               and r^2 < (scale h_ij)^2 of m_c exp(-r^2 / h_ij^2),
//   h_ij = max((h_q + h_c) / 2, 1e-6). Queries (NT 8, 4) and candidates
//   (NC 64, 4) are rows [x, y, h, m]. The TPU carried a tile's sum across
//   grid steps in its output block; here a tile belongs to G warps of an
//   8-warp block (the tile's items found through item_ptr, the CSR of qt):
//   G = 1, one warp per tile, while that leaves every SM a block (the
//   probe's largest list: 384 blocks of 8 tiles), else 2, 4 or 8
//   (probes.sweep_tiles_per_block). A warp holds its tile's 8 query rows in
//   registers and flattens the in-range candidates of the tile's items into
//   one list, of which it takes its G-th share: lane j takes entries j, j +
//   32, ... (its item found by a 5-step shuffle search of the items' prefix
//   sums), reads the candidate row as one float4 from global memory (the
//   table stays in L2), the next entry's row in flight while it evaluates
//   the current one against the 8 queries, and keeps 8 per-query sums in
//   registers across all the tile's items. Candidates outside [lo, hi) are
//   never evaluated; pairs outside the radius skip the exp and the
//   division. The warp reduces once per tile, a reduce-scatter of the 8
//   sums (9 shuffles); a tile's G shares are added in warp order in shared
//   memory. A tile of more than SPLIT_ITEMS items per warp is split over
//   all 8 warps of its block in contiguous pieces of its items, added in
//   warp order (two block barriers per long tile, none per item). A tile
//   with no item writes 0. Bound: operations (16 per pair in range); the
//   exp and the IEEE division also take 2 special-function operations per
//   pair, whose units run at 16 per clock per SM. expf and _rn arithmetic
//   (no fast math), so the kernel agrees with the plain version to
//   rounding (only the order of the sums differs). Each pair's IEEE
//   division keeps its own slow-path branch, so a round's 8 pairs run one
//   after another; on the H100 a variant with the division's fast path
//   written out branch-free (bit for bit __fdiv_rn) ran slower, so the
//   division stays __fdiv_rn.
//
// window_sum (asph_window_sum) replaces scripts/proto_v8.py::_kernel (:74):
//   out[k] = sum over the anchors a, in order, of v[a + k], k < width. The
//   TPU script tested a sublane extraction of windows at dynamic offsets.
//   Here a block owns 128 columns and stages its anchors' windows (a row of
//   up to 512 B per anchor) into shared memory with asynchronous copies,
//   WINDOW_STAGE (64) anchors a stage, so the probe's 64 windows (32 KB)
//   are all in flight at once and the block pays one memory latency
//   instead of one per batch of loads: each of the block's 32 warps copies
//   its share of the windows, a 16-byte-aligned window as one cp.async of
//   16 B per lane (one warp instruction per window), any other as cp.async
//   of 4 B. More anchors than one stage run through a double-buffered ring
//   of two stages (64 KB, the limit raised once per device by
//   asph_window_sum_setup): stage k + 1 is in flight while stage k is
//   summed. The block's first 128 threads add their column from shared
//   memory in anchor order, so the result equals the plain version bit for
//   bit. Bound: bytes (the windows' elements once); at the probe's 32 KB
//   the launch and one memory latency, not the bytes, set the time. On the
//   H100 a TMA bulk copy per window (cp.async.bulk on an mbarrier) ran
//   three times slower than these copies: the bulk copies of one SM are
//   processed one after another, ~0.1 us each at 512 B, and the copies
//   issued by fewer warps leave fewer in flight.
//
// pair_stream (asph_pair_stream) replaces scripts/matvec_probe.py::
//   dma_variant's kern (pallas_call at :195), the pure weight stream: one
//   TPU program streaming the list through a ring of nbuf DMA buffers and
//   their semaphores. Here a persistent grid of one block per SM (at most
//   one per stage) streams the first nbytes of a pair array (the list's w
//   or g) in stages of grp 1 KB chunks; block b takes stages b, b + grid,
//   ... through its own ring of NBUF slots in shared memory, so grp and
//   nbuf set the bytes in flight per SM as they did on the TPU. One thread
//   of the producer warp copies each stage with one TMA bulk copy
//   (cp.async.bulk) that completes the transaction count of the slot's
//   "full" mbarrier, armed with mbarrier.arrive.expect_tx; the 4 consumer
//   warps wait on it (try_wait.parity), fold the landed words and arrive on
//   the slot's "empty" mbarrier, which the producer waits on before it
//   copies into the slot again (the first NBUF stages go out before the
//   block barrier, their slots being free). A bulk copy moves whole 16-byte
//   units: the last nbytes % 16 bytes are read from x with plain loads.
//   Output: (8, 128) zeros, as the reference's, and folds[b], the XOR of
//   the 32-bit words of the stages block b landed (the tail's missing bytes
//   as zeros), so a copy that is dropped or lands short shows. Bound: bytes;
//   on the H100 a stage's copy also has a fixed cost, so small stages (grp
//   1) are bound by the copies a block issues rather than by the bytes.
//
// Every entry point launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

constexpr int TQ = 8;   // queries per tile (the script's TQ)
constexpr int WK = 64;  // candidates per chunk (the script's WK)
constexpr int SWEEP_WARPS = 8;  // tiles per block, one warp each
constexpr int SWEEP_THREADS = 32 * SWEEP_WARPS;
// a tile with more items per warp is split over all the warps of its block
// (a warp's items then take more than one warp-wide load of their ranges)
constexpr int SPLIT_ITEMS = 32;

constexpr int WINDOW_COLS = 128;       // columns per block, one summing thread each
constexpr int WINDOW_THREADS = 1024;   // 32 warps, each copying its share of the windows
constexpr int WINDOW_STAGE = 64;       // anchors' windows per stage
constexpr int WINDOW_NBUF = 2;         // stages in the ring
constexpr int WINDOW_SMEM = WINDOW_NBUF * WINDOW_STAGE * WINDOW_COLS * 4;  // 64 KB

constexpr int STREAM_CONSUMERS = 4;  // warps folding the landed stages
constexpr int STREAM_THREADS = 32 * (1 + STREAM_CONSUMERS);  // warp 0 issues the copies
constexpr int CHUNK_BYTES = 1024;
constexpr int MAX_RING_BYTES = 232448;  // shared memory a block can use

// the 8 queries' terms with candidate row cj = [x, y, h, m], added into acc
__device__ __forceinline__ void pair_terms(const float4 cj, const float (&qx)[TQ],
                                           const float (&qy)[TQ], const float (&qh)[TQ],
                                           float scale, float (&acc)[TQ]) {
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const float h_ij = fmaxf(__fmul_rn(0.5f, __fadd_rn(qh[i], cj.z)), 1e-6f);
    const float dx = __fsub_rn(qx[i], cj.x);
    const float dy = __fsub_rn(qy[i], cj.y);
    const float r2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    const float rad = __fmul_rn(scale, h_ij);
    if (r2 < __fmul_rn(rad, rad))
      acc[i] = __fadd_rn(acc[i], __fmul_rn(cj.w, expf(__fdiv_rn(-r2, __fmul_rn(h_ij, h_ij)))));
  }
}

// lane sums over share `part` of `parts` of the in-range candidates of
// items [i0, i1) (all of one tile), 32 items' ranges at a time: the ranges'
// lengths are scanned across the lanes, and lane j walks entries v0 + j,
// v0 + j + 32, ... of the share [v0, v1) of their concatenation
__device__ __forceinline__ void sweep_items(const float4* __restrict__ c4,
                                            const int* __restrict__ ck,
                                            const int* __restrict__ lo,
                                            const int* __restrict__ hi, int i0, int i1, int part,
                                            int parts, const float (&qx)[TQ],
                                            const float (&qy)[TQ], const float (&qh)[TQ],
                                            float scale, int lane, float (&acc)[TQ]) {
  for (int base = i0; base < i1; base += 32) {
    // lane k: item base + k's candidate rows [first, first + span) of its chunk
    int span = 0, first = 0;
    if (base + lane < i1) {
      const int e = base + lane;
      const int c0 = __ldg(ck + e) * WK;
      const int a = max(__ldg(lo + e), c0), b = min(__ldg(hi + e), c0 + WK);
      span = b > a ? b - a : 0;
      first = a;
    }
    int incl = span;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += v;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    const int shift = first - (incl - span);  // entry v of item k is row v + shift_k
    // entry v's candidate row (garbage for v >= total; every lane shuffles)
    auto row = [&](int v) {
      int k = 0;
#pragma unroll
      for (int s = 16; s > 0; s >>= 1)
        if (__shfl_sync(FULL, incl, k + s - 1) <= v) k += s;
      return v + __shfl_sync(FULL, shift, k);
    };
    const int v0 = total * part / parts, v1 = total * (part + 1) / parts;
    const float4 none = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    int v = v0 + lane;
    int r = row(v);
    float4 cur = v < v1 ? __ldg(c4 + r) : none;
    for (int round = 0; round < (v1 - v0 + 31) / 32; ++round, v += 32) {
      r = row(v + 32);  // the next round's row in flight during this round's terms
      const float4 next = v + 32 < v1 ? __ldg(c4 + r) : none;
      if (v < v1) pair_terms(cur, qx, qy, qh, scale, acc);
      cur = next;
    }
  }
}

// tile t's sums over share `part` of `parts` of the candidates of items
// [i0, i1): lane l returns query l / 4's
__device__ __forceinline__ float tile_part(const float4* __restrict__ q4,
                                           const float4* __restrict__ c4,
                                           const int* __restrict__ ck, const int* __restrict__ lo,
                                           const int* __restrict__ hi, int t, int i0, int i1,
                                           int part, int parts, float scale, int lane) {
  float qx[TQ], qy[TQ], qh[TQ], acc[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const float4 r = __ldg(q4 + (size_t)t * TQ + i);
    qx[i] = r.x;
    qy[i] = r.y;
    qh[i] = r.z;
    acc[i] = 0.0f;
  }
  sweep_items(c4, ck, lo, hi, i0, i1, part, parts, qx, qy, qh, scale, lane, acc);
  // reduce-scatter: each step a lane keeps half of its sums and adds its
  // partner's copy of that half (4 + 2 + 1 shuffles), leaving query l / 4's
  // sum over a group of 4 lanes; two more steps sum the group
  const bool hi16 = lane & 16, hi8 = lane & 8, hi4 = lane & 4;
  float a4[4], a2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = hi16 ? acc[i + 4] : acc[i], give = hi16 ? acc[i] : acc[i + 4];
    a4[i] = __fadd_rn(keep, __shfl_xor_sync(FULL, give, 16));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = hi8 ? a4[i + 2] : a4[i], give = hi8 ? a4[i] : a4[i + 2];
    a2[i] = __fadd_rn(keep, __shfl_xor_sync(FULL, give, 8));
  }
  float s = __fadd_rn(hi4 ? a2[1] : a2[0], __shfl_xor_sync(FULL, hi4 ? a2[0] : a2[1], 4));
  s = __fadd_rn(s, __shfl_xor_sync(FULL, s, 2));
  return __fadd_rn(s, __shfl_xor_sync(FULL, s, 1));
}

template <int TPB>
__global__ void __launch_bounds__(SWEEP_THREADS, 3)
    block_sweep_kernel(const float4* __restrict__ q4, const float4* __restrict__ c4, int nt,
                       const int* __restrict__ item_ptr, const int* __restrict__ ck,
                       const int* __restrict__ lo, const int* __restrict__ hi, float scale,
                       float* __restrict__ out) {
  constexpr int G = SWEEP_WARPS / TPB;  // warps per tile
  __shared__ float part[SWEEP_WARPS][TQ];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * TPB;
  // lane k <= TPB: item_ptr[t0 + k] (tiles past the last one have no items)
  const int ptr = __ldg(item_ptr + min(t0 + min(lane, TPB), nt));
  // bit k: tile t0 + k has more than SPLIT_ITEMS items per warp (long: its
  // items are split over all the block's warps below)
  const int next = __shfl_down_sync(FULL, ptr, 1);
  const unsigned longs = __ballot_sync(FULL, lane < TPB && next - ptr > SPLIT_ITEMS * G);
  auto is_long = [&](int tl) { return (longs >> tl) & 1u; };
  {  // tile t0 + warp / G, share warp % G of its candidates
    const int tl = warp / G, t = t0 + tl;
    const int i0 = __shfl_sync(FULL, ptr, tl), i1 = __shfl_sync(FULL, ptr, tl + 1);
    const bool mine = t < nt && !is_long(tl);
    float s = 0.0f;
    if (mine) s = tile_part(q4, c4, ck, lo, hi, t, i0, i1, warp % G, G, scale, lane);
    if (G == 1) {
      if (mine && (lane & 3) == 0) out[(size_t)t * TQ + (lane >> 2)] = s;
    } else {  // the tile's pieces added in warp order
      if ((lane & 3) == 0) part[warp][lane >> 2] = s;
      __syncthreads();
      if (warp < TPB && lane < TQ && t0 + warp < nt && !is_long(warp)) {
        float sum = 0.0f;
#pragma unroll
        for (int k = 0; k < G; ++k) sum = __fadd_rn(sum, part[warp * G + k][lane]);
        out[(size_t)(t0 + warp) * TQ + lane] = sum;
      }
      __syncthreads();
    }
  }
  for (int tl = 0; tl < TPB; ++tl) {  // the block's long tiles
    if (!is_long(tl)) continue;  // the same for every warp of the block
    const int a = __shfl_sync(FULL, ptr, tl);
    const long long n = __shfl_sync(FULL, ptr, tl + 1) - a;
    const float s = tile_part(q4, c4, ck, lo, hi, t0 + tl, a + (int)(n * warp / SWEEP_WARPS),
                              a + (int)(n * (warp + 1) / SWEEP_WARPS), 0, 1, scale, lane);
    if ((lane & 3) == 0) part[warp][lane >> 2] = s;
    __syncthreads();
    if (threadIdx.x < TQ) {
      float sum = 0.0f;
#pragma unroll
      for (int k = 0; k < SWEEP_WARPS; ++k) sum = __fadd_rn(sum, part[k][threadIdx.x]);
      out[(size_t)(t0 + tl) * TQ + threadIdx.x] = sum;
    }
    __syncthreads();
  }
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// arrive and add bytes to the transaction count the current phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA bulk copy of bytes (a multiple of 16, both addresses 16-byte aligned)
// from global to shared memory, completing that many bytes on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// cp.async of 16 (cg: L2 only) or 4 bytes from global to shared memory,
// completed by this thread's wait_group
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's cp.async groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__global__ void __launch_bounds__(WINDOW_THREADS)
    window_sum_kernel(const float* __restrict__ v, const int* __restrict__ anchors, int na,
                      int width, float* __restrict__ out) {
  extern __shared__ __align__(128) float win[];  // [WINDOW_NBUF][WINDOW_STAGE][WINDOW_COLS]
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int c0 = blockIdx.x * WINDOW_COLS;
  const int wcols = min(WINDOW_COLS, width - c0);
  const int nst = (na + WINDOW_STAGE - 1) / WINDOW_STAGE;
  // stage k's windows into slot k % NBUF: a warp per window, every warp's
  // copies in flight at once, one commit group per stage
  auto issue = [&](int k) {
    float* slot = win + (k % WINDOW_NBUF) * WINDOW_STAGE * WINDOW_COLS;
    const int m = min(WINDOW_STAGE, na - k * WINDOW_STAGE);
    for (int i = warp; i < m; i += WINDOW_THREADS / 32) {
      const float* src = v + __ldg(anchors + k * WINDOW_STAGE + i) + c0;
      float* dst = slot + i * WINDOW_COLS;
      if ((wcols & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
        if (lane * 4 < wcols) cp_async16(dst + lane * 4, src + lane * 4);
      } else {
        for (int c = lane; c < wcols; c += 32) cp_async4(dst + c, src + c);
      }
    }
    cp_async_commit();
  };
  if (nst > 0) issue(0);
  float acc = 0.0f;
  for (int k = 0; k < nst; ++k) {
    if (k + 1 < nst) {
      issue(k + 1);  // its slot was freed by the barrier that ended stage k - 1
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // stage k landed, every thread's copies
    const float* slot = win + (k % WINDOW_NBUF) * WINDOW_STAGE * WINDOW_COLS;
    const int m = min(WINDOW_STAGE, na - k * WINDOW_STAGE);
    if (t < wcols) {
#pragma unroll 16
      for (int i = 0; i < m; ++i) acc = __fadd_rn(acc, slot[i * WINDOW_COLS + t]);
    }
    __syncthreads();  // slot k % NBUF read by every thread
  }
  if (t < wcols) out[c0 + t] = acc;
}

template <int NBUF>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
    pair_stream_kernel(const unsigned char* __restrict__ x, long long nbytes, int grp,
                       float* __restrict__ out, unsigned* __restrict__ folds) {
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ uint64_t full[NBUF], empty[NBUF];
  __shared__ unsigned warp_fold[STREAM_CONSUMERS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long stage_bytes = (long long)grp * CHUNK_BYTES;
  const long long nstage = (nbytes + stage_bytes - 1) / stage_bytes;
  // this block's stages: blockIdx.x, blockIdx.x + gridDim.x, ...
  const long long mine = blockIdx.x < nstage ? (nstage - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto offset = [&](long long k) { return (blockIdx.x + k * gridDim.x) * stage_bytes; };
  // the bytes of this block's stage k a bulk copy lands: whole 16-byte units
  auto landed = [&](long long k) {
    return static_cast<unsigned>(min(stage_bytes, nbytes - offset(k)) & ~15LL);
  };
  // stage k into its slot, arming the slot's full barrier with its bytes
  auto issue = [&](long long k) {
    const int s = static_cast<int>(k % NBUF);
    const unsigned b = landed(k);
    if (b > 0) {
      mbar_arrive_expect_tx(&full[s], b);
      bulk_copy(ring + s * stage_bytes, x + offset(k), b, &full[s]);
    } else {
      mbar_arrive(&full[s]);  // a stage of fewer than 16 bytes: all tail
    }
  };
  if (threadIdx.x == 0) {
    for (int s = 0; s < NBUF; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], STREAM_CONSUMERS);
    }
    // the initialised barriers visible to the bulk copies' complete_tx
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the ring's first stages go out before the block barrier: their slots
    // are free
    for (long long k = 0; k < mine && k < NBUF; ++k) issue(k);
  }
  __syncthreads();
  if (warp == 0) {
    if (lane == 0)
      for (long long k = NBUF; k < mine; ++k) {
        // the slot's previous stage (k - NBUF) released by every consumer warp
        mbar_wait(&empty[k % NBUF], static_cast<unsigned>((k / NBUF - 1) & 1));
        issue(k);
      }
  } else {
    const int ct = threadIdx.x - 32;
    unsigned fold = 0;
    for (long long k = 0; k < mine; ++k) {
      const int s = static_cast<int>(k % NBUF);
      mbar_wait(&full[s], static_cast<unsigned>((k / NBUF) & 1));
      const unsigned char* slot = ring + s * stage_bytes;
      const unsigned b = landed(k);
      for (unsigned o = ct * 16u; o < b; o += STREAM_CONSUMERS * 32 * 16) {
        const uint4 v = *reinterpret_cast<const uint4*>(slot + o);
        fold ^= v.x ^ v.y ^ v.z ^ v.w;
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }
    // the ragged tail (nbytes % 16 bytes of the last stage) with plain loads,
    // each byte at its place in its little-endian word
    if (ct == 0 && nstage > 0 && blockIdx.x == (nstage - 1) % gridDim.x)
      for (long long i = nbytes & ~15LL; i < nbytes; ++i)
        fold ^= static_cast<unsigned>(x[i]) << (8 * (i & 3));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) fold ^= __shfl_xor_sync(FULL, fold, off);
    if (lane == 0) warp_fold[warp - 1] = fold;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned f = 0;
    for (int w = 0; w < STREAM_CONSUMERS; ++w) f ^= warp_fold[w];
    folds[blockIdx.x] = f;
  }
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < 8 * 128; i += blockDim.x) out[i] = 0.0f;
}

// lets the nbuf instance take every byte of shared memory a block can opt in
// to beside its static barriers; *max_ring: those bytes
template <int NBUF>
int stream_setup(int* max_ring) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, pair_stream_kernel<NBUF>);
  if (e == cudaSuccess) {
    *max_ring = optin - static_cast<int>(attr.sharedSizeBytes);
    e = cudaFuncSetAttribute(pair_stream_kernel<NBUF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, *max_ring);
  }
  return static_cast<int>(e);
}

template <int NBUF>
int launch_stream(const unsigned char* x, long long nbytes, int grp, int grid, float* out,
                  unsigned* folds, cudaStream_t st) {
  if (grid < 1 || grp < 1 || NBUF * grp * CHUNK_BYTES > MAX_RING_BYTES)
    return static_cast<int>(cudaErrorInvalidValue);
  pair_stream_kernel<NBUF><<<grid, STREAM_THREADS, NBUF * grp * CHUNK_BYTES, st>>>(
      x, nbytes, grp, out, folds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (nt 8, 4), c (nc 64, 4) float32 rows [x, y, h, m]; tpb in {1, 2, 4, 8}
// tiles per block (8 / tpb warps per tile); item_ptr (nt + 1) int32 CSR of
// the sorted tile list; ck, lo, hi (E) int32; out (nt 8)
int asph_block_sweep(const float* q, const float* c, int nt, int tpb, const int* item_ptr,
                     const int* ck, const int* lo, const int* hi, float scale, float* out,
                     void* stream) {
  if (nt == 0) return 0;
  if (tpb < 1 || tpb > SWEEP_WARPS || SWEEP_WARPS % tpb)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (nt + tpb - 1) / tpb;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4* c4 = reinterpret_cast<const float4*>(c);
  if (tpb == 8)
    block_sweep_kernel<8><<<grid, SWEEP_THREADS, 0, st>>>(q4, c4, nt, item_ptr, ck, lo, hi, scale,
                                                          out);
  else if (tpb == 4)
    block_sweep_kernel<4><<<grid, SWEEP_THREADS, 0, st>>>(q4, c4, nt, item_ptr, ck, lo, hi, scale,
                                                          out);
  else if (tpb == 2)
    block_sweep_kernel<2><<<grid, SWEEP_THREADS, 0, st>>>(q4, c4, nt, item_ptr, ck, lo, hi, scale,
                                                          out);
  else
    block_sweep_kernel<1><<<grid, SWEEP_THREADS, 0, st>>>(q4, c4, nt, item_ptr, ck, lo, hi, scale,
                                                          out);
  return static_cast<int>(cudaGetLastError());
}

// once per device, before the first launch with more than WINDOW_STAGE
// anchors: raises window_sum's dynamic shared memory limit to its ring
int asph_window_sum_setup() {
  return static_cast<int>(cudaFuncSetAttribute(
      window_sum_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WINDOW_SMEM));
}

// v float32 (4-byte aligned); anchors (na) int32 with a + width <= len(v);
// out (width)
int asph_window_sum(const float* v, const int* anchors, int na, int width, float* out,
                    void* stream) {
  if (width == 0) return 0;
  const int grid = (width + WINDOW_COLS - 1) / WINDOW_COLS;
  const int nst = (na + WINDOW_STAGE - 1) / WINDOW_STAGE;
  const int smem = (nst < WINDOW_NBUF ? nst : WINDOW_NBUF) * WINDOW_STAGE * WINDOW_COLS * 4;
  window_sum_kernel<<<grid, WINDOW_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      v, anchors, na, width, out);
  return static_cast<int>(cudaGetLastError());
}

// once per device and nbuf in {4, 8}, before that instance's first launch:
// raises its dynamic shared memory limit; *max_ring: the largest ring it takes
int asph_pair_stream_setup(int nbuf, int* max_ring) {
  if (nbuf == 4) return stream_setup<4>(max_ring);
  if (nbuf == 8) return stream_setup<8>(max_ring);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x 16-byte aligned; streams its first nbytes through rings of nbuf in
// {4, 8} stages of grp 1 KB chunks on `grid` blocks (at most one per SM and
// one per stage); out (8, 128) float32 zeros, folds (grid) the blocks' XOR
// folds
int asph_pair_stream(const void* x, long long nbytes, int grp, int nbuf, int grid, float* out,
                     unsigned* folds, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* p = static_cast<const unsigned char*>(x);
  if (nbuf == 4) return launch_stream<4>(p, nbytes, grp, grid, out, folds, st);
  if (nbuf == 8) return launch_stream<8>(p, nbytes, grp, grid, out, folds, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
