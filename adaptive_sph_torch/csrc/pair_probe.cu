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
//   (NC 64, 4) are rows [x, y, h, m]. One block per query tile (its items
//   found through item_ptr, the CSR of qt), one warp per query: the block
//   stages each item's 64 candidates in shared memory, every lane takes two,
//   and the warp reduces in a fixed order. A tile with no item writes 0.
//   The TPU carried the sum across grid steps in its output block; here the
//   tile's run of items is a loop inside one block. Bound: operations (~20
//   per tested pair, 512 tested pairs per item, against ~1 KB of candidate
//   rows per item). expf and _rn arithmetic (no fast math), so the kernel
//   agrees with the plain version to rounding.
//
// window_sum (asph_window_sum) replaces scripts/proto_v8.py::_kernel (:74):
//   out[k] = sum over the anchors a, in order, of v[a + k], k < width. The
//   TPU script tested a sublane extraction of windows at dynamic offsets;
//   on the card a window is a coalesced load. One thread per k sums in the
//   anchors' order, so the result equals the plain version bit for bit.
//   Bound: bytes (the windows' elements once).
//
// pair_stream (asph_pair_stream) replaces scripts/matvec_probe.py::
//   dma_variant's kern (pallas_call at :195), the pure weight stream. It
//   copies the first nbytes of a pair array (the list's w or g) into shared
//   memory: 16-byte cp.async copies into a ring of NBUF stages of grp chunks
//   of 1 KB (64 threads x 16 B), each stage one commit group, waited on with
//   cp.async.wait_group NBUF - 1, the counterpart of the TPU's ring of nbuf
//   DMA buffers and semaphores. Block b streams stages b, b + grid, ...
//   (grid: as many blocks as are resident, asph_pair_stream_blocks). Output:
//   (8, 128) zeros, as the reference's, and folds[b], the XOR of the 32-bit
//   words block b read back from its landed stages (a ragged tail's missing
//   bytes land as zeros), so a copy that is dropped or lands short shows.
//   Bound: bytes. TMA bulk copies are not used yet.
//
// Every entry point launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TQ = 8;   // queries per tile (the script's TQ)
constexpr int WK = 64;  // candidates per chunk (the script's WK)
constexpr int NF = 4;   // columns: x, y, h, m
constexpr int SWEEP_THREADS = 32 * TQ;
static_assert(SWEEP_THREADS == WK * NF, "one staged candidate float per thread");

constexpr int WINDOW_THREADS = 128;

constexpr int STREAM_THREADS = 64;
constexpr int CHUNK_BYTES = STREAM_THREADS * 16;  // one 16-byte copy per thread
constexpr int MAX_RING_BYTES = 232448;            // shared memory a block can use

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

__global__ void block_sweep_kernel(const float* __restrict__ q, const float* __restrict__ c,
                                   const int* __restrict__ item_ptr,
                                   const int* __restrict__ ck, const int* __restrict__ lo,
                                   const int* __restrict__ hi, float scale,
                                   float* __restrict__ out) {
  __shared__ float cs[WK * NF];
  const int t = blockIdx.x;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const float* qr = q + (size_t)(t * TQ + warp) * NF;
  const float qx = qr[0], qy = qr[1], qh = qr[2];
  const int e_end = item_ptr[t + 1];
  float acc = 0.0f;
  for (int e = item_ptr[t]; e < e_end; ++e) {
    const long long chunk = ck[e];
    __syncthreads();
    cs[threadIdx.x] = c[chunk * (WK * NF) + threadIdx.x];
    __syncthreads();
    const long long l = lo[e], h = hi[e];
    float part = 0.0f;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int i = lane + 32 * s;
      const float* cc = cs + i * NF;
      const long long colg = chunk * WK + i;
      const float h_ij = fmaxf(__fmul_rn(0.5f, __fadd_rn(qh, cc[2])), 1e-6f);
      const float dx = __fsub_rn(qx, cc[0]);
      const float dy = __fsub_rn(qy, cc[1]);
      const float r2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
      const float rad = __fmul_rn(scale, h_ij);
      const bool valid = colg >= l && colg < h && r2 < __fmul_rn(rad, rad);
      const float w = expf(__fdiv_rn(-r2, __fmul_rn(h_ij, h_ij)));
      part = __fadd_rn(part, valid ? __fmul_rn(cc[3], w) : 0.0f);
    }
    acc = __fadd_rn(acc, warp_sum(part));  // lane 0 holds the item's sum
  }
  if (lane == 0) out[t * TQ + warp] = acc;
}

__global__ void window_sum_kernel(const float* __restrict__ v, const int* __restrict__ anchors,
                                  int na, int width, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= width) return;
  float acc = 0.0f;
  for (int i = 0; i < na; ++i) acc = __fadd_rn(acc, v[(long long)anchors[i] + k]);
  out[k] = acc;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  // src_bytes < 16 reads that many bytes and fills the rest with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <int NBUF>
__global__ void pair_stream_kernel(const unsigned char* __restrict__ x, long long nbytes,
                                   int grp, float* __restrict__ out,
                                   unsigned* __restrict__ folds) {
  extern __shared__ __align__(16) unsigned char ring[];
  __shared__ unsigned block_fold;
  const long long stage_bytes = (long long)grp * CHUNK_BYTES;
  const long long nstage = (nbytes + stage_bytes - 1) / stage_bytes;
  // this block's stages: blockIdx.x, blockIdx.x + gridDim.x, ...
  const long long mine = blockIdx.x < nstage ? (nstage - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  auto offset = [&](long long k, int j) {
    return (blockIdx.x + k * gridDim.x) * stage_bytes + (long long)j * CHUNK_BYTES +
           threadIdx.x * 16;
  };
  auto slot = [&](long long k, int j) {
    return ring + (k % NBUF) * stage_bytes + j * CHUNK_BYTES + threadIdx.x * 16;
  };
  auto issue = [&](long long k) {
    for (int j = 0; j < grp; ++j) {
      const long long off = offset(k, j);
      if (off < nbytes)
        cp_async16(slot(k, j), x + off, nbytes - off < 16 ? (int)(nbytes - off) : 16);
    }
  };
  // prologue: NBUF - 1 stages in flight (empty groups keep the count uniform)
  for (int k = 0; k < NBUF - 1; ++k) {
    if (k < mine) issue(k);
    cp_async_commit();
  }
  unsigned fold = 0;
  for (long long k = 0; k < mine; ++k) {
    if (k + NBUF - 1 < mine) issue(k + NBUF - 1);
    cp_async_commit();
    cp_async_wait<NBUF - 1>();  // stage k has landed
    // each thread reads back only its own copies: no barrier
    for (int j = 0; j < grp; ++j)
      if (offset(k, j) < nbytes) {
        const uint4 v = *reinterpret_cast<const uint4*>(slot(k, j));
        fold ^= v.x ^ v.y ^ v.z ^ v.w;
      }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) fold ^= __shfl_xor_sync(0xffffffffu, fold, off);
  if (threadIdx.x == 0) block_fold = 0;
  __syncthreads();
  if ((threadIdx.x & 31) == 0) atomicXor(&block_fold, fold);
  __syncthreads();
  if (threadIdx.x == 0) folds[blockIdx.x] = block_fold;
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < 8 * 128; i += blockDim.x) out[i] = 0.0f;
}

template <int NBUF>
cudaError_t stream_attribute(int grp) {
  const int smem = NBUF * grp * CHUNK_BYTES;
  if (grp < 1 || smem > MAX_RING_BYTES) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(pair_stream_kernel<NBUF>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// the blocks of one pair_stream instance resident on the current device
template <int NBUF>
int stream_blocks(int grp, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = stream_attribute<NBUF>(grp);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pair_stream_kernel<NBUF>,
                                                      STREAM_THREADS, NBUF * grp * CHUNK_BYTES);
  *blocks = (per_sm > 0 ? per_sm : 1) * sms;
  return static_cast<int>(e);
}

template <int NBUF>
int launch_stream(const unsigned char* x, long long nbytes, int grp, int grid, float* out,
                  unsigned* folds, cudaStream_t st) {
  const cudaError_t e = stream_attribute<NBUF>(grp);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (grid < 1) return static_cast<int>(cudaErrorInvalidValue);
  pair_stream_kernel<NBUF><<<grid, STREAM_THREADS, NBUF * grp * CHUNK_BYTES, st>>>(
      x, nbytes, grp, out, folds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q (nt 8, 4), c (nc 64, 4) float32 rows [x, y, h, m]; item_ptr (nt + 1)
// int32 CSR of the sorted tile list; ck, lo, hi (E) int32; out (nt 8)
int asph_block_sweep(const float* q, const float* c, int nt, const int* item_ptr, const int* ck,
                     const int* lo, const int* hi, float scale, float* out, void* stream) {
  if (nt == 0) return 0;
  block_sweep_kernel<<<nt, SWEEP_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      q, c, item_ptr, ck, lo, hi, scale, out);
  return static_cast<int>(cudaGetLastError());
}

// v float32; anchors (na) int32 with a + width <= len(v); out (width)
int asph_window_sum(const float* v, const int* anchors, int na, int width, float* out,
                    void* stream) {
  if (width == 0) return 0;
  const int grid = (width + WINDOW_THREADS - 1) / WINDOW_THREADS;
  window_sum_kernel<<<grid, WINDOW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      v, anchors, na, width, out);
  return static_cast<int>(cudaGetLastError());
}

// the resident blocks of the nbuf in {4, 8}, grp instance: the grid
// asph_pair_stream is meant to run with (capped at its stage count)
int asph_pair_stream_blocks(int grp, int nbuf, int* blocks) {
  if (nbuf == 4) return stream_blocks<4>(grp, blocks);
  if (nbuf == 8) return stream_blocks<8>(grp, blocks);
  return static_cast<int>(cudaErrorInvalidValue);
}

// x 16-byte aligned; streams its first nbytes through a ring of nbuf in
// {4, 8} stages of grp 1 KB chunks on `grid` blocks; out (8, 128) float32
// zeros, folds (grid) the blocks' XOR folds
int asph_pair_stream(const void* x, long long nbytes, int grp, int nbuf, int grid, float* out,
                     unsigned* folds, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned char* p = static_cast<const unsigned char*>(x);
  if (nbuf == 4) return launch_stream<4>(p, nbytes, grp, grid, out, folds, st);
  if (nbuf == 8) return launch_stream<8>(p, nbytes, grp, grid, out, folds, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
