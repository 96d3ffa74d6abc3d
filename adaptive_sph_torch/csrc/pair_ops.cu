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
//   One block per query tile, one thread per query. The block walks the
//   tile's candidate slot ranges [cell_starts[a], cell_starts[b]) from the
//   window meta, stages candidates (the table's 6 or 7 columns) through
//   shared memory in chunks of 128, and every thread tests its query against the chunk with
//   the reference's exact pair mask. Two passes over the same walk: the count
//   pass writes per-row pair counts (the host turns them into row_ptr and
//   sizes the outputs exactly, so the list cannot overflow and the
//   reference's wcache_overflow is always 0); the fill pass writes the entries
//   in candidate order (ascending slot) and keeps the 4 or 8 prep sums in
//   registers. Cost on the H100: the function's bound is the ~3 MB it writes
//   (the ~0.15M pairs inside the radius need few operations), but the walk
//   tests every candidate of the tile's windows (~6.4M on the stress scene),
//   arithmetic on shared-memory operands. The tile holding the few
//   coarse particles walks the whole fine range serially per thread — the
//   known skew; splitting coarse rows across blocks is the planned fix.
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
// Every entry point launches on the given stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int WM_STRIDE = 33;  // [count, a0, b0, ..., a15, b15] per (tile, level)
constexpr int CHUNK = 128;     // candidates staged per shared-memory chunk
constexpr int NF = 6;          // candidate table columns: x, y, h, m, vx, vy
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

// K1 modes: the mega walk without or with the viscosity stream, and the
// classic walk (candidate table with rho, s2 and inline viscosity rows)
enum BuildMode { MEGA = 0, MEGA_VISC = 1, CLASSIC = 2 };

template <bool FILL, int MODE, typename W>
__global__ void pair_build_kernel(const int* __restrict__ cell_starts,
                                  const int* __restrict__ wm, int nl,
                                  const float* __restrict__ flat, float scale,
                                  float visc, int* __restrict__ counts,
                                  const int* __restrict__ row_ptr,
                                  int* __restrict__ col, W* __restrict__ w,
                                  W* __restrict__ s, long long P,
                                  float* __restrict__ prep, int C) {
  // candidate columns: x, y, h, m, vx, vy (mega) or x, y, h, m, rho, vx, vy
  constexpr int NF = MODE == CLASSIC ? 7 : 6;
  constexpr int VX = MODE == CLASSIC ? 5 : 4;
  __shared__ float cand[CHUNK * 7];
  const int t = blockIdx.x;
  const int q = t * blockDim.x + threadIdx.x;
  const float* qr = flat + (size_t)q * NF;
  const float qx = qr[0], qy = qr[1], qh = qr[2], qvx = qr[VX], qvy = qr[VX + 1];
  const float qrho = MODE == CLASSIC ? qr[4] : 0.0f;
  const bool qvalid = qh > 0.0f;
  long long e = 0;  // fill pass: this row's next entry
  if (FILL) e = row_ptr[q];
  int n = 0;
  // prep sums: s1x, s1y, s1sq, then density (mega) or s2x, s2y, s2sq,
  // visc_x, visc_y (classic)
  float acc[8] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};

  for (int li = 0; li < nl; ++li) {
    const int* ent = wm + (size_t)(t * nl + li) * WM_STRIDE;
    const int cnt = ent[0];
    for (int r = 0; r < cnt; ++r) {
      const int lo = cell_starts[ent[1 + 2 * r]];
      const int hi = cell_starts[ent[2 + 2 * r]];
      for (int c0 = lo; c0 < hi; c0 += CHUNK) {
        const int nc = min(CHUNK, hi - c0);
        __syncthreads();
        for (int i = threadIdx.x; i < nc * NF; i += blockDim.x)
          cand[i] = flat[(size_t)c0 * NF + i];
        __syncthreads();
        if (!qvalid) continue;
        for (int k = 0; k < nc; ++k) {
          const float* c = cand + k * NF;
          const float ch = c[2];
          const float h_ij = fmaxf(0.5f * (qh + ch), 1e-6f);
          const float dx = qx - c[0];
          const float dy = qy - c[1];
          // the pair mask is discrete: no contraction into FMAs, so it
          // agrees bit for bit with the plain version
          const float r2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          const float rad = scale * h_ij;
          if (!(r2 < __fmul_rn(rad, rad) && ch > 0.0f)) continue;
          if (FILL) {
            const float cm = c[3];
            const float r = sqrtf(fmaxf(r2, 1e-30f));
            const float two_h = 2.0f * h_ij;
            const float qq = r / two_h;
            const float norm = 10.0f / (SEVEN_PI * (h_ij * h_ij));
            const float mag = norm * cubic_deriv(qq) / two_h;
            const float gmag = qq > 1.0e-5f ? mag / r : 0.0f;
            const float g = cm * gmag;
            const float wx = g * dx;
            const float wy = g * dy;
            col[e] = c0 + k;
            store_w(w, e, wx);
            store_w(w, P + e, wy);
            const float inv_m = 1.0f / fmaxf(cm, 1e-30f);
            const float t2 = (wx * wx + wy * wy) * inv_m;
            acc[0] += wx;
            acc[1] += wy;
            acc[2] += t2;
            if (MODE != CLASSIC) {
              acc[3] += cm * (norm * cubic(qq));
            } else {
              const float inv_rho = 1.0f / fmaxf(c[4], 1e-30f);
              acc[3] += wx * inv_rho;
              acc[4] += wy * inv_rho;
              acc[5] += t2 * inv_rho;
            }
            if (MODE != MEGA) {
              const float dvx = qvx - c[VX];
              const float dvy = qvy - c[VX + 1];
              const float dot = __fadd_rn(__fmul_rn(dx, dvx), __fmul_rn(dy, dvy));
              if (MODE == MEGA_VISC) {
                // rho-free factor B; the stream divides by rho_i + rho_j
                float B = visc * dot / (r2 + 0.01f * h_ij * h_ij);
                B = dot < 0.0f ? B : 0.0f;
                store_w(s, e, B * wx);
                store_w(s, P + e, B * wy);
              } else {
                // ApproxLaplace inline: nu 2(D+2) dot / (r2 + 0.01 h^2) / rho_ij
                const float rho_ij = fmaxf((qrho + c[4]) * 0.5f, 1e-30f);
                float coef = visc * (8.0f * dot / (r2 + 0.01f * h_ij * h_ij) / rho_ij);
                coef = dot < 0.0f ? coef : 0.0f;
                acc[6] += coef * wx;
                acc[7] += coef * wy;
              }
            }
            ++e;
          }
          ++n;
        }
      }
    }
  }
  if (FILL) {
    constexpr int NPREP = MODE == CLASSIC ? 8 : 4;
#pragma unroll
    for (int k = 0; k < NPREP; ++k) prep[k * (size_t)C + q] = acc[k];
  } else {
    counts[q] = n;
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

template <bool DIV, typename W>
__global__ void pair_matvec_kernel(const int* __restrict__ row_ptr,
                                   const int* __restrict__ col,
                                   const W* __restrict__ w, long long P, int C,
                                   const float* __restrict__ t0,
                                   const float* __restrict__ t1,
                                   float* __restrict__ out0,
                                   float* __restrict__ out1) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= C) return;  // whole warps leave together
  const int beg = row_ptr[row], end = row_ptr[row + 1];
  float a0 = 0.0f, a1 = 0.0f;
  for (int e = beg + lane; e < end; e += 32) {
    const int j = col[e];
    const float wx = load_w(w, e), wy = load_w(w, P + e);
    if (DIV) {
      a0 += wx * t0[j] + wy * t1[j];
    } else {
      const float u = t0[j];
      a0 += wx * u;
      a1 += wy * u;
    }
  }
  a0 = warp_sum(a0);
  if (!DIV) a1 = warp_sum(a1);
  if (lane == 0) {
    out0[row] = a0;
    if (!DIV) out1[row] = a1;
  }
}

template <typename W>
__global__ void pair_visc_kernel(const int* __restrict__ row_ptr,
                                 const int* __restrict__ col,
                                 const W* __restrict__ s, long long P, int C,
                                 const float* __restrict__ rho,
                                 float* __restrict__ out0,
                                 float* __restrict__ out1) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= C) return;
  const int beg = row_ptr[row], end = row_ptr[row + 1];
  const float ri = rho[row];
  float a0 = 0.0f, a1 = 0.0f;
  for (int e = beg + lane; e < end; e += 32) {
    const float inv = 1.0f / fmaxf(rho[col[e]] + ri, 1e-30f);
    a0 += load_w(s, e) * inv;
    a1 += load_w(s, P + e) * inv;
  }
  a0 = warp_sum(a0);
  a1 = warp_sum(a1);
  if (lane == 0) {
    out0[row] = a0;
    out1[row] = a1;
  }
}

template <bool FILL, int MODE, typename W>
void launch_build(const int* cs, const int* wm, int nt, int nl, int tq, const float* flat,
                  float scale, float visc, int* counts, const int* row_ptr, int* col,
                  void* w, void* s, long long P, float* prep, cudaStream_t st) {
  pair_build_kernel<FILL, MODE, W><<<nt, tq, 0, st>>>(
      cs, wm, nl, flat, scale, visc, counts, row_ptr, col, static_cast<W*>(w),
      static_cast<W*>(s), P, prep, nt * tq);
}

template <typename W>
void launch_fill(int mode, const int* cs, const int* wm, int nt, int nl, int tq,
                 const float* flat, float scale, float visc, const int* row_ptr, int* col,
                 void* w, void* s, long long P, float* prep, cudaStream_t st) {
  if (mode == CLASSIC)
    launch_build<true, CLASSIC, W>(cs, wm, nt, nl, tq, flat, scale, visc, nullptr, row_ptr, col,
                                   w, s, P, prep, st);
  else if (mode == MEGA_VISC)
    launch_build<true, MEGA_VISC, W>(cs, wm, nt, nl, tq, flat, scale, visc, nullptr, row_ptr,
                                     col, w, s, P, prep, st);
  else
    launch_build<true, MEGA, W>(cs, wm, nt, nl, tq, flat, scale, visc, nullptr, row_ptr, col, w,
                                s, P, prep, st);
}

int rows_grid(int C) { return (C + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK; }

}  // namespace

extern "C" {

// mode: 0 mega, 1 mega with the viscosity stream, 2 classic (BuildMode);
// visc: 2 nu 8 (the stream's factor) or nu (classic), unused in mode 0
int asph_pair_count(const int* cell_starts, const int* wm, int nt, int nl, int tq,
                    const float* flat, int mode, float scale, int* counts, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode == CLASSIC)
    launch_build<false, CLASSIC, float>(cell_starts, wm, nt, nl, tq, flat, scale, 0.0f, counts,
                                        nullptr, nullptr, nullptr, nullptr, 0, nullptr, st);
  else
    launch_build<false, MEGA, float>(cell_starts, wm, nt, nl, tq, flat, scale, 0.0f, counts,
                                     nullptr, nullptr, nullptr, nullptr, 0, nullptr, st);
  return static_cast<int>(cudaGetLastError());
}

int asph_pair_fill(const int* cell_starts, const int* wm, int nt, int nl, int tq,
                   const float* flat, int mode, float scale, float visc, int wbf16,
                   const int* row_ptr, int* col, void* w, void* s, long long P, float* prep,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mode < MEGA || mode > CLASSIC) return static_cast<int>(cudaErrorInvalidValue);
  if (wbf16)
    launch_fill<__nv_bfloat16>(mode, cell_starts, wm, nt, nl, tq, flat, scale, visc, row_ptr,
                               col, w, s, P, prep, st);
  else
    launch_fill<float>(mode, cell_starts, wm, nt, nl, tq, flat, scale, visc, row_ptr, col, w, s,
                       P, prep, st);
  return static_cast<int>(cudaGetLastError());
}

int asph_pair_matvec(const int* row_ptr, const int* col, const void* w, int wbf16,
                     long long P, int C, const float* t0, const float* t1, int div,
                     float* out0, float* out1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = rows_grid(C), block = 32 * ROWS_PER_BLOCK;
  if (C == 0) return 0;
  if (wbf16) {
    const __nv_bfloat16* wb = static_cast<const __nv_bfloat16*>(w);
    if (div)
      pair_matvec_kernel<true><<<grid, block, 0, st>>>(row_ptr, col, wb, P, C, t0, t1, out0, out1);
    else
      pair_matvec_kernel<false><<<grid, block, 0, st>>>(row_ptr, col, wb, P, C, t0, t1, out0, out1);
  } else {
    const float* wf = static_cast<const float*>(w);
    if (div)
      pair_matvec_kernel<true><<<grid, block, 0, st>>>(row_ptr, col, wf, P, C, t0, t1, out0, out1);
    else
      pair_matvec_kernel<false><<<grid, block, 0, st>>>(row_ptr, col, wf, P, C, t0, t1, out0, out1);
  }
  return static_cast<int>(cudaGetLastError());
}

int asph_pair_visc(const int* row_ptr, const int* col, const void* s, int wbf16, long long P,
                   int C, const float* rho, float* out0, float* out1, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = rows_grid(C), block = 32 * ROWS_PER_BLOCK;
  if (C == 0) return 0;
  if (wbf16)
    pair_visc_kernel<<<grid, block, 0, st>>>(row_ptr, col,
                                             static_cast<const __nv_bfloat16*>(s), P, C, rho,
                                             out0, out1);
  else
    pair_visc_kernel<<<grid, block, 0, st>>>(row_ptr, col, static_cast<const float*>(s), P,
                                             C, rho, out0, out1);
  return static_cast<int>(cudaGetLastError());
}

const char* asph_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
