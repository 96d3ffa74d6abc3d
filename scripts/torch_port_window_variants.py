"""The designs window_sum (TPU kernel #11) left behind, timed on the card beside the port's kernel.

The port's window_sum (adaptive_sph_torch/csrc/pair_probe.cu) stages its
anchors' windows into shared memory with cp.async copies issued by 32 warps.
This script builds two designs it replaced (nvcc, sm_90a) and times them with
the port's kernel, by torch.profiler's device time (the mean of 50 launches,
three rounds), on proto_v8.py's inputs (C = 24,576, 64 anchors, width 128)
and on 64 misaligned anchors, each result held bit for bit against the plain
version:

  pr5   one thread per column summing global loads (the kernel before)
  bulk  a TMA bulk copy per window (cp.async.bulk on one mbarrier, issued by
        warp 0's lanes), 4-byte cp.async for misaligned ones
  noop  an empty kernel of the same grid
  port  the port's kernel, through probes.window_sum

    python scripts/torch_port_window_variants.py     (on a CUDA GPU; ~40 s)
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# name -> (kernel name the profiler shows, variant id of ws_run)
VARIANTS = {"pr5": ("ws_orig", 0), "bulk": ("ws_bulk", 1), "noop": ("ws_noop", 2)}

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void commit_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__global__ void ws_orig(const float* __restrict__ v, const int* __restrict__ anchors, int na,
                        int width, float* __restrict__ out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= width) return;
  float acc = 0.0f;
  for (int i = 0; i < na; ++i) acc = __fadd_rn(acc, v[(long long)anchors[i] + k]);
  out[k] = acc;
}

__global__ void __launch_bounds__(128) ws_bulk(const float* __restrict__ v,
                                               const int* __restrict__ anchors, int na,
                                               int width, float* __restrict__ out) {
  extern __shared__ __align__(128) float win[];
  __shared__ uint64_t full;
  __shared__ int anc[64];
  const int t = threadIdx.x, lane = t & 31;
  const int c0 = blockIdx.x * 128, wcols = min(128, width - c0);
  const unsigned rb = wcols * 4u;
  auto bulk = [&](int a) {
    return (wcols & 3) == 0 && (reinterpret_cast<uintptr_t>(v + a + c0) & 15) == 0;
  };
  if (t == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(&full)) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (t < na) anc[t] = anchors[t];
  __syncthreads();
  if (t < 32) {
    int nb = 0;
    for (int i0 = 0; i0 < na; i0 += 32)
      nb += __popc(__ballot_sync(0xffffffffu, i0 + lane < na && bulk(anc[i0 + lane])));
    if (lane == 0)
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   ::"r"(smem_u32(&full)), "r"(nb * rb) : "memory");
    __syncwarp();
    for (int i = lane; i < na; i += 32)
      if (bulk(anc[i]))
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
            ::"r"(smem_u32(win + i * 128)), "l"(v + anc[i] + c0), "r"(rb), "r"(smem_u32(&full))
            : "memory");
  }
  if (t < wcols)
    for (int i = 0; i < na; ++i)
      if (!bulk(anc[i])) cp4(win + i * 128 + t, v + anc[i] + c0 + t);
  commit_wait();
  unsigned done;
  do {
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n" : "=r"(done) : "r"(smem_u32(&full)) : "memory");
  } while (!done);
  if (t < wcols) {
    float acc = 0.0f;
    for (int i = 0; i < na; ++i) acc = __fadd_rn(acc, win[i * 128 + t]);
    out[c0 + t] = acc;
  }
}

__global__ void ws_noop(const float* __restrict__ v, const int* __restrict__ anchors, int na,
                        int width, float* __restrict__ out) {
  if (blockIdx.x == 0 && threadIdx.x < width) out[threadIdx.x] = 0.0f;
}

extern "C" int ws_run(int variant, const float* v, const int* an, int na, int width, float* out,
                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int grid = (width + 127) / 128, smem = na * 512;
  if (na > 64) return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 0: ws_orig<<<grid, 128, 0, st>>>(v, an, na, width, out); break;
    case 1: ws_bulk<<<grid, 128, smem, st>>>(v, an, na, width, out); break;
    case 2: ws_noop<<<grid, 128, 0, st>>>(v, an, na, width, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


def build(tmp: str):
    src, so = os.path.join(tmp, "ws.cu"), os.path.join(tmp, "ws.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    nvcc = "/usr/local/cuda/bin/nvcc" if os.path.exists("/usr/local/cuda/bin/nvcc") else "nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", "-o", so, src], check=True)
    lib = ctypes.CDLL(so)
    vp = ctypes.c_void_p
    lib.ws_run.argtypes = [ctypes.c_int, vp, vp, ctypes.c_int, ctypes.c_int, vp, vp]
    lib.ws_run.restype = ctypes.c_int
    return lib


def main():
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    from adaptive_sph_torch import probe
    from adaptive_sph_torch.ops import probes
    from adaptive_sph_torch.timing import device_ms

    if not torch.cuda.is_available():
        raise SystemExit("torch_port_window_variants: needs a CUDA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(f"gpu: {smi.stdout.strip()}")
    v, an = probe.window_inputs()
    rng = np.random.default_rng(2)
    odd = rng.integers(0, (probe.WINDOW_C - 512) // 4, 64) * 4 + rng.integers(1, 4, 64)
    sets = {"probe": an, "misaligned": torch.from_numpy(odd.astype(np.int32)).cuda()}
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(tmp)
        for tag, a in sets.items():
            want = probes.window_sum_ref(v, a)
            out = torch.empty(probe.WINDOW_WIDTH, device="cuda")
            for name, (kernel, vid) in VARIANTS.items():
                def run(vid=vid, a=a, out=out):
                    rc = lib.ws_run(vid, v.data_ptr(), a.data_ptr(), a.numel(),
                                    probe.WINDOW_WIDTH, out.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
                    if rc:
                        raise RuntimeError(f"{name}: launch failed ({rc})")

                run()
                torch.cuda.synchronize()
                if name != "noop" and not torch.equal(out, want):
                    raise AssertionError(f"{name} on {tag}: not bit for bit the plain version")
                us = [device_ms(run, 50, kernel) * 1e3 for _ in range(3)]
                print(f"{tag:10s} {name:10s} device us " + " ".join(f"{x:.3f}" for x in us))
            us = [device_ms(lambda a=a: probes.window_sum(v, a), 50, "window_sum_kernel") * 1e3
                  for _ in range(3)]
            print(f"{tag:10s} {'port':10s} device us " + " ".join(f"{x:.3f}" for x in us))


if __name__ == "__main__":
    main()
