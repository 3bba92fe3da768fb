// MoE combine gather-reduce for Hopper (sm_90a):
//   y[i] = sum_{j=0..k-1} scale[i, j] * rows[src[i, j]]     (src < 0 skipped)
// rows (R, d) bf16, src (t, k) int32, scale (t, k) fp32 -> y (t, d) bf16.
//
// Replaces the TPU kernel src/repro/kernels/moe_dispatch.py
// combine_gather_pallas, whose grid (t, k) revisited one fp32 VMEM
// accumulator tile over the sequential k axis.
//
// What bounds it on the card: bytes.  It does 2 flops per element read; the
// least time is (t*k rows read + t rows written) * d * 2 bytes over
// 3.35 TB/s.  Design for that: one thread block per token, each thread owning
// 8 consecutive columns (one 16-byte uint4 of bf16).  The k-way reduction
// runs inside the thread, in registers, in the fixed order j = 0..k-1, so it
// needs no shared memory, no atomics, and gives the same bits on every run;
// the output is rounded to bf16 once and written once.  Each term is one
// rounded fp32 multiply and one rounded fp32 add (__fmul_rn / __fadd_rn, no
// fused multiply-add), which is exactly the arithmetic of the plain version
// in repro_torch/kernels/ref.py, so the two agree bit for bit.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(256)
combine_gather_kernel(const __nv_bfloat16* __restrict__ rows,
                      const int32_t* __restrict__ src,
                      const float* __restrict__ scale,
                      __nv_bfloat16* __restrict__ out, int R, int t, int k,
                      int d) {
  const int vec = d / 8;
  for (int i = blockIdx.x; i < t; i += gridDim.x) {
    for (int c = threadIdx.x; c < vec; c += blockDim.x) {
      float acc[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[e] = 0.0f;
      for (int j = 0; j < k; ++j) {
        const int s = src[(size_t)i * k + j];
        if (s < 0 || s >= R) continue;
        const float w = scale[(size_t)i * k + j];
        const uint4 v =
            reinterpret_cast<const uint4*>(rows + (size_t)s * d)[c];
        const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float2 f = __bfloat1622float2(p[q]);
          acc[2 * q] = __fadd_rn(acc[2 * q], __fmul_rn(w, f.x));
          acc[2 * q + 1] = __fadd_rn(acc[2 * q + 1], __fmul_rn(w, f.y));
        }
      }
      uint4 o;
      __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        po[q] = __floats2bfloat162_rn(acc[2 * q], acc[2 * q + 1]);
      }
      reinterpret_cast<uint4*>(out + (size_t)i * d)[c] = o;
    }
  }
}

extern "C" int combine_gather(const void* rows, const void* src,
                              const void* scale, void* out, int R, int t,
                              int k, int d, void* stream) {
  if (t <= 0) return 0;
  if (d % 8 != 0) return (int)cudaErrorInvalidValue;
  const int vec = d / 8;
  int threads = ((vec + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  if (threads < 32) threads = 32;
  const int blocks = t < (1 << 30) ? t : (1 << 30);
  combine_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)rows, (const int32_t*)src, (const float*)scale,
      (__nv_bfloat16*)out, R, t, k, d);
  return (int)cudaGetLastError();
}
