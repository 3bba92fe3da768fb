// MoE dispatch gather for Hopper (sm_90a): out[i] = x[src[i]], or a row of
// zeros when src[i] < 0 (an empty capacity slot).
//
// Replaces the TPU kernel src/repro/kernels/moe_dispatch.py
// dispatch_gather_pallas, which streamed one (1, d) row per grid step with
// the source index scalar-prefetched into SMEM.
//
// What bounds it on the card: bytes.  It does no arithmetic; the least time
// is (R rows read + R rows written) * d * sizeof(elem) over 3.35 TB/s.
// Design for that: one thread block per destination row, each thread moving
// 16 bytes (uint4) per load and store, so a warp touches 512 contiguous bytes
// and every access is a full, coalesced 16-byte transaction.  The block reads
// its own index (no scalar prefetch is needed: the index load is one 4-byte
// broadcast per row).  Empty slots are written as zeros in the same pass.
// The kernel copies bytes, so it takes any element type whose row is a
// multiple of 16 bytes.  An index outside [0, T) is treated as an empty
// slot, so a bad index never reads out of bounds.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(256)
dispatch_gather_kernel(const uint4* __restrict__ x,
                       const int32_t* __restrict__ src,
                       uint4* __restrict__ out, int T, int R,
                       int vec_per_row) {
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const int s = src[r];
    uint4* dst = out + (size_t)r * vec_per_row;
    if (s >= 0 && s < T) {
      const uint4* from = x + (size_t)s * vec_per_row;
      for (int i = threadIdx.x; i < vec_per_row; i += blockDim.x) {
        dst[i] = from[i];
      }
    } else {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      for (int i = threadIdx.x; i < vec_per_row; i += blockDim.x) {
        dst[i] = z;
      }
    }
  }
}

extern "C" int dispatch_gather(const void* x, const void* src, void* out,
                               int T, int R, long long row_bytes,
                               void* stream) {
  if (R <= 0) return 0;
  if (row_bytes % 16 != 0) return (int)cudaErrorInvalidValue;
  const int vec = (int)(row_bytes / 16);
  int threads = ((vec + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  if (threads < 32) threads = 32;
  const int blocks = R < (1 << 30) ? R : (1 << 30);
  dispatch_gather_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint4*)x, (const int32_t*)src, (uint4*)out, T, R, vec);
  return (int)cudaGetLastError();
}
