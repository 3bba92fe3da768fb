// RWKV6 (WKV6) recurrence for Hopper (sm_90a), per (batch, head):
//   y_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
// r/k/v/w (B, T, nh, 64) fp32, u (nh, 64), s0 (B, nh, 64, 64) fp32 ->
// y (B, T, nh, 64) fp32 and the final state s_last (B, nh, 64, 64) fp32.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan.py
// rwkv6_scan_pallas: grid (B, nh), the state S resident on chip and the
// time series streamed through it in a fori_loop over T.
//
// What bounds it on the card: the chain of T dependent steps.  Counted as
// ~7 * hd^2 fp32 operations per (b, h, t) (1.5e10 at rwkv6-1.6b's
// (4, 4096, 32, 64): 0.22 ms at 67 TFLOP/s) against ~0.34 GB of bytes
// (0.10 ms); but each step waits on the last, so what the kernel can do is
// keep a step short.  Design: one 256-thread block per (b, h), 128 blocks at
// B = 4, about one per SM.  The state never leaves registers: thread
// (j, q) = (tid / 4, tid % 4) holds column j's 16 entries i = q, q + 4, ...,
// q + 60, so a step is 16 fused updates a thread, and y_j's four partial
// sums sit in four neighbouring lanes of one warp and are added by two
// shuffles in a fixed order ((q0 + q1) + (q2 + q3)): no shared memory, no
// block barrier and no atomics per step, the same bits on every run.  r, k,
// v and w are staged through shared memory 32 steps at a time with
// coalesced 16-byte row loads; the four i's a warp reads at once fall in
// four banks.
//
// Arithmetic: everything fp32, nothing TF32.  The state update is w * S,
// rounded, then + k v, rounded (__fmul_rn / __fadd_rn, no fused multiply-
// add), as the plain version computes it, so s_last matches it bit for bit
// where k v is formed the same way; y's sum over i runs in another order
// than the plain version's product, within fp32 rounding.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;            // head size
constexpr int QUARTERS = 4;       // threads per state column
constexpr int PER = HD / QUARTERS;  // state entries per thread
constexpr int THREADS = HD * QUARTERS;
constexpr int TC = 32;            // time steps staged per chunk

__global__ void __launch_bounds__(THREADS)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ s_last, int T,
                  int nh) {
  __shared__ __align__(16) float sr[TC][HD];
  __shared__ __align__(16) float sk[TC][HD];
  __shared__ __align__(16) float sv[TC][HD];
  __shared__ __align__(16) float sw[TC][HD];

  const int b = blockIdx.x / nh, h = blockIdx.x % nh;
  const int tid = threadIdx.x;
  const int j = tid / QUARTERS, q = tid % QUARTERS;
  const size_t state = ((size_t)b * nh + h) * HD * HD;

  float S[PER], uu[PER];
#pragma unroll
  for (int a = 0; a < PER; ++a) {
    const int i = q + QUARTERS * a;
    S[a] = s0[state + (size_t)i * HD + j];
    uu[a] = u[(size_t)h * HD + i];
  }

  for (int t0 = 0; t0 < T; t0 += TC) {
    const int n = min(TC, T - t0);
    __syncthreads();  // every thread is done with the previous chunk
    for (int e = tid; e < n * (HD / 4); e += THREADS) {
      const int row = e / (HD / 4), c = (e % (HD / 4)) * 4;
      const size_t off = (((size_t)b * T + t0 + row) * nh + h) * HD + c;
      *reinterpret_cast<float4*>(&sr[row][c]) =
          *reinterpret_cast<const float4*>(r + off);
      *reinterpret_cast<float4*>(&sk[row][c]) =
          *reinterpret_cast<const float4*>(k + off);
      *reinterpret_cast<float4*>(&sv[row][c]) =
          *reinterpret_cast<const float4*>(v + off);
      *reinterpret_cast<float4*>(&sw[row][c]) =
          *reinterpret_cast<const float4*>(w + off);
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt][j];
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < PER; ++a) {
        const int i = q + QUARTERS * a;
        const float kv = __fmul_rn(sk[tt][i], vj);
        acc = fmaf(sr[tt][i], __fadd_rn(S[a], __fmul_rn(uu[a], kv)), acc);
        S[a] = __fadd_rn(__fmul_rn(sw[tt][i], S[a]), kv);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (q == 0) y[(((size_t)b * T + t0 + tt) * nh + h) * HD + j] = acc;
    }
  }

#pragma unroll
  for (int a = 0; a < PER; ++a) {
    const int i = q + QUARTERS * a;
    s_last[state + (size_t)i * HD + j] = S[a];
  }
}

}  // namespace

extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_last, int B, int T, int nh, int hd,
                          void* stream) {
  if (hd != HD || B < 0 || T < 0 || nh < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || nh == 0) return 0;
  rwkv6_scan_kernel<<<B * nh, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (const float*)s0, (float*)y, (float*)s_last, T, nh);
  return (int)cudaGetLastError();
}
