// The fused routing prologue for Hopper (sm_90a): router GEMM, softmax,
// top-k and the dispatch positions over the chosen experts.
//
//   x (t, d) bf16 or fp32, w (d, E) fp32  ->  logits, probs (t, E) fp32,
//   gates (t, k) fp32, idx (t, k) int32, ranks (t * k,) int32,
//   starts (E + 1,) int32
//
// Replaces the TPU kernel src/repro/kernels/router_fused.py
// router_fused_pallas.  That kernel runs one pass over 128-row tiles and
// carries the expert histogram across the sequential grid in VMEM scratch.
// Here the first kernel does the GEMM, the softmax, top-k and a per-block
// histogram; the scan and rank phases of the counting sort
// (group_sort.cuh, shared with group_sort.cu) then turn the histograms into
// starts and each assignment's stable rank, since CUDA blocks carry nothing
// over from one to the next.
//
// Design of the first kernel: one block of 256 threads per 16 tokens.  The
// block stages 16 x 128 columns of x at a time in shared memory as fp32 (x
// is cast inside the kernel, as jnp.dot(x.astype(f32), ...) does), and
// each thread owns one expert column and one of 256 / E slices of d, with 16
// fp32 accumulators in registers: the GEMM is fp32 on the CUDA cores,
// never TF32.  Each staged chunk is summed apart and then added to the
// running sum, and the slices are summed in a fixed order in shared memory.
// Then one warp per token computes the softmax (max-subtracted,
// exp(l - m) / sum, as torch.softmax) and k rounds of max extraction in
// which the lowest expert index wins ties, the order lax.top_k guarantees.
// Gate renormalisation stays in the wrapper.  E may be anything up to 256.
//
// What bounds it on the card: launches.  At the training shapes (t = 2,048
// x d = 768 x E = 16, or 4,096 x 768 x 8) the GEMM is 50 MFLOP (under a
// microsecond at 67 TFLOP/s fp32) and the bytes are x plus logits and probs
// (3 MB), about a microsecond at 3.35 TB/s; three launches cost more.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; returns the cudaError_t of the launches.  The caller allocates
// `counts` (E * nb int32, nb = ceil(t / 16)) as scratch.

#include <cuda_bf16.h>

#include "group_sort.cuh"

using namespace group_sort_phases;

namespace {

constexpr int kRows = 16;        // tokens per block
constexpr int kChunk = 128;      // columns of x staged per step
constexpr int kMaxExperts = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
router_kernel(const T* __restrict__ x, const float* __restrict__ w, int t,
              int d, int E, int k, float* __restrict__ logits,
              float* __restrict__ probs, float* __restrict__ gates,
              int32_t* __restrict__ idx, int32_t* __restrict__ counts,
              int nb) {
  __shared__ float xs[kRows][kChunk];
  // the d-slices' partial sums; later each token's top-k work row
  __shared__ float part[kThreads * kRows];
  __shared__ float lg[kRows][kMaxExperts];
  __shared__ int32_t hist[kMaxExperts];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int S = kThreads / E;
  const int e = tid % E;
  const int s = tid / E;
  const bool active = s < S;
  for (int i = tid; i < E; i += kThreads) hist[i] = 0;

  float acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int c0 = 0; c0 < d; c0 += kChunk) {
    const int width = d - c0 < kChunk ? d - c0 : kChunk;
    for (int i = tid; i < kRows * kChunk; i += kThreads) {
      const int r = i / kChunk, c = i % kChunk;
      const int row = row0 + r;
      xs[r][c] = (row < t && c < width)
                     ? to_f32(x[(size_t)row * d + c0 + c]) : 0.f;
    }
    __syncthreads();
    if (active) {
      // a fresh sum per staged chunk, added to the running one: two short
      // chains instead of one of d / S terms, so the rounding error stays
      // well under that of a single fp32 chain over d
      float cacc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) cacc[r] = 0.f;
      for (int c = s; c < width; c += S) {
        const float wv = w[(size_t)(c0 + c) * E + e];
#pragma unroll
        for (int r = 0; r < kRows; ++r) cacc[r] = fmaf(xs[r][c], wv, cacc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] += cacc[r];
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[(s * kRows + r) * E + e] = acc[r];
  }
  __syncthreads();
  for (int o = tid; o < kRows * E; o += kThreads) {
    const int r = o / E, j = o % E;
    float v = 0.f;
    for (int q = 0; q < S; ++q) v += part[(q * kRows + r) * E + j];
    lg[r][j] = v;
  }
  __syncthreads();

  // softmax and top-k, one warp per token
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    const int row = row0 + r;
    if (row >= t) continue;                      // the same for the warp
    float m = neg_inf();
    for (int j = lane; j < E; j += 32) m = fmaxf(m, lg[r][j]);
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    float sum = 0.f;
    for (int j = lane; j < E; j += 32) sum += expf(lg[r][j] - m);
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    float* work = part + r * kMaxExperts;
    for (int j = lane; j < E; j += 32) {
      const float l = lg[r][j];
      const float p = expf(l - m) / sum;
      logits[(size_t)row * E + j] = l;
      probs[(size_t)row * E + j] = p;
      work[j] = p;
    }
    __syncwarp();
    for (int q = 0; q < k; ++q) {
      float best = neg_inf();
      int bi = E;
      for (int j = lane; j < E; j += 32) {
        const float v = work[j];
        if (v > best || (v == best && j < bi)) { best = v; bi = j; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
      }
      if (lane == 0) {
        gates[(size_t)row * k + q] = best;
        idx[(size_t)row * k + q] = bi;
        atomicAdd(&hist[bi], 1);                 // a count: order-free
        work[bi] = neg_inf();
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int i = tid; i < E; i += kThreads) {
    counts[(long long)i * nb + blockIdx.x] = hist[i];
  }
}

}  // namespace

extern "C" int router_fused(const void* x, int x_bf16, const void* w, int t,
                            int d, int E, int k, void* logits, void* probs,
                            void* gates, void* idx, void* counts, int nb,
                            void* ranks, void* starts, void* stream) {
  if (t <= 0 || d <= 0 || E < 1 || E > kMaxExperts || k < 1 || k > E ||
      nb != (t + kRows - 1) / kRows) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    router_kernel<__nv_bfloat16><<<nb, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x, (const float*)w, t, d, E, k,
        (float*)logits, (float*)probs, (float*)gates, (int32_t*)idx,
        (int32_t*)counts, nb);
  } else {
    router_kernel<float><<<nb, kThreads, 0, s>>>(
        (const float*)x, (const float*)w, t, d, E, k, (float*)logits,
        (float*)probs, (float*)gates, (int32_t*)idx, (int32_t*)counts, nb);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return scan_and_rank((const int32_t*)idx, (long long)t * k,
                       (long long)kRows * k, E, nb, (int32_t*)counts,
                       (int32_t*)ranks, (int32_t*)starts, s);
}
