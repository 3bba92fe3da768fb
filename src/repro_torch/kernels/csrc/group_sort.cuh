// The three phases of a stable counting sort over small-domain int32 keys,
// shared by group_sort.cu and router_fused.cu.
//
// The keys are cut into nb contiguous chunks, one thread block each:
//
//   1. hist:  block b counts its chunk's keys in shared memory and writes
//             counts[key * nb + b] (key-major, block-minor).  The shared
//             atomics only count, so the result does not depend on their
//             order.
//   2. scan:  one block turns counts into their exclusive prefix sum, in
//             place, in that key-major, block-minor order: base[key * nb + b]
//             = #keys < key + #(key in chunks < b).  starts[key] is
//             base[key * nb] and starts[K] the total.
//   3. rank:  block b walks its chunk again in order, 256 keys at a time,
//             with a running per-key counter in shared memory that starts
//             at base[key * nb + b].  Within a warp, the lanes holding equal
//             keys find each other with __match_any_sync; a lane's rank is
//             the counter plus the number of lower equal lanes.  The warps
//             of a block take their turns in warp order, and after its turn
//             the lowest lane of each equal-key group adds the group's size
//             to the counter.  No step depends on the order of atomics, so
//             the ranks are those of a stable sort, bit for bit.
//
// A key outside [0, K) is not counted and gets rank -1.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace group_sort_phases {

constexpr int kThreads = 256;       // hist and rank blocks
constexpr int kScanThreads = 1024;  // the one scan block
constexpr int kMaxKeys = 8192;      // 32 KB of shared counters

__global__ void __launch_bounds__(kThreads)
hist_kernel(const int32_t* __restrict__ keys, long long A, long long chunk,
            int K, int nb, int32_t* __restrict__ counts) {
  extern __shared__ int32_t h[];
  for (int i = threadIdx.x; i < K; i += blockDim.x) h[i] = 0;
  __syncthreads();
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < A ? lo + chunk : A;
  for (long long a = lo + threadIdx.x; a < hi; a += blockDim.x) {
    const int key = keys[a];
    if ((unsigned)key < (unsigned)K) atomicAdd(&h[key], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    counts[(long long)i * nb + blockIdx.x] = h[i];
  }
}

// One block: base (n = K * nb entries) in place to its exclusive prefix sum;
// starts (K + 1) from it.  Each thread sums a contiguous segment, the
// segment sums are scanned in shared memory, and each thread then writes its
// segment's prefix.  The total is at most A < 2^31, so int32 holds it.
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int32_t* __restrict__ base, long long n, int nb, int K,
            int32_t* __restrict__ starts) {
  __shared__ int32_t part[kScanThreads];
  const int tid = threadIdx.x;
  const long long per = (n + blockDim.x - 1) / blockDim.x;
  long long lo = (long long)tid * per;
  if (lo > n) lo = n;
  const long long hi = lo + per < n ? lo + per : n;
  int32_t sum = 0;
  for (long long i = lo; i < hi; ++i) sum += base[i];
  part[tid] = sum;
  __syncthreads();
  for (int off = 1; off < (int)blockDim.x; off <<= 1) {
    const int32_t v = tid >= off ? part[tid - off] : 0;
    __syncthreads();
    part[tid] += v;
    __syncthreads();
  }
  int32_t run = part[tid] - sum;
  for (long long i = lo; i < hi; ++i) {
    const int32_t c = base[i];
    base[i] = run;
    if (i % nb == 0) starts[i / nb] = run;
    run += c;
  }
  if (tid == (int)blockDim.x - 1) starts[K] = part[tid];
}

__global__ void __launch_bounds__(kThreads)
rank_kernel(const int32_t* __restrict__ keys, long long A, long long chunk,
            int K, int nb, const int32_t* __restrict__ base,
            int32_t* __restrict__ ranks) {
  extern __shared__ int32_t run[];
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    run[i] = base[(long long)i * nb + blockIdx.x];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const unsigned lower_lanes = (1u << lane) - 1u;
  const long long lo = (long long)blockIdx.x * chunk;
  const long long hi = lo + chunk < A ? lo + chunk : A;
  for (long long tile = lo; tile < hi; tile += blockDim.x) {
    const long long a = tile + threadIdx.x;
    const bool in = a < hi;
    const int key = in ? keys[a] : -1;
    const bool ok = in && (unsigned)key < (unsigned)K;
    // every out-of-domain lane carries -1, so it never groups with a key
    const unsigned peers = __match_any_sync(0xffffffffu, ok ? key : -1);
    const int below = __popc(peers & lower_lanes);
    for (int w = 0; w < nwarps; ++w) {
      if (warp == w && ok) ranks[a] = run[key] + below;
      __syncwarp();
      if (warp == w && ok && below == 0) run[key] += __popc(peers);
      __syncthreads();
    }
    if (in && !ok) ranks[a] = -1;
  }
}

// Phases 2 and 3 on keys whose per-chunk counts are already in `counts`.
inline int scan_and_rank(const int32_t* keys, long long A, long long chunk,
                         int K, int nb, int32_t* counts, int32_t* ranks,
                         int32_t* starts, cudaStream_t stream) {
  scan_kernel<<<1, kScanThreads, 0, stream>>>(counts, (long long)K * nb, nb,
                                              K, starts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rank_kernel<<<nb, kThreads, K * sizeof(int32_t), stream>>>(
      keys, A, chunk, K, nb, counts, ranks);
  return (int)cudaGetLastError();
}

}  // namespace group_sort_phases
