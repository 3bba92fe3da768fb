// Stable counting sort of small-domain int32 keys for Hopper (sm_90a):
// keys (A,) in [0, K) -> ranks (A,), each key's position in the stable sort,
// and starts (K + 1,), the exclusive prefix counts (starts[k] = #keys < k).
//
// Replaces the TPU kernel src/repro/kernels/radix_sort.py group_sort_pallas.
// That kernel runs one pass over the row tiles and carries a running
// histogram from one grid step to the next in VMEM scratch, which works
// because the TPU grid runs in order.  CUDA blocks run in no order and carry
// nothing over.  Here (the phases in group_sort.cuh):
//
//   group_sort_one: one launch of one block (up to 16 warps, each lane
//     holding up to 8 keys in registers).  Each warp counts and ranks its
//     own segment (equal keys found by a ballot per key bit), one scan
//     over the warps' counts gives each key's base, and the block finishes
//     the ranks: one read of the keys, one write of ranks and starts, no
//     scratch in device memory.  For up to 4,096 keys over up to 1,024
//     values; ops.sort_route picks the layout.
//   group_sort_three: a per-block histogram, one exclusive scan in
//     key-major, block-minor order, and a second walk over each block's
//     chunk in which the warps take their turns: three launches, for any
//     A < 2^31 over up to 8,192 values.  The caller allocates `counts`
//     (K * nb int32) as scratch.
//
// The ranks are bit-identical to the inverse of torch.sort(keys,
// stable=True)'s permutation on either route.
//
// What bounds it on the card: launches.  The least work is to read the keys
// once and write ranks and starts once, 8 bytes a key: at the dispatch
// shapes (2,048 or 4,096 keys over 17 or 129 values) a hundredth of a
// microsecond, so one launch is the whole of its time.
//
// launch_floor launches an empty kernel: the least a launch through this
// ctypes path costs, which chip_smoke.py measures beside the bounds.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; each function returns the cudaError_t of its launches.

#include "group_sort.cuh"

using namespace group_sort_phases;

extern "C" int group_sort_one(const void* keys, long long A, int K,
                              int warps, int steps, void* ranks, void* starts,
                              void* stream) {
  if (A <= 0 || K < 1 || K > kOneMaxKeys || warps < 1 || warps > kOneMaxWarps ||
      (warps & (warps - 1)) != 0 || steps < 1 || steps > kOneSteps ||
      A > (long long)warps * 32 * steps) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)one_launch_words(warps, K) * sizeof(int32_t);
  static size_t allowed[kMaxDevices] = {};
  cudaError_t err = allow_shared_memory((const void*)one_launch_kernel, smem,
                                        allowed);
  if (err != cudaSuccess) return (int)err;
  one_launch_kernel<<<1, warps * 32, smem, (cudaStream_t)stream>>>(
      (const int32_t*)keys, (int)A, K, steps, (int32_t*)ranks,
      (int32_t*)starts);
  return (int)cudaGetLastError();
}

extern "C" int group_sort_three(const void* keys, long long A, int K, int nb,
                                long long chunk, void* counts, void* ranks,
                                void* starts, void* stream) {
  if (A <= 0 || K < 1 || K > kMaxKeys || nb < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  hist_kernel<<<nb, kThreads, K * sizeof(int32_t), s>>>(
      (const int32_t*)keys, A, chunk, K, nb, (int32_t*)counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, kScanThreads, 0, s>>>((int32_t*)counts, (long long)K * nb,
                                         nb, K, (int32_t*)starts);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rank_kernel<<<nb, kThreads, K * sizeof(int32_t), s>>>(
      (const int32_t*)keys, A, chunk, K, nb, (const int32_t*)counts,
      (int32_t*)ranks);
  return (int)cudaGetLastError();
}

__global__ void empty_kernel() {}

extern "C" int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
