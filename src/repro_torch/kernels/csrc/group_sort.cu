// Stable counting sort of small-domain int32 keys for Hopper (sm_90a):
// keys (A,) in [0, K) -> ranks (A,), each key's position in the stable sort,
// and starts (K + 1,), the exclusive prefix counts (starts[k] = #keys < k).
//
// Replaces the TPU kernel src/repro/kernels/radix_sort.py group_sort_pallas.
// That kernel runs one pass over the row tiles and carries a running
// histogram from one grid step to the next in VMEM scratch, which works
// because the TPU grid runs in order.  CUDA blocks run in no order and carry
// nothing over, so this is a count, a scan and a rank pass instead (the three
// phases in group_sort.cuh): a per-block histogram, one exclusive scan in
// key-major, block-minor order that gives every block its base per key and
// gives starts, and a second walk over each block's chunk in which equal
// keys of a warp find each other with __match_any_sync and the warps take
// their turns in order.  The ranks are bit-identical to the inverse of
// torch.sort(keys, stable=True)'s permutation.
//
// What bounds it on the card: bytes and launches.  The least work is to read
// the keys once and write ranks and starts once, 8 bytes per key; the three
// launches read the keys twice.  At the dispatch shapes (A = 2,048 or 4,096
// keys over 17 or 129 values) the work is a few microseconds of launches;
// the block count is capped so that the counts array (K * nb) and the one
// scan block stay small.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; returns the cudaError_t of the launches.  The caller allocates
// `counts` (K * nb int32) as scratch.

#include "group_sort.cuh"

using namespace group_sort_phases;

extern "C" int group_sort(const void* keys, long long A, int K, int nb,
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
  return scan_and_rank((const int32_t*)keys, A, chunk, K, nb,
                       (int32_t*)counts, (int32_t*)ranks, (int32_t*)starts,
                       s);
}
