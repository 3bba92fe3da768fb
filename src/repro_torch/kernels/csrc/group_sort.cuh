// The phases of a stable counting sort over small-domain int32 keys, shared
// by group_sort.cu and router_fused.cu.
//
// The sort gives each key a rank: the number of keys below it plus the
// number of equal keys before it.  Both routes cut the keys into
// contiguous segments, count each segment's keys, take one exclusive scan
// of the counts in key-major, segment-minor order (which gives each key's
// base in each segment, and starts), and add the base to each key's rank
// within its segment.
//
// One launch (one_launch_kernel, for up to kOneMaxKeys key values and a
// block's worth of keys): one block of W warps; warp w holds the keys
// [w * steps * 32, + steps * 32) in registers.
//   1. In one pass over the keys each warp counts its segment in its own
//      row of shared counters and gives each key its rank within the
//      segment: at each step of 32 keys the lanes holding equal keys find
//      each other (equal_lanes: a ballot per key bit), and a lane's rank is
//      the running count plus the number of lower equal lanes.  No warp
//      waits on another.
//   2. Each key's counts are scanned over the warps in place (a segmented
//      shuffle scan); the key's total goes to tot.
//   3. One block scan over the keys gives each key's first rank, and
//      starts.
//   4. Each key's rank is that base plus its warp's prefix plus its rank in
//      the segment.
//
// Three launches (for more keys or key values): hist_kernel counts each
// block's chunk, scan_kernel scans the counts (scan_counts below), and
// rank_kernel walks each chunk again in 256-key tiles, the warps taking
// their turns.  The router's last-arriving block runs scan_counts too.
//
// No step depends on the order of atomics or of blocks, so the ranks are
// those of a stable sort, bit for bit.  A key outside [0, K) is not counted
// and gets rank -1.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace group_sort_phases {

constexpr int kThreads = 256;       // hist and rank blocks
constexpr int kScanThreads = 1024;  // the one scan block
constexpr int kMaxKeys = 8192;      // 32 KB of shared counters
// the one-launch route: warps, keys a lane holds, key values
constexpr int kOneMaxWarps = 16;
constexpr int kOneSteps = 8;
constexpr int kOneMaxKeys = 1024;

constexpr int kMaxDevices = 64;

// Let `kernel` take `smem` bytes of dynamic shared memory (past the default
// 48 KB the attribute must be raised first).  `allowed`, one per kernel,
// remembers per device what it has been raised to, so that a launch costs
// no extra host call after the first.
inline cudaError_t allow_shared_memory(const void* kernel, size_t smem,
                                       size_t (&allowed)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return err;
}

// The exclusive prefix of v over the block in thread order; *total gets the
// block's sum.  Every thread calls it; blockDim.x is a multiple of 32 and
// scratch holds 33 ints of shared memory.
__device__ __forceinline__ int32_t block_exclusive_scan(int32_t v,
                                                        int32_t* scratch,
                                                        int32_t* total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int32_t incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int32_t u = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += u;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int32_t s = lane < nwarps ? scratch[lane] : 0;
    int32_t si = s;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t u = __shfl_up_sync(0xffffffffu, si, off);
      if (lane >= off) si += u;
    }
    scratch[lane] = si - s;
    if (lane == 31) scratch[32] = si;
  }
  __syncthreads();
  const int32_t out = scratch[warp] + incl - v;
  *total = scratch[32];
  __syncthreads();                     // scratch is free again on return
  return out;
}

constexpr int kScanBatch = 8;         // counts a thread loads at once

template <bool kL2>
__device__ __forceinline__ int32_t load_count(const int32_t* p) {
  if (kL2) return __ldcg(p);
  return *p;
}

// One block: counts (n = K * nb entries, key-major, block-minor) in place to
// their exclusive prefix sum; starts (K + 1) from it.  Each thread sums a
// contiguous segment, kScanBatch loads in flight at a time, the segment
// sums are scanned across the block, and each thread then writes its
// segment's prefix (the second pass reads the segment again: from L1 in
// the standalone scan, from registers for its first batch).  kL2: the
// counts come from other blocks of the same launch (the router's last
// block), so they are read past L1.  The total is at most 2^31 - 1, so
// int32 holds it.
template <bool kL2>
__device__ __forceinline__ void scan_counts(int32_t* counts, long long n,
                                            int nb, int K, int32_t* starts,
                                            int32_t* scratch) {
  const long long per = (n + blockDim.x - 1) / blockDim.x;
  long long lo = (long long)threadIdx.x * per;
  if (lo > n) lo = n;
  const long long hi = lo + per < n ? lo + per : n;
  int32_t head[kScanBatch];
  int32_t sum = 0;
  for (long long i0 = lo; i0 < hi; i0 += kScanBatch) {
    int32_t c[kScanBatch];
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      c[j] = i0 + j < hi ? load_count<kL2>(counts + i0 + j) : 0;
    }
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      sum += c[j];
      if (i0 == lo) head[j] = c[j];
    }
  }
  int32_t total;
  int32_t run = block_exclusive_scan(sum, scratch, &total);
  long long key = lo / nb;             // entry lo's key and block, stepped
  int b = (int)(lo - key * nb);
  for (long long i0 = lo; i0 < hi; i0 += kScanBatch) {
    int32_t c[kScanBatch];
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      c[j] = i0 == lo ? head[j]
                      : (i0 + j < hi ? load_count<kL2>(counts + i0 + j) : 0);
    }
#pragma unroll
    for (int j = 0; j < kScanBatch; ++j) {
      if (i0 + j < hi) {
        counts[i0 + j] = run;
        if (b == 0) starts[key] = run;
        run += c[j];
        if (++b == nb) {
          b = 0;
          ++key;
        }
      }
    }
  }
  if (threadIdx.x == 0) starts[K] = total;
}

// The lanes of the warp whose v equals this lane's, for v in [0, 2^bits):
// one ballot per bit of v, kept where the lane's bit is set and inverted
// where it is not.  The same mask as __match_any_sync(v), whose cost grows
// with the number of distinct values in the warp; this one's with their
// width (5 bits for 17 keys, 8 for 129).
__device__ __forceinline__ unsigned equal_lanes(unsigned v, int bits) {
  unsigned peers = 0xffffffffu;
  for (int i = 0; i < bits; ++i) {
    const bool one = (v >> i) & 1u;
    const unsigned set = __ballot_sync(0xffffffffu, one);
    peers &= one ? set : ~set;
  }
  return peers;
}

// The bits of the values 0..K: the keys and the value K, which stands for
// a key outside [0, K).
__device__ __forceinline__ int key_bits(int K) { return 32 - __clz(K); }

// ---- the one-launch route ------------------------------------------------

// Shared memory of one_launch_kernel, in int32 words, for W warps.
__host__ __device__ constexpr long long one_launch_words(int W, int K) {
  return (long long)W * (K | 1) + 2LL * K + 33;
}

__global__ void __launch_bounds__(kOneMaxWarps * 32)
one_launch_kernel(const int32_t* __restrict__ keys, int A, int K, int steps,
                  int32_t* __restrict__ ranks, int32_t* __restrict__ starts) {
  extern __shared__ int32_t sm[];
  const int W = blockDim.x >> 5;       // a power of two, at most 16
  const int S = K | 1;                 // odd row stride of the counters
  int32_t* hist = sm;                  // [W][S] per-(warp, key) counts
  int32_t* tot = hist + W * S;         // [K] the count per key
  int32_t* base = tot + K;             // [K] each key's first rank
  int32_t* scratch = base + K;         // [33]
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  for (int i = tid; i < W * S; i += blockDim.x) hist[i] = 0;

  // 1. load the warp's segment, then rank it within the segment
  const int seg = warp * steps * 32;
  int32_t v[kOneSteps];
#pragma unroll
  for (int s = 0; s < kOneSteps; ++s) {
    const int a = seg + s * 32 + lane;
    v[s] = (s < steps && a < A) ? __ldg(keys + a) : -1;
  }
  __syncthreads();
  int32_t* h = hist + warp * S;
  const unsigned lower = (1u << lane) - 1u;
  const int bits = key_bits(K);
#pragma unroll
  for (int s = 0; s < kOneSteps; ++s) {
    if (s < steps) {                   // the same for the whole warp
      const int key = v[s];
      const bool ok = (unsigned)key < (unsigned)K;
      // every lane without a key in [0, K) carries K, so it never groups
      // with one
      const unsigned peers = equal_lanes(ok ? key : K, bits);
      const int below = __popc(peers & lower);
      const int within = ok ? h[key] + below : 0;
      __syncwarp();
      if (ok && below == 0) h[key] += __popc(peers);
      __syncwarp();
      // a rank in the segment is below steps * 32 <= 256: it fits above
      // the key's 16 bits
      v[s] = ok ? (within << 16 | key) : -1;
    }
  }
  __syncthreads();

  // 2. per key, the exclusive prefix over the warps in place, and the
  // block's count; the W counts of a key sit in W adjacent lanes
  const int n = K * W;
  for (int i0 = 0; i0 < n; i0 += blockDim.x) {
    const int i = i0 + tid;
    const int key = i / W, w = i & (W - 1);
    const int32_t c = i < n ? hist[w * S + key] : 0;
    int32_t incl = c;
    for (int off = 1; off < W; off <<= 1) {
      const int32_t u = __shfl_up_sync(0xffffffffu, incl, off, W);
      if (w >= off) incl += u;
    }
    if (i < n) {
      hist[w * S + key] = incl - c;
      if (w == W - 1) tot[key] = incl;
    }
  }
  __syncthreads();

  // 3. one scan over the keys, a contiguous run of keys a thread
  const int per = (K + blockDim.x - 1) / blockDim.x;
  int k0 = tid * per;
  if (k0 > K) k0 = K;
  const int k1 = k0 + per < K ? k0 + per : K;
  int32_t sum = 0;
  for (int key = k0; key < k1; ++key) sum += tot[key];
  int32_t total;
  int32_t run = block_exclusive_scan(sum, scratch, &total);
  for (int key = k0; key < k1; ++key) {
    starts[key] = run;
    base[key] = run;
    run += tot[key];
  }
  if (tid == 0) starts[K] = total;
  __syncthreads();

  // 4. the ranks
#pragma unroll
  for (int s = 0; s < kOneSteps; ++s) {
    const int a = seg + s * 32 + lane;
    if (s < steps && a < A) {
      const int32_t p = v[s];
      const int key = p & 0xffff;
      ranks[a] = p < 0 ? -1 : base[key] + hist[warp * S + key] + (p >> 16);
    }
  }
}

// ---- the three-launch route ------------------------------------------------

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

__global__ void __launch_bounds__(kScanThreads)
scan_kernel(int32_t* __restrict__ counts, long long n, int nb, int K,
            int32_t* __restrict__ starts) {
  __shared__ int32_t scratch[33];
  scan_counts<false>(counts, n, nb, K, starts, scratch);
}

// Block b walks its chunk again in order, 256 keys at a time, with a
// running per-key counter in shared memory that starts at base[key * nb +
// b].  Within a warp, the lanes holding equal keys find each other
// (equal_lanes); a lane's rank is the counter plus the number of lower
// equal lanes.  The warps of a block take their turns in warp order, and
// after its turn the lowest lane of each equal-key group adds the group's
// size to the counter.
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
    // every out-of-domain lane carries K, so it never groups with a key
    const unsigned peers = equal_lanes(ok ? key : K, key_bits(K));
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

}  // namespace group_sort_phases
