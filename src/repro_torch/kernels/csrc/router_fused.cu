// The fused routing prologue for Hopper (sm_90a), in one launch: router
// GEMM, softmax, top-k and the dispatch positions over the chosen experts.
//
//   x (t, d) bf16 or fp32, w (d, E) fp32  ->  logits, probs (t, E) fp32,
//   gates (t, k) fp32, idx (t, k) int32, ranks (t * k,) int32,
//   starts (E + 1,) int32
//
// Replaces the TPU kernel src/repro/kernels/router_fused.py
// router_fused_pallas.  That kernel runs one pass over 128-row tiles and
// carries the expert histogram across the sequential grid in VMEM scratch.
// CUDA blocks run in no order, so here each block of 16 tokens computes its
// own histogram and its assignments' ranks within the block, and the
// last block to arrive turns the histograms into starts and each
// assignment's stable rank.
//
// GEMM: each block stages w and its 16 rows of x in shared memory, chunk by
// chunk of d, through a ring of up to 8 cp.async stages (at the path's
// shapes all of d, 6 chunks, is in flight before the first is summed, so
// the block waits one memory latency, not one a chunk), so w crosses into
// each block's shared memory once and is never read from device memory in
// the inner loop.  x is cast to
// fp32 as it is read (jnp.dot(x.astype(f32), ...)); the GEMM is fp32 on the
// CUDA cores, never TF32.  A thread owns 4 experts x 16 rows (64 fp32
// accumulators) over a slice of the chunk's columns: per column, one
// 16-byte load of w and 16 of x feed 64 FMAs.  w's rows are padded in
// shared memory so that 8 adjacent columns' 16-byte loads fall in distinct
// banks.  The slices' partial sums are added in a fixed tree: first across
// the lanes of a warp (log2 of the slices in a warp halving steps, after
// which each lane holds whole sums of 64 / that many outputs), then across
// warps in shared memory, in slice order.  E is padded to a power of two,
// at least 4: the block's threads = (E / 4 expert groups) x (slices).  A
// block has 512 threads where all blocks fit one wave at one block an SM
// (128 registers a thread), else 256 at two an SM.
//
// Softmax and top-k: one warp per token; softmax max-subtracted, exp(l - m)
// / sum as torch.softmax; k rounds of max extraction in which the lowest
// expert index wins ties and NaN ranks above every number, the order
// lax.top_k guarantees.  Gate
// renormalisation stays in the wrapper.
//
// Positions: one warp walks the block's assignments in token-major,
// slot-minor order, 32 at a time; lanes holding equal experts find each
// other (group_sort.cuh's equal_lanes), and a lane's rank within the block
// is the running count of its expert plus the lower equal lanes.  The block
// writes its per-expert counts (key-major, block-minor), fences, and takes
// a ticket.  The block that draws the last ticket scans the counts
// (group_sort.cuh's scan_counts, in shared memory where they fit), writes
// starts, adds each assignment's base to its rank, and sets the ticket
// counter back to 0.  Logits and probs are written after the ticket, so
// that the fence before it waits on fewer stores.  Every output is
// a function of the counts alone, so which block arrives last changes no
// bit.  The counter is one int32 per stream, zero when the wrapper first
// allocates it and zero again at the end of every launch; a launch on
// another stream uses its own, so two launches never share one.
//
// What bounds it on the card: launches.  At the training shapes (t = 2,048
// x d = 768 x E = 16, or 4,096 x 768 x 8) the GEMM is 50 MFLOP (under a
// microsecond at 67 TFLOP/s fp32) and the bytes are x plus logits and probs
// (3 MB), about a microsecond at 3.35 TB/s; one launch, with its last
// block's serial scan, is the floor.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; returns the cudaError_t of the launch.  The caller allocates
// `counts` (E * nb int32, nb = ceil(t / 16)) as scratch and keeps `ticket`.

#include <cuda_bf16.h>

#include "group_sort.cuh"

using namespace group_sort_phases;

namespace {

constexpr int kMaxThreads = 512;       // threads a block, or half that
constexpr int kRows = 16;              // tokens per block
constexpr int kMaxExperts = 256;
constexpr int kAcc = kRows * 4;        // accumulators a thread
constexpr int kMaxChunk = 256;         // columns of d staged per step
constexpr int kMaxStages = 8;          // chunks in flight
constexpr int kStageBudget = 160 * 1024;  // bytes of the stages together
constexpr int kFixBatch = 8;           // the last block's loads in flight

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

// top-k's order: NaN above every number (as lax.top_k), the lower expert
// index on ties, so that a NaN row (a fault plan's) picks its lanes in
// order and never an index past E
__device__ __forceinline__ bool ranks_above(float v, int j, float b, int bj) {
  const bool vn = v != v, bn = b != b;
  if (vn != bn) return vn;
  return v > b || ((v == b || vn) && j < bj);
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n (< kMaxStages) groups of this thread's copies are
// pending
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// One halving step of the transpose-reduce over the lanes of a slice group:
// lanes whose bit O is set keep the upper half of the N values, the others
// the lower, and each adds its partner's copy of the half it keeps.
template <int O, int N>
struct Halve {
  static __device__ __forceinline__ void run(float* acc, int lane) {
    const bool up = (lane & O) != 0;
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const float send = up ? acc[i] : acc[i + N / 2];
      const float keep = up ? acc[i + N / 2] : acc[i];
      acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    Halve<O / 2, N / 2>::run(acc, lane);
  }
};
template <int N>
struct Halve<0, N> {
  static __device__ __forceinline__ void run(float*, int) {}
};

// Stage chunk c0 of w (C rows of E, into rows of `stride` floats, zeros
// past d and past E up to Ep) and of x (16 rows of C columns, zeros past t
// and past d).
template <typename T>
__device__ __forceinline__ void stage(float* buf, const T* __restrict__ x,
                                      const float* __restrict__ w, int t,
                                      int d, int E, int Ep, int stride,
                                      int C, int c0, int row0, bool vec16,
                                      bool vecw) {
  const int tid = threadIdx.x;
  const int width = d - c0 < C ? d - c0 : C;
  if (vecw) {
    // E a multiple of 4: 16-byte pieces of w's rows (Ep / 4 a row, a power
    // of two)
    const int lgP = __ffs(Ep / 4) - 1;
    for (int i = tid; i < C * Ep / 4; i += blockDim.x) {
      const int c = i >> lgP, e = (i & (Ep / 4 - 1)) * 4;
      float* dst = buf + c * stride + e;
      if (c < width && e < E) {
        cp_async16(dst, w + (size_t)(c0 + c) * E + e);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    const int lgE = __ffs(Ep) - 1;
    for (int i = tid; i < C * Ep; i += blockDim.x) {
      const int c = i >> lgE, e = i & (Ep - 1);
      float* dst = buf + c * stride + e;
      if (c < width && e < E) {
        cp_async4(dst, w + (size_t)(c0 + c) * E + e);
      } else {
        *dst = 0.f;
      }
    }
  }
  T* xs = reinterpret_cast<T*>(buf + C * stride);
  if (vec16) {
    // row bytes and C are multiples of 16 bytes, so no piece straddles d
    constexpr int kPer = 16 / sizeof(T);
    const int P = C / kPer;
    for (int i = tid; i < kRows * P; i += blockDim.x) {
      const int r = i / P, col = (i % P) * kPer;
      T* dst = xs + r * C + col;
      if (row0 + r < t && col < width) {
        cp_async16(dst, x + (size_t)(row0 + r) * d + c0 + col);
      } else {
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
  } else {
    for (int i = tid; i < kRows * C; i += blockDim.x) {
      const int r = i / C, c = i % C;
      xs[r * C + c] = (row0 + r < t && c < width)
                          ? x[(size_t)(row0 + r) * d + c0 + c]
                          : T(0.f);
    }
  }
}

// SL: the slices of a group that share a warp, min(blockDim.x / (Ep / 4),
// 32)
template <typename T, int SL>
__global__ void __launch_bounds__(kMaxThreads)
router_kernel(const T* __restrict__ x, const float* __restrict__ w, int t,
              int d, int E, int k, int Ep, int stride, int C, int NS,
              int vec16, int vecw,
              float* __restrict__ logits, float* __restrict__ probs,
              float* __restrict__ gates, int32_t* __restrict__ idx,
              int32_t* __restrict__ counts, int nb,
              int32_t* __restrict__ ranks, int32_t* __restrict__ starts,
              unsigned* __restrict__ ticket) {
  extern __shared__ __align__(16) float smem[];
  const int G = Ep / 4;
  const int S = blockDim.x / G;                     // slices of d
  const int stage_words = C * stride + kRows * C * (int)sizeof(T) / 4;
  const int NH = S / SL;                            // warps a group spans
  int region = NS * stage_words;
  if (region < NH * kRows * Ep) region = NH * kRows * Ep;
  if (region < kRows * E) region = kRows * E;
  float* lg = smem + region;                        // [16][E]
  int32_t* ids = reinterpret_cast<int32_t*>(lg + kRows * E);  // [16 k]
  int32_t* hist = ids + kRows * k;                  // [E]
  int32_t* scratch = hist + E;                      // [33]
  int32_t* last = scratch + 33;                     // [1]
  float* row_max = reinterpret_cast<float*>(last + 1);  // [16]
  float* row_sum = row_max + kRows;                 // [16]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row0 = blockIdx.x * kRows;
  const int g = tid / S, s = tid % S;
  for (int i = tid; i < E; i += blockDim.x) hist[i] = 0;

  // GEMM over the chunks of d, a ring of NS stages: every stage is filled
  // before the first chunk is summed, and a stage is filled again with the
  // chunk NS further on as soon as it has been summed
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const int nch = (d + C - 1) / C;
  for (int st = 0; st < NS; ++st) {
    if (st < nch) {
      stage<T>(smem + st * stage_words, x, w, t, d, E, Ep, stride, C, st * C,
               row0, vec16, vecw);
    }
    cp_async_commit();                              // one group a stage
  }
  for (int ch = 0; ch < nch; ++ch) {
    cp_async_wait_at_most(NS - 1);                  // chunk ch has landed
    __syncthreads();
    float* ws = smem + (ch % NS) * stage_words;
    const T* xs = reinterpret_cast<const T*>(ws + C * stride);
    for (int c = s; c < C; c += S) {
      const float4 wv =
          *reinterpret_cast<const float4*>(ws + c * stride + 4 * g);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float xv = to_f32(xs[r * C + c]);
        acc[4 * r + 0] = fmaf(xv, wv.x, acc[4 * r + 0]);
        acc[4 * r + 1] = fmaf(xv, wv.y, acc[4 * r + 1]);
        acc[4 * r + 2] = fmaf(xv, wv.z, acc[4 * r + 2]);
        acc[4 * r + 3] = fmaf(xv, wv.w, acc[4 * r + 3]);
      }
    }
    __syncthreads();
    if (ch + NS < nch) {
      stage<T>(ws, x, w, t, d, E, Ep, stride, C, (ch + NS) * C, row0, vec16,
               vecw);
    }
    cp_async_commit();
  }

  // the slices' partial sums: across the SL lanes of a warp, then across
  // the NH warps of a group in shared memory (over the stage buffers)
  Halve<SL / 2, kAcc>::run(acc, lane);
  constexpr int NF = kAcc / SL;                     // sums a lane holds
  float* red = smem;                                // [NH][16][Ep]
  const int sh = s / SL;
#pragma unroll
  for (int j = 0; j < NF; ++j) {
    const int i = j + NF * (lane & (SL - 1));       // index r * 4 + e % 4
    red[(sh * kRows + (i >> 2)) * Ep + 4 * g + (i & 3)] = acc[j];
  }
  __syncthreads();
  for (int o = tid; o < kRows * E; o += blockDim.x) {
    const int r = o / E, e = o % E;
    float v = red[r * Ep + e];
    for (int q = 1; q < NH; ++q) v += red[(q * kRows + r) * Ep + e];
    lg[o] = v;
  }
  __syncthreads();

  // softmax and top-k, one warp per token
  for (int r = warp; r < kRows; r += blockDim.x / 32) {
    const int row = row0 + r;
    if (row >= t) continue;                         // the same for the warp
    const float* l = lg + r * E;
    float m = neg_inf();
    for (int j = lane; j < E; j += 32) m = fmaxf(m, l[j]);
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    float sum = 0.f;
    for (int j = lane; j < E; j += 32) sum += expf(l[j] - m);
    for (int off = 16; off > 0; off >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    }
    if (lane == 0) {
      row_max[r] = m;
      row_sum[r] = sum;
    }
    float* work = smem + r * E;                     // over the free stages
    for (int j = lane; j < E; j += 32) work[j] = expf(l[j] - m) / sum;
    __syncwarp();
    for (int q = 0; q < k; ++q) {
      float best = neg_inf();
      int bi = E;
      for (int j = lane; j < E; j += 32) {
        const float v = work[j];
        if (ranks_above(v, j, best, bi)) { best = v; bi = j; }
      }
      for (int off = 16; off > 0; off >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ranks_above(ob, oi, best, bi)) { best = ob; bi = oi; }
      }
      if (lane == 0) {
        gates[(size_t)row * k + q] = best;
        idx[(size_t)row * k + q] = bi;
        ids[r * k + q] = bi;
        work[bi] = neg_inf();
      }
      __syncwarp();
    }
  }
  __syncthreads();

  // each assignment's rank within the block, in token-major, slot-minor
  // order, and the block's count per expert
  if (warp == 0) {
    const int n = (t - row0 < kRows ? t - row0 : kRows) * k;
    const unsigned lower = (1u << lane) - 1u;
    const int bits = key_bits(E);
    for (int a0 = 0; a0 < n; a0 += 32) {
      const int a = a0 + lane;
      const bool ok = a < n;
      const int key = ok ? ids[a] : E;            // E: no assignment
      const unsigned peers = equal_lanes(key, bits);
      const int below = __popc(peers & lower);
      const int within = ok ? hist[key] + below : 0;
      __syncwarp();
      if (ok && below == 0) hist[key] += __popc(peers);
      __syncwarp();
      if (ok) ranks[(size_t)row0 * k + a] = within;
    }
  }
  __syncthreads();
  for (int e = tid; e < E; e += blockDim.x) {
    counts[(long long)e * nb + blockIdx.x] = hist[e];
  }

  // one ordering point across the grid: the last block to arrive.  The
  // fence covers idx, ranks and counts; logits and probs are written after
  // it, coalesced over the block's rows, with the probabilities top-k read
  // (the same expression on the same values)
  __threadfence();
  __syncthreads();
  if (tid == 0) *last = atomicAdd(ticket, 1u) == (unsigned)(nb - 1);
  __syncthreads();
  const int rows = t - row0 < kRows ? t - row0 : kRows;
  if (!*last) {
    for (int o = tid; o < rows * E; o += blockDim.x) {
      const int r = o / E;
      logits[(size_t)row0 * E + o] = lg[o];
      probs[(size_t)row0 * E + o] = expf(lg[o] - row_max[r]) / row_sum[r];
    }
    return;
  }
  __threadfence();
  // the counts (key-major, block-minor) scanned in shared memory over the
  // free stages where they fit, else in place in device memory
  const long long n = (long long)E * nb;
  const bool in_smem = n <= region;
  int32_t* base = in_smem ? reinterpret_cast<int32_t*>(smem) : counts;
  if (in_smem) {
    for (long long i0 = 0; i0 < n; i0 += kFixBatch * blockDim.x) {
      int32_t c[kFixBatch];
#pragma unroll
      for (int j = 0; j < kFixBatch; ++j) {
        const long long i = i0 + j * blockDim.x + tid;
        c[j] = i < n ? __ldcg(counts + i) : 0;
      }
#pragma unroll
      for (int j = 0; j < kFixBatch; ++j) {
        const long long i = i0 + j * blockDim.x + tid;
        if (i < n) base[i] = c[j];
      }
    }
    __syncthreads();
    scan_counts<false>(base, n, nb, E, starts, scratch);
  } else {
    scan_counts<true>(base, n, nb, E, starts, scratch);
  }
  __syncthreads();
  // each assignment's base, kFixBatch assignments a thread in flight (t * k
  // < 2^31: ranks are int32)
  const int A = t * k;
  for (int a0 = 0; a0 < A; a0 += kFixBatch * blockDim.x) {
    int e[kFixBatch], r[kFixBatch];
#pragma unroll
    for (int j = 0; j < kFixBatch; ++j) {
      const int a = a0 + j * blockDim.x + tid;
      e[j] = a < A ? __ldcg(idx + a) : 0;
      r[j] = a < A ? __ldcg(ranks + a) : 0;
    }
#pragma unroll
    for (int j = 0; j < kFixBatch; ++j) {
      const int a = a0 + j * blockDim.x + tid;
      if (a < A) {
        const long long at = (long long)e[j] * nb + a / k / kRows;
        ranks[a] = r[j] + (in_smem ? base[at] : __ldcg(base + at));
      }
    }
  }
  if (tid == 0) *ticket = 0u;
  for (int o = tid; o < rows * E; o += blockDim.x) {
    const int r = o / E;
    logits[(size_t)row0 * E + o] = lg[o];
    probs[(size_t)row0 * E + o] = expf(lg[o] - row_max[r]) / row_sum[r];
  }
}

template <typename T, int SL>
int launch(const void* x, const void* w, int t, int d, int E, int k, int Ep,
           int stride, int C, int NS, int vec16, int vecw, int threads,
           size_t smem, void* logits,
           void* probs, void* gates, void* idx, void* counts, int nb,
           void* ranks, void* starts, void* ticket, cudaStream_t s) {
  static size_t allowed[kMaxDevices] = {};
  cudaError_t err =
      allow_shared_memory((const void*)router_kernel<T, SL>, smem, allowed);
  if (err != cudaSuccess) return (int)err;
  router_kernel<T, SL><<<nb, threads, smem, s>>>(
      (const T*)x, (const float*)w, t, d, E, k, Ep, stride, C, NS, vec16, vecw,
      (float*)logits, (float*)probs, (float*)gates, (int32_t*)idx,
      (int32_t*)counts, nb, (int32_t*)ranks, (int32_t*)starts,
      (unsigned*)ticket);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_by_slices(int SL, const void* x, const void* w, int t, int d,
                     int E, int k, int Ep, int stride, int C, int NS,
                     int vec16, int vecw, int threads, size_t smem, void* logits, void* probs, void* gates,
                     void* idx, void* counts, int nb, void* ranks,
                     void* starts, void* ticket, cudaStream_t s) {
#define ROUTER_LAUNCH(N)                                                    \
  return launch<T, N>(x, w, t, d, E, k, Ep, stride, C, NS, vec16, vecw,      \
                      threads, smem,                                        \
                      logits, probs, gates, idx, counts, nb, ranks, starts, \
                      ticket, s)
  switch (SL) {
    case 32: ROUTER_LAUNCH(32);
    case 16: ROUTER_LAUNCH(16);
    case 8: ROUTER_LAUNCH(8);
    case 4: ROUTER_LAUNCH(4);
    default: return (int)cudaErrorInvalidValue;
  }
#undef ROUTER_LAUNCH
}

}  // namespace

extern "C" int router_fused(const void* x, int x_bf16, const void* w, int t,
                            int d, int E, int k, void* logits, void* probs,
                            void* gates, void* idx, void* counts, int nb,
                            void* ranks, void* starts, void* ticket,
                            void* stream) {
  if (t <= 0 || d <= 0 || E < 1 || E > kMaxExperts || k < 1 || k > E ||
      nb != (t + kRows - 1) / kRows) {
    return (int)cudaErrorInvalidValue;
  }
  // 512 threads a block where the blocks fit one wave at one block an SM
  // (the kernel's 128 registers a thread allow no more), else 256, two an
  // SM
  static int sms[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount,
                                 dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int threads = nb <= sms[dev] ? kMaxThreads : kMaxThreads / 2;
  // E padded to a power of two (at least 4): E / 4 groups of 4 experts,
  // and the rest of the threads as slices of d
  int Ep = 4;
  while (Ep < E) Ep <<= 1;
  const int S = threads / (Ep / 4);
  const int SL = S < 32 ? S : 32;
  // rows padded so that 8 adjacent rows' 16-byte loads hit distinct banks
  const int stride = Ep % 8 == 0 ? Ep + 4 : Ep;
  const size_t xb = x_bf16 ? 2 : 4;
  // C: a multiple of the slices (and of 8 columns, a 16-byte piece of
  // bf16) that cuts d into at most kMaxStages chunks where the stages fit
  // the budget; NS of them in flight
  const int M = S > 8 ? S : 8;
  const int col_bytes = stride * 4 + kRows * (int)xb;
  int C = (d + kMaxStages - 1) / kMaxStages;
  C = (C + M - 1) / M * M;
  if (C > kMaxChunk) C = kMaxChunk > M ? kMaxChunk / M * M : M;
  while (C > M && 2 * C * col_bytes > kStageBudget) C -= M;
  const int nch = (d + C - 1) / C;
  int NS = kStageBudget / (C * col_bytes);
  if (NS > kMaxStages) NS = kMaxStages;
  if (NS > nch) NS = nch;
  if (NS < 1) NS = 1;
  const int vec16 = (d * (int)xb) % 16 == 0 && (uintptr_t)x % 16 == 0;
  const int vecw = E % 4 == 0 && (uintptr_t)w % 16 == 0;
  const int stage_words = C * stride + kRows * C * (int)xb / 4;
  const int NH = S / SL;
  int region = NS * stage_words;
  if (region < NH * kRows * Ep) region = NH * kRows * Ep;
  if (region < kRows * E) region = kRows * E;
  const size_t smem =
      ((size_t)region + kRows * E + kRows * k + E + 33 + 1 + 2 * kRows) *
      sizeof(float);
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16) {
    return launch_by_slices<__nv_bfloat16>(
        SL, x, w, t, d, E, k, Ep, stride, C, NS, vec16, vecw, threads, smem,
        logits, probs, gates, idx, counts, nb, ranks, starts, ticket, s);
  }
  return launch_by_slices<float>(SL, x, w, t, d, E, k, Ep, stride, C, NS,
                                 vec16, vecw, threads, smem, logits, probs,
                                 gates, idx, counts, nb, ranks, starts,
                                 ticket, s);
}
