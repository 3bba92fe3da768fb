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
// What bounds it on the card: its bytes, 0.20 ms at rwkv6-1.6b's
// (4, 4096, 32, 64) (5 fp32 streams of 134 MB at 3.35 TB/s), but a step's
// least work is 4 fp32 instructions an entry of S (the readout's r S as an
// FMA, k v, w S, and the add): 8.6 G instructions at that shape, 128 cycles
// a step on an SM that holds one head, ~0.26 ms near 2 GHz.  And each step
// waits on the last, so what the kernel can do is keep a step short.
// Besides the fp32 work, a step's length is set by moving numbers through
// shared memory (128 bytes a cycle an SM): a thread that owns C columns and
// P rows of S reads 3 P + C numbers a step, 4096 (3 / C + 1 / P) a step and
// head, and the partial readouts of the 64 / P threads that share a column
// go through it too.  One column a thread (C = 1) reads ~3 numbers an
// entry.  Design:
//  * a head's 64 columns are split over two blocks of 128 threads (two
//    blocks and 8 warps on each SM at B = 4); thread (cg, g) = (tid / 16,
//    tid % 16) holds the 4 columns 4 cg .. 4 cg + 3 of its block's 32 and
//    the 4 rows 4 g .. 4 g + 3 of S in registers, so r, k and w come in as
//    three 16-byte shared loads a step (16 neighbouring words across the
//    g's: no bank conflict; the 2 column groups of a warp share them as
//    broadcasts) and v as one;
//  * the bonus is factored out of the readout:
//      y_t[j] = sum_i r_i S_ij + v_j * beta_t,  beta_t = sum_i r_i u_i k_i
//    so an entry costs the 4 instructions above; beta_t is one number a
//    step and head, computed after each chunk from the staged inputs;
//  * a thread's partial readouts of its 4 columns over its 4 rows go to
//    shared memory (one 16-byte store a step, no shuffle on the step's
//    path), and after each chunk the block adds the 16 partials of every
//    (t, j) in a fixed order, adds v_j beta_t and writes the chunk's y rows
//    out in 16-byte stores;
//  * r, k, w and the block's half of v come through a ring of STAGES
//    chunks of TC steps in shared memory, filled by cp.async STAGES - 1
//    chunks ahead of use (a thread for each 16-byte word of a step, which
//    walks the chunk's steps), so the loads overlap the recurrence; two
//    block barriers a chunk (one for the ring, one for the partial sums),
//    none a step.  A block's 88 KB of shared memory keeps a third block
//    off an SM while another has none.
// PERF.md section 6 has the times of this design and of the shapes it was
// chosen from.
//
// Arithmetic: everything fp32, nothing TF32.  The state update is w * S,
// rounded, then + k v, rounded (__fmul_rn / __fadd_rn, no fused multiply-
// add), as the plain version computes it, so s_last matches it bit for bit.
// y is the same sum in another order (and with the bonus factored), within
// fp32 rounding of the plain version's; the same bits on every run.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 64;                 // head size
constexpr int SPLIT = 2;               // blocks a head (column slices)
constexpr int BCOLS = HD / SPLIT;      // columns a block
constexpr int COLS = 4;                // columns a thread
constexpr int ROWS = 4;                // rows a thread
constexpr int GROUPS = HD / ROWS;      // threads sharing a column group
constexpr int CGS = BCOLS / COLS;      // column groups a block
constexpr int THREADS = CGS * GROUPS;
constexpr int TC = 16;                 // time steps a chunk
constexpr int STAGES = 4;              // chunks in the ring
// a ring slot: r, k, w (TC x 64 each), then the block's columns of v
constexpr int ARR = TC * HD;
constexpr int V_OFF = 3 * ARR;
constexpr int CHUNK = V_OFF + TC * BCOLS;
constexpr int ROW4 = (3 * HD + BCOLS) / 4;        // 16-byte words a step
constexpr int PARTS = TC * CGS * GROUPS * COLS;   // partial readouts
constexpr int SMEM_BYTES = (STAGES * CHUNK + PARTS) * 4;

static_assert(COLS == 4 && ROWS % 4 == 0, "float4 columns, rows by four");
static_assert(THREADS >= ROW4, "a thread for each 16-byte word of a step");
static_assert(TC % GROUPS == 0 && CGS <= 32 && 32 % CGS == 0,
              "whole readout rounds, a step's readers in one warp");

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
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

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the q-th run of 4 rows that a thread (or lane) of `n` holds: rows
// 4 n q + 4 g .. + 3, so that the n neighbours read neighbouring words
template <int N>
__device__ __forceinline__ int run(int q, int g) {
  return 4 * N * q + 4 * g;
}

__global__ void __launch_bounds__(THREADS)
rwkv6_scan_kernel(const float* __restrict__ r, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ w,
                  const float* __restrict__ u, const float* __restrict__ s0,
                  float* __restrict__ y, float* __restrict__ s_last, int T,
                  int nh) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);   // [STAGES][CHUNK]
  float4* part = smem4 + STAGES * CHUNK / 4;       // [TC][CGS][GROUPS]

  const int bh = blockIdx.x / SPLIT;
  const int b = bh / nh, h = bh % nh;
  const int col0 = (blockIdx.x % SPLIT) * BCOLS;   // the block's columns
  const int tid = threadIdx.x;
  const size_t state = (size_t)bh * HD * HD;
  const size_t step = (size_t)nh * HD;               // floats between steps
  const size_t base = ((size_t)b * T * nh + h) * HD;  // (b, t = 0, h, 0)
  const int nchunks = (T + TC - 1) / TC;

  // a chunk's copies: thread q < ROW4 moves 16-byte word q of every step
  // (words 0..47: r, k, w; then the block's columns of v)
  const int qa = tid / (HD / 4), qx = (tid % (HD / 4)) * 4;
  const float* src = (qa == 0 ? r : qa == 1 ? k : qa == 2 ? w : v + col0) +
                     base + (qa < 3 ? qx : (tid - 3 * (HD / 4)) * 4);
  const int dst = qa < 3 ? qa * ARR + qx : V_OFF + (tid - 3 * (HD / 4)) * 4;
  const int dst_step = qa < 3 ? HD : BCOLS;
  auto load_chunk = [&](int c) {
    if (tid >= ROW4) return;
    float* d = ring + (c % STAGES) * CHUNK + dst;
    const float* s_ = src + (size_t)c * TC * step;
    const int n = min(TC, T - c * TC);
    for (int tt = 0; tt < n; ++tt)
      cp_async16(d + tt * dst_step, s_ + (size_t)tt * step);
  };
  for (int c = 0; c < STAGES - 1; ++c) {
    if (c < nchunks) load_chunk(c);
    cp_async_commit();
  }

  // the recurrence: thread (cg, g) holds columns c0 .. c0 + 3 of the
  // block's and the ROWS rows run<GROUPS>(q, g) + 0..3
  const int cg = tid / GROUPS, g = tid % GROUPS;
  const int c0 = COLS * cg;
  float S[ROWS][COLS];
#pragma unroll
  for (int q = 0; q < ROWS / 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float4 x = ld4(s0 + state +
                           (size_t)(run<GROUPS>(q, g) + e) * HD + col0 + c0);
      S[4 * q + e][0] = x.x, S[4 * q + e][1] = x.y, S[4 * q + e][2] = x.z,
                    S[4 * q + e][3] = x.w;
    }
  // a thread's partials of step tt sit at part[tt][cg][g ^ (cg % GROUPS)]:
  // the GROUPS threads of a column group fill neighbouring words, and the
  // readout's loads of one g across neighbouring column groups hit
  // distinct ones
  float4* my_part = part + cg * GROUPS + (g ^ (cg % GROUPS));

  // the readout: column group cr of steps tr + GROUPS m; beta's rows
  // run<CGS>(q, cr) + 0..3 (the CGS threads of a step share its sum)
  const int cr = tid % CGS, tr = tid / CGS;
  float4 uu[HD / 4 / CGS];
#pragma unroll
  for (int q = 0; q < HD / 4 / CGS; ++q)
    uu[q] = ld4(u + (size_t)h * HD + run<CGS>(q, cr));

  for (int c = 0; c < nchunks; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c
    __syncthreads();  // everyone's; and chunk c - 1's slot is free again
    if (c + STAGES - 1 < nchunks) load_chunk(c + STAGES - 1);
    cp_async_commit();

    const float* slot = ring + (c % STAGES) * CHUNK;
    const int n = min(TC, T - c * TC);
    for (int tt = 0; tt < n; ++tt) {
      const float* R = slot + tt * HD;
      float rr[ROWS], kk[ROWS], ww[ROWS];
#pragma unroll
      for (int q = 0; q < ROWS / 4; ++q) {
        const int i = run<GROUPS>(q, g);
        const float4 r4 = ld4(R + i), k4 = ld4(R + ARR + i),
                     w4 = ld4(R + 2 * ARR + i);
        rr[4 * q] = r4.x, rr[4 * q + 1] = r4.y, rr[4 * q + 2] = r4.z,
                  rr[4 * q + 3] = r4.w;
        kk[4 * q] = k4.x, kk[4 * q + 1] = k4.y, kk[4 * q + 2] = k4.z,
                  kk[4 * q + 3] = k4.w;
        ww[4 * q] = w4.x, ww[4 * q + 1] = w4.y, ww[4 * q + 2] = w4.z,
                  ww[4 * q + 3] = w4.w;
      }
      const float4 v4 = ld4(slot + V_OFF + tt * BCOLS + c0);
      const float vv[COLS] = {v4.x, v4.y, v4.z, v4.w};
      float p[COLS];
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        p[j] = rr[0] * S[0][j];
#pragma unroll
        for (int a = 1; a < ROWS; ++a) p[j] = fmaf(rr[a], S[a][j], p[j]);
      }
      my_part[tt * CGS * GROUPS] = make_float4(p[0], p[1], p[2], p[3]);
#pragma unroll
      for (int a = 0; a < ROWS; ++a)
#pragma unroll
        for (int j = 0; j < COLS; ++j)
          S[a][j] = __fadd_rn(__fmul_rn(ww[a], S[a][j]),
                              __fmul_rn(kk[a], vv[j]));
    }
    __syncthreads();  // the chunk's partial sums are complete

#pragma unroll
    for (int m = 0; m < TC / GROUPS; ++m) {
      // every lane computes (rows past n hold stale numbers), so the
      // shuffles see the whole warp; only steps < n are stored
      const int t = tr + GROUPS * m;
      const float* R = slot + t * HD;
      float beta = 0.0f;
#pragma unroll
      for (int q = 0; q < HD / 4 / CGS; ++q) {
        const int i = run<CGS>(q, cr);
        const float4 r4 = ld4(R + i), k4 = ld4(R + ARR + i);
        beta = fmaf(r4.x * uu[q].x, k4.x, beta);
        beta = fmaf(r4.y * uu[q].y, k4.y, beta);
        beta = fmaf(r4.z * uu[q].z, k4.z, beta);
        beta = fmaf(r4.w * uu[q].w, k4.w, beta);
      }
#pragma unroll
      for (int x = 1; x < CGS; x <<= 1)
        beta += __shfl_xor_sync(0xffffffffu, beta, x);
      const float4* pp = part + (t * CGS + cr) * GROUPS;
      const int sw = cr % GROUPS;
      float4 sum = pp[sw];  // g = 0
#pragma unroll
      for (int gg = 1; gg < GROUPS; ++gg) {
        const float4 q4 = pp[gg ^ sw];
        sum.x += q4.x, sum.y += q4.y, sum.z += q4.z, sum.w += q4.w;
      }
      const float4 vt = ld4(slot + V_OFF + t * BCOLS + COLS * cr);
      if (t < n)
        *reinterpret_cast<float4*>(
            y + base + (size_t)(c * TC + t) * step + col0 + COLS * cr) =
            make_float4(fmaf(vt.x, beta, sum.x), fmaf(vt.y, beta, sum.y),
                        fmaf(vt.z, beta, sum.z), fmaf(vt.w, beta, sum.w));
    }
  }

#pragma unroll
  for (int q = 0; q < ROWS / 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      *reinterpret_cast<float4*>(
          s_last + state + (size_t)(run<GROUPS>(q, g) + e) * HD + col0 +
          c0) = make_float4(S[4 * q + e][0], S[4 * q + e][1],
                            S[4 * q + e][2], S[4 * q + e][3]);
}

}  // namespace

extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* s0,
                          void* y, void* s_last, int B, int T, int nh, int hd,
                          void* stream) {
  if (hd != HD || B < 0 || T < 0 || nh < 0) return (int)cudaErrorInvalidValue;
  if (B == 0 || nh == 0) return 0;
  if ((long long)B * nh * SPLIT > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  static bool sized = false;  // the shared-memory limit, set once
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        rwkv6_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  rwkv6_scan_kernel<<<B * nh * SPLIT, THREADS, SMEM_BYTES,
                      (cudaStream_t)stream>>>(
      (const float*)r, (const float*)k, (const float*)v, (const float*)w,
      (const float*)u, (const float*)s0, (float*)y, (float*)s_last, T, nh);
  return (int)cudaGetLastError();
}
