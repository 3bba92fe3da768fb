// The grouped bf16 GEMM that the ragged expert-FFN kernel
// (grouped_ffn_ragged.cu, the dropless layout) launches twice, until that
// kernel's redesign for Hopper moves it onto grouped_gemm_sm90.cuh as
// grouped_ffn.cu was:
//   C = epilogue(A @ B [, A @ B2])    A (M, K), B/B2 (K, N), C (M, N), bf16
// with fp32 accumulation on the tensor cores (WMMA bf16 16x16x16 fragments).
// A 128-thread block computes a BM x 64 output tile of one group; K is
// walked in steps of 32 through shared memory with 16-byte vector loads.
// EPI_GLU keeps the A@B and A@B2 accumulators side by side so A is read
// once for both, and applies act(A@B) * (A@B2) on the fragments before the
// single rounding to bf16; EPI_ACT applies act alone; EPI_NONE stores the
// product.  act: 0 = SiLU (x * sigmoid(x)), 1 = GELU in its tanh form
// (jax.nn.gelu's default).
//
// Which rows a block takes, and which group's B, comes from its Rows: A
// and C are flat (M = R rows); block y takes the `step` rows from y * step
// (step <= BM, step divides the layout's row tile), and its group is the
// tile's owner, clip(searchsorted(starts, tile_row0, side="right") - 1, 0,
// G - 1) over the (G+1,) aligned offsets `starts`, the ids
// repro.core.dispatch.ragged_tile_gids gives.  A block past starts[G] holds
// only zero rows (the dispatch gather writes zeros there), so the FFN gives
// zeros: the first pass skips it and the second writes its zeros without
// reading any weight.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace ffn {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BN = 64;       // output columns per block
constexpr int BK = 32;       // depth per shared-memory step
constexpr int LDA = BK + 8;  // padded leading dims (bank spread, 16B rows)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int THREADS = 128;

enum Epilogue { EPI_NONE = 0, EPI_ACT = 1, EPI_GLU = 2 };

struct Rows {
  const int* starts;  // (G+1,) aligned segment offsets
  int G;              // groups
  int tile;           // the layout's row tile
  int step;           // rows per block
};

__device__ __forceinline__ float act_fn(float v, int act) {
  if (act == 0) return v / (1.0f + expf(-v));  // SiLU
  const float c = 0.7978845608028654f;         // sqrt(2 / pi)
  return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
}

// searchsorted(starts[0..G], t0, side="right") - 1, clipped to [0, G-1]
__device__ __forceinline__ int tile_group(const int* starts, int G, int t0) {
  int lo = 0, hi = G + 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(starts + mid) <= t0)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int g = lo - 1;
  return g < 0 ? 0 : (g > G - 1 ? G - 1 : g);
}

// sB: the element stride between groups' weights.  N % 64 == 0 and
// K % 32 == 0.  BM is 16, 32 or 64.
template <int EPI, int BM>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
            const bf16* __restrict__ B2, bf16* __restrict__ C, int N, int K,
            long long sB, int act, Rows rows) {
  constexpr int WARPS_M = BM >= 32 ? 2 : 1;  // 4 warps: WARPS_M x WARPS_N
  constexpr int WARPS_N = 4 / WARPS_M;
  constexpr int FM = BM / 16 / WARPS_M;      // fragments per warp
  constexpr int FN = BN / 16 / WARPS_N;
  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * rows.step;
  const int mrows = rows.step;
  if (m0 >= __ldg(rows.starts + rows.G)) {
    // past the last segment: zero rows in, zeros out
    if (EPI == EPI_NONE) {
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      for (int v = tid; v < mrows * BN / 8; v += THREADS) {
        const int r = v / (BN / 8);
        const int c = (v % (BN / 8)) * 8;
        *reinterpret_cast<uint4*>(C + (size_t)(m0 + r) * N + n0 + c) = z;
      }
    }
    return;
  }
  const int g = tile_group(rows.starts, rows.G, m0 - m0 % rows.tile);
  B += g * sB;
  if (EPI == EPI_GLU) B2 += g * sB;

  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[BK * LDB];
  __shared__ __align__(128) bf16 B2s[EPI == EPI_GLU ? BK * LDB : 8];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int warp = tid / 32;
  const int wm = warp / WARPS_N;  // warp row: rows wm * FM * 16 ..
  const int wn = warp % WARPS_N;  // warp col: cols wn * FN * 16 ..

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc2[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      wmma::fill_fragment(acc[i][j], 0.0f);
      if (EPI == EPI_GLU) wmma::fill_fragment(acc2[i][j], 0.0f);
    }

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM x BK bf16; rows past mrows load as zeros
    for (int v = tid; v < BM * BK / 8; v += THREADS) {
      const int r = v / (BK / 8);
      const int c = (v % (BK / 8)) * 8;
      uint4 val = zero;
      if (r < mrows)
        val = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(As + r * LDA + c) = val;
    }
    // B tile(s): BK x BN bf16 = 256 uint4 each
    for (int v = tid; v < BK * BN / 8; v += THREADS) {
      const int r = v / (BN / 8);
      const int c = (v % (BN / 8)) * 8;
      const size_t off = (size_t)(k0 + r) * N + n0 + c;
      *reinterpret_cast<uint4*>(Bs + r * LDB + c) =
          *reinterpret_cast<const uint4*>(B + off);
      if (EPI == EPI_GLU)
        *reinterpret_cast<uint4*>(B2s + r * LDB + c) =
            *reinterpret_cast<const uint4*>(B2 + off);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * FM * 16 + i * 16) * LDA + kk,
                               LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bs + kk * LDB + wn * FN * 16 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
        if (EPI == EPI_GLU) {
          wmma::load_matrix_sync(b, B2s + kk * LDB + wn * FN * 16 + j * 16,
                                 LDB);
#pragma unroll
          for (int i = 0; i < FM; ++i)
            wmma::mma_sync(acc2[i][j], a[i], b, acc2[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue on the fragments (acc and acc2 share one element layout), then
  // through shared memory to coalesced bf16 stores
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) {
      if (EPI != EPI_NONE) {
#pragma unroll
        for (int e = 0; e < acc[i][j].num_elements; ++e) {
          float h = act_fn(acc[i][j].x[e], act);
          if (EPI == EPI_GLU) h = h * acc2[i][j].x[e];
          acc[i][j].x[e] = h;
        }
      }
      wmma::store_matrix_sync(
          Cs + (wm * FM * 16 + i * 16) * LDC + wn * FN * 16 + j * 16,
          acc[i][j], LDC, wmma::mem_row_major);
    }
  __syncthreads();
  for (int v = tid; v < BM * BN / 8; v += THREADS) {
    const int r = v / (BN / 8);
    const int c = (v % (BN / 8)) * 8;
    if (r >= mrows) continue;
    const float* src = Cs + r * LDC + c;
    uint4 o;
    __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      po[q] = __floats2bfloat162_rn(src[2 * q], src[2 * q + 1]);
    *reinterpret_cast<uint4*>(C + (size_t)(m0 + r) * N + n0 + c) = o;
  }
}

// Both passes of the FFN:
//   pass 1: h = act(x @ w1) [* (x @ w3)]      (N = f, K = d)
//   pass 2: y = h @ w2                         (N = d, K = f)
// grid1/grid2 are the passes' grids.  Returns the cudaError_t of the first
// failing launch.
template <int BM>
int ffn_two_pass(const bf16* x, const bf16* w1, const bf16* w3,
                 const bf16* w2, bf16* h, bf16* y, int d, int f, dim3 grid1,
                 dim3 grid2, int act, Rows rows, cudaStream_t s) {
  const dim3 block(THREADS);
  const long long sw = (long long)d * f;
  if (w3 != nullptr) {
    gemm_kernel<EPI_GLU, BM><<<grid1, block, 0, s>>>(x, w1, w3, h, f, d, sw,
                                                     act, rows);
  } else {
    gemm_kernel<EPI_ACT, BM><<<grid1, block, 0, s>>>(x, w1, nullptr, h, f, d,
                                                     sw, act, rows);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gemm_kernel<EPI_NONE, BM><<<grid2, block, 0, s>>>(h, w2, nullptr, y, d, f,
                                                    sw, act, rows);
  return (int)cudaGetLastError();
}

}  // namespace ffn
