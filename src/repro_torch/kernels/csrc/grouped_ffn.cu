// Grouped expert FFN for Hopper (sm_90a), capacity layout:
//   y[g] = (act(x[g] @ w1[g]) * (x[g] @ w3[g])) @ w2[g]     (SiLU/GELU-GLU)
//   y[g] =  act(x[g] @ w1[g])                  @ w2[g]     (plain MLP, w3 = 0)
// x (G, T, d), w1/w3 (G, d, f), w2 (G, f, d), all bf16 -> y (G, T, d) bf16.
//
// Replaces the TPU kernel src/repro/kernels/grouped_ffn.py
// grouped_ffn_pallas (grid (G, T/bt, f/bf), output tile revisited over the
// f axis).
//
// Numerics follow the oracle ref.grouped_ffn_ref, not the Pallas body:
//   pass 1: h = bf16(act(x@w1) * (x@w3)), both products accumulated in fp32
//           over the whole of d, the activation and the GLU product in fp32,
//           one rounding to bf16;
//   pass 2: y = bf16(h @ w2), accumulated in fp32 over the WHOLE of f and
//           rounded once.  The Pallas kernel instead rounds its output tile
//           to bf16 after every f tile (grouped_ffn.py _accumulate), which
//           adds one bf16 rounding per f tile; this kernel does not.
// The h scratch (G, T, f) is allocated by the wrapper.  act: 0 = SiLU
// (x * sigmoid(x)), 1 = GELU in its tanh form (jax.nn.gelu's default).
//
// What bounds it on the card: at the serving prefill shape (G=128, T=256,
// d=2048, f=768) the 309 GFLOP take 0.31 ms at 989 TFLOP/s and the 1.2 GB of
// bf16 weights 0.36 ms at 3.35 TB/s, so it sits near the ridge; at decode
// (T=2) it is bound by the weight bytes alone.
// Design for that, kept simple in this first version: one batched GEMM
// kernel on the tensor cores (WMMA bf16 16x16x16 fragments, fp32 accumulate)
// launched twice.  A 128-thread block computes a 64x64 output tile of one
// group, 4 warps each owning 32x32; K is walked in steps of 32 through
// shared memory with 16-byte vector loads.  Pass 1 keeps the x@w1 and x@w3
// accumulators side by side so x is read once for both, and applies the
// activation and the GLU product on the fragments before the single
// rounding.  Every weight byte is read once per 64-row tile of x, so at
// decode (one row tile) the weights are read exactly once.  Rows of x past T
// load as zeros and are never stored.  Not yet done (later work): wgmma,
// TMA, a multi-stage shared-memory ring, and a persistent schedule.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; returns the cudaError_t of the first failing launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;       // rows of x per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 32;       // depth per shared-memory step
constexpr int LDA = BK + 8;  // padded leading dims (bank spread, 16B rows)
constexpr int LDB = BN + 8;
constexpr int LDC = BN + 4;
constexpr int THREADS = 128;

enum Epilogue { EPI_NONE = 0, EPI_ACT = 1, EPI_GLU = 2 };

__device__ __forceinline__ float act_fn(float v, int act) {
  if (act == 0) return v / (1.0f + expf(-v));  // SiLU
  const float c = 0.7978845608028654f;         // sqrt(2 / pi)
  return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
}

// C[g] (M, N) = epilogue(A[g] (M, K) @ B[g] (K, N) [, A[g] @ B2[g]]), all
// row-major bf16, fp32 accumulation.  N % 64 == 0 and K % 32 == 0.
template <int EPI>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
            const bf16* __restrict__ B2, bf16* __restrict__ C, int M, int N,
            int K, long long sA, long long sB, long long sC, int act) {
  const int g = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  A += g * sA;
  B += g * sB;
  C += g * sC;
  if (EPI == EPI_GLU) B2 += g * sB;

  __shared__ __align__(128) bf16 As[BM * LDA];
  __shared__ __align__(128) bf16 Bs[BK * LDB];
  __shared__ __align__(128) bf16 B2s[EPI == EPI_GLU ? BK * LDB : 8];
  __shared__ __align__(128) float Cs[BM * LDC];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 2;  // warp row (0..1): rows wm*32 .. +32
  const int wn = warp % 2;  // warp col (0..1): cols wn*32 .. +32

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc2[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(acc[i][j], 0.0f);
      if (EPI == EPI_GLU) wmma::fill_fragment(acc2[i][j], 0.0f);
    }

  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  for (int k0 = 0; k0 < K; k0 += BK) {
    // A tile: BM x BK bf16 = 256 uint4; rows past M load as zeros
    for (int v = tid; v < BM * BK / 8; v += THREADS) {
      const int r = v / (BK / 8);
      const int c = (v % (BK / 8)) * 8;
      uint4 val = zero;
      if (m0 + r < M)
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
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(b, Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
        if (EPI == EPI_GLU) {
          wmma::load_matrix_sync(b, B2s + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::mma_sync(acc2[i][j], a[i], b, acc2[i][j]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue on the fragments (acc and acc2 share one element layout), then
  // through shared memory to coalesced bf16 stores
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (EPI != EPI_NONE) {
#pragma unroll
        for (int e = 0; e < acc[i][j].num_elements; ++e) {
          float h = act_fn(acc[i][j].x[e], act);
          if (EPI == EPI_GLU) h = h * acc2[i][j].x[e];
          acc[i][j].x[e] = h;
        }
      }
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
    }
  __syncthreads();
  for (int v = tid; v < BM * BN / 8; v += THREADS) {
    const int r = v / (BN / 8);
    const int c = (v % (BN / 8)) * 8;
    if (m0 + r >= M) continue;
    const float* src = Cs + r * LDC + c;
    uint4 o;
    __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      po[q] = __floats2bfloat162_rn(src[2 * q], src[2 * q + 1]);
    *reinterpret_cast<uint4*>(C + (size_t)(m0 + r) * N + n0 + c) = o;
  }
}

}  // namespace

extern "C" int grouped_ffn(const void* x, const void* w1, const void* w3,
                           const void* w2, void* h, void* y, int G, int T,
                           int d, int f, int act, void* stream) {
  if (G <= 0 || T <= 0) return 0;
  if (d % BN != 0 || f % BN != 0) return (int)cudaErrorInvalidValue;
  if (G > 65535 || (T + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 block(THREADS);
  const long long sx = (long long)T * d, sw = (long long)d * f,
                  sh = (long long)T * f;
  // pass 1: h = act(x @ w1) [* (x @ w3)]      (M = T, N = f, K = d)
  const dim3 g1(f / BN, (T + BM - 1) / BM, G);
  if (w3 != nullptr) {
    gemm_kernel<EPI_GLU><<<g1, block, 0, s>>>(
        (const bf16*)x, (const bf16*)w1, (const bf16*)w3, (bf16*)h, T, f, d,
        sx, sw, sh, act);
  } else {
    gemm_kernel<EPI_ACT><<<g1, block, 0, s>>>(
        (const bf16*)x, (const bf16*)w1, nullptr, (bf16*)h, T, f, d, sx, sw,
        sh, act);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // pass 2: y = h @ w2                         (M = T, N = d, K = f)
  const dim3 g2(d / BN, (T + BM - 1) / BM, G);
  gemm_kernel<EPI_NONE><<<g2, block, 0, s>>>(
      (const bf16*)h, (const bf16*)w2, nullptr, (bf16*)y, T, d, f, sh, sw, sx,
      act);
  return (int)cudaGetLastError();
}
