// Mamba2 SSD intra-chunk terms for Hopper (sm_90a), per (batch * chunk c,
// head h), over the chunk's Q steps:
//   cs      = cumsum(loga)                                         (Q,)
//   W[i][j] = exp(cs_i - cs_j) * (C_i . B_j) * dt_j    for i >= j, else 0
//   y       = W x                                                  (Q, hd)
//   sB[p][n] = sum_j exp(cs_{Q-1} - cs_j) * dt_j * x[j][p] * B[j][n]
//   a_chunk = exp(cs_{Q-1})
// xh (B, nc, Q, nh, hd), dt/loga (B, nc, Q, nh), Bc/Cc (B, nc, Q, ds), all
// fp32 -> y_intra (B, nc, Q, nh, hd), sB (B, nc, nh, hd, ds), a_chunk
// (B, nc, nh), fp32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_chunk.py ssd_chunk_pallas:
// grid (B * nc, nh), the (Q, Q) decay-weighted scores kept in VMEM instead
// of the (B, nc, Q, Q, nh) tensor the jnp reference builds in HBM.
//
// What bounds it on the card: at zamba2-2.7b's shapes (B 4, nc 32, Q 128,
// nh 80, hd 64, ds 64) ~0.85 GB of bytes (0.25 ms at 3.35 TB/s) against
// ~2e10 fp32 operations for the causal half (0.3 ms at 67 TFLOP/s): the
// two are close.  Design, kept simple: one 256-thread block per (b * c, h),
// everything fp32 on the CUDA cores (never TF32: the reference is fp32).
// The block stages x, B^T and C^T in shared memory and builds W^T (Q x Q,
// 64 KB at Q = 128) there, 165 KB of dynamic shared memory in all; each
// thread computes 4 x 4 output tiles from 16-byte shared loads.  Score
// tiles wholly above the diagonal are skipped, and y's sum for a row tile
// stops at its last row.  The scores C B^T do not depend on the head, and
// this kernel recomputes them for each head: sharing them is later work.
//
// exp(cs_i - cs_j) is evaluated only where i >= j, as the Pallas body's
// where: cs falls along the chunk, so above the diagonal the exponent is
// large and positive, exp gives inf, and inf * 0 would be NaN.
//
// The cumsum runs in order j = 0..Q-1 in one thread; another order (as
// jnp's or torch's on the card) rounds cs differently, by up to an ulp of
// |cs| per step, which the exponentials carry as a relative error of the
// same size: the tolerance against the plain version is stated where the
// two are compared.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;

struct Dims {
  int Q, nh, hd, ds;
  int ldt;  // leading dim of B^T, C^T and W^T rows: Q + 4
};

// a block's dynamic shared memory, in floats; over the 227 KB a block can
// have, cudaFuncSetAttribute fails and the launch returns its error
inline size_t smem_floats(const Dims& d) {
  return (size_t)2 * d.ds * d.ldt + (size_t)d.Q * d.ldt +
         (size_t)d.Q * d.hd + 3 * (size_t)d.Q;
}

__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const float* __restrict__ xh, const float* __restrict__ dt,
                 const float* __restrict__ loga,
                 const float* __restrict__ Bc, const float* __restrict__ Cc,
                 float* __restrict__ y, float* __restrict__ sB,
                 float* __restrict__ a_chunk, Dims d) {
  extern __shared__ __align__(16) float smem[];
  const int Q = d.Q, nh = d.nh, hd = d.hd, ds = d.ds, ldt = d.ldt;
  float* Bt = smem;                          // (ds, ldt): B^T
  float* Ct = Bt + (size_t)ds * ldt;         // (ds, ldt): C^T
  float* Wt = Ct + (size_t)ds * ldt;         // (Q, ldt): W^T, Wt[j][i]
  float* X = Wt + (size_t)Q * ldt;           // (Q, hd)
  float* cs = X + (size_t)Q * hd;            // (Q,)
  float* dts = cs + Q;                       // (Q,)
  float* coef = dts + Q;                     // (Q,): exp(cs_{Q-1} - cs_j) dt_j

  const int bc = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;

  for (int e = tid; e < Q * (hd / 4); e += THREADS) {
    const int j = e / (hd / 4), c = (e % (hd / 4)) * 4;
    *reinterpret_cast<float4*>(X + (size_t)j * hd + c) =
        *reinterpret_cast<const float4*>(
            xh + (((size_t)bc * Q + j) * nh + h) * hd + c);
  }
  for (int e = tid; e < Q * ds; e += THREADS) {
    const int j = e / ds, n = e % ds;
    const size_t g = ((size_t)bc * Q + j) * ds + n;
    Bt[(size_t)n * ldt + j] = Bc[g];
    Ct[(size_t)n * ldt + j] = Cc[g];
  }
  for (int j = tid; j < Q; j += THREADS) {
    const size_t g = ((size_t)bc * Q + j) * nh + h;
    cs[j] = loga[g];
    dts[j] = dt[g];
  }
  __syncthreads();
  if (tid == 0) {
    float run = 0.0f;
    for (int j = 0; j < Q; ++j) {
      run += cs[j];
      cs[j] = run;
    }
    a_chunk[(size_t)bc * nh + h] = expf(run);
  }
  __syncthreads();
  for (int j = tid; j < Q; j += THREADS)
    coef[j] = expf(cs[Q - 1] - cs[j]) * dts[j];

  // W^T: 4 x 4 tiles (ti, tj) of rows i and columns j, tj fastest
  const int nq = Q / 4;
  for (int e = tid; e < nq * nq; e += THREADS) {
    const int ti = e / nq, tj = e % nq;
    if (tj > ti) continue;  // wholly above the diagonal: never read
    float acc[4][4] = {};
    for (int n = 0; n < ds; ++n) {
      const float4 cv = *reinterpret_cast<const float4*>(
          Ct + (size_t)n * ldt + 4 * ti);
      const float4 bv = *reinterpret_cast<const float4*>(
          Bt + (size_t)n * ldt + 4 * tj);
      const float c4[4] = {cv.x, cv.y, cv.z, cv.w};
      const float b4[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
          acc[a][bb] = fmaf(c4[a], b4[bb], acc[a][bb]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * ti + a;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const int j = 4 * tj + bb;
        // exp only where i >= j: above the diagonal it would overflow
        Wt[(size_t)j * ldt + i] =
            i >= j ? expf(cs[i] - cs[j]) * acc[a][bb] * dts[j] : 0.0f;
      }
    }
  }
  __syncthreads();

  // y = W x: 4 x 4 tiles (ti, tp), tp fastest; row tile ti sums j <= 4ti+3
  const int np = hd / 4;
  for (int e = tid; e < nq * np; e += THREADS) {
    const int ti = e / np, tp = e % np;
    float acc[4][4] = {};
    for (int j = 0; j < 4 * ti + 4; ++j) {
      const float4 wv = *reinterpret_cast<const float4*>(
          Wt + (size_t)j * ldt + 4 * ti);
      const float4 xv = *reinterpret_cast<const float4*>(
          X + (size_t)j * hd + 4 * tp);
      const float w4[4] = {wv.x, wv.y, wv.z, wv.w};
      const float x4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int bb = 0; bb < 4; ++bb)
          acc[a][bb] = fmaf(w4[a], x4[bb], acc[a][bb]);
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * ti + a;
      *reinterpret_cast<float4*>(
          y + (((size_t)bc * Q + i) * nh + h) * hd + 4 * tp) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
    }
  }

  // sB = (coef * x)^T B: 4 x 4 tiles (tn, tp) of (p, n), tp fastest
  const int nn = ds / 4;
  for (int e = tid; e < nn * np; e += THREADS) {
    const int tn = e / np, tp = e % np;
    float acc[4][4] = {};  // [p][n]
    for (int j = 0; j < Q; ++j) {
      const float cj = coef[j];
      const float4 xv = *reinterpret_cast<const float4*>(
          X + (size_t)j * hd + 4 * tp);
      const float cx[4] = {cj * xv.x, cj * xv.y, cj * xv.z, cj * xv.w};
      float b4[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) b4[c] = Bt[(size_t)(4 * tn + c) * ldt + j];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(cx[a], b4[c], acc[a][c]);
    }
    float* dst = sB + (((size_t)bc * nh + h) * hd) * ds;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(dst + (size_t)(4 * tp + a) * ds + 4 * tn) =
          make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]);
  }
}

}  // namespace

extern "C" int ssd_chunk(const void* xh, const void* dt, const void* loga,
                         const void* Bc, const void* Cc, void* y, void* sB,
                         void* a_chunk, int BC, int Q, int nh, int hd, int ds,
                         void* stream) {
  if (BC < 0 || Q <= 0 || nh < 0 || Q % 4 || hd % 4 || ds % 4 || hd <= 0 ||
      ds <= 0 || nh > 65535)
    return (int)cudaErrorInvalidValue;
  if (BC == 0 || nh == 0) return 0;
  const Dims d{Q, nh, hd, ds, Q + 4};
  const size_t bytes = smem_floats(d) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_chunk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BC, nh);
  ssd_chunk_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)xh, (const float*)dt, (const float*)loga,
      (const float*)Bc, (const float*)Cc, (float*)y, (float*)sB,
      (float*)a_chunk, d);
  return (int)cudaGetLastError();
}
