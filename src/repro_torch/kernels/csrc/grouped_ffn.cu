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
// Design for that, kept simple in this first version: the grouped GEMM of
// grouped_gemm.cuh (WMMA bf16 16x16x16 fragments, fp32 accumulate), one
// 64 x 64 output tile of one group per 128-thread block, launched twice.
// Every weight byte is read once per 64-row tile of x, so at decode (one row
// tile) the weights are read exactly once.  Rows of x past T load as zeros
// and are never stored.  Not yet done (later work): wgmma, TMA, a
// multi-stage shared-memory ring, and a persistent schedule.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; returns the cudaError_t of the first failing launch.

#include "grouped_gemm.cuh"

extern "C" int grouped_ffn(const void* x, const void* w1, const void* w3,
                           const void* w2, void* h, void* y, int G, int T,
                           int d, int f, int act, void* stream) {
  using namespace ffn;
  constexpr int BM = 64;
  if (G <= 0 || T <= 0) return 0;
  if (d % BN != 0 || f % BN != 0) return (int)cudaErrorInvalidValue;
  if (G > 65535 || (T + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  const dim3 g1(f / BN, (T + BM - 1) / BM, G), g2(d / BN, (T + BM - 1) / BM, G);
  return ffn_two_pass<BM>((const bf16*)x, (const bf16*)w1, (const bf16*)w3,
                          (const bf16*)w2, (bf16*)h, (bf16*)y, T, d, f,
                          (long long)T * d, (long long)T * f, g1, g2, act,
                          Rows{nullptr, 0, 0, 0}, (cudaStream_t)stream);
}
