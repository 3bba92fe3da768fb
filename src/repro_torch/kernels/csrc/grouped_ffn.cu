// Grouped expert FFN for Hopper (sm_90a), capacity layout:
//   y[g] = (act(x[g] @ w1[g]) * (x[g] @ w3[g])) @ w2[g]     (SiLU/GELU-GLU)
//   y[g] =  act(x[g] @ w1[g])                  @ w2[g]     (plain MLP)
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
// (T=2) it is bound by the weight bytes alone; at the scoring forward's
// (128, 2048, 2048) by its 2.47 TFLOP (2.5 ms).
// Design for that: the grouped GEMM of grouped_gemm_sm90.cuh (TMA into a
// 4-stage ring, one producer warp, two consumer warpgroups on wgmma,
// 128-row tiles), launched twice: pass 1 on 128 x 128 tiles of h with both
// accumulators (x@w1, x@w3) in registers, pass 2 on 128 x 256 tiles of y.
// Blocks of one expert run next to each other, so its 9.4 MB of weights
// come from HBM once and from L2 for its other row tiles.  Where T <= 64
// (decode: T = 2) a tile has one consumer warpgroup of 64 rows, its rows
// past T loaded as zeros by TMA, and the weight stream sets the pace.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; returns the cudaError_t of the first failing launch (or of a
// tensor map that could not be built: every base pointer must be 16-byte
// aligned).

#include "grouped_gemm_sm90.cuh"

extern "C" int grouped_ffn(const void* x, const void* w1, const void* w3,
                           const void* w2, void* h, void* y, int G, int T,
                           int d, int f, int act, void* stream) {
  using namespace ffn90;
  if (G <= 0 || T <= 0) return 0;
  if (d % 64 != 0 || f % 64 != 0 || G > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const bf16 *xb = (const bf16*)x, *b1 = (const bf16*)w1,
             *b3 = (const bf16*)w3, *b2 = (const bf16*)w2;
  int err = w3 != nullptr
                ? grouped_gemm<EPI_GLU>(xb, b1, b3, (bf16*)h, G, T, f, d, act,
                                        s)
                : grouped_gemm<EPI_ACT>(xb, b1, nullptr, (bf16*)h, G, T, f, d,
                                        act, s);
  if (err != 0) return err;
  return grouped_gemm<EPI_NONE>((const bf16*)h, b2, nullptr, (bf16*)y, G, T,
                                d, f, act, s);
}
