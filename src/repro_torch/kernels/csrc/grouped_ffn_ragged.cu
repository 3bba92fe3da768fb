// Ragged grouped expert FFN for Hopper (sm_90a), dropless layout:
//   y[tile] = (act(x[tile] @ w1[g]) * (x[tile] @ w3[g])) @ w2[g]   (GLU)
//   y[tile] =  act(x[tile] @ w1[g])                      @ w2[g]   (MLP)
// for every row tile of `block` rows, g the expert owning the tile.
// x (R, d) bf16, the tile-aligned ragged layout of
// repro_torch.core.dispatch.dispatch_ragged (each group's segment starts at a
// multiple of `block`; padding rows and the rows past group_starts[G] are
// zeros); group_starts (G+1,) int32; w1/w3 (G, d, f), w2 (G, f, d) bf16 ->
// y (R, d) bf16.
//
// Replaces the TPU kernel src/repro/kernels/grouped_ffn.py
// grouped_ffn_ragged_pallas (grid (R/bt, f/bf), the tile's weights chosen by
// the scalar-prefetched tile_gid, the output tile revisited over the f axis).
//
// Numerics follow the oracle ref.grouped_ffn_ragged_ref: x@w1 and x@w3
// accumulated in fp32 over all of d, the activation and the GLU product in
// fp32, h rounded to bf16 once; y = h @ w2 summed in fp32 over all of f and
// rounded once.
//
// What bounds it on the card: at the serving prefill (R = 18,432 rows of
// which 8,192 are real, 128 experts, d=2048, f=768) the real rows need
// 77 GFLOP (0.08 ms at 989 TFLOP/s) and the weights of the experts they
// touch, up to 1.2 GB of bf16 (0.36 ms at 3.35 TB/s): bound by the weight
// bytes, as at decode, where 64 real rows touch at most 64 experts.
// Design for that, kept simple in this first version: two passes through
// an h scratch (R, f) (CUDA blocks share nothing, so the Pallas kernel's
// f-axis accumulation becomes pass 2's fp32 sum over all of f), on the WMMA
// grouped GEMM of grouped_gemm.cuh, with one indirection:
// a block takes min(block, 64) rows of one tile and finds the tile's expert
// by a binary search over group_starts, the ids of
// repro.core.dispatch.ragged_tile_gids (searchsorted side="right" minus one,
// clipped to [0, G-1]).  A 64-row tile reads its expert's weights once; an
// 8-row tile (decode) runs in a 16-row WMMA tile whose last 8 rows load as
// zeros.  Tiles past group_starts[G] hold only zero rows, whose FFN output is
// zero: the kernel skips them in pass 1 and writes their zeros in pass 2
// without reading a weight (at decode more than 100 of 168 tiles).  Not yet
// done (later work): wgmma, TMA, a pipelined ring, one block over all tiles
// of an expert so its weights are read once.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; returns the cudaError_t of the first failing launch.

#include "grouped_gemm.cuh"

extern "C" int grouped_ffn_ragged(const void* x, const int* group_starts,
                                  const void* w1, const void* w3,
                                  const void* w2, void* h, void* y, int R,
                                  int G, int d, int f, int block, int act,
                                  void* stream) {
  using namespace ffn;
  if (R <= 0) return 0;
  if (G <= 0 || d % BN != 0 || f % BN != 0) return (int)cudaErrorInvalidValue;
  const int step = block < 64 ? block : 64;
  if (block < 8 || block % 8 != 0 || block % step != 0 || R % block != 0 ||
      R / step > 65535)
    return (int)cudaErrorInvalidValue;
  const Rows rows{group_starts, G, block, step};
  const dim3 g1(f / BN, R / step, 1), g2(d / BN, R / step, 1);
  const bf16* xb = (const bf16*)x;
  const bf16 *b1 = (const bf16*)w1, *b3 = (const bf16*)w3,
             *b2 = (const bf16*)w2;
  cudaStream_t s = (cudaStream_t)stream;
  if (step <= 16)
    return ffn_two_pass<16>(xb, b1, b3, b2, (bf16*)h, (bf16*)y, d, f, g1, g2,
                            act, rows, s);
  if (step <= 32)
    return ffn_two_pass<32>(xb, b1, b3, b2, (bf16*)h, (bf16*)y, d, f, g1, g2,
                            act, rows, s);
  return ffn_two_pass<64>(xb, b1, b3, b2, (bf16*)h, (bf16*)y, d, f, g1, g2,
                          act, rows, s);
}
