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
// Design for that: two passes through an h scratch (R, f) (CUDA blocks
// share nothing, so the Pallas kernel's f-axis accumulation becomes pass
// 2's fp32 sum over all of f), each one launch of the Hopper grouped GEMM
// of grouped_gemm_sm90.cuh in its ragged layout (TMA into a 4-stage ring,
// one producer warp, wgmma m64n128k16; pass 1 on 64 x 128 tiles with both
// GLU accumulators in registers, pass 2 on 64 x 256 tiles).  A block has
// one consumer warpgroup and takes min(block, 64) rows of one tile, whose
// expert the producer finds by a binary search over group_starts, the ids
// of repro.core.dispatch.ragged_tile_gids (searchsorted side="right" minus
// one, clipped to [0, G-1]), and loads that expert's weights: a 64-row
// prefill tile reads them once; an 8-row decode tile loads only its 8 rows
// of x (or h) into the 64-row wgmma tile, and stores only those 8.  Blocks
// of neighbouring tiles run next to each other, so an expert's weights come
// from HBM once for its tiles.  Tiles past group_starts[G] hold only zero
// rows, whose FFN output is zero: the kernel skips them in pass 1 and
// writes their zeros in pass 2 without reading a weight (at decode more
// than 100 of 168 tiles).
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; returns the cudaError_t of the first failing launch (or of a
// tensor map that could not be built: every base pointer must be 16-byte
// aligned).

#include "grouped_gemm_sm90.cuh"

extern "C" int grouped_ffn_ragged(const void* x, const int* group_starts,
                                  const void* w1, const void* w3,
                                  const void* w2, void* h, void* y, int R,
                                  int G, int d, int f, int block, int act,
                                  void* stream) {
  using namespace ffn90;
  if (R <= 0) return 0;
  if (G <= 0 || d % 64 != 0 || f % 64 != 0)
    return (int)cudaErrorInvalidValue;
  const int step = block < 64 ? block : 64;
  if (block < 8 || block % 8 != 0 || block % step != 0 || R % block != 0)
    return (int)cudaErrorInvalidValue;
  const Ragged rows{group_starts, G, block, step};
  const bf16 *xb = (const bf16*)x, *b1 = (const bf16*)w1,
             *b3 = (const bf16*)w3, *b2 = (const bf16*)w2;
  cudaStream_t s = (cudaStream_t)stream;
  int err = w3 != nullptr
                ? ragged_gemm<EPI_GLU>(xb, b1, b3, (bf16*)h, R, f, d, act,
                                       rows, s)
                : ragged_gemm<EPI_ACT>(xb, b1, nullptr, (bf16*)h, R, f, d,
                                       act, rows, s);
  if (err != 0) return err;
  return ragged_gemm<EPI_NONE>((const bf16*)h, b2, nullptr, (bf16*)y, R, d,
                               f, act, rows, s);
}
