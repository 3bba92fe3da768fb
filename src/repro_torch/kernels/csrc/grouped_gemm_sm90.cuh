// The grouped bf16 GEMM for Hopper (sm_90a) that grouped_ffn.cu (capacity
// layout) and grouped_ffn_ragged.cu (ragged layout) launch twice each:
//   capacity: C[g] = epilogue(A[g] @ B[g] [, A[g] @ B2[g]])
//             A (G, M, K), B/B2 (G, K, N), C (G, M, N)
//   ragged:   C[rows] = epilogue(A[rows] @ B[g] [, A[rows] @ B2[g]]) for
//             every row tile, g the group that owns the tile
//             A (R, K), B/B2 (G, K, N), C (R, N)
// bf16, fp32 accumulation, with the primitives of sm90.cuh:
//  * one block per output tile of 64 WGS rows: one producer warp and WGS
//    consumer warpgroups of 64 rows each (WGS = 2; 1 where M <= 64, as at
//    decode, so no warpgroup runs on rows that are all padding);
//  * the producer loads A and B in depth steps of 64 through a ring of
//    STAGES stages by TMA, with a full and an empty barrier per stage.  The
//    tensor maps are 3-D over (G, M, K) and (G, K, N), so rows past M of one
//    group load as zeros and are never read from the next group;
//  * wgmma m64n128k16 with A K-major (as stored) and the weights (K, N) with
//    N contiguous as the MN-major B operand (the transpose bit); a consumer
//    keeps one group of wgmmas in flight and releases a stage when the
//    group that read it has completed.  No wgmma sits under a branch that
//    the compiler cannot prove uniform (it would serialize them all);
//  * blocks are numbered with the row tiles of one group and column tile
//    next to each other, so a group's weights come from HBM once and from
//    L2 for its other row tiles.
// The ragged layout (repro_torch.core.dispatch.dispatch_ragged): each
// group's rows start at a multiple of the layout's row tile (`tile` rows);
// the rows of the alignment padding and past starts[G] are zeros.  A block
// has one consumer warpgroup and takes `step` = min(tile, 64) rows of one
// tile, so a block never straddles two groups: at prefill (tile 64) two
// warpgroups of one 128-row block would often belong to two experts, whose
// weights they would not share.  A's tensor map is 2-D over the flat rows
// with a box of `step` rows: at decode (tile 8) the warpgroup's wgmma tile
// is 64 rows of which the first 8 are the tile's and the other 56 hold
// whatever the ring's stage held before; their rows of the product are
// never stored (rows past m0 + step are not written).  The producer looks up
// the tile's group in starts (tile_group) and loads that group's B.  Blocks
// past starts[G] hold only zero rows, whose output is zero: they load
// nothing; the first pass (h) skips them, the second writes their zeros.
// Epilogues, on the fp32 accumulators before the one rounding to bf16:
//  * EPI_GLU: act(A@B) * (A@B2), both accumulators of a 128-column tile
//    side by side, so A is read once for both;
//  * EPI_ACT: act(A@B), 128 columns;
//  * EPI_NONE: A@B over a tile of 256 columns, its second half taking the
//    place of B2 (two accumulators of 128 columns).
// Columns past N (N a multiple of 64 narrower than a tile) are not loaded
// (their shared memory keeps whatever it held, which reaches only the
// accumulator columns of those B columns) and not stored.  The tile is
// stored from registers, a column pair a thread: staging it in shared
// memory for a TMA store measured slower at decode (two rows a block).
// act: 0 = SiLU (x * sigmoid(x)), 1 = GELU in its tanh form (jax.nn.gelu's
// default).

#pragma once

#include "sm90.cuh"

namespace ffn90 {

using namespace sm90;
typedef __nv_bfloat16 bf16;

constexpr int BN = 128;             // columns per B operand
constexpr int BK = 64;              // depth per stage (one 128-byte row)
constexpr int STAGES = 4;
constexpr int BOX_B = BK * 128;     // one 64 x 64 weight box, 8 KB
constexpr int B_BYTES = 2 * BOX_B;  // 64 x 128

// the block's shape for WGS consumer warpgroups
template <int WGS>
struct Tile {
  static constexpr int BM = 64 * WGS;               // rows per tile
  static constexpr int CONSUMERS = 128 * WGS;
  static constexpr int THREADS = CONSUMERS + 32;    // + one producer warp
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE_BYTES;
  static constexpr int SMEM_BYTES = BAR_OFF + 8 * 2 * STAGES + 1024;  // + align
};

enum Epilogue { EPI_NONE = 0, EPI_ACT = 1, EPI_GLU = 2 };

// the ragged layout's rows: starts == nullptr is the capacity layout
struct Ragged {
  const int* starts;  // (G+1,) aligned segment offsets
  int G;              // groups
  int tile;           // the layout's row tile
  int step;           // rows per block, min(tile, 64)
};

// the group owning the tile that starts at row t0:
// searchsorted(starts[0..G], t0, side="right") - 1, clipped to [0, G - 1]
// (the ids repro.core.dispatch.ragged_tile_gids gives)
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

__device__ __forceinline__ float act_fn(float v, int act) {
  if (act == 0) return v / (1.0f + expf(-v));  // SiLU
  const float c = 0.7978845608028654f;         // sqrt(2 / pi)
  return 0.5f * v * (1.0f + tanhf(c * (v + 0.044715f * v * v * v)));
}

// RAGGED: rg describes the rows (M = R, and A's map is 2-D); otherwise the
// capacity layout (A's map 3-D over (G, M, K)) and rg is unused
template <int EPI, int WGS, bool RAGGED>
__global__ void __launch_bounds__(Tile<WGS>::THREADS, 1)
grouped_gemm_sm90(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_b,
                  const __grid_constant__ CUtensorMap tm_b2,
                  bf16* __restrict__ C, int M, int N, int K, int m_tiles,
                  int n_tiles, int act, Ragged rg) {
  using L = Tile<WGS>;
  constexpr int STAGE_BYTES = L::STAGE_BYTES, CONSUMERS = L::CONSUMERS;
  constexpr int TN = EPI == EPI_NONE ? 2 * BN : BN;  // columns per tile
  constexpr bool TWO = EPI != EPI_ACT;                // a second B operand
  static_assert(!RAGGED || WGS == 1, "a ragged block has one warpgroup");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + STAGES;

  const int rows = RAGGED ? rg.step : L::BM;  // rows the block loads, stores
  int id = blockIdx.x;  // row tiles fastest, then column tiles, then groups
  const int m0 = (id % m_tiles) * rows;
  id /= m_tiles;
  const int n0 = (id % n_tiles) * TN;
  const int nb2 = EPI == EPI_NONE ? n0 + BN : n0;  // B2's first column
  const int nk = K / BK;
  if (RAGGED && m0 >= __ldg(rg.starts + rg.G)) {
    // past the last segment: zero rows in, zeros out, no weight read
    if (EPI == EPI_NONE)
      for (int e = threadIdx.x; e < rows * (TN / 8); e += blockDim.x) {
        const int col = n0 + (e % (TN / 8)) * 8;
        if (col < N)
          *reinterpret_cast<uint4*>(C + (size_t)(m0 + e / (TN / 8)) * N +
                                    col) = make_uint4(0u, 0u, 0u, 0u);
      }
    return;
  }
  const int g = RAGGED ? 0 : id / n_tiles;  // the capacity layout's group

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // the producer warp: one lane issues every load.  A 64-column box is
    // loaded only where it starts inside N; the columns of one it skips are
    // never stored.
    if (threadIdx.x == CONSUMERS) {
      const int nbox = n0 + 64 < N ? 2 : 1;
      const int nbox2 = !TWO ? 0 : (nb2 >= N ? 0 : nb2 + 64 < N ? 2 : 1);
      const uint32_t bytes = rows * BK * 2 + (nbox + nbox2) * BOX_B;
      const CUtensorMap* m2 = EPI == EPI_GLU ? &tm_b2 : &tm_b;
      // A's group coordinate, and B's group
      const int ga = RAGGED ? 0 : g;
      const int gb =
          RAGGED ? tile_group(rg.starts, rg.G, m0 - m0 % rg.tile) : g;
      for (int k = 0; k < nk; ++k) {
        const int s = k % STAGES;
        if (k >= STAGES) mbar_wait(&empty[s], ((k / STAGES) - 1) & 1);
        uint8_t* st = smem + s * STAGE_BYTES;
        mbar_expect_tx(&full[s], bytes);
        tma_load_3d(st, &tm_a, &full[s], k * BK, m0, ga);
        for (int x = 0; x < nbox; ++x)
          tma_load_3d(st + L::A_BYTES + x * BOX_B, &tm_b, &full[s],
                      n0 + 64 * x, k * BK, gb);
        for (int x = 0; x < nbox2; ++x)
          tma_load_3d(st + L::A_BYTES + B_BYTES + x * BOX_B, m2, &full[s],
                      nb2 + 64 * x, k * BK, gb);
      }
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row = 16 * (t / 32) + lane / 4;  // and row + 8, of the 64

  // the first step overwrites the accumulators (scale_d = 0): instructions
  // that define them between wgmmas can make ptxas serialize the wgmmas
  float acc[64], acc2[64];
  for (int k = 0; k < nk; ++k) {
    const int s = k % STAGES;
    mbar_wait(&full[s], (k / STAGES) & 1);
    const uint8_t* st = smem + s * STAGE_BYTES;
    const uint8_t* a = st + 64 * wg * 128;  // the warpgroup's 64 rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t da = desc(a + 32 * kk, 16, 1024, 1);
      const int accumulate = k > 0 || kk > 0;
      wgmma_ss_n128<1>(acc, da,
                       desc(st + L::A_BYTES + kk * 2048, BOX_B, 1024, 1),
                       accumulate);
      if constexpr (TWO)
        wgmma_ss_n128<1>(acc2, da,
                         desc(st + L::A_BYTES + B_BYTES + kk * 2048, BOX_B,
                              1024, 1),
                         accumulate);
    }
    wgmma_commit();
    // one group stays in flight: the previous step's has completed, so its
    // stage goes back to the producer
    wgmma_wait<1>();
    if (k > 0) mbar_arrive(&empty[(k - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(acc2);
  mbar_arrive(&empty[(nk - 1) % STAGES]);

  // epilogue in registers, one rounding, 4-byte stores of column pairs;
  // ragged: only the block's own rows
  bf16* Cg = C + (size_t)g * M * N;
  const int m_end = RAGGED ? m0 + rows : M;
#pragma unroll
  for (int n = 0; n < BN / 8; ++n) {
    const int col = n0 + 8 * n + 2 * (lane % 4);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + 64 * wg + row + 8 * half;
      if (r >= m_end) continue;
      const int i = 4 * n + 2 * half;
      float v0 = acc[i], v1 = acc[i + 1];
      if (EPI == EPI_GLU) {
        v0 = act_fn(v0, act) * acc2[i];
        v1 = act_fn(v1, act) * acc2[i + 1];
      } else if (EPI == EPI_ACT) {
        v0 = act_fn(v0, act);
        v1 = act_fn(v1, act);
      }
      bf16* dst = Cg + (size_t)r * N + col;
      if (col < N) *reinterpret_cast<uint32_t*>(dst) = pack_bf16(v0, v1);
      if (EPI == EPI_NONE && col + BN < N)
        *reinterpret_cast<uint32_t*>(dst + BN) =
            pack_bf16(acc2[i], acc2[i + 1]);
    }
  }
}

// One launch: C (G, M, N) = epilogue(A (G, M, K) @ B (G, K, N) [, B2]);
// RAGGED: C (M, N) = epilogue(A (M, K) @ B (G, K, N) [, B2]) over rg's
// tiles.  K and N multiples of 64.  Returns a cudaError_t.
template <int EPI, int WGS, bool RAGGED>
int launch(const bf16* A, const bf16* B, const bf16* B2, bf16* C, int G,
           int M, int N, int K, int act, Ragged rg, cudaStream_t stream) {
  using L = Tile<WGS>;
  constexpr int TN = EPI == EPI_NONE ? 2 * BN : BN;
  const int rows = RAGGED ? rg.step : L::BM;
  const int ga = RAGGED ? 1 : G;  // A's groups
  const uint64_t da[3] = {(uint64_t)K, (uint64_t)M, (uint64_t)ga};
  const uint64_t sa[2] = {(uint64_t)K * 2, (uint64_t)M * K * 2};
  const uint32_t boxa[3] = {BK, (uint32_t)rows, 1};
  const uint64_t db[3] = {(uint64_t)N, (uint64_t)K, (uint64_t)G};
  const uint64_t sb[2] = {(uint64_t)N * 2, (uint64_t)K * N * 2};
  const uint32_t boxb[3] = {64, BK, 1};
  CUtensorMap ma, mb, mb2;
  int err;
  if ((err = make_map(&ma, A, 3, da, sa, boxa, 128)) != 0) return err;
  if ((err = make_map(&mb, B, 3, db, sb, boxb, 128)) != 0) return err;
  mb2 = mb;
  if (B2 != nullptr && (err = make_map(&mb2, B2, 3, db, sb, boxb, 128)) != 0)
    return err;
  static bool sized = false;  // the shared-memory limit, set once
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        grouped_gemm_sm90<EPI, WGS, RAGGED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM_BYTES);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const int m_tiles = (M + rows - 1) / rows, n_tiles = (N + TN - 1) / TN;
  const long long blocks = (long long)ga * m_tiles * n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  grouped_gemm_sm90<EPI, WGS, RAGGED>
      <<<(unsigned)blocks, L::THREADS, L::SMEM_BYTES, stream>>>(
          ma, mb, mb2, C, M, N, K, m_tiles, n_tiles, act, rg);
  return (int)cudaGetLastError();
}

// the capacity layout: A (G, M, K), C (G, M, N)
template <int EPI>
int grouped_gemm(const bf16* A, const bf16* B, const bf16* B2, bf16* C,
                 int G, int M, int N, int K, int act, cudaStream_t stream) {
  const Ragged none{nullptr, 0, 0, 0};
  return M <= 64
             ? launch<EPI, 1, false>(A, B, B2, C, G, M, N, K, act, none,
                                     stream)
             : launch<EPI, 2, false>(A, B, B2, C, G, M, N, K, act, none,
                                     stream);
}

// the ragged layout: A (R, K), C (R, N), B's group per row tile from rg
template <int EPI>
int ragged_gemm(const bf16* A, const bf16* B, const bf16* B2, bf16* C,
                int R, int N, int K, int act, Ragged rg,
                cudaStream_t stream) {
  return launch<EPI, 1, true>(A, B, B2, C, rg.G, R, N, K, act, rg, stream);
}

}  // namespace ffn90
