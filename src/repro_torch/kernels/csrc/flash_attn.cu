// Causal flash attention (streaming softmax) for Hopper (sm_90a):
//   o[b, t, h] = softmax_s(q[b, t, h] . k[b, s, h/g] / sqrt(hd), s <= t)
//                . v[b, s, h/g]
// q (B, T, H, hd), k/v (B, T, KV, hd) bf16 with g = H / KV query heads per
// KV head (GQA); o (B, T, H, hd) bf16; hd any multiple of 8 up to 512 (past
// 192 on the wide route, at the end of this file).
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py
// flash_attention_pallas: one grid step per (b, h, 128-row query tile),
// looping over the 128-key KV tiles up to the causal frontier with an
// online-softmax accumulator in VMEM; its wrapper repeats the KV heads for
// GQA.
//
// What bounds it on the card: operations.  The causal products are
// 4 * B * H * T^2 * hd / 2 flops (2.75e11 at qwen3's (2, 4096, 32, 128):
// 0.28 ms at 989 TFLOP/s) against ~0.15 GB of bytes (0.045 ms).  Design for
// that, FlashAttention-3's core without its ping-pong scheduling (sm90.cuh
// holds the primitives):
//  * one block per (128-row query tile, h, b), longest loops first: one
//    producer warp and two consumer warpgroups of 64 query rows each;
//  * the producer loads Q once and the K and V tiles of BK keys (128; 64 at
//    a padded head of 192) through a ring of STAGES stages by TMA (4-D tensor maps over (hd, heads, T, B), so
//    KV head h / g is read in place of the wrapper's repeat, and rows past T
//    load as zeros), with full and empty barriers for K and for V apart: a
//    K buffer goes back to the producer as soon as S is computed;
//  * S = Q K^T is a wgmma with both operands in shared memory (K-major, as
//    stored), accumulated in fp32 registers; the causal mask is applied
//    only on the tiles that reach past the warpgroup's first query;
//  * the online softmax runs in registers on wgmma's accumulator layout:
//    each thread holds two rows, whose max and sum close with two shuffles
//    inside the quad of lanes that shares them; O is rescaled in registers;
//  * O += P V is a wgmma with P, rounded to bf16, as the A operand from
//    registers (the S accumulator's layout is the A fragment's) and V as the
//    MN-major B operand (hd contiguous) with the transpose bit;
//  * a warpgroup runs its steps in order (S, softmax, P V); the two
//    warpgroups overlap each other's softmax with their products, and the
//    loads overlap both.  FlashAttention-3's overlap of the softmax with the
//    next S inside a warpgroup needs S, P and O in registers at once, more
//    than the 168 a thread that 288 threads leave: ptxas spills and
//    serializes the wgmmas, also under setmaxnreg with a producer
//    warpgroup, and P through shared memory instead costs more than the
//    overlap gains (all three measured slower, PERF.md section 6);
//  * O is normalised and rounded once, written swizzled into the warpgroup's
//    own Q rows in shared memory, and stored by TMA (rows past T are not
//    written).
// A row of hd 128 is 256 bytes: it comes in two 64-column boxes of the
// 128-byte swizzle; hd 64 is one such box and hd 32 one box of the 64-byte
// swizzle.  Other head sizes run at the next of those widths, or at 192
// (three boxes): the kernel is instantiated at a padded head HDP (hd <= 32
// -> 32, else hd rounded up to a multiple of 64), while the tensor maps keep
// the true hd as their innermost dimension, so TMA loads the columns past hd
// as zeros (which add nothing to Q K^T or to P V) and the store of O stops
// at hd.  Rows stay hd * 2 bytes apart, a multiple of 16 for every hd that
// is a multiple of 8.  At HDP 192 the KV tile is 64 keys wide: O (96 fp32
// registers a thread) and a 128-key S (64) would not fit the 168 registers
// a thread that 288 threads leave, nor two stages of 128-key K and V tiles
// the shared memory; with 64 keys S takes 32 registers, and three stages
// take 192 KB.  The online softmax then rescales every 64 keys, not every
// 128 as Pallas's bk; the bf16 output is held to the same bound.
//
// The arithmetic follows the Pallas body where it changes bits: q is scaled
// in its own dtype before QK^T (the consumers scale their rows in shared
// memory after the TMA load, then fence the async proxy, since the wrapper's
// scale, rounded to bf16 as JAX rounds a Python float multiplying a bf16
// array, is not a power of two at hd 128); masked scores are -1e30 and the
// running max starts at -1e30; the running sum adds the fp32
// probabilities; the probabilities are rounded to v's dtype before PV; the
// output is acc / max(l, 1e-30), rounded once.  KV tiles are 128 keys wide,
// as Pallas's bk, up to HDP 128.  The exponentials are exp2 of the scores
// scaled by log2(e) in one fused multiply-add (FlashAttention's form): a few
// fp32 ulps from exp, far under the bf16 rounding of p; the order of the
// fp32 sums differs too.
//
// Query rows past T (T < 128) load as zeros and are not stored; keys past T
// sit past every real query, so the causal mask removes them, and no KV
// tile starts past T.  No row is fully masked in the first tile: key 0 is
// in every query's first tile.  With 64-key tiles the first
// warpgroup's rows see every key of the block's last tile masked, which
// leaves their max and sum as they were and adds zeros to O.
//
// Head sizes past 192 (up to 512, multiples of 8) take a second route,
// flash_attn_wide: O's 64 rows of 128 fp32 registers a warpgroup would not
// fit the registers a thread has, so this route tiles the head dim through
// shared memory and computes on the CUDA cores in fp32.  A block takes 16
// query rows of one (b, h) and 256 threads, 16 a row; it holds its rows of
// q (scaled and rounded to bf16, as above) for the whole head in shared
// memory, and for each 64-key tile up to the diagonal accumulates S over
// the head in 64-column chunks of K, runs the same online softmax (fp32
// sum, probabilities rounded to bf16 before PV, masked scores -1e30) with
// shuffles inside the row's 16 lanes, and adds P V chunk by chunk of V into
// O, which a thread keeps in registers (its row's columns c == lane mod 16).
// A simple route, held against the plain version: no tensor cores, no
// pipelining of the loads.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; returns the cudaError_t of the launch.

#include "sm90.cuh"

namespace {

using namespace sm90;
typedef __nv_bfloat16 bf16;

constexpr int BQ = 128;                  // query rows per block
constexpr int CONSUMERS = 256;           // two warpgroups of 64 query rows
constexpr int THREADS = CONSUMERS + 32;  // and one producer warp
constexpr int MAX_HD = 192;              // the widest padded head

// the padded head a head size runs at (0: none)
constexpr int padded_head(int hd) {
  return hd <= 0 || hd % 8 != 0 || hd > MAX_HD ? 0
         : hd <= 32                            ? 32
                                               : (hd + 63) / 64 * 64;
}

// HD is the padded head (32, 64, 128 or 192)
template <int HD>
struct Cfg {
  static constexpr int SWZ = HD >= 64 ? 128 : 64;  // swizzle span (bytes)
  static constexpr int BOX = SWZ / 2;              // hd columns per box
  static constexpr int NBOX = HD / BOX;
  static constexpr int LAYOUT = layout_of(SWZ);
  static constexpr int BK = HD > 128 ? 64 : 128;   // keys per KV tile
  static constexpr int STAGES = HD > 128 ? 3 : 2;  // K/V ring depth
  static constexpr int Q_BOX = BQ * SWZ;           // one box of the Q tile
  static constexpr int KV_BOX = BK * SWZ;          // one box of a K/V tile
  static constexpr int Q_TILE = BQ * HD * 2;
  static constexpr int KV_TILE = BK * HD * 2;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_TILE;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_TILE;
  // + 1024 for aligning the dynamic shared memory's start
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 4 * STAGES) + 1024;
};

// S (64 query rows x BK keys) = Q K^T over hd in steps of 16, both from
// shared memory (K-major)
template <int HD>
__device__ __forceinline__ void issue_qk(float (&sc)[Cfg<HD>::BK / 2],
                                         const uint8_t* q_rows,
                                         const uint8_t* ks) {
  using C = Cfg<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int x = kk / (C::BOX / 16), in_box = (kk % (C::BOX / 16)) * 32;
    wgmma_ss<C::BK, 0>(
        sc, desc(q_rows + x * C::Q_BOX + in_box, 16, 8 * C::SWZ, C::LAYOUT),
        desc(ks + x * C::KV_BOX + in_box, 16, 8 * C::SWZ, C::LAYOUT),
        kk > 0);
  }
}

// O (64 x hd) += P (64 x BK keys, bf16 registers) V over the keys in steps
// of 16; V (keys, hd) is the MN-major B operand
template <int HD>
__device__ __forceinline__ void issue_pv(
    float (&o)[HD / 2], const uint32_t (&pa)[Cfg<HD>::BK / 16][4],
    const uint8_t* vs) {
  using C = Cfg<HD>;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk)
    wgmma_rs<HD, 1>(o, pa[kk],
                    desc(vs + kk * 16 * C::SWZ, C::KV_BOX, 8 * C::SWZ,
                         C::LAYOUT),
                    1);
}

// P rounded to bf16, as wgmma's A fragments of 16 keys each
template <int KS>
__device__ __forceinline__ void to_bf16(uint32_t (&pa)[KS][4],
                                        const float (&sc)[8 * KS]) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kk][i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
}

// The online softmax of a thread's two rows (row and row + 8 of wgmma's
// accumulator layout); the quad of lanes that shares a row closes its max
// and sum with two shuffles.
struct Softmax {
  float m0 = -1e30f, m1 = -1e30f, l0 = 0.0f, l1 = 0.0f;
  float corr0 = 1.0f, corr1 = 1.0f;

  // one tile's scores (R of them a thread) in place -> probabilities.
  // diag: a tile that reaches past the rows' first query, where the key of
  // column c of the first row lies c + c0 past its query
  template <int R>
  __device__ __forceinline__ void step(float (&sc)[R], bool diag, int c0) {
    if (diag) {
#pragma unroll
      for (int n = 0; n < R / 4; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (c0 + 8 * n + e > 0) sc[4 * n + e] = -1e30f;
          if (c0 + 8 * n + e > 8) sc[4 * n + 2 + e] = -1e30f;
        }
    }
    float mx0 = -1e30f, mx1 = -1e30f;
#pragma unroll
    for (int n = 0; n < R / 4; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
    }
    constexpr float L2E = 1.4426950408889634f;  // log2(e)
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    corr0 = exp2f((m0 - mn0) * L2E);
    corr1 = exp2f((m1 - mn1) * L2E);
    const float b0 = mn0 * L2E, b1 = mn1 * L2E;
    float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
    for (int n = 0; n < R / 4; ++n) {
      sc[4 * n] = exp2f(fmaf(sc[4 * n], L2E, -b0));
      sc[4 * n + 1] = exp2f(fmaf(sc[4 * n + 1], L2E, -b0));
      sc[4 * n + 2] = exp2f(fmaf(sc[4 * n + 2], L2E, -b1));
      sc[4 * n + 3] = exp2f(fmaf(sc[4 * n + 3], L2E, -b1));
      sum0 += sc[4 * n] + sc[4 * n + 1];
      sum1 += sc[4 * n + 2] + sc[4 * n + 3];
    }
#pragma unroll
    for (int w = 1; w <= 2; w <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, w);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, w);
    }
    l0 = l0 * corr0 + sum0;
    l1 = l1 * corr1 + sum1;
    m0 = mn0;
    m1 = mn1;
  }

  // O's rows times the last step's corrections
  template <int R>
  __device__ __forceinline__ void rescale(float (&o)[R]) const {
#pragma unroll
    for (int n = 0; n < R / 4; ++n) {
      o[4 * n] *= corr0;
      o[4 * n + 1] *= corr0;
      o[4 * n + 2] *= corr1;
      o[4 * n + 3] *= corr1;
    }
  }
};

template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_sm90(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                const __grid_constant__ CUtensorMap tm_o, int T, int H,
                int KV, float scale) {
  using C = Cfg<HD>;
  constexpr int BK = C::BK, STAGES = C::STAGES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;
  uint64_t* v_full = bars + 1 + STAGES;
  uint64_t* k_empty = bars + 1 + 2 * STAGES;
  uint64_t* v_empty = bars + 1 + 3 * STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest loops first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  // KV tiles up to the diagonal, none past T
  const int n_kv = (min(q0 + BQ, T) + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&k_empty[s], CONSUMERS);
      mbar_init(&v_empty[s], CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // the producer warp: one lane issues every load
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, C::Q_TILE);
      for (int x = 0; x < C::NBOX; ++x)
        tma_load_4d(smem + C::Q_OFF + x * C::Q_BOX, &tm_q, q_full,
                    x * C::BOX, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % STAGES;
        const uint32_t parity = ((j / STAGES) - 1) & 1;  // the last use's
        if (j >= STAGES) mbar_wait(&k_empty[s], parity);
        mbar_expect_tx(&k_full[s], C::KV_TILE);
        for (int x = 0; x < C::NBOX; ++x)
          tma_load_4d(smem + C::K_OFF + s * C::KV_TILE + x * C::KV_BOX, &tm_k,
                      &k_full[s], x * C::BOX, kvh, j * BK, b);
        if (j >= STAGES) mbar_wait(&v_empty[s], parity);
        mbar_expect_tx(&v_full[s], C::KV_TILE);
        for (int x = 0; x < C::NBOX; ++x)
          tma_load_4d(smem + C::V_OFF + s * C::KV_TILE + x * C::KV_BOX, &tm_v,
                      &v_full[s], x * C::BOX, kvh, j * BK, b);
      }
    }
    return;
  }

  // consumer warpgroup wg takes query rows q0 + 64 wg .. + 63
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row = 16 * (t / 32) + lane / 4;  // and row + 8, of the 64
  const int qpos = q0 + 64 * wg + row;
  uint8_t* q_rows = smem + C::Q_OFF + 64 * wg * C::SWZ;  // in box 0

  // q * scale, rounded to bf16, in place (the swizzle does not matter for
  // an elementwise pass); then make the writes visible to wgmma
  mbar_wait(q_full, 0);
  for (int x = 0; x < C::NBOX; ++x) {
    uint4* p = reinterpret_cast<uint4*>(q_rows + x * C::Q_BOX);
    for (int e = t; e < 64 * C::SWZ / 16; e += 128) {
      uint4 val = p[e];
      __nv_bfloat162* v2 = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(v2[i]);
        v2[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      p[e] = val;
    }
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float sc[BK / 2];         // S of the tile, then its probabilities
  uint32_t pa[BK / 16][4];  // the probabilities in bf16, as A fragments
  Softmax sm;
  const int first_q = q0 + 64 * wg;  // the warpgroup's first query row

  for (int j = 0; j < n_kv; ++j) {
    const int s = j % STAGES;
    const uint32_t parity = (j / STAGES) & 1;
    // S = Q K_j^T; the K buffer goes back to the producer at once
    mbar_wait(&k_full[s], parity);
    wgmma_fence();
    issue_qk<HD>(sc, q_rows, smem + C::K_OFF + s * C::KV_TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    mbar_arrive(&k_empty[s]);
    sm.step(sc, j * BK + BK - 1 > first_q, j * BK + 2 * (lane % 4) - qpos);
    sm.rescale(o);
    to_bf16(pa, sc);
    // O += P V_j
    mbar_wait(&v_full[s], parity);
    wgmma_fence();
    issue_pv<HD>(o, pa, smem + C::V_OFF + s * C::KV_TILE);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
    mbar_arrive(&v_empty[s]);
  }

  // out = O / max(l, 1e-30), rounded once, written swizzled into the
  // warpgroup's own Q rows (every wgmma that read them is done), then
  // stored by TMA
  const float lm0 = fmaxf(sm.l0, 1e-30f), lm1 = fmaxf(sm.l1, 1e-30f);
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = 8 * n + 2 * (lane % 4);
    const int x = col / C::BOX, cb = (col % C::BOX) * 2;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = row + 8 * half;
      const int sw = C::SWZ == 128 ? ((cb >> 4) ^ (r & 7))
                                   : ((cb >> 4) ^ ((r >> 1) & 3));
      const float lm = half ? lm1 : lm0;
      *reinterpret_cast<uint32_t*>(q_rows + x * C::Q_BOX + r * C::SWZ +
                                   sw * 16 + (cb & 15)) =
          pack_bf16(o[4 * n + 2 * half] / lm, o[4 * n + 2 * half + 1] / lm);
    }
  }
  fence_proxy_async();
  named_barrier(1 + wg, 128);
  if (t == 0 && q0 + 64 * wg < T) {
    for (int x = 0; x < C::NBOX; ++x)
      tma_store_4d(&tm_o, q_rows + x * C::Q_BOX, x * C::BOX, h,
                   q0 + 64 * wg, b);
    tma_store_commit_and_wait();
  }
}

// HD: the padded head; hd: the true one, the maps' innermost dimension
template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T, int H, int KV, int hd, float scale, cudaStream_t stream) {
  using C = Cfg<HD>;
  // (hd, heads, T, B), innermost first
  const uint64_t row = (uint64_t)hd * 2;
  const uint64_t dq[4] = {(uint64_t)hd, (uint64_t)H, (uint64_t)T,
                          (uint64_t)B};
  const uint64_t sq[3] = {row, H * row, (uint64_t)T * H * row};
  const uint64_t dk[4] = {(uint64_t)hd, (uint64_t)KV, (uint64_t)T,
                          (uint64_t)B};
  const uint64_t sk[3] = {row, KV * row, (uint64_t)T * KV * row};
  const uint32_t box_q[4] = {C::BOX, 1, BQ, 1};
  const uint32_t box_kv[4] = {C::BOX, 1, C::BK, 1};
  const uint32_t box_out[4] = {C::BOX, 1, 64, 1};
  CUtensorMap mq, mk, mv, mo;
  int err;
  if ((err = make_map(&mq, q, 4, dq, sq, box_q, C::SWZ)) != 0) return err;
  if ((err = make_map(&mk, k, 4, dk, sk, box_kv, C::SWZ)) != 0) return err;
  if ((err = make_map(&mv, v, 4, dk, sk, box_kv, C::SWZ)) != 0) return err;
  if ((err = make_map(&mo, out, 4, dq, sq, box_out, C::SWZ)) != 0) return err;
  static bool sized = false;  // the shared-memory limit, set once
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attn_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::BYTES);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_attn_sm90<HD><<<grid, THREADS, C::BYTES, stream>>>(mq, mk, mv, mo, T,
                                                            H, KV, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- wide route
constexpr int WQ = 16;            // query rows a block
constexpr int WK = 64;            // keys a tile
constexpr int WC = 64;            // head columns a chunk
constexpr int W_THREADS = 256;    // 16 a row
constexpr int W_MAX_HD = 512;

// NC: head chunks of 64 columns (hd <= 64 NC)
template <int NC>
__global__ void __launch_bounds__(W_THREADS)
flash_attn_wide(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ out, int T,
                int H, int KV, int hd, float scale) {
  constexpr int HDP = NC * WC;
  extern __shared__ float wsm[];
  float* qs = wsm;                    // [WQ][HDP]: q * scale, bf16 values
  float* ks = qs + WQ * HDP;          // [WK][WC + 1]: a chunk of K or V
  float* ps = ks + WK * (WC + 1);     // [WQ][WK]: P rounded to bf16
  const int q0 = blockIdx.x * WQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x;
  const int r = tid / 16, c = tid % 16;  // the thread's row; its lane in it
  const int qpos = q0 + r;
  const size_t qrow = (size_t)H * hd, krow = (size_t)KV * hd;
  const bf16* qb = q + ((size_t)b * T) * qrow + (size_t)h * hd;
  const bf16* kb = k + ((size_t)b * T) * krow + (size_t)kvh * hd;
  const bf16* vb = v + ((size_t)b * T) * krow + (size_t)kvh * hd;

  for (int e = tid; e < WQ * HDP; e += W_THREADS) {
    const int rr = e / HDP, d = e % HDP;
    float x = 0.0f;
    if (q0 + rr < T && d < hd)
      x = __bfloat162float(__float2bfloat16(
          __bfloat162float(qb[(size_t)(q0 + rr) * qrow + d]) * scale));
    qs[e] = x;
  }

  float o[NC * 4];
#pragma unroll
  for (int i = 0; i < NC * 4; ++i) o[i] = 0.0f;
  float m = -1e30f, l = 0.0f;
  const int n_kv = (min(q0 + WQ, T) + WK - 1) / WK;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * WK;
    // S: the thread's keys are c + 16 i
    float s[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int ch = 0; ch < NC; ++ch) {
      __syncthreads();
      for (int e = tid; e < WK * WC; e += W_THREADS) {
        const int kk = e / WC, d = ch * WC + e % WC;
        ks[kk * (WC + 1) + e % WC] =
            (k0 + kk < T && d < hd)
                ? __bfloat162float(kb[(size_t)(k0 + kk) * krow + d])
                : 0.0f;
      }
      __syncthreads();
      const float* qr = qs + r * HDP + ch * WC;
#pragma unroll 8
      for (int d = 0; d < WC; ++d) {
        const float qv = qr[d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[i] = fmaf(qv, ks[(c + 16 * i) * (WC + 1) + d], s[i]);
      }
    }
    // the online softmax over the row's 16 lanes
    float mx = -1e30f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (k0 + c + 16 * i > qpos) s[i] = -1e30f;
      mx = fmaxf(mx, s[i]);
    }
#pragma unroll
    for (int w = 1; w < 16; w <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float mn = fmaxf(m, mx);
    const float corr = expf(m - mn);
    float sum = 0.0f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = expf(s[i] - mn);
      sum += p;
      ps[r * WK + c + 16 * i] = __bfloat162float(__float2bfloat16(p));
    }
#pragma unroll
    for (int w = 1; w < 16; w <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, w);
    l = l * corr + sum;
    m = mn;
#pragma unroll
    for (int i = 0; i < NC * 4; ++i) o[i] *= corr;
    // O += P V, chunk by chunk of V
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      __syncthreads();
      for (int e = tid; e < WK * WC; e += W_THREADS) {
        const int kk = e / WC, d = ch * WC + e % WC;
        ks[kk * (WC + 1) + e % WC] =
            (k0 + kk < T && d < hd)
                ? __bfloat162float(vb[(size_t)(k0 + kk) * krow + d])
                : 0.0f;
      }
      __syncthreads();
      const float* pr = ps + r * WK;
#pragma unroll 4
      for (int kk = 0; kk < WK; ++kk) {
        const float p = pr[kk];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          o[ch * 4 + i] = fmaf(p, ks[kk * (WC + 1) + c + 16 * i],
                               o[ch * 4 + i]);
      }
    }
  }
  if (qpos < T) {
    const float lm = fmaxf(l, 1e-30f);
    bf16* orow = out + ((size_t)b * T + qpos) * qrow + (size_t)h * hd;
#pragma unroll
    for (int ch = 0; ch < NC; ++ch)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = ch * WC + c + 16 * i;
        if (d < hd) orow[d] = __float2bfloat16(o[ch * 4 + i] / lm);
      }
  }
}

template <int NC>
int launch_wide(const void* q, const void* k, const void* v, void* out,
                int B, int T, int H, int KV, int hd, float scale,
                cudaStream_t stream) {
  constexpr int BYTES =
      (WQ * NC * WC + WK * (WC + 1) + WQ * WK) * (int)sizeof(float);
  static bool sized = false;  // the shared-memory limit, set once
  if (!sized) {
    cudaError_t e = cudaFuncSetAttribute(
        flash_attn_wide<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        BYTES);
    if (e != cudaSuccess) return (int)e;
    sized = true;
  }
  const dim3 grid((T + WQ - 1) / WQ, H, B);
  flash_attn_wide<NC><<<grid, W_THREADS, BYTES, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, T, H, KV,
      hd, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int B, int T, int H, int KV, int hd,
                               float scale, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return 0;
  if (KV <= 0 || H % KV != 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (padded_head(hd)) {
    case 32: return launch<32>(q, k, v, out, B, T, H, KV, hd, scale, s);
    case 64: return launch<64>(q, k, v, out, B, T, H, KV, hd, scale, s);
    case 128: return launch<128>(q, k, v, out, B, T, H, KV, hd, scale, s);
    case 192: return launch<192>(q, k, v, out, B, T, H, KV, hd, scale, s);
    default: break;
  }
  if (hd <= MAX_HD || hd > W_MAX_HD || hd % 8 != 0)
    return (int)cudaErrorInvalidValue;
  switch ((hd + WC - 1) / WC) {
    case 4: return launch_wide<4>(q, k, v, out, B, T, H, KV, hd, scale, s);
    case 5: return launch_wide<5>(q, k, v, out, B, T, H, KV, hd, scale, s);
    case 6: return launch_wide<6>(q, k, v, out, B, T, H, KV, hd, scale, s);
    case 7: return launch_wide<7>(q, k, v, out, B, T, H, KV, hd, scale, s);
    case 8: return launch_wide<8>(q, k, v, out, B, T, H, KV, hd, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
