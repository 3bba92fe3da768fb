// Causal flash attention (streaming softmax) for Hopper (sm_90a):
//   o[b, t, h] = softmax_s(q[b, t, h] . k[b, s, h/g] / sqrt(hd), s <= t)
//                . v[b, s, h/g]
// q (B, T, H, hd), k/v (B, T, KV, hd) bf16 with g = H / KV query heads per
// KV head (GQA); o (B, T, H, hd) bf16.
//
// Replaces the TPU kernel src/repro/kernels/flash_attn.py
// flash_attention_pallas: one grid step per (b, h, 128-row query tile),
// looping over the KV tiles up to the causal frontier with an online-softmax
// accumulator in VMEM; its wrapper repeats the KV heads for GQA.
//
// What bounds it on the card: operations.  The causal products are
// 4 * B * H * T^2 * hd / 2 flops (2.75e11 at qwen3's (2, 4096, 32, 128):
// 0.28 ms at 989 TFLOP/s) against ~0.15 GB of bytes (0.045 ms).  Design for
// that, kept simple: one 128-thread block per (query tile of 64 rows, h, b);
// both products on the tensor cores (WMMA bf16 16x16x16, fp32 sums, with
// padded shared tiles and 16-byte loads as in grouped_gemm.cuh); each warp
// owns 16 query rows, so the softmax and the rescale of its rows need only
// warp syncs, and the block syncs only around the shared K/V tile loads.
// The KV head is read as h / g in place of the wrapper's repeat: the same
// function, 8x fewer K/V bytes at qwen3's 32/4 heads.  Query tiles are
// issued from the last (the longest loop) to the first.
//
// The arithmetic follows the Pallas body where it changes bits: q is scaled
// in its own dtype before QK^T (the wrapper passes the scale rounded to
// bf16, as JAX rounds a Python float multiplying a bf16 array); masked
// scores are -1e30 and the running max starts at -1e30; the running sum adds
// the fp32 probabilities; the probabilities are rounded to v's dtype before
// PV; the output is acc / max(l, 1e-30), rounded once.  KV tiles are 64 keys
// wide here (128 in Pallas), which changes only the order of the fp32 sums.
//
// Rows past T (T < 64) load as zeros and are not stored; keys past T sit
// past every real query, so the causal mask removes them.  No row is ever
// fully masked: key 0 is in every query's first tile.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;        // query rows per block (16 per warp)
constexpr int BKV = 64;       // keys per KV tile
constexpr int THREADS = 128;
constexpr int LDS = BKV + 4;  // fp32 scores
constexpr int LDP = BKV + 8;  // bf16 probabilities

template <int HD>
struct Smem {
  static constexpr int LDQ = HD + 8;  // bf16 q / k / v rows (16-byte rows)
  static constexpr int LDO = HD + 4;  // fp32 accumulator rows
  static constexpr size_t q = 0;
  static constexpr size_t k = q + (size_t)BQ * LDQ * 2;
  static constexpr size_t v = k + (size_t)BKV * LDQ * 2;
  static constexpr size_t s = v + (size_t)BKV * LDQ * 2;
  static constexpr size_t p = s + (size_t)BQ * LDS * 4;
  static constexpr size_t o = p + (size_t)BQ * LDP * 2;
  static constexpr size_t bytes = o + (size_t)BQ * LDO * 4;
};

// rows [row0, row0 + 64) of one head of a (B, T, heads, HD) tensor into
// shared memory (ld LDQ), 16 bytes a thread; rows past T load as zeros.
// With SCALE each element is multiplied by `scale` and rounded to bf16.
template <int HD, bool SCALE>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int b,
                                          int row0, int T, int heads,
                                          int head, float scale) {
  constexpr int VEC = HD / 8;
  for (int e = threadIdx.x; e < 64 * VEC; e += THREADS) {
    const int r = e / VEC, c = (e % VEC) * 8;
    const int t = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) {
      val = *reinterpret_cast<const uint4*>(
          src + (((size_t)b * T + t) * heads + head) * HD + c);
      if (SCALE) {
        __nv_bfloat162* pv = reinterpret_cast<__nv_bfloat162*>(&val);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(pv[i]);
          pv[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * Smem<HD>::LDQ + c) = val;
  }
}

template <int HD>
__global__ void __launch_bounds__(THREADS)
flash_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int T,
                  int H, int KV, float scale) {
  using S = Smem<HD>;
  constexpr int LDQ = S::LDQ, LDO = S::LDO;
  constexpr int NF = HD / 16;  // 16-column fragments across hd
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + S::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + S::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + S::v);
  float* Ss = reinterpret_cast<float*>(smem + S::s);
  bf16* Ps = reinterpret_cast<bf16*>(smem + S::p);
  float* Os = reinterpret_cast<float*>(smem + S::o);

  const int qt = gridDim.x - 1 - blockIdx.x;  // longest loops first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int q0 = qt * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;        // the warp's first row in the tile
  const int rr = lane >> 1;        // the lane's row among the warp's 16
  const int half = lane & 1;       // which half of the row the lane takes
  const int qpos = q0 + r0 + rr;

  load_tile<HD, true>(Qs, q, b, q0, T, H, h, scale);
  for (int e = lane; e < 16 * LDO; e += 32) Os[r0 * LDO + e] = 0.0f;
  float m = -1e30f, l = 0.0f;  // the lane's row: running max and sum

  for (int j = 0; j <= qt; ++j) {
    const int k0 = j * BKV;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<HD, false>(Ks, k, b, k0, T, KV, kvh, 0.0f);
    load_tile<HD, false>(Vs, v, b, k0, T, KV, kvh, 0.0f);
    __syncthreads();

    // S = Q K^T for the warp's 16 rows: 4 fragments of 16 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BKV / 16];
#pragma unroll
      for (int n = 0; n < BKV / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
#pragma unroll
      for (int kk = 0; kk < HD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + r0 * LDQ + kk, LDQ);
#pragma unroll
        for (int n = 0; n < BKV / 16; ++n) {
          // K^T as a column-major B operand: element (kk, key) at
          // Ks[key * LDQ + kk]
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
              bt;
          wmma::load_matrix_sync(bt, Ks + n * 16 * LDQ + kk, LDQ);
          wmma::mma_sync(acc[n], a, bt, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < BKV / 16; ++n)
        wmma::store_matrix_sync(Ss + r0 * LDS + n * 16, acc[n], LDS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: each lane takes half of one row (32 keys)
    float* srow = Ss + (r0 + rr) * LDS + half * 32;
    float mx = -1e30f;
    for (int c = 0; c < 32; ++c) {
      float s = srow[c];
      if (k0 + half * 32 + c > qpos) s = -1e30f;
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float sum = 0.0f;
    bf16* prow = Ps + (r0 + rr) * LDP + half * 32;
    for (int c = 0; c < 32; ++c) {
      const float p = expf(srow[c] - m_new);
      sum += p;
      prow[c] = __float2bfloat16_rn(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * corr + sum;
    m = m_new;
    float* orow = Os + (r0 + rr) * LDO + half * (HD / 2);
    for (int c = 0; c < HD / 2; ++c) orow[c] *= corr;
    __syncwarp();

    // O = O * corr + P V for the warp's 16 rows
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
      for (int n = 0; n < NF; ++n)
        wmma::load_matrix_sync(acc[n], Os + r0 * LDO + n * 16, LDO,
                               wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::load_matrix_sync(a, Ps + r0 * LDP + kk, LDP);
#pragma unroll
        for (int n = 0; n < NF; ++n) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>
              bv;
          wmma::load_matrix_sync(bv, Vs + kk * LDQ + n * 16, LDQ);
          wmma::mma_sync(acc[n], a, bv, acc[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < NF; ++n)
        wmma::store_matrix_sync(Os + r0 * LDO + n * 16, acc[n], LDO,
                                wmma::mem_row_major);
    }
    __syncwarp();
  }

  // out = O / max(l, 1e-30), rounded to bf16 once; each lane half a row
  if (qpos < T) {
    const float inv_l = 1.0f / fmaxf(l, 1e-30f);
    const float* orow = Os + (r0 + rr) * LDO + half * (HD / 2);
    bf16* dst = out + (((size_t)b * T + qpos) * H + h) * HD + half * (HD / 2);
    for (int c = 0; c < HD / 2; c += 2) {
      *reinterpret_cast<__nv_bfloat162*>(dst + c) =
          __floats2bfloat162_rn(orow[c] * inv_l, orow[c + 1] * inv_l);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T, int H, int KV, float scale, cudaStream_t stream) {
  const size_t bytes = Smem<HD>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_attn_kernel<HD><<<grid, THREADS, bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, T, H, KV,
      scale);
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
  switch (hd) {
    case 32: return launch<32>(q, k, v, out, B, T, H, KV, scale, s);
    case 64: return launch<64>(q, k, v, out, B, T, H, KV, scale, s);
    case 128: return launch<128>(q, k, v, out, B, T, H, KV, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
