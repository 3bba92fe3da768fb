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
// What bounds it on the card: its fp32 operations.  At zamba2-2.7b's shapes
// (B 4, nc 32, Q 128, nh 80, hd 64, ds 64) the causal half of W x and the
// sB product are ~1.05 M fused multiply-adds a (chunk, head), 21 GFLOP in
// all with C B^T counted once a chunk: 0.33 ms at 67 TFLOP/s, against
// ~0.85 GB of bytes (0.25 ms at 3.35 TB/s).  Everything is fp32 on the CUDA
// cores, never TF32 (the reference is fp32).  Two routes, chosen on the
// host by shape (ops.ssd_route):
//
// The grouped kernel (ssd_chunk_grouped; instantiated for (Q, hd, ds) =
// (128, 64, 64) and (32, 32, 16), zamba2-2.7b's and its reduced config's)
// runs one 256-thread block for a chunk and a group of G consecutive heads
// (the host picks G <= 27 to fill the card's waves; ~226 KB of shared
// memory at (128, 64, 64), so one block an SM):
//  * the scores S = C B^T do not depend on the head: the block computes
//    their causal 8 x 8 tiles once, from C^T and B^T staged in shared
//    memory, and each thread keeps its units of them in registers for all
//    G heads; meanwhile warp 7 runs the G cumsums, one lane a head, in step
//    order j = 0..Q-1 (the order of torch's cumsum over a non-innermost
//    dimension on the card, so cs has the plain version's bits);
//  * a head's W^T lies in shared memory in 16-row strips (strip I holds
//    W[i][j] for i in [16 I, 16 I + 16) and j < 16 I + 16, j-major), built
//    a 16-byte unit (4 consecutive i, one j) at a time; a unit on or
//    below the diagonal with one exponential, exp(cs_i - cs_j) =
//    exp(cs_i0 - cs_j) exp(cs_i - cs_i0) for the unit's first i0, the
//    second factor a per-head table; the 3 Q / 4 units that straddle it,
//    one a thread of the first sB warps, with one an entry on or below it.
//    Exp only where i >= j (above the diagonal cs_i - cs_j grows with the
//    distance, exp overflows and inf * 0 would be NaN); the entries above
//    it are selected to 0.  Straight-line code, so a thread's units
//    overlap;
//  * warps 0-3 compute y = W x and warps 4-7 sB at once, 8 x 8 outputs a
//    lane from four 16-byte shared loads and 64 FMAs a step, the next
//    step's loads in flight; two lanes split each tile's sum over j in
//    halves and add them with shuffles in a fixed order.  y's warp w takes
//    strip w, then strip NT - 1 - w, so every warp walks the same number of
//    j.  sB scales x by exp(cs_{Q-1} - cs_j) dt_j in registers;
//  * the next head's x comes in by cp.async and its W^T is built into the
//    other buffer after the sums, one barrier a head; y and sB leave in
//    16-byte stores whose lanes cover whole rows.
//
// The general kernel (ssd_chunk) takes every other Q, hd, ds that are
// multiples of 4 and whose working set fits a block: one block per
// (chunk, head), W^T built in shared memory, 4 x 4 outputs a thread,
// the cumsum in one thread in the same step order.
//
// Both compute S, W x and sB in other orders than the plain version's
// matrix products: fp32 rounding, within the tolerance stated where the two
// are compared.  Each gives the same bits on every call.
//
// Plain C interface, built by nvcc into a shared library and called through
// ctypes; returns the cudaError_t of the launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int kMaxDevices = 64;
// heads a grouped block, at most warp 7's 32 lanes; at (128, 64, 64) their
// vectors fill what a block's 227 KB of shared memory leaves (ops.py's
// SSD_MAX_GROUP is the same number)
constexpr int kMaxGroup = 27;
constexpr size_t kMaxSmem = 227 * 1024;  // an H100 block's, opted in

// Let `kernel` take `smem` bytes of dynamic shared memory; `allowed`
// remembers per device what it has been raised to, so that a launch costs
// no extra host call after the first.
cudaError_t allow_shared_memory(const void* kernel, size_t smem,
                                size_t (&allowed)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev] >= smem) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev] = smem;
  return err;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// wait for all but the last group of this thread's copies
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ---------------------------------------------------------------- grouped

template <int Q, int HD, int DS>
struct Grouped {
  static_assert(Q % 32 == 0 && HD % 8 == 0 && DS % 8 == 0, "tile sizes");
  static constexpr int NT = Q / 16;                    // 16-row strips
  static constexpr int TRI = 256 * NT * (NT + 1) / 2;  // floats, all strips
  static constexpr int UNITS = TRI / 4;                // float4s of a W^T
  // a thread's units of S^T, kept in registers: the first 128 threads (y)
  // own KY rounds of 128 units, the other 128 (sB) the KS rounds after them
  static constexpr int KY = UNITS / 2 / 128;
  static constexpr int KS = (UNITS - 128 * KY + 127) / 128;
  static constexpr int UPT = KY > KS ? KY : KS;
  static constexpr bool WHOLE = 128 * (KY + KS) == UNITS;  // no unit left over
  // the units that straddle the diagonal: one each for the first NDIAG sB
  // threads, which keep it in registers too
  static constexpr int NDIAG = 3 * Q / 4;
  static_assert(NDIAG <= THREADS / 2, "a straddling unit a sB thread");
  static constexpr int QP = Q + 4;                     // per-head vectors
  static constexpr int DSP = DS + 4;                   // rows of B, C
  static constexpr int NQ8 = Q / 8;
  static constexpr int S_JOBS = NQ8 * (NQ8 + 1) / 2;   // causal 8 x 8 tiles
  // y: a warp (or half of one) per pair of strips, two lanes (the two
  // halves of the sum over j) per 8 x 8 tile of a strip
  static constexpr int Y_LANES = HD / 2;               // lanes a pair
  static constexpr int Y_THREADS = (Q / 32) * Y_LANES;
  static constexpr int Y_XOR = HD / 4;                 // the other half
  // sB: two lanes per 8 x 8 tile (p, n), likewise
  static constexpr int SB_JOBS = (HD / 8) * (DS / 8);
  static constexpr int SB_THREADS = 2 * SB_JOBS;
  static constexpr int SB_XOR = SB_JOBS < 16 ? SB_JOBS : 16;
  static_assert((Y_XOR & (Y_XOR - 1)) == 0 && (SB_XOR & (SB_XOR - 1)) == 0 &&
                    SB_JOBS % SB_XOR == 0 && Y_LANES <= 32,
                "a tile's two lanes share a warp");
  static_assert(S_JOBS <= THREADS - 32, "warp 7 runs the cumsums");
  static_assert(Y_THREADS <= THREADS / 2 && SB_THREADS <= THREADS / 2,
                "y and sB each take half the block");
  // shared memory, in floats: two W^T buffers, two x buffers, B (rows
  // padded to DSP), then cs (at first loga), dt, the sB coefficients and
  // the decays within 4 steps of each of the G heads
  static constexpr int OFF_W0 = 0;
  static constexpr int OFF_X1 = TRI;
  static constexpr int OFF_W1 = TRI + Q * HD;
  static constexpr int OFF_X0 = 2 * TRI + Q * HD;
  static constexpr int OFF_BS = 2 * TRI + 2 * Q * HD;
  static constexpr int OFF_VEC = OFF_BS + Q * DSP;
  // before the first head: C^T and B^T over W0 and x1, C (rows padded) and
  // then S^T over W1
  static_assert(2 * DS * Q <= TRI + Q * HD && Q * DSP <= TRI,
                "the first phase's arrays fit where the heads' go");
  static constexpr size_t smem_bytes(int G) {
    return sizeof(float) * ((size_t)OFF_VEC + 4 * (size_t)G * QP);
  }
};

__host__ __device__ constexpr int strip_off(int I) {
  return 128 * I * (I + 1);  // floats before strip I: 16 x (16 I' + 16)
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// x of head h into shared memory, one 16-byte copy per unit
template <int Q, int HD>
__device__ __forceinline__ void issue_x(float* dst, const float* xh, int bc,
                                        int h, int nh) {
  for (int u = threadIdx.x; u < Q * HD / 4; u += THREADS) {
    const int j = u / (HD / 4), c = u % (HD / 4);
    cp_async16(dst + 4 * u, xh + (((size_t)bc * Q + j) * nh + h) * HD + 4 * c);
  }
}

// Unit u of W^T (4 consecutive i of row j of a strip) from the same unit s
// of S^T and the head's cs, dt and al_i = exp(cs_i - cs_{i & ~3}), where
// the unit lies wholly on or below the diagonal (j <= i0) or wholly above
// it.  On or below, one exponential: exp(cs_i - cs_j) = exp(cs_i0 - cs_j)
// al_i for i0 <= i < i0 + 4, two decays (each at most 1 where loga <= 0).
// Exp only where i >= j: above the diagonal cs_i - cs_j grows with the
// distance, exp overflows and inf * 0 would be NaN, so a unit above it
// takes exponent 0 and is selected to 0.  A unit that straddles it
// (i0 < j <= i0 + 3: cs_i0 - cs_j is such a growth) is build_diag's, and
// left unwritten here
__device__ __forceinline__ void build_unit(float* Wt, int u, int j, int i0,
                                           float4 s, const float* cs,
                                           const float* dts,
                                           const float* al) {
  const float4 a = *reinterpret_cast<const float4*>(al + i0);
  const bool below = i0 >= j;
  const float e = expf(below ? cs[i0] - cs[j] : 0.0f) * dts[j];
  float4 w;
  w.x = below ? e * a.x * s.x : 0.0f;
  w.y = below ? e * a.y * s.y : 0.0f;
  w.z = below ? e * a.z * s.z : 0.0f;
  w.w = below ? e * a.w * s.w : 0.0f;
  if (below || i0 + 3 < j) reinterpret_cast<float4*>(Wt)[u] = w;
}

// The k-th of the 3 Q / 4 units that straddle the diagonal: in strip
// I = k / 12, i0 = 16 I + 4 ((k % 12) / 3) and j = i0 + 1 + k % 3
__device__ __forceinline__ int diag_unit(int k, int& i0, int& j) {
  const int I = k / 12, r = k % 12;
  i0 = 16 * I + 4 * (r / 3);
  j = i0 + 1 + r % 3;
  return 32 * I * (I + 1) + 4 * j + r / 3;
}

// ... built from its unit s of S^T with an exponential an entry on or
// below the diagonal, as the plain version; 0 above it
__device__ __forceinline__ void build_diag(float* Wt, int k, float4 s,
                                           const float* cs,
                                           const float* dts) {
  int i0, j;
  const int u = diag_unit(k, i0, j);
  const float dj = dts[j];
  const bool p1 = i0 + 1 >= j, p2 = i0 + 2 >= j;
  const float e1 = expf(p1 ? cs[i0 + 1] - cs[j] : 0.0f);
  const float e2 = expf(p2 ? cs[i0 + 2] - cs[j] : 0.0f);
  const float e3 = expf(cs[i0 + 3] - cs[j]);
  reinterpret_cast<float4*>(Wt)[u] =
      make_float4(0.0f, p1 ? e1 * dj * s.y : 0.0f, p2 ? e2 * dj * s.z : 0.0f,
                  e3 * dj * s.w);
}

// The thread's first unit; its m-th is 128 m further
template <class L>
__device__ __forceinline__ int first_unit() {
  const int t = threadIdx.x;
  return t < THREADS / 2 ? t : 128 * L::KY + t - THREADS / 2;
}

// W^T of one head from the thread's ROUNDS units of S^T, at rows j and
// columns i0 packed as pos = j + 256 i0; straight-line code, so that the
// units' loads and exponentials overlap
template <class L, int ROUNDS>
__device__ __forceinline__ void build_w(float* Wt,
                                        const float4 (&sreg)[L::UPT],
                                        const int (&pos)[L::UPT],
                                        const float* cs, const float* dts,
                                        const float* al) {
  const int u0 = first_unit<L>();
#pragma unroll
  for (int m = 0; m < ROUNDS; ++m)
    if (L::WHOLE || u0 + 128 * m < L::UNITS)
      build_unit(Wt, u0 + 128 * m, pos[m] & 255, pos[m] >> 8, sreg[m], cs,
                 dts, al);
}

// ... by whichever threads own units: the y threads KY, the sB threads KS
template <class L>
__device__ __forceinline__ void build_w(float* Wt,
                                        const float4 (&sreg)[L::UPT],
                                        const int (&pos)[L::UPT],
                                        const float* cs, const float* dts,
                                        const float* al) {
  if (threadIdx.x < THREADS / 2)
    build_w<L, L::KY>(Wt, sreg, pos, cs, dts, al);
  else
    build_w<L, L::KS>(Wt, sreg, pos, cs, dts, al);
}

__device__ __forceinline__ float4 scale(float4 v, float c) {
  return make_float4(v.x * c, v.y * c, v.z * c, v.w * c);
}

// acc[a][c] += r[a] * q[c] over an 8 x 8 tile
__device__ __forceinline__ void fma8x8(float (&acc)[8][8], float4 ra, float4 rb,
                                       float4 qa, float4 qb) {
  const float r[8] = {ra.x, ra.y, ra.z, ra.w, rb.x, rb.y, rb.z, rb.w};
  const float q[8] = {qa.x, qa.y, qa.z, qa.w, qb.x, qb.y, qb.z, qb.w};
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[a][c] = fmaf(r[a], q[c], acc[a][c]);
}

// The two lanes of a tile hold partial sums of its 8 x 8 outputs, each with
// its own 4 rows first: each adds the other's copy of those 4 rows (a fixed
// order: the same bits on every run) and keeps them in acc[0..3]
__device__ __forceinline__ void reduce_halves(float (&acc)[8][8],
                                              unsigned mask, int lane_xor) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      acc[m][c] += __shfl_xor_sync(mask, acc[4 + m][c], lane_xor);
}

template <int Q, int HD, int DS>
__global__ void __launch_bounds__(THREADS, 1)
ssd_grouped_kernel(const float* __restrict__ xh, const float* __restrict__ dt,
                   const float* __restrict__ loga,
                   const float* __restrict__ Bc, const float* __restrict__ Cc,
                   float* __restrict__ y, float* __restrict__ sB,
                   float* __restrict__ a_chunk, int nh, int G, int ngroups) {
  using L = Grouped<Q, HD, DS>;
  constexpr int NT = L::NT, QP = L::QP, DSP = L::DSP;
  extern __shared__ __align__(16) float smem[];
  // head g's W^T and x: W0 and x0 for even g, W1 and x1 for odd
  auto Wbuf = [&](int g) { return smem + (g & 1 ? L::OFF_W1 : L::OFF_W0); };
  auto Xbuf = [&](int g) { return smem + (g & 1 ? L::OFF_X1 : L::OFF_X0); };
  float* Bs = smem + L::OFF_BS;              // (Q, DSP): B
  float* csv = smem + L::OFF_VEC;            // (G, QP): loga, then cs
  float* dtv = csv + G * QP;                 // (G, QP): dt
  float* cfv = dtv + G * QP;                 // (G, QP): exp(cs_last - cs) dt
  float* alv = cfv + G * QP;                 // (G, QP): exp(cs_i - cs_{i & ~3})
  float* Ct = smem + L::OFF_W0;              // (DS, Q), first phase only
  float* Bt = Ct + DS * Q;                   // (DS, Q), first phase only
  float* Cs = smem + L::OFF_W1;              // (Q, DSP), first phase only
  float* St = smem + L::OFF_W1;              // S^T strips, first phase only

  const int tid = threadIdx.x;
  const int bc = blockIdx.x / ngroups;
  const int h0 = (blockIdx.x % ngroups) * G;
  const int Gv = min(G, nh - h0);            // heads of this block

  // every load of the first phase in flight at once: B and C (rows
  // padded), loga and dt of the group's heads (transposed), then x of the
  // first head, which is waited for only after the scores
  const float* Bg = Bc + (size_t)bc * Q * DS;
  const float* Cg = Cc + (size_t)bc * Q * DS;
  for (int u = tid; u < Q * DS / 4; u += THREADS) {
    const int i = u / (DS / 4), n = 4 * (u % (DS / 4));
    cp_async16(Bs + i * DSP + n, Bg + 4 * u);
    cp_async16(Cs + i * DSP + n, Cg + 4 * u);
  }
  for (int u = tid; u < Q * Gv; u += THREADS) {
    const int i = u / Gv, g = u % Gv;
    const size_t at = ((size_t)bc * Q + i) * nh + h0 + g;
    cp_async4(csv + g * QP + i, loga + at);
    cp_async4(dtv + g * QP + i, dt + at);
  }
  cp_async_commit();
  issue_x<Q, HD>(Xbuf(0), xh, bc, h0, nh);
  cp_async_commit();
  cp_async_wait_prior();  // all but x
  __syncthreads();
  for (int u = tid; u < Q * DS / 4; u += THREADS) {
    const int i = u % Q, n = 4 * (u / Q);
    const float4 c = *reinterpret_cast<const float4*>(Cs + i * DSP + n);
    const float4 b = *reinterpret_cast<const float4*>(Bs + i * DSP + n);
    Ct[(n + 0) * Q + i] = c.x; Ct[(n + 1) * Q + i] = c.y;
    Ct[(n + 2) * Q + i] = c.z; Ct[(n + 3) * Q + i] = c.w;
    Bt[(n + 0) * Q + i] = b.x; Bt[(n + 1) * Q + i] = b.y;
    Bt[(n + 2) * Q + i] = b.z; Bt[(n + 3) * Q + i] = b.w;
  }
  __syncthreads();

  if (tid < L::S_JOBS) {
    // S^T tile (I8, J8): S[i][j] for i in [8 I8, +8), j in [8 J8, +8)
    int I8 = 0;
    while ((I8 + 1) * (I8 + 2) / 2 <= tid) ++I8;
    const int J8 = tid - I8 * (I8 + 1) / 2;
    float acc[8][8] = {};
#pragma unroll 4
    for (int n = 0; n < DS; ++n) {
      const float4* c4 = reinterpret_cast<const float4*>(Ct + n * Q + 8 * I8);
      const float4* b4 = reinterpret_cast<const float4*>(Bt + n * Q + 8 * J8);
      fma8x8(acc, c4[0], c4[1], b4[0], b4[1]);
    }
    float* strip = St + strip_off(I8 / 2) + 8 * (I8 & 1);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float* dst = strip + (8 * J8 + c) * 16;
      *reinterpret_cast<float4*>(dst) =
          make_float4(acc[0][c], acc[1][c], acc[2][c], acc[3][c]);
      *reinterpret_cast<float4*>(dst + 4) =
          make_float4(acc[4][c], acc[5][c], acc[6][c], acc[7][c]);
    }
  } else if (tid >= THREADS - 32 && tid - (THREADS - 32) < Gv) {
    // the cumsum of head g in step order
    const int g = tid - (THREADS - 32);
    float* cs = csv + g * QP;
    float run = 0.0f;
    for (int i = 0; i < Q; i += 4) {
      float4 v = *reinterpret_cast<float4*>(cs + i);
      run += v.x; v.x = run;
      run += v.y; v.y = run;
      run += v.z; v.z = run;
      run += v.w; v.w = run;
      *reinterpret_cast<float4*>(cs + i) = v;
    }
    a_chunk[(size_t)bc * nh + h0 + g] = expf(run);
  }
  __syncthreads();
  // each head's sB coefficients, and the decays within a group of 4 steps
  for (int e = tid; e < Gv * Q; e += THREADS) {
    const float* cs = csv + (e / Q) * QP;
    const int at = (e / Q) * QP + e % Q, i = e % Q;
    cfv[at] = expf(cs[Q - 1] - cs[i]) * dtv[at];
    alv[at] = expf(cs[i] - cs[i & ~3]);
  }
  cp_async_wait_all();    // x of the first head
  __syncthreads();

  // the thread's units of S^T, and where they lie, stay in registers for
  // every head
  float4 sreg[L::UPT];
  int pos[L::UPT];
  {
    const int u0 = first_unit<L>();
    const int rounds = tid < THREADS / 2 ? L::KY : L::KS;
    int I = 0;
#pragma unroll
    for (int m = 0; m < L::UPT; ++m) {
      const int u = u0 + 128 * m;
      sreg[m] = make_float4(0.f, 0.f, 0.f, 0.f);
      pos[m] = -1;
      if (m < rounds && u < L::UNITS) {
        sreg[m] = reinterpret_cast<const float4*>(St)[u];
        while (u >= 32 * (I + 1) * (I + 2)) ++I;
        const int rem = u - 32 * I * (I + 1);
        pos[m] = (rem >> 2) + 256 * (16 * I + 4 * (rem & 3));
      }
    }
  }
  const int dk = tid - THREADS / 2;          // the straddling unit, if any
  const bool diag = dk >= 0 && dk < L::NDIAG;
  float4 sdiag = make_float4(0.f, 0.f, 0.f, 0.f);
  if (diag) {
    int i0, j;
    sdiag = reinterpret_cast<const float4*>(St)[diag_unit(dk, i0, j)];
  }
  build_w<L>(Wbuf(0), sreg, pos, csv, dtv, alv);
  if (diag) build_diag(Wbuf(0), dk, sdiag, csv, dtv);
  __syncthreads();

  // head g: x of head g + 1 comes in, y and sB of head g are computed, then
  // W^T of head g + 1 is built (the sB warps, whose sums end first, own as
  // many units as the y warps); one barrier a head
  for (int g = 0; g < Gv; ++g) {
    const int h = h0 + g;
    const float* Wt = Wbuf(g);
    const float* X = Xbuf(g);
    if (g + 1 < Gv) {
      issue_x<Q, HD>(Xbuf(g + 1), xh, bc, h + 1, nh);
      cp_async_commit();
    }

    if (tid < L::Y_THREADS) {
      // y: in pair w, lane (ks, half, cg) sums the ks-th half of j for
      // rows 16 S + 8 half + [0, 8), columns 8 cg + [0, 8) of strip S = w,
      // then of S = NT - 1 - w; each lane loads its own 4 rows first
      constexpr unsigned mask = L::Y_THREADS >= 32
                                    ? 0xffffffffu
                                    : (1u << L::Y_THREADS) - 1u;
      const int pair = tid / L::Y_LANES, pl = tid % L::Y_LANES;
      const int ks = pl / L::Y_XOR, r = pl % L::Y_XOR;
      const int half = r / (HD / 8), cg = r % (HD / 8);
#pragma unroll 1
      for (int t = 0; t < 2; ++t) {
        const int S = t == 0 ? pair : NT - 1 - pair;
        const int nj = 8 * (S + 1), j0 = ks * nj;
        const float4* w4 = reinterpret_cast<const float4*>(Wt + strip_off(S));
        const float4* x4 = reinterpret_cast<const float4*>(X) + 2 * cg;
        const int wa = 2 * half + ks, wb = 2 * half + 1 - ks;
        float acc[8][8] = {};
        // the next step's operands load while this step's FMAs run
        float4 ra = w4[4 * j0 + wa], rb = w4[4 * j0 + wb];
        float4 qa = x4[j0 * (HD / 4)], qb = x4[j0 * (HD / 4) + 1];
#pragma unroll 2
        for (int j = j0 + 1; j < j0 + nj; ++j) {
          const float4 na = w4[4 * j + wa], nb = w4[4 * j + wb];
          const float4 nqa = x4[j * (HD / 4)], nqb = x4[j * (HD / 4) + 1];
          fma8x8(acc, ra, rb, qa, qb);
          ra = na; rb = nb; qa = nqa; qb = nqb;
        }
        fma8x8(acc, ra, rb, qa, qb);
        reduce_halves(acc, mask, L::Y_XOR);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          float* dst = y + (((size_t)bc * Q + 16 * S + 8 * half + 4 * ks + m) *
                                nh + h) * HD + 8 * cg;
          *reinterpret_cast<float4*>(dst) =
              make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
          *reinterpret_cast<float4*>(dst + 4) =
              make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
        }
      }
    } else if (tid >= 128 && tid - 128 < L::SB_THREADS) {
      // sB: lane (ks, pg, ng) sums the ks-th half of j for p in 8 pg +
      // [0, 8), n in 8 ng + [0, 8), x scaled by exp(cs_last - cs_j) dt_j
      constexpr unsigned mask = L::SB_THREADS >= 32
                                    ? 0xffffffffu
                                    : (1u << L::SB_THREADS) - 1u;
      const int s = tid - 128;
      const int ks = (s / L::SB_XOR) & 1;
      const int job = s % L::SB_XOR + (s / (2 * L::SB_XOR)) * L::SB_XOR;
      const int pg = job / (DS / 8), ng = job % (DS / 8);
      const float4* x4 = reinterpret_cast<const float4*>(X) + 2 * pg;
      const float4* b4 = reinterpret_cast<const float4*>(Bs) + 2 * ng;
      const float* cf = cfv + g * QP;
      const int j0 = ks * (Q / 2);
      float acc[8][8] = {};
      // the next step's operands load while this step's FMAs run
      float c = cf[j0];
      float4 xa = x4[j0 * (HD / 4) + ks], xb = x4[j0 * (HD / 4) + 1 - ks];
      float4 ba = b4[j0 * (DSP / 4)], bb = b4[j0 * (DSP / 4) + 1];
#pragma unroll 2
      for (int j = j0 + 1; j < j0 + Q / 2; ++j) {
        const float nc = cf[j];
        const float4 nxa = x4[j * (HD / 4) + ks];
        const float4 nxb = x4[j * (HD / 4) + 1 - ks];
        const float4 nba = b4[j * (DSP / 4)], nbb = b4[j * (DSP / 4) + 1];
        fma8x8(acc, scale(xa, c), scale(xb, c), ba, bb);
        c = nc; xa = nxa; xb = nxb; ba = nba; bb = nbb;
      }
      fma8x8(acc, scale(xa, c), scale(xb, c), ba, bb);
      reduce_halves(acc, mask, L::SB_XOR);
      float* dst = sB + (((size_t)bc * nh + h) * HD + 8 * pg + 4 * ks) * DS +
                   8 * ng;
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        *reinterpret_cast<float4*>(dst + (size_t)m * DS) =
            make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
        *reinterpret_cast<float4*>(dst + (size_t)m * DS + 4) =
            make_float4(acc[m][4], acc[m][5], acc[m][6], acc[m][7]);
      }
    }
    if (g + 1 < Gv) {
      build_w<L>(Wbuf(g + 1), sreg, pos, csv + (g + 1) * QP,
                 dtv + (g + 1) * QP, alv + (g + 1) * QP);
      if (diag)
        build_diag(Wbuf(g + 1), dk, sdiag, csv + (g + 1) * QP,
                   dtv + (g + 1) * QP);
    }
    cp_async_wait_all();     // x of head g + 1, for every thread after ...
    __syncthreads();         // ... this barrier, which also ends head g
  }
}

template <int Q, int HD, int DS>
int launch_grouped(const void* xh, const void* dt, const void* loga,
                   const void* Bc, const void* Cc, void* y, void* sB,
                   void* a_chunk, int BC, int nh, int G, cudaStream_t stream) {
  static_assert(kMaxGroup <= 32 &&
                    Grouped<Q, HD, DS>::smem_bytes(kMaxGroup) <= kMaxSmem,
                "a block of kMaxGroup heads fits");
  static size_t allowed[kMaxDevices] = {};
  const size_t bytes = Grouped<Q, HD, DS>::smem_bytes(G);
  cudaError_t err = allow_shared_memory(
      (const void*)ssd_grouped_kernel<Q, HD, DS>, bytes, allowed);
  if (err != cudaSuccess) return (int)err;
  const int ngroups = (nh + G - 1) / G;
  if ((long long)BC * ngroups > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  ssd_grouped_kernel<Q, HD, DS><<<BC * ngroups, THREADS, bytes, stream>>>(
      (const float*)xh, (const float*)dt, (const float*)loga,
      (const float*)Bc, (const float*)Cc, (float*)y, (float*)sB,
      (float*)a_chunk, nh, G, ngroups);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- general

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
ssd_general_kernel(const float* __restrict__ xh, const float* __restrict__ dt,
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

// The general route: one block per (chunk, head).
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
  static size_t allowed[kMaxDevices] = {};
  cudaError_t err = allow_shared_memory((const void*)ssd_general_kernel,
                                        bytes, allowed);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(BC, nh);
  ssd_general_kernel<<<grid, THREADS, bytes, (cudaStream_t)stream>>>(
      (const float*)xh, (const float*)dt, (const float*)loga,
      (const float*)Bc, (const float*)Cc, (float*)y, (float*)sB,
      (float*)a_chunk, d);
  return (int)cudaGetLastError();
}

// The grouped route: one block per (chunk, group of G consecutive heads),
// for the (Q, hd, ds) it is instantiated at; anything else is refused.
extern "C" int ssd_chunk_grouped(const void* xh, const void* dt,
                                 const void* loga, const void* Bc,
                                 const void* Cc, void* y, void* sB,
                                 void* a_chunk, int BC, int Q, int nh, int hd,
                                 int ds, int G, void* stream) {
  if (BC < 0 || nh < 0 || G < 1 || G > kMaxGroup)
    return (int)cudaErrorInvalidValue;
  if (BC == 0 || nh == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (Q == 128 && hd == 64 && ds == 64)
    return launch_grouped<128, 64, 64>(xh, dt, loga, Bc, Cc, y, sB, a_chunk,
                                       BC, nh, G, s);
  if (Q == 32 && hd == 32 && ds == 16)
    return launch_grouped<32, 32, 16>(xh, dt, loga, Bc, Cc, y, sB, a_chunk,
                                      BC, nh, G, s);
  return (int)cudaErrorInvalidValue;
}

// The grouped route's dynamic shared memory a block, in bytes (0 where it
// is not instantiated).
extern "C" int ssd_chunk_grouped_smem(int Q, int hd, int ds, int G) {
  if (Q == 128 && hd == 64 && ds == 64)
    return (int)Grouped<128, 64, 64>::smem_bytes(G);
  if (Q == 32 && hd == 32 && ds == 16)
    return (int)Grouped<32, 32, 16>::smem_bytes(G);
  return 0;
}
