// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas kernels of dlrover_tpu/ops/flash_attention.py:
//   flash_fwd_kernel     <- _fwd_kernel      (:129-183, launched by _flash_fwd)
//   flash_bwd_dq_kernel  <- _bwd_dq_kernel   (:249-290, launched by _flash_bwd)
//   flash_bwd_dkv_kernel <- _bwd_dkv_kernel  (:293-341, launched by _flash_bwd)
//
// Semantics kept from the reference: scores in the exp2 domain
// (s * scale * log2e), fp32 running max / sum / accumulators, the finite
// NEG_INF = -1e30 sentinel, top-left causal mask q_idx >= k_idx, GQA kv
// head h / group, the saved LSE in natural-log units (m + log2 l) * ln2
// with the l == 0 -> 1 guard, and the same bf16 rounding points: P is
// rounded to bf16 before P.V and P^T.dO, dS before dS.K and dS^T.Q.
//
// What bounds them on the H100: at the Llama-1B slice shape (b=4, h=16,
// s=2048, d=128, causal) the forward does 4*b*h*d*pairs ~ 6.9e10 FLOP
// against ~67 MB of q/k/v/o traffic, about 1000 FLOP per byte, far above
// the card's ~295 FLOP/byte ridge; dQ (3 products) and dK/dV (4 products)
// are further above it. All three are bound by tensor-core operations.
//
// All three: wgmma, TMA and warp specialisation (sm90.cuh holds the
// PTX). A block is three warpgroups: warpgroup 0 is the producer, one
// thread of which issues every TMA load into an mbarrier ring and which
// then keeps 24 registers (setmaxnreg); warpgroups 1 and 2 are consumers
// at 240 registers, each owning 64 rows of the block's 128-row tile.
// - forward: one block per (128-row q tile, head, batch). Q is loaded
//   once; K and V stream in 128-row tiles through a 2-stage ring with
//   separate full / empty barriers for K and V, so S = Q.K^T starts as
//   soon as K lands. S = Q.K^T is wgmma m64n128k16 with both operands
//   K-major from shared memory; the online softmax runs on the accumulator
//   fragments (a row's four owners are one quad of lanes); P, rounded to
//   bf16 in registers, is the A operand of O += P.V (V MN-major). O is
//   staged as bf16 through its Q rows and written by TMA, which clips
//   rows past s_q.
// - dQ: one block per (128-row q tile, head, batch). Q and dO are loaded
//   once; K and V stream in 128-row tiles through a 2-stage ring with
//   separate full / empty barriers; each thread reads the lse and delta of
//   its two rows with plain loads. S = Q.K^T and dP = dO.V^T (m64n128k16,
//   K-major) in one commit group, P and dS on the fragments, then
//   dQ += dS.K with dS, rounded to bf16, as the register A operand and K
//   read MN-major from the same stage. S, dP and dQ hold 192 f32
//   registers at d = 128 and ptxas spills none under 240; 64-row kv tiles
//   (3 stages) ran 10% slower on an H100, and the ring's depth (2-4
//   stages) changed nothing. V's stage is released after dP, K's after
//   dS.K. Rows past s_q read zero Q and dO, so their dS is 0. dQ is
//   staged as bf16 through its Q rows and written by TMA.
// - dK/dV: one block per (128-row kv tile, kv head, batch), transposed so
//   that kv rows are the wgmma M dimension. K and V stay resident; 64-row
//   tiles of Q and dO with their 64 lse and delta values stream through a
//   2-stage ring, over every query head of the GQA group and every q tile
//   at or below the diagonal (a producer warp copies lse and delta, whose
//   rows start at any offset). S^T = K.Q^T and dP^T = V.dO^T (m64n64k16,
//   K-major), P^T and dS^T on the fragments with lse and delta per column,
//   then dV += P^T.dO and dK += dS^T.Q with P^T and dS^T as register A
//   operands and dO, Q MN-major. dK and dV stay in f32 registers for the
//   whole group: no atomics, no per-query-head partials. Kv tiles past the
//   last query (causal, s_k > s_q) run no q tile and store zeros.
// No kernel uses atomics: each block owns its output rows and sums its
// tiles in a fixed order, so every output is the same bits on every call.
// Every tile is 128-byte swizzled by TMA over 3-D tensor maps (d, rows,
// batch * heads), so a tile never reads into the next head and rows past
// the sequence read as zero. Masks cost only tiles that straddle the
// diagonal or a ragged edge; causal q tiles (forward, dQ) and kv tiles
// (dK/dV) are launched heaviest first. Not yet used: persistent blocks,
// ping-pong between the consumer warpgroups, softmax overlapped with the
// next product, clusters.
//
// Layout: q (b, h, s_q, d), k/v (b, h_kv, s_k, d), contiguous bf16;
// lse and delta (b, h, s_q) f32. d is 64 or 128. Each entry point
// launches on the given stream, never synchronises, allocates nothing and
// returns cudaGetLastError() (or the error of encoding a tensor map).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

// Two f32 values rounded to a bf16 pair; `lo` takes the low half (the
// lower column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ===========================================================================
// Warp-specialised wgmma kernels
// ===========================================================================

constexpr int WS_THREADS = 384;   // producer warpgroup + 2 consumer warpgroups
constexpr int CONSUMERS = 256;    // threads of the consumer warpgroups
constexpr int ROW_BYTES = 128;    // a swizzled row: 64 bf16
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Byte offset of bf16 element (r, c) of a 128B-swizzled tile of 64-column
// sub-tiles, each `sub` bytes; c is even, and the 4 bytes at the offset
// hold columns c and c + 1.
__device__ __forceinline__ int swz(int r, int c, int sub) {
  return (c / 64) * sub + r * ROW_BYTES + ((((c % 64) / 8) ^ (r & 7)) << 4) + (c % 8) * 2;
}

// A thread's part of a warpgroup's m64nD f32 accumulator (its rows `row`
// and row + 8) as bf16 into those rows of a swizzled shared tile.
template <int N>
__device__ __forceinline__ void stage_rows(const float (&acc)[N], unsigned char* tile, int sub,
                                           int row, int t) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half)
      *reinterpret_cast<uint32_t*>(tile + swz(row + 8 * half, 8 * i + 2 * t, sub)) =
          pack_bf16(acc[4 * i + 2 * half], acc[4 * i + 2 * half + 1]);
}

// The A fragments of a k-step j (16 columns, chunks 2j and 2j + 1) from
// an f32 accumulator, rounded to bf16.
template <int N>
__device__ __forceinline__ void pack_a(const float (&acc)[N], uint32_t (&a)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) a[i] = pack_bf16(acc[2 * i], acc[2 * i + 1]);
}

// ---------------------------------------------------------------------------
// Forward: one block per (128-row q tile, head, batch)
// ---------------------------------------------------------------------------

template <int D> struct FwdSmem {
  static constexpr int SUB = 128 * ROW_BYTES;  // 64 columns of a 128-row tile
  static constexpr int TILE = D / 64 * SUB;    // a 128 x D tile
  static constexpr int Q = 0, K = TILE, V = 3 * TILE;  // K, V: 2 stages each
  static constexpr int BARS = 5 * TILE;
  static constexpr int BYTES = BARS + 128 + 1024;  // barriers, alignment slack
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_o, float* __restrict__ lse, int h,
                 int h_kv, int s_q, int s_k, float scale_log2, int causal) {
  using L = FwdSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* k_full = q_full + 1;   // [2]
  uint64_t* v_full = q_full + 3;   // [2]
  uint64_t* k_empty = q_full + 5;  // [2]
  uint64_t* v_empty = q_full + 7;  // [2]

  const int n_q_tiles = cdiv(s_q, 128);
  const int q0 = (n_q_tiles - 1 - (int)blockIdx.z) * 128;  // longest causal rows first
  const int hh = blockIdx.x, bb = blockIdx.y;
  const int qh = bb * h + hh, kvh = bb * h_kv + hh / (h / h_kv);
  int n_k_tiles = cdiv(s_k, 128);
  if (causal) n_k_tiles = min(n_k_tiles, q0 / 128 + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < 2; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(k_empty + st, CONSUMERS);
      mbar_init(v_empty + st, CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, L::TILE);
      for (int sub = 0; sub < D / 64; ++sub)
        tma_load_3d(smem + L::Q + sub * L::SUB, &tm_q, q_full, 64 * sub, q0, qh);
      for (int kt = 0; kt < n_k_tiles; ++kt) {
        const int st = kt & 1;
        const uint32_t ph = (kt >> 1) & 1;
        mbar_wait(k_empty + st, ph ^ 1);
        mbar_arrive_expect_tx(k_full + st, L::TILE);
        for (int sub = 0; sub < D / 64; ++sub)
          tma_load_3d(smem + L::K + st * L::TILE + sub * L::SUB, &tm_k, k_full + st, 64 * sub,
                      kt * 128, kvh);
        mbar_wait(v_empty + st, ph ^ 1);
        mbar_arrive_expect_tx(v_full + st, L::TILE);
        for (int sub = 0; sub < D / 64; ++sub)
          tma_load_3d(smem + L::V + st * L::TILE + sub * L::SUB, &tm_v, v_full + st, 64 * sub,
                      kt * 128, kvh);
      }
    }
  } else {
    // consumers: warpgroup wc owns rows 64 wc .. 64 wc + 63 of the tile
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wc = wg - 1, t128 = threadIdx.x % 128;
    const int lane = t128 % 32, g = lane >> 2, t = lane & 3;
    const int row = 64 * wc + 16 * (t128 / 32) + g;  // this thread's rows: row, row + 8
    const uint32_t sq = smem_u32(smem + L::Q) + 64 * wc * ROW_BYTES;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
    mbar_wait(q_full, 0);

    for (int kt = 0; kt < n_k_tiles; ++kt) {
      const int st = kt & 1, k0 = kt * 128;
      const uint32_t ph = (kt >> 1) & 1;
      const uint32_t sk = smem_u32(smem + L::K + st * L::TILE);
      const uint32_t sv = smem_u32(smem + L::V + st * L::TILE);

      // S = Q K^T: 64 rows x 128 keys
      float s[64];
      mbar_wait(k_full + st, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk / 4) * L::SUB + (kk % 4) * 32;
        wgmma_ss<0, 0>(s, desc_sw128(sq + off, 16, 1024), desc_sw128(sk + off, 16, 1024),
                       kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(k_empty + st);

      // online softmax on the fragments
      const bool masked = (k0 + 128 > s_k) || (causal && k0 + 127 > q0 + 64 * wc);
      float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        float x = s[i] * scale_log2;
        if (masked) {
          const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int qi = q0 + row + 8 * ((i >> 1) & 1);
          if (key >= s_k || (causal && key > qi)) x = NEG_INF;
        }
        s[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = quad_max(mx[r]);
        alpha[r] = exp2f(m_r[r] - mx[r]);
        m_r[r] = mx[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const float p = exp2f(s[i] - mx[(i >> 1) & 1]);
        s[i] = p;
        rs[(i >> 1) & 1] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + quad_sum(rs[r]);
      uint32_t pa[32];  // P in bf16: the A operand of 8 k-steps
      pack_a(s, pa);

      // O = O * alpha + P V
      mbar_wait(v_full + st, ph);
      fence_regs(o);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 8; ++j)
        wgmma_rs<1>(o, pa + 4 * j, desc_sw128(sv + j * 16 * ROW_BYTES, L::SUB, 1024), true);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
      mbar_arrive(v_empty + st);
    }

    // epilogue: O / l as bf16 through this warpgroup's own Q rows (read
    // by no one else), then one TMA store a 64-column box
    float l_safe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) l_safe[r] = (l_r[r] == 0.f) ? 1.f : l_r[r];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] /= l_safe[(i >> 1) & 1];
    fence_proxy_async();
    stage_rows(o, smem + L::Q, L::SUB, row, t);
    fence_proxy_async();
    named_barrier(1 + wc, 128);
    if (t128 == 0 && q0 + 64 * wc < s_q) {
      for (int sub = 0; sub < D / 64; ++sub)
        tma_store_3d(&tm_o, smem + L::Q + sub * L::SUB + 64 * wc * ROW_BYTES, 64 * sub,
                     q0 + 64 * wc, qh);
      tma_store_commit();
      tma_store_wait_read();
    }
    if (t == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qi = q0 + row + 8 * r;
        if (qi < s_q) lse[(size_t)qh * s_q + qi] = (m_r[r] + log2f(l_safe[r])) * LN2;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (128-row kv tile, kv head, batch); loops over the
// `group` query heads of the kv head and, for each, over the 64-row q
// tiles at or below the diagonal
// ---------------------------------------------------------------------------

constexpr int DKV_STAGES = 2;

template <int D> struct DkvSmem {
  static constexpr int KV_SUB = 128 * ROW_BYTES, KV_TILE = D / 64 * KV_SUB;
  static constexpr int Q_SUB = 64 * ROW_BYTES, Q_TILE = D / 64 * Q_SUB;
  // a stage: Q, dO, then 64 lse and 64 delta values
  static constexpr int LSE = 2 * Q_TILE, DELTA = LSE + 256, STAGE = 2 * Q_TILE + 1024;
  static constexpr int K = 0, V = KV_TILE, RING = 2 * KV_TILE;
  static constexpr int BARS = RING + DKV_STAGES * STAGE;
  static constexpr int BYTES = BARS + 128 + 1024;  // barriers, alignment slack
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const __grid_constant__ CUtensorMap tm_dk,
                     const __grid_constant__ CUtensorMap tm_dv, int h, int h_kv, int s_q,
                     int s_k, float scale, int causal) {
  using L = DkvSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = kv_full + 1;              // [DKV_STAGES]
  uint64_t* empty = full + DKV_STAGES;       // [DKV_STAGES]

  const int k0 = blockIdx.z * 128;  // low kv tiles, the longest under causal, first
  const int hk = blockIdx.x, bb = blockIdx.y;
  const int group = h / h_kv, kvh = bb * h_kv + hk;
  const int n_q_tiles = cdiv(s_q, 64);
  // q tile i holds a row q >= k0 iff i >= k0 / 64
  const int first_q_tile = causal ? min(k0 / 64, n_q_tiles) : 0;
  const int q_tiles = n_q_tiles - first_q_tile;
  const int n_it = group * q_tiles;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < DKV_STAGES; ++st) {
      mbar_init(full + st, 1 + 32);  // the TMA thread and warp 1's lanes
      mbar_init(empty + st, CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: thread 0 issues the TMA loads; warp 1 copies each stage's
    // lse and delta rows (64 f32 values at any offset, which a TMA box
    // cannot start at), zero past s_q
    setmaxnreg_dec<PRODUCER_REGS>();
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::KV_TILE);
      for (int sub = 0; sub < D / 64; ++sub) {
        tma_load_3d(smem + L::K + sub * L::KV_SUB, &tm_k, kv_full, 64 * sub, k0, kvh);
        tma_load_3d(smem + L::V + sub * L::KV_SUB, &tm_v, kv_full, 64 * sub, k0, kvh);
      }
    }
    if (warp <= 1) {
      for (int it = 0; it < n_it; ++it) {
        const int st = it % DKV_STAGES;
        const uint32_t ph = (it / DKV_STAGES) & 1;
        const int qh = bb * h + hk * group + it / q_tiles;
        const int q0 = (first_q_tile + it % q_tiles) * 64;
        unsigned char* stage = smem + L::RING + st * L::STAGE;
        if (threadIdx.x == 0) {
          mbar_wait(empty + st, ph ^ 1);
          mbar_arrive_expect_tx(full + st, 2 * L::Q_TILE);
          for (int sub = 0; sub < D / 64; ++sub) {
            tma_load_3d(stage + sub * L::Q_SUB, &tm_q, full + st, 64 * sub, q0, qh);
            tma_load_3d(stage + L::Q_TILE + sub * L::Q_SUB, &tm_do, full + st, 64 * sub, q0,
                        qh);
          }
        } else if (warp == 1) {
          mbar_wait(empty + st, ph ^ 1);
          float* rows = reinterpret_cast<float*>(stage + L::LSE);
          for (int c = lane; c < 64; c += 32) {
            const bool in = q0 + c < s_q;
            const size_t i = (size_t)qh * s_q + q0 + c;
            rows[c] = in ? lse[i] : 0.f;
            rows[c + 64] = in ? delta[i] : 0.f;
          }
          mbar_arrive(full + st);
        }
      }
    }
  } else {
    // consumers: warpgroup wc owns kv rows 64 wc .. 64 wc + 63 of the tile
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wc = wg - 1, t128 = threadIdx.x % 128;
    const int lane = t128 % 32, g = lane >> 2, t = lane & 3;
    const int row = 64 * wc + 16 * (t128 / 32) + g;  // this thread's kv rows: row, row + 8
    const float scale_log2 = scale * LOG2E;
    const uint32_t sk = smem_u32(smem + L::K) + 64 * wc * ROW_BYTES;
    const uint32_t sv = smem_u32(smem + L::V) + 64 * wc * ROW_BYTES;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
    mbar_wait(kv_full, 0);

    for (int it = 0; it < n_it; ++it) {
      const int st = it % DKV_STAGES;
      const uint32_t ph = (it / DKV_STAGES) & 1;
      const int q0 = (first_q_tile + it % q_tiles) * 64;
      const unsigned char* stage = smem + L::RING + st * L::STAGE;
      const uint32_t sq = smem_u32(stage), sdo = sq + L::Q_TILE;
      const float* s_lse = reinterpret_cast<const float*>(stage + L::LSE);
      const float* s_delta = reinterpret_cast<const float*>(stage + L::DELTA);

      // S^T = K Q^T and dP^T = V dO^T: 64 kv rows x 64 q columns
      float s[32], dp[32];
      mbar_wait(full + st, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * L::KV_SUB + (kk % 4) * 32;
        const uint32_t b_off = (kk / 4) * L::Q_SUB + (kk % 4) * 32;
        wgmma_ss<0, 0>(s, desc_sw128(sk + a_off, 16, 1024), desc_sw128(sq + b_off, 16, 1024),
                       kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * L::KV_SUB + (kk % 4) * 32;
        const uint32_t b_off = (kk / 4) * L::Q_SUB + (kk % 4) * 32;
        wgmma_ss<0, 0>(dp, desc_sw128(sv + a_off, 16, 1024), desc_sw128(sdo + b_off, 16, 1024),
                       kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T = exp2(s - lse[q]) (kept in s), dS^T = P^T (dP^T - delta[q]) scale
      const bool masked = (q0 + 64 > s_q) || (causal && k0 + 64 * wc + 63 > q0);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = 8 * (i / 4) + 2 * t + (i & 1);
        float p = exp2f(s[i] * scale_log2 - s_lse[col] * LOG2E);
        if (masked) {
          const int qi = q0 + col, kr = k0 + row + 8 * ((i >> 1) & 1);
          if (qi >= s_q || (causal && qi < kr)) p = 0.f;
        }
        s[i] = p;
        dp[i] = p * (dp[i] - s_delta[col]) * scale;
      }
      uint32_t pa[16], da[16];
      pack_a(s, pa);
      pack_a(dp, da);

      // dV += P^T dO and dK += dS^T Q over the tile's 64 q rows
      fence_regs(dv);
      fence_regs(dk);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs<1>(dv, pa + 4 * j, desc_sw128(sdo + j * 16 * ROW_BYTES, L::Q_SUB, 1024), true);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wgmma_rs<1>(dk, da + 4 * j, desc_sw128(sq + j * 16 * ROW_BYTES, L::Q_SUB, 1024), true);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      mbar_arrive(empty + st);
    }

    // epilogue: every load of K and V has landed (kv_full) and every wgmma
    // of both consumer warpgroups has completed before dK and dV are
    // staged as bf16 through the K and V rows, then one TMA store a box
    named_barrier(1, CONSUMERS);
    fence_proxy_async();
    stage_rows(dk, smem + L::K, L::KV_SUB, row, t);
    stage_rows(dv, smem + L::V, L::KV_SUB, row, t);
    fence_proxy_async();
    named_barrier(2 + wc, 128);
    if (t128 == 0 && k0 + 64 * wc < s_k) {
      for (int sub = 0; sub < D / 64; ++sub) {
        const int off = sub * L::KV_SUB + 64 * wc * ROW_BYTES;
        tma_store_3d(&tm_dk, smem + L::K + off, 64 * sub, k0 + 64 * wc, kvh);
        tma_store_3d(&tm_dv, smem + L::V + off, 64 * sub, k0 + 64 * wc, kvh);
      }
      tma_store_commit();
      tma_store_wait_read();
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (128-row q tile, head, batch); loops over the kv tiles
// up to the diagonal, keeping dQ in f32 registers
// ---------------------------------------------------------------------------

constexpr int DQ_BK = 128;  // rows of a K or V tile
constexpr int DQ_STAGES = 2;

template <int D> struct DqSmem {
  static constexpr int Q_SUB = 128 * ROW_BYTES, Q_TILE = D / 64 * Q_SUB;      // Q, dO
  static constexpr int KV_SUB = DQ_BK * ROW_BYTES, KV_TILE = D / 64 * KV_SUB;  // a K or V stage
  static constexpr int Q = 0, DO = Q_TILE, K = 2 * Q_TILE, V = K + DQ_STAGES * KV_TILE;
  static constexpr int BARS = V + DQ_STAGES * KV_TILE;
  static constexpr int BYTES = BARS + 128 + 1024;  // barriers, alignment slack
};

template <int D>
__global__ void __launch_bounds__(WS_THREADS, 1)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    const __grid_constant__ CUtensorMap tm_dq, int h, int h_kv, int s_q,
                    int s_k, float scale, int causal) {
  using L = DqSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BARS);  // Q and dO
  uint64_t* k_full = q_full + 1;           // [DQ_STAGES]
  uint64_t* v_full = k_full + DQ_STAGES;   // [DQ_STAGES]
  uint64_t* k_empty = v_full + DQ_STAGES;  // [DQ_STAGES]
  uint64_t* v_empty = k_empty + DQ_STAGES; // [DQ_STAGES]

  const int n_q_tiles = cdiv(s_q, 128);
  const int q0 = (n_q_tiles - 1 - (int)blockIdx.z) * 128;  // longest causal rows first
  const int hh = blockIdx.x, bb = blockIdx.y;
  const int qh = bb * h + hh, kvh = bb * h_kv + hh / (h / h_kv);
  int n_k_tiles = cdiv(s_k, DQ_BK);
  if (causal) n_k_tiles = min(n_k_tiles, (q0 + 127) / DQ_BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < DQ_STAGES; ++st) {
      mbar_init(k_full + st, 1);
      mbar_init(v_full + st, 1);
      mbar_init(k_empty + st, CONSUMERS);
      mbar_init(v_empty + st, CONSUMERS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every load
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(q_full, 2 * L::Q_TILE);
      for (int sub = 0; sub < D / 64; ++sub) {
        tma_load_3d(smem + L::Q + sub * L::Q_SUB, &tm_q, q_full, 64 * sub, q0, qh);
        tma_load_3d(smem + L::DO + sub * L::Q_SUB, &tm_do, q_full, 64 * sub, q0, qh);
      }
      for (int kt = 0; kt < n_k_tiles; ++kt) {
        const int st = kt % DQ_STAGES;
        const uint32_t ph = (kt / DQ_STAGES) & 1;
        mbar_wait(k_empty + st, ph ^ 1);
        mbar_arrive_expect_tx(k_full + st, L::KV_TILE);
        for (int sub = 0; sub < D / 64; ++sub)
          tma_load_3d(smem + L::K + st * L::KV_TILE + sub * L::KV_SUB, &tm_k, k_full + st,
                      64 * sub, kt * DQ_BK, kvh);
        mbar_wait(v_empty + st, ph ^ 1);
        mbar_arrive_expect_tx(v_full + st, L::KV_TILE);
        for (int sub = 0; sub < D / 64; ++sub)
          tma_load_3d(smem + L::V + st * L::KV_TILE + sub * L::KV_SUB, &tm_v, v_full + st,
                      64 * sub, kt * DQ_BK, kvh);
      }
    }
  } else {
    // consumers: warpgroup wc owns q rows 64 wc .. 64 wc + 63 of the tile
    setmaxnreg_inc<CONSUMER_REGS>();
    const int wc = wg - 1, t128 = threadIdx.x % 128;
    const int lane = t128 % 32, g = lane >> 2, t = lane & 3;
    const int row = 64 * wc + 16 * (t128 / 32) + g;  // this thread's rows: row, row + 8
    const int first_row = q0 + 64 * wc;
    const float scale_log2 = scale * LOG2E;
    const uint32_t sq = smem_u32(smem + L::Q) + 64 * wc * ROW_BYTES;
    const uint32_t sdo = smem_u32(smem + L::DO) + 64 * wc * ROW_BYTES;

    // this thread's two rows' lse (exp2 domain) and delta, plain loads
    // (a head's rows start at any offset); 0 past s_q
    float lse2[2], dl[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + row + 8 * r;
      const size_t i = (size_t)qh * s_q + qi;
      lse2[r] = qi < s_q ? lse[i] * LOG2E : 0.f;
      dl[r] = qi < s_q ? delta[i] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
    mbar_wait(q_full, 0);

    for (int kt = 0; kt < n_k_tiles; ++kt) {
      const int st = kt % DQ_STAGES, k0 = kt * DQ_BK;
      const uint32_t ph = (kt / DQ_STAGES) & 1;
      const uint32_t sk = smem_u32(smem + L::K + st * L::KV_TILE);
      const uint32_t sv = smem_u32(smem + L::V + st * L::KV_TILE);

      // S = Q K^T and dP = dO V^T: 64 q rows x DQ_BK keys, one commit group
      float s[DQ_BK / 2], dp[DQ_BK / 2];
      mbar_wait(k_full + st, ph);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * L::Q_SUB + (kk % 4) * 32;
        const uint32_t b_off = (kk / 4) * L::KV_SUB + (kk % 4) * 32;
        wgmma_ss<0, 0>(s, desc_sw128(sq + a_off, 16, 1024), desc_sw128(sk + b_off, 16, 1024),
                       kk > 0);
      }
      mbar_wait(v_full + st, ph);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a_off = (kk / 4) * L::Q_SUB + (kk % 4) * 32;
        const uint32_t b_off = (kk / 4) * L::KV_SUB + (kk % 4) * 32;
        wgmma_ss<0, 0>(dp, desc_sw128(sdo + a_off, 16, 1024), desc_sw128(sv + b_off, 16, 1024),
                       kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      mbar_arrive(v_empty + st);  // V is read by nothing else

      // P = exp2(s - lse), dS = P (dP - delta) scale, kept in dp
      const bool masked = (k0 + DQ_BK > s_k) || (causal && k0 + DQ_BK - 1 > first_row);
#pragma unroll
      for (int i = 0; i < DQ_BK / 2; ++i) {
        float x = s[i] * scale_log2;
        if (masked) {
          const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          const int qi = q0 + row + 8 * ((i >> 1) & 1);
          if (key >= s_k || (causal && key > qi)) x = NEG_INF;
        }
        const float p = exp2f(x - lse2[(i >> 1) & 1]);
        dp[i] = p * (dp[i] - dl[(i >> 1) & 1]) * scale;
      }
      uint32_t da[DQ_BK / 4];  // dS in bf16: the A operand of DQ_BK / 16 k-steps
      pack_a(dp, da);

      // dQ += dS K over the tile's keys, K MN-major from the same stage
      fence_regs(dq);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < DQ_BK / 16; ++j)
        wgmma_rs<1>(dq, da + 4 * j, desc_sw128(sk + j * 16 * ROW_BYTES, L::KV_SUB, 1024), true);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
      mbar_arrive(k_empty + st);
    }

    // epilogue: dQ as bf16 through this warpgroup's own Q rows (read by
    // no one else), then one TMA store a 64-column box; the map clips rows
    // past s_q
    fence_proxy_async();
    stage_rows(dq, smem + L::Q, L::Q_SUB, row, t);
    fence_proxy_async();
    named_barrier(1 + wc, 128);
    if (t128 == 0 && first_row < s_q) {
      for (int sub = 0; sub < D / 64; ++sub)
        tma_store_3d(&tm_dq, smem + L::Q + sub * L::Q_SUB + 64 * wc * ROW_BYTES, 64 * sub,
                     first_row, qh);
      tma_store_commit();
      tma_store_wait_read();
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   bytes);
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int b,
               int h, int h_kv, int s_q, int s_k, float scale, int causal,
               cudaStream_t stream) {
  CUtensorMap tq, tk, tv, to;
  cudaError_t err;
  if ((err = map_bf16_3d(&tq, q, D, s_q, b * h, 128)) ||
      (err = map_bf16_3d(&tk, k, D, s_k, b * h_kv, 128)) ||
      (err = map_bf16_3d(&tv, v, D, s_k, b * h_kv, 128)) ||
      (err = map_bf16_3d(&to, o, D, s_q, b * h, 64)))
    return (int)err;
  constexpr int smem = FwdSmem<D>::BYTES;
  if (int e = set_smem(flash_fwd_kernel<D>, smem)) return e;
  dim3 grid(h, b, cdiv(s_q, 128));
  flash_fwd_kernel<D><<<grid, WS_THREADS, smem, stream>>>(tq, tk, tv, to, (float*)lse, h, h_kv,
                                                          s_q, s_k, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int b, int h, int h_kv,
              int s_q, int s_k, float scale, int causal, cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv, tdq;
  cudaError_t err;
  if ((err = map_bf16_3d(&tq, q, D, s_q, b * h, 128)) ||
      (err = map_bf16_3d(&tdo, dout, D, s_q, b * h, 128)) ||
      (err = map_bf16_3d(&tk, k, D, s_k, b * h_kv, DQ_BK)) ||
      (err = map_bf16_3d(&tv, v, D, s_k, b * h_kv, DQ_BK)) ||
      (err = map_bf16_3d(&tdq, dq, D, s_q, b * h, 64)))
    return (int)err;
  constexpr int smem = DqSmem<D>::BYTES;
  if (int e = set_smem(flash_bwd_dq_kernel<D>, smem)) return e;
  dim3 grid(h, b, cdiv(s_q, 128));
  flash_bwd_dq_kernel<D><<<grid, WS_THREADS, smem, stream>>>(
      tq, tdo, tk, tv, (const float*)lse, (const float*)delta, tdq, h, h_kv, s_q, s_k, scale,
      causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int b, int h,
               int h_kv, int s_q, int s_k, float scale, int causal,
               cudaStream_t stream) {
  CUtensorMap tq, tdo, tk, tv, tdk, tdv;
  cudaError_t err;
  if ((err = map_bf16_3d(&tq, q, D, s_q, b * h, 64)) ||
      (err = map_bf16_3d(&tdo, dout, D, s_q, b * h, 64)) ||
      (err = map_bf16_3d(&tk, k, D, s_k, b * h_kv, 128)) ||
      (err = map_bf16_3d(&tv, v, D, s_k, b * h_kv, 128)) ||
      (err = map_bf16_3d(&tdk, dk, D, s_k, b * h_kv, 64)) ||
      (err = map_bf16_3d(&tdv, dv, D, s_k, b * h_kv, 64)))
    return (int)err;
  constexpr int smem = DkvSmem<D>::BYTES;
  if (int e = set_smem(flash_bwd_dkv_kernel<D>, smem)) return e;
  dim3 grid(h_kv, b, cdiv(s_k, 128));
  flash_bwd_dkv_kernel<D><<<grid, WS_THREADS, smem, stream>>>(
      tq, tdo, tk, tv, (const float*)lse, (const float*)delta, tdk, tdv, h, h_kv, s_q, s_k,
      scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

int flash_fwd_bf16(const void* q, const void* k, const void* v, void* o, void* lse,
                   int b, int h, int h_kv, int s_q, int s_k, int d, float scale,
                   int causal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64) return launch_fwd<64>(q, k, v, o, lse, b, h, h_kv, s_q, s_k, scale, causal, st);
  if (d == 128) return launch_fwd<128>(q, k, v, o, lse, b, h, h_kv, s_q, s_k, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

int flash_bwd_dq_bf16(const void* q, const void* k, const void* v, const void* dout,
                      const void* lse, const void* delta, void* dq, int b, int h,
                      int h_kv, int s_q, int s_k, int d, float scale, int causal,
                      void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, b, h, h_kv, s_q, s_k, scale, causal, st);
  if (d == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, b, h, h_kv, s_q, s_k, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}

int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v, const void* dout,
                       const void* lse, const void* delta, void* dk, void* dv, int b,
                       int h, int h_kv, int s_q, int s_k, int d, float scale,
                       int causal, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (d == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, b, h, h_kv, s_q, s_k, scale,
                          causal, st);
  if (d == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, b, h, h_kv, s_q, s_k, scale,
                           causal, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
