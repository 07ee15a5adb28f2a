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
// rounded to bf16 before P.V, dS before dS.K and dS^T.Q.
//
// What bounds them on the H100: at the Llama-1B slice shape (b=4, h=16,
// s=2048, d=128, causal) the forward does 4*b*h*d*pairs ~ 6.9e10 FLOP
// against ~67 MB of q/k/v/o traffic, about 1000 FLOP per byte, far above
// the card's ~295 FLOP/byte ridge; dQ (3 products) and dK/dV (4 products)
// are further above it. All three are bound by tensor-core operations.
//
// What the design does about it (FlashAttention-2 style, on mma.sync):
// - every product is a tensor-core mma.sync.m16n8k16 (bf16 in, f32
//   accumulate) whose operands come from shared memory through ldmatrix;
// - scores, probabilities and output accumulators never leave registers:
//   the softmax runs on the accumulator fragments (a row's four owners
//   are one quad of lanes, reduced with two shuffles) and P, rounded to
//   bf16, is reused in place as the A operand of P.V (dS likewise);
// - the streamed tiles (K/V, or Q/dO) are double-buffered with cp.async,
//   so the next tile's load overlaps this tile's products;
// - causal blocks stop at the diagonal and only tiles that straddle it
//   or a ragged edge pay for the mask.
// Not yet used: wgmma, TMA, warp specialisation and larger tiles, which
// are what reaches most of the 989 TFLOP/s peak.
//
// Where the TPU kernels carried the kv (or q) grid axis sequentially in
// VMEM scratch, each CUDA block here loops over that axis itself. Blocks
// never share state: the dK/dV block of a kv head loops over the `group`
// query heads that read it and sums their contributions in f32 registers,
// so no per-query-head partials are written and no atomics are needed.
// Ragged edges are masked in the kernel (zero-filled loads, NEG_INF scores
// past s_k, no stores past s_q or s_k) instead of requiring tiles that
// divide the sequence.
//
// Layout: q (b, h, s_q, d), k/v (b, h_kv, s_k, d), contiguous bf16;
// lse and delta (b, h, s_q) f32. d is 64 or 128. Each block has 4 warps;
// each warp owns 16 rows of the block's 64-row tile.
// Each entry point launches on the given stream, never synchronises,
// allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64;        // rows of the tile a block owns
constexpr int BN = 64;        // rows of each tile a block streams
constexpr int NTHREADS = 128; // 4 warps, 16 owned rows each
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Shared-memory tiles are 64 rows of D bf16, each row padded by 16 bytes
// so the eight rows one ldmatrix reads fall in different banks.
template <int D> struct Tile {
  static constexpr int LD = D + 8;               // row stride, elements
  static constexpr int ELEMS = 64 * LD;          // one tile
  // forward: Q + 2 stages of (K, V)
  static constexpr int FWD_SMEM = 5 * ELEMS * 2;
  // dQ: Q, dO + 2 stages of (K, V)
  static constexpr int DQ_SMEM = 6 * ELEMS * 2;
  // dK/dV: K, V + 2 stages of (Q, dO) + 2 stages of (lse, delta) rows
  static constexpr int DKV_SMEM = 6 * ELEMS * 2 + 2 * 2 * BM * 4;
};

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// 4-byte async copy; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a . b for one 16x8 tile: a is 16x16 bf16 (row major), b 16x8 bf16.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to a bf16 pair; `lo` takes the low half (the
// lower column of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// Fragment loads. Lane l of a warp: g = l / 4 is its row in an 8-row
// group, t = l % 4 its column pair. An accumulator fragment c[4] holds
// (row g, cols 2t, 2t+1) in c[0..1] and (row g + 8, same cols) in c[2..3].
// ---------------------------------------------------------------------------

// A operand: the 16x16 block at (r0, c0) of a row-major tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* t, int r0, int c0,
                                       int lane) {
  ldmatrix_x4(a, t + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8);
}

// B operands of two n-tiles from a row-major [n][k] tile (B = tile^T):
// rows n0..n0+15, cols c0..c0+15; b[0..1] for n0..n0+7, b[2..3] for the
// next eight.
template <int LD>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* t, int n0, int c0,
                                          int lane) {
  const int m = lane >> 3, i = lane & 7;
  ldmatrix_x4(b, t + (n0 + i + (m >> 1) * 8) * LD + c0 + (m & 1) * 8);
}

// B operands of two n-tiles from a row-major [k][n] tile (B = tile):
// rows k0..k0+15, cols n0..n0+15; b[0..1] for n0..n0+7, b[2..3] for the
// next eight.
template <int LD>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* t, int k0, int n0,
                                          int lane) {
  const int m = lane >> 3, i = lane & 7;
  ldmatrix_x4_trans(b, t + (k0 + i + (m & 1) * 8) * LD + n0 + (m >> 1) * 8);
}

// Async copy of rows [row0, row0 + 64) of a (n_rows, D) bf16 matrix into
// a padded tile; rows past n_rows are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ src,
                                                int row0, int n_rows) {
  constexpr int VPR = D / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < 64 * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool valid = row0 + r < n_rows;
    cp_async16(dst + r * Tile<D>::LD + c, valid ? src + (size_t)(row0 + r) * D + c : src,
               valid);
  }
}

// Async copy of 64 f32 row values (lse or delta); zero past n_rows.
__device__ __forceinline__ void load_rows_async(float* dst, const float* __restrict__ src,
                                                int row0, int n_rows) {
  for (int i = threadIdx.x; i < 64; i += NTHREADS) {
    const bool valid = row0 + i < n_rows;
    cp_async4(dst + i, valid ? src + row0 + i : src, valid);
  }
}

// Store a warp's 16 x D f32 accumulator rows as bf16: through the warp's
// own rows of the padded shared tile `stage`, then 16-byte stores of the
// rows below n_rows.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 8][4], bf16* stage,
                                           bf16* __restrict__ out, int row0, int wr,
                                           int n_rows, int lane) {
  constexpr int LD = Tile<D>::LD;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<uint32_t*>(stage + (wr + g) * LD + n * 8 + 2 * t) =
        pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(stage + (wr + g + 8) * LD + n * 8 + 2 * t) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  constexpr int VPR = D / 8;
  for (int i = lane; i < 16 * VPR; i += 32) {
    const int r = i / VPR, c = (i % VPR) * 8;
    if (row0 + wr + r < n_rows)
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + wr + r) * D + c) =
          *reinterpret_cast<const uint4*>(stage + (wr + r) * LD + c);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// Forward: one block per (q tile, head, batch); loops over kv tiles.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int h, int h_kv, int s_q, int s_k,
                 float scale_log2, int causal) {
  using T = Tile<D>;
  constexpr int LD = T::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sKV = sQ + T::ELEMS;  // stage s: K at 2s, V at 2s + 1

  const int n_q_tiles = (s_q + BM - 1) / BM;
  const int q0 = (n_q_tiles - 1 - (int)blockIdx.x) * BM;  // longest causal rows first
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int hk = hh / (h / h_kv);
  const size_t qh = (size_t)bb * h + hh;
  const bf16* kp = k + ((size_t)bb * h_kv + hk) * s_k * D;
  const bf16* vp = v + ((size_t)bb * h_kv + hk) * s_k * D;
  const int lane = threadIdx.x % 32, wr = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t = lane & 3;

  int n_k_tiles = (s_k + BN - 1) / BN;
  if (causal) n_k_tiles = min(n_k_tiles, (q0 + BM - 1) / BN + 1);

  load_tile_async<D>(sQ, q + qh * s_q * D, q0, s_q);
  load_tile_async<D>(sKV, kp, 0, s_k);
  load_tile_async<D>(sKV + T::ELEMS, vp, 0, s_k);
  cp_async_commit();

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  uint32_t qf[D / 16][4];

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int k0 = kt * BN;
    const bf16* sK = sKV + (kt & 1) * 2 * T::ELEMS;
    const bf16* sV = sK + T::ELEMS;
    if (kt + 1 < n_k_tiles) {
      bf16* nK = sKV + ((kt + 1) & 1) * 2 * T::ELEMS;
      load_tile_async<D>(nK, kp, k0 + BN, s_k);
      load_tile_async<D>(nK + T::ELEMS, vp, k0 + BN, s_k);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) load_a<LD>(qf[kk], sQ, wr, kk * 16, lane);
    }

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t b[4];
        load_b_nk<LD>(b, sK, np * 16, kk * 16, lane);
        mma(s[2 * np], qf[kk], b[0], b[1]);
        mma(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // online softmax on the fragments; this lane's rows are g and g + 8
    const bool masked = (k0 + BN > s_k) || (causal && k0 + BN - 1 > q0);
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (masked) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int qi = q0 + wr + g + (e >> 1) * 8;
          if (key >= s_k || (causal && key > qi)) x = NEG_INF;
        }
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
    }
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - mx[e >> 1]);
        s[n][e] = p;
        rs[e >> 1] += p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_r[r] = l_r[r] * alpha[r] + quad_sum(rs[r]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // O += P V, with P (rounded to bf16) as the A operand in place
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        load_b_kn<LD>(b, sV, j * 16, dp * 16, lane);
        mma(acc[2 * dp], pa, b[0], b[1]);
        mma(acc[2 * dp + 1], pa, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before its refill
  }

  float l_safe[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) l_safe[r] = (l_r[r] == 0.f) ? 1.f : l_r[r];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[n][0] /= l_safe[0];
    acc[n][1] /= l_safe[0];
    acc[n][2] /= l_safe[1];
    acc[n][3] /= l_safe[1];
  }
  store_rows<D>(acc, sQ, o + qh * s_q * D, q0, wr, s_q, lane);
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qi = q0 + wr + g + 8 * r;
      if (qi < s_q) lse[qh * s_q + qi] = (m_r[r] + log2f(l_safe[r])) * LN2;
    }
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (q tile, head, batch); loops over kv tiles up to the
// diagonal, keeping dQ in f32 accumulator fragments.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    bf16* __restrict__ dq, int h, int h_kv, int s_q, int s_k,
                    float scale, int causal) {
  using T = Tile<D>;
  constexpr int LD = T::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = sQ + T::ELEMS;
  bf16* sKV = sdO + T::ELEMS;  // stage s: K at 2s, V at 2s + 1

  const int n_q_tiles = (s_q + BM - 1) / BM;
  const int q0 = (n_q_tiles - 1 - (int)blockIdx.x) * BM;
  const int hh = blockIdx.y, bb = blockIdx.z;
  const int hk = hh / (h / h_kv);
  const size_t qh = (size_t)bb * h + hh;
  const bf16* kp = k + ((size_t)bb * h_kv + hk) * s_k * D;
  const bf16* vp = v + ((size_t)bb * h_kv + hk) * s_k * D;
  const int lane = threadIdx.x % 32, wr = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * LOG2E;

  int n_k_tiles = (s_k + BN - 1) / BN;
  if (causal) n_k_tiles = min(n_k_tiles, (q0 + BM - 1) / BN + 1);

  load_tile_async<D>(sQ, q + qh * s_q * D, q0, s_q);
  load_tile_async<D>(sdO, dout + qh * s_q * D, q0, s_q);
  load_tile_async<D>(sKV, kp, 0, s_k);
  load_tile_async<D>(sKV + T::ELEMS, vp, 0, s_k);
  cp_async_commit();

  // this lane's two rows' lse (exp2 domain) and delta; 0 past s_q
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + wr + g + 8 * r;
    lse2[r] = qi < s_q ? lse[qh * s_q + qi] * LOG2E : 0.f;
    dl[r] = qi < s_q ? delta[qh * s_q + qi] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int kt = 0; kt < n_k_tiles; ++kt) {
    const int k0 = kt * BN;
    const bf16* sK = sKV + (kt & 1) * 2 * T::ELEMS;
    const bf16* sV = sK + T::ELEMS;
    if (kt + 1 < n_k_tiles) {
      bf16* nK = sKV + ((kt + 1) & 1) * 2 * T::ELEMS;
      load_tile_async<D>(nK, kp, k0 + BN, s_k);
      load_tile_async<D>(nK + T::ELEMS, vp, k0 + BN, s_k);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T
    float s[BN / 8][4], dp[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t qa[4], da[4];
      load_a<LD>(qa, sQ, wr, kk * 16, lane);
      load_a<LD>(da, sdO, wr, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        uint32_t b[4];
        load_b_nk<LD>(b, sK, np * 16, kk * 16, lane);
        mma(s[2 * np], qa, b[0], b[1]);
        mma(s[2 * np + 1], qa, b[2], b[3]);
        load_b_nk<LD>(b, sV, np * 16, kk * 16, lane);
        mma(dp[2 * np], da, b[0], b[1]);
        mma(dp[2 * np + 1], da, b[2], b[3]);
      }
    }

    // P = exp2(s - lse), dS = P (dP - delta) scale, kept in s
    const bool masked = (k0 + BN > s_k) || (causal && k0 + BN - 1 > q0);
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (masked) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int qi = q0 + wr + g + (e >> 1) * 8;
          if (key >= s_k || (causal && key > qi)) x = NEG_INF;
        }
        const float p = exp2f(x - lse2[e >> 1]);
        s[n][e] = p * (dp[n][e] - dl[e >> 1]) * scale;
      }
    }

    // dQ += dS K, with dS (rounded to bf16) as the A operand
#pragma unroll
    for (int j = 0; j < BN / 16; ++j) {
      const uint32_t da[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t b[4];
        load_b_kn<LD>(b, sK, j * 16, n2 * 16, lane);
        mma(acc[2 * n2], da, b[0], b[1]);
        mma(acc[2 * n2 + 1], da, b[2], b[3]);
      }
    }
    __syncthreads();
  }

  // sQ rows are read only by their own warp: stage through them
  store_rows<D>(acc, sQ, dq + qh * s_q * D, q0, wr, s_q, lane);
}

// ---------------------------------------------------------------------------
// dK/dV: one block per (kv tile, kv head, batch); loops over the `group`
// query heads of the kv head and, for each, over the q tiles at or below
// the diagonal. Each warp owns 16 kv rows and keeps their dK and dV in f32
// accumulator fragments for the whole loop; each q tile is taken in two
// halves of 32 columns to bound the live score registers.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     bf16* __restrict__ dk, bf16* __restrict__ dv, int h, int h_kv,
                     int s_q, int s_k, float scale, int causal) {
  using T = Tile<D>;
  constexpr int LD = T::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + T::ELEMS;
  bf16* sQO = sV + T::ELEMS;  // stage s: Q at 2s, dO at 2s + 1
  float* sRows = reinterpret_cast<float*>(sQO + 4 * T::ELEMS);  // stage s: lse, delta

  const int k0 = blockIdx.x * BN;
  const int hk = blockIdx.y, bb = blockIdx.z;
  const int group = h / h_kv;
  const size_t kvh = (size_t)bb * h_kv + hk;
  const int lane = threadIdx.x % 32, wr = (threadIdx.x / 32) * 16;
  const int g = lane >> 2, t = lane & 3;
  const float scale_log2 = scale * LOG2E;

  const int n_q_tiles = (s_q + BM - 1) / BM;
  // q tile i holds a row q >= k0 iff i >= k0 / BM (BM == BN)
  const int first_q_tile = causal ? min(k0 / BM, n_q_tiles) : 0;
  const int q_tiles = n_q_tiles - first_q_tile;
  const int n_it = group * q_tiles;

  auto issue = [&](int it) {
    const int st = it & 1;
    const size_t qh = (size_t)bb * h + (size_t)hk * group + it / q_tiles;
    const int q0 = (first_q_tile + it % q_tiles) * BM;
    load_tile_async<D>(sQO + 2 * st * T::ELEMS, q + qh * s_q * D, q0, s_q);
    load_tile_async<D>(sQO + (2 * st + 1) * T::ELEMS, dout + qh * s_q * D, q0, s_q);
    load_rows_async(sRows + 2 * st * BM, lse + qh * s_q, q0, s_q);
    load_rows_async(sRows + (2 * st + 1) * BM, delta + qh * s_q, q0, s_q);
  };

  load_tile_async<D>(sK, k + kvh * s_k * D, k0, s_k);
  load_tile_async<D>(sV, v + kvh * s_k * D, k0, s_k);
  if (n_it > 0) issue(0);
  cp_async_commit();

  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[n][e] = acc_dv[n][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    const int q0 = (first_q_tile + it % q_tiles) * BM;
    const bf16* sQ = sQO + 2 * st * T::ELEMS;
    const bf16* sdO = sQ + T::ELEMS;
    const float* sLse = sRows + 2 * st * BM;
    const float* sDelta = sLse + BM;
    if (it + 1 < n_it) {
      issue(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    const bool masked = (q0 + BM > s_q) || (causal && k0 + BN - 1 > q0);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int c0 = half * 32;  // first q column of this half
      // S^T = K_w Q^T and dP^T = V_w dO^T: 16 kv rows x 32 q columns
      float s[4][4], dp[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4];
        load_a<LD>(ka, sK, wr, kk * 16, lane);
        load_a<LD>(va, sV, wr, kk * 16, lane);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t b[4];
          load_b_nk<LD>(b, sQ, c0 + np * 16, kk * 16, lane);
          mma(s[2 * np], ka, b[0], b[1]);
          mma(s[2 * np + 1], ka, b[2], b[3]);
          load_b_nk<LD>(b, sdO, c0 + np * 16, kk * 16, lane);
          mma(dp[2 * np], va, b[0], b[1]);
          mma(dp[2 * np + 1], va, b[2], b[3]);
        }
      }
      // P^T = exp2(s - lse[q]) (kept in s), dS^T = P^T (dP^T - delta[q]) scale
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + n * 8 + 2 * t + (e & 1);
          float p = exp2f(s[n][e] * scale_log2 - sLse[col] * LOG2E);
          if (masked) {
            const int qi = q0 + col, kr = k0 + wr + g + (e >> 1) * 8;
            if (qi >= s_q || (causal && qi < kr)) p = 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - sDelta[col]) * scale;
        }
      }
      // dV += P^T dO and dK += dS^T Q over this half's 32 q rows
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                                pack_bf16(s[2 * j][2], s[2 * j][3]),
                                pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
        const uint32_t da[4] = {pack_bf16(dp[2 * j][0], dp[2 * j][1]),
                                pack_bf16(dp[2 * j][2], dp[2 * j][3]),
                                pack_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1]),
                                pack_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3])};
#pragma unroll
        for (int n2 = 0; n2 < D / 16; ++n2) {
          uint32_t b[4];
          load_b_kn<LD>(b, sdO, c0 + j * 16, n2 * 16, lane);
          mma(acc_dv[2 * n2], pa, b[0], b[1]);
          mma(acc_dv[2 * n2 + 1], pa, b[2], b[3]);
          load_b_kn<LD>(b, sQ, c0 + j * 16, n2 * 16, lane);
          mma(acc_dk[2 * n2], da, b[0], b[1]);
          mma(acc_dk[2 * n2 + 1], da, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }
  // When the loop ran no iteration (a causal kv tile past the last query)
  // the K/V copies are still in flight, and a row of sK/sV may be filled
  // by another warp's thread: every copy lands before any warp stages its
  // zero dK/dV through them.
  cp_async_wait<0>();
  __syncthreads();

  // sK / sV rows are read only by their own warp: stage through them
  store_rows<D>(acc_dk, sK, dk + kvh * s_k * D, k0, wr, s_k, lane);
  store_rows<D>(acc_dv, sV, dv + kvh * s_k * D, k0, wr, s_k, lane);
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
  constexpr int smem = Tile<D>::FWD_SMEM;
  if (int err = set_smem(flash_fwd_kernel<D>, smem)) return err;
  dim3 grid((s_q + BM - 1) / BM, h, b);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, h, h_kv,
      s_q, s_k, scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int b, int h, int h_kv,
              int s_q, int s_k, float scale, int causal, cudaStream_t stream) {
  constexpr int smem = Tile<D>::DQ_SMEM;
  if (int err = set_smem(flash_bwd_dq_kernel<D>, smem)) return err;
  dim3 grid((s_q + BM - 1) / BM, h, b);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, h, h_kv, s_q, s_k, scale,
      causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int b, int h,
               int h_kv, int s_q, int s_k, float scale, int causal,
               cudaStream_t stream) {
  constexpr int smem = Tile<D>::DKV_SMEM;
  if (int err = set_smem(flash_bwd_dkv_kernel<D>, smem)) return err;
  dim3 grid((s_k + BN - 1) / BN, h_kv, b);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, h, h_kv, s_q, s_k,
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
