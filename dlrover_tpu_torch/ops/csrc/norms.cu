// RMSNorm forward and backward for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of dlrover_tpu/ops/norms.py:
//   rms_fwd_kernel    <- _rms_fwd_kernel (:25-31, launched by _rms_fwd :91)
//   rms_bwd_kernel    <- _rms_bwd_kernel (:34-55, launched by _rms_bwd_vjp :123)
//   rms_dw_sum_kernel    the sum of the per-block dw partials, which the
//                        reference takes outside its kernel (:144)
//
// Semantics kept from the reference: f32 math on x in any of bf16 / f32;
// var = sum(x^2) / dim; rstd = rsqrt(var + eps), saved f32 per row;
// y = (x * rstd) * w, rounded to x's type. Backward: xhat = x * rstd,
// wg = g * w, dx = rstd * (wg - xhat * mean(wg * xhat)) rounded to x's
// type, dw = sum over rows of g * xhat in f32.
//
// What bounds them on the H100: a few f32 operations per element against
// 4 (forward: bf16 x in, y out) or 6 (backward: x, g in, dx out) bytes,
// far below the card's ~295 FLOP/byte ridge: both are bound by device
// memory. At Llama-1B micro 8 (16384 x 2048 bf16) the forward must move
// 134 MB (0.040 ms at 3.35 TB/s), the backward 201 MB (0.060 ms).
//
// What the design does about it: every element is read once and written
// once. Each thread of a block owns 8 consecutive columns of a row (one
// 16-byte load for bf16, two for f32), or 8 columns in each of CHUNKS
// places for rows wider than 8192. The row's sum is reduced with warp
// shuffles and then across warps through shared memory, and the output is
// computed from the values still held in registers. w is loaded once a
// block. Blocks loop over rows (block b takes rows b, b + grid, ...), and
// the grid is as many blocks as are resident on the card at once, so the
// loads of many rows are in flight together.
//
// dw: the TPU kernel carried one (8, dim) accumulator across its
// sequential row grid. CUDA blocks run in no order, so each block sums its
// own rows' g * xhat in registers and writes one f32 partial row
// (grid, dim); rms_dw_sum_kernel then adds the partial rows of each column
// in a fixed order. No atomics: dw is the same bits from run to run.
//
// Ragged edges are masked in the kernel: rows need not divide anything,
// and a dim that is not a multiple of 8 takes per-element loads with the
// columns past dim read as zero and never stored. (The reference needs a
// row block that divides the rows only because Pallas pads out-of-bounds
// reads with undefined data.)
//
// Layout: x, g, y, dx (rows, dim) contiguous; w (dim) f32; rstd (rows) f32;
// pointers 16-byte aligned. Each entry point launches on the given stream,
// never synchronises, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int VEC = 8;              // consecutive columns a thread owns
constexpr int MAX_THREADS = 1024;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int SUM_COLS = 32;        // rms_dw_sum_kernel block: 32 columns
constexpr int SUM_LANES = 16;       //   x 16 lanes over the partial rows

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// v[j] = p[col + j] for j < 8: 16-byte loads when vec (dim is a multiple
// of 8, so every group of 8 inside the row is aligned), else one element
// at a time; columns past dim read as 0.
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p, int col, int dim, bool vec,
                                      float (&v)[VEC]) {
  if (vec && col + VEC <= dim) {
    if constexpr (sizeof(T) == 2) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + col);
      const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[j] = __bfloat162float(h[j]);
    } else {
      const float4 a = *reinterpret_cast<const float4*>(p + col);
      const float4 b = *reinterpret_cast<const float4*>(p + col + 4);
      v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
      v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = col + j < dim ? to_f32(p[col + j]) : 0.f;
  }
}

// p[col + j] = v[j] (rounded to T) for the columns inside the row.
template <typename T>
__device__ __forceinline__ void store8(T* __restrict__ p, int col, int dim, bool vec,
                                       const float (&v)[VEC]) {
  if (vec && col + VEC <= dim) {
    if constexpr (sizeof(T) == 2) {
      uint4 raw;
      bf16* h = reinterpret_cast<bf16*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) h[j] = __float2bfloat16_rn(v[j]);
      *reinterpret_cast<uint4*>(p + col) = raw;
    } else {
      *reinterpret_cast<float4*>(p + col) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(p + col + 4) = make_float4(v[4], v[5], v[6], v[7]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (col + j < dim) p[col + j] = from_f32<T>(v[j]);
  }
}

// The sum of v over the block, every thread getting the same bits: a
// butterfly of shuffles inside each warp, then the warps' sums in warp
// order. Callers alternate between the two halves of their shared buffer
// from one row to the next, so a fast warp's write for the next row cannot
// land before a slow warp has read this row's sums.
__device__ __forceinline__ float block_sum(float v, float* buf) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) buf[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  const int nwarps = blockDim.x >> 5;
  for (int w = 0; w < nwarps; ++w) s += buf[w];
  return s;
}

template <typename T, int CHUNKS>
__global__ void __launch_bounds__(MAX_THREADS)
rms_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w, T* __restrict__ y,
               float* __restrict__ rstd, int rows, int dim, float eps, bool vec) {
  __shared__ float red[2][MAX_WARPS];
  int cols[CHUNKS];
  float wv[CHUNKS][VEC];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    cols[c] = (threadIdx.x + c * blockDim.x) * VEC;
    load8(w, cols[c], dim, vec, wv[c]);
  }
  int parity = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
    const T* xr = x + (size_t)row * dim;
    float xv[CHUNKS][VEC];
    float ss = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      load8(xr, cols[c], dim, vec, xv[c]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) ss += xv[c][j] * xv[c][j];
    }
    const float r = rsqrtf(block_sum(ss, red[parity]) / (float)dim + eps);
    T* yr = y + (size_t)row * dim;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = (xv[c][j] * r) * wv[c][j];
      store8(yr, cols[c], dim, vec, o);
    }
    if (threadIdx.x == 0) rstd[row] = r;
  }
}

template <typename T, int CHUNKS>
__global__ void __launch_bounds__(MAX_THREADS)
rms_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ rstd, const T* __restrict__ g, T* __restrict__ dx,
               float* __restrict__ dw_part, int rows, int dim, bool vec) {
  __shared__ float red[2][MAX_WARPS];
  int cols[CHUNKS];
  float wv[CHUNKS][VEC], acc[CHUNKS][VEC];
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    cols[c] = (threadIdx.x + c * blockDim.x) * VEC;
    load8(w, cols[c], dim, vec, wv[c]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[c][j] = 0.f;
  }
  int parity = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
    const size_t base = (size_t)row * dim;
    const float r = rstd[row];
    float xh[CHUNKS][VEC], wg[CHUNKS][VEC];
    float s = 0.f;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      float gv[VEC];
      load8(x + base, cols[c], dim, vec, xh[c]);
      load8(g + base, cols[c], dim, vec, gv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        xh[c][j] *= r;
        wg[c][j] = gv[j] * wv[c][j];
        s += wg[c][j] * xh[c][j];
        acc[c][j] += gv[j] * xh[c][j];
      }
    }
    const float mean = block_sum(s, red[parity]) / (float)dim;
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      float o[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = r * (wg[c][j] - xh[c][j] * mean);
      store8(dx + base, cols[c], dim, vec, o);
    }
  }
  float* part = dw_part + (size_t)blockIdx.x * dim;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) store8(part, cols[c], dim, vec, acc[c]);
}

// dw[c] = sum over b < nparts of part[b, c]: lane y of a column adds rows
// y, y + 16, ... in order, then lane 0 adds the 16 lane sums in order.
__global__ void __launch_bounds__(SUM_COLS * SUM_LANES)
rms_dw_sum_kernel(const float* __restrict__ part, float* __restrict__ dw, int nparts,
                  int dim) {
  __shared__ float sums[SUM_LANES][SUM_COLS];
  const int col = blockIdx.x * SUM_COLS + threadIdx.x;
  float s = 0.f;
  if (col < dim)
    for (int b = threadIdx.y; b < nparts; b += SUM_LANES) s += part[(size_t)b * dim + col];
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < dim) {
    float total = 0.f;
#pragma unroll
    for (int l = 0; l < SUM_LANES; ++l) total += sums[l][threadIdx.x];
    dw[col] = total;
  }
}

// Threads a block and chunks a thread for rows of dim columns.
void block_shape(int dim, int* chunks, int* threads) {
  const int nvec = (dim + VEC - 1) / VEC;
  *chunks = nvec <= MAX_THREADS ? 1 : nvec <= 2 * MAX_THREADS ? 2 : 4;
  *threads = ((nvec + *chunks - 1) / *chunks + 31) / 32 * 32;
}

// As many blocks as are resident on the current card at once, at most one
// a row.
template <typename Kernel>
int resident_grid(Kernel kernel, int threads, int rows) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  const long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  return (int)(grid < rows ? grid : rows);
}

template <typename T, int CHUNKS>
int fwd_launch(const void* x, const void* w, void* y, void* rstd, int rows, int dim,
               float eps, int threads, cudaStream_t stream) {
  const int grid = resident_grid(rms_fwd_kernel<T, CHUNKS>, threads, rows);
  rms_fwd_kernel<T, CHUNKS><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<T*>(y),
      static_cast<float*>(rstd), rows, dim, eps, dim % VEC == 0);
  return (int)cudaGetLastError();
}

template <typename T, int CHUNKS>
int bwd_grid(int rows, int threads) {
  return resident_grid(rms_bwd_kernel<T, CHUNKS>, threads, rows);
}

template <typename T, int CHUNKS>
int bwd_launch(const void* x, const void* w, const void* rstd, const void* g, void* dx,
               void* dw_part, void* dw, int rows, int dim, int grid, int threads,
               cudaStream_t stream) {
  rms_bwd_kernel<T, CHUNKS><<<grid, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w),
      static_cast<const float*>(rstd), static_cast<const T*>(g), static_cast<T*>(dx),
      static_cast<float*>(dw_part), rows, dim, dim % VEC == 0);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rms_dw_sum_kernel<<<(dim + SUM_COLS - 1) / SUM_COLS, dim3(SUM_COLS, SUM_LANES), 0,
                      stream>>>(static_cast<const float*>(dw_part), static_cast<float*>(dw),
                                grid, dim);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// The grid rms_bwd must be given (and the rows of its dw_part) for rows x
// dim on the current card; the same inputs always give the same grid.
int rms_bwd_grid(int rows, int dim, int is_bf16) {
  int chunks, threads;
  block_shape(dim, &chunks, &threads);
  switch (chunks * 2 + (is_bf16 ? 1 : 0)) {
    case 2: return bwd_grid<float, 1>(rows, threads);
    case 3: return bwd_grid<bf16, 1>(rows, threads);
    case 4: return bwd_grid<float, 2>(rows, threads);
    case 5: return bwd_grid<bf16, 2>(rows, threads);
    case 8: return bwd_grid<float, 4>(rows, threads);
    default: return bwd_grid<bf16, 4>(rows, threads);
  }
}

// y (rows, dim) and rstd (rows) from x (rows, dim) and w (dim); dim <= 32768.
int rms_fwd(const void* x, const void* w, void* y, void* rstd, int rows, int dim, float eps,
            int is_bf16, void* stream) {
  int chunks, threads;
  block_shape(dim, &chunks, &threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunks * 2 + (is_bf16 ? 1 : 0)) {
    case 2: return fwd_launch<float, 1>(x, w, y, rstd, rows, dim, eps, threads, s);
    case 3: return fwd_launch<bf16, 1>(x, w, y, rstd, rows, dim, eps, threads, s);
    case 4: return fwd_launch<float, 2>(x, w, y, rstd, rows, dim, eps, threads, s);
    case 5: return fwd_launch<bf16, 2>(x, w, y, rstd, rows, dim, eps, threads, s);
    case 8: return fwd_launch<float, 4>(x, w, y, rstd, rows, dim, eps, threads, s);
    default: return fwd_launch<bf16, 4>(x, w, y, rstd, rows, dim, eps, threads, s);
  }
}

// dx (rows, dim) and dw (dim) from x, w, rstd and g; dw_part is (grid, dim)
// f32 scratch, grid the value of rms_bwd_grid for the same rows and dim.
int rms_bwd(const void* x, const void* w, const void* rstd, const void* g, void* dx,
            void* dw_part, void* dw, int rows, int dim, int grid, int is_bf16, void* stream) {
  int chunks, threads;
  block_shape(dim, &chunks, &threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (chunks * 2 + (is_bf16 ? 1 : 0)) {
    case 2:
      return bwd_launch<float, 1>(x, w, rstd, g, dx, dw_part, dw, rows, dim, grid, threads, s);
    case 3:
      return bwd_launch<bf16, 1>(x, w, rstd, g, dx, dw_part, dw, rows, dim, grid, threads, s);
    case 4:
      return bwd_launch<float, 2>(x, w, rstd, g, dx, dw_part, dw, rows, dim, grid, threads, s);
    case 5:
      return bwd_launch<bf16, 2>(x, w, rstd, g, dx, dw_part, dw, rows, dim, grid, threads, s);
    case 8:
      return bwd_launch<float, 4>(x, w, rstd, g, dx, dw_part, dw, rows, dim, grid, threads, s);
    default:
      return bwd_launch<bf16, 4>(x, w, rstd, g, dx, dw_part, dw, rows, dim, grid, threads, s);
  }
}

}  // extern "C"
