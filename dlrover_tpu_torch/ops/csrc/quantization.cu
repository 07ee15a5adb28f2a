// Groupwise symmetric quantize / dequantize for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of dlrover_tpu/ops/quantization.py:
//   quantize_kernel   <- _quantize_kernel   (:48-55, launched by quantize :86)
//   dequantize_kernel <- _dequantize_kernel (:58-60, launched by dequantize :120)
//
// Semantics, to the bit, per group of `group` consecutive values:
//   absmax = max |x| in f32;
//   scale  = absmax * (1 / qmax), the reciprocal rounded to f32 once: what
//            XLA compiles the reference's absmax / qmax to (a division by a
//            constant becomes a product with its reciprocal), so a plain
//            IEEE division would differ from the reference in the last bit;
//   inv    = scale > 0 ? 1 / scale : 0, an IEEE division;
//   q      = clamp(rint(x * inv), -qmax, qmax), rint rounding half to even
//            as jnp.round does (roundf would round ties away from zero).
// Dequantize is q * scale in f32, rounded to the output type. The library
// is built without fast math, so each of these is the IEEE operation and
// the kernels equal their plain PyTorch versions bit for bit. int4 packing
// stays outside the kernel, as in the reference.
//
// What bounds them on the H100: a compare, a multiply and a round per
// value against 5 bytes moved (f32 in, int8 out; the other way for
// dequantize), far below the ~295 FLOP/byte ridge: device-memory bytes.
// At a Llama-1B gate_proj gradient (2048 x 5504 f32, groups of 128) each
// moves 56.7 MB, 0.017 ms at 3.35 TB/s.
//
// Design: one warp a group, eight groups a block. The lanes stride the
// group, each lane taking V neighbouring values (V = 4 when the group is a
// multiple of 4 and the pointers 16-byte aligned: one 16-byte f32 load, an
// 8-byte bf16 one, a 4-byte store of codes; else V = 1), so each pass of
// the warp is one coalesced stretch; quantize reduces |x| with shuffles
// and reads the group again (from cache) to quantize it. One warp a group
// also means no division of an element index by the group size on the way
// to its scale. Any group size works; a group shorter than 32·V idles some
// lanes.
//
// Layout: x / out (rows, group) contiguous, q int8 (rows, group), scales
// (rows) f32. Each entry point launches on the given stream, never
// synchronises, allocates nothing and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int WARPS = 8;             // groups a block handles at once
constexpr int THREADS = WARPS * 32;
constexpr long long MAX_BLOCKS = 1 << 20;

// V values from p (aligned to V elements of T when V = 4).
template <int V>
__device__ __forceinline__ void load_v(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void load_v(const bf16* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __bfloat162float(h[j]);
  } else {
    v[0] = __bfloat162float(*p);
  }
}

template <int V>
__device__ __forceinline__ void store_v(float* p, const float (&v)[V]) {
  if constexpr (V == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *p = v[0];
}

template <int V>
__device__ __forceinline__ void store_v(bf16* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    uint2 raw;
    bf16* h = reinterpret_cast<bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 4; ++j) h[j] = __float2bfloat16_rn(v[j]);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
    *p = __float2bfloat16_rn(v[0]);
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
quantize_kernel(const T* __restrict__ x, int8_t* __restrict__ q, float* __restrict__ scales,
                long long rows, int group, int qmax) {
  const int lane = threadIdx.x & 31;
  const long long first = (blockIdx.x * (long long)THREADS + threadIdx.x) >> 5;
  const long long stride = ((long long)gridDim.x * THREADS) >> 5;
  const float fq = (float)qmax;
  const float rcp = 1.0f / fq;
  for (long long r = first; r < rows; r += stride) {
    const T* xr = x + r * group;
    float m = 0.f;
    for (int i = lane * V; i < group; i += 32 * V) {
      float v[V];
      load_v<V>(xr + i, v);
#pragma unroll
      for (int j = 0; j < V; ++j) m = fmaxf(m, fabsf(v[j]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float scale = m * rcp;
    const float inv = scale > 0.f ? 1.0f / scale : 0.f;
    int8_t* qr = q + r * group;
    for (int i = lane * V; i < group; i += 32 * V) {
      float v[V];
      load_v<V>(xr + i, v);
      int8_t c[V];
#pragma unroll
      for (int j = 0; j < V; ++j) c[j] = (int8_t)fminf(fmaxf(rintf(v[j] * inv), -fq), fq);
      if constexpr (V == 4)
        *reinterpret_cast<char4*>(qr + i) = make_char4(c[0], c[1], c[2], c[3]);
      else
        qr[i] = c[0];
    }
    if (lane == 0) scales[r] = scale;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
dequantize_kernel(const int8_t* __restrict__ q, const float* __restrict__ scales,
                  T* __restrict__ out, long long rows, int group) {
  const int lane = threadIdx.x & 31;
  const long long first = (blockIdx.x * (long long)THREADS + threadIdx.x) >> 5;
  const long long stride = ((long long)gridDim.x * THREADS) >> 5;
  for (long long r = first; r < rows; r += stride) {
    const float scale = scales[r];
    const int8_t* qr = q + r * group;
    T* o = out + r * group;
    for (int i = lane * V; i < group; i += 32 * V) {
      float v[V];
      if constexpr (V == 4) {
        const char4 c = *reinterpret_cast<const char4*>(qr + i);
        v[0] = (float)c.x * scale; v[1] = (float)c.y * scale;
        v[2] = (float)c.z * scale; v[3] = (float)c.w * scale;
      } else {
        v[0] = (float)qr[i] * scale;
      }
      store_v<V>(o + i, v);
    }
  }
}

int blocks_for(long long rows) {
  const long long blocks = (rows + WARPS - 1) / WARPS;
  return (int)(blocks < MAX_BLOCKS ? blocks : MAX_BLOCKS);
}

// Four values a lane when every group starts 16-byte aligned in both
// tensors.
bool four_wide(const void* a, const void* b, int group) {
  return group % 4 == 0 && ((uintptr_t)a | (uintptr_t)b) % 16 == 0;
}

template <typename T, int V>
int quantize_launch(const void* x, void* q, void* scales, long long rows, int group,
                    int qmax, cudaStream_t s) {
  quantize_kernel<T, V><<<blocks_for(rows), THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<int8_t*>(q), static_cast<float*>(scales), rows,
      group, qmax);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int dequantize_launch(const void* q, const void* scales, void* out, long long rows, int group,
                      cudaStream_t s) {
  dequantize_kernel<T, V><<<blocks_for(rows), THREADS, 0, s>>>(
      static_cast<const int8_t*>(q), static_cast<const float*>(scales), static_cast<T*>(out),
      rows, group);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* cuda_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

// q (rows, group) int8 and scales (rows) f32 from x (rows, group), f32 or
// bf16; qmax is 127 (int8) or 7 (int4 before packing).
int quantize_rows(const void* x, void* q, void* scales, long long rows, int group, int qmax,
                  int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v4 = four_wide(x, q, group);
  if (is_bf16)
    return v4 ? quantize_launch<bf16, 4>(x, q, scales, rows, group, qmax, s)
              : quantize_launch<bf16, 1>(x, q, scales, rows, group, qmax, s);
  return v4 ? quantize_launch<float, 4>(x, q, scales, rows, group, qmax, s)
            : quantize_launch<float, 1>(x, q, scales, rows, group, qmax, s);
}

// out (rows, group), f32 or bf16, from q (rows, group) int8 and scales (rows).
int dequantize_rows(const void* q, const void* scales, void* out, long long rows, int group,
                    int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v4 = four_wide(q, out, group);
  if (out_bf16)
    return v4 ? dequantize_launch<bf16, 4>(q, scales, out, rows, group, s)
              : dequantize_launch<bf16, 1>(q, scales, out, rows, group, s);
  return v4 ? dequantize_launch<float, 4>(q, scales, out, rows, group, s)
            : dequantize_launch<float, 1>(q, scales, out, rows, group, s);
}

}  // extern "C"
