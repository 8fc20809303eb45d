// LayerNorm over the rows of a token matrix for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's LayerNorm before attention and
// at the end of the encoder is jnp ops, which XLA fuses into one pass. In
// PyTorch the same arithmetic is about twelve launches over the whole
// activation (a float32 copy, two means, subtractions, a square, rsqrt,
// the scale and bias, the cast back), most of them in float32 and through
// the generic strided elementwise kernel. This kernel is that arithmetic in
// one pass: y = (x - mean) * rsqrt(var + eps) * scale + bias over each row
// of x [M, D] (row stride ldx), with float32 statistics, the two-pass
// variance mean((x - mean)^2), float32 scale and bias, and y rounded to x's
// storage type (round to nearest even). The products and the sums are
// rounded one by one as the torch ops round them (no fused multiply-add);
// only the order of the row's sums differs.
//
// Bound on an H100 SXM: by bytes. At the round's shape (M = 176,512 tokens
// = 7 coalitions x 128 images x 197, D = 768, bf16) a call reads 271 MB and
// writes 271 MB: 0.162 ms at 3.35 TB/s; ~12 flops a value, far below the
// card's operations per byte. So the design reads each row once:
//  * one warp per row, 8 rows per block; blocks stride over the rows, at
//    most 8 resident blocks per SM, so each block loads the scale and bias
//    (2 D floats) into shared memory once and uses them for many rows;
//  * the row is held in registers as 16-byte vectors, NV per lane (3 at
//    D = 768 bf16, 4 at 1024; 6 and 8 in float32), read and written with
//    16-byte loads and stores, neighbouring lanes on neighbouring vectors;
//  * mean and variance from those registers by warp shuffles, so x is read
//    from device memory once and y written once;
//  * the scale and bias sit in shared memory as float4s in the vectors'
//    order (first float4 of every vector, then the second), so a warp's
//    float4 reads of them are free of bank conflicts.
// Rows whose width or stride is not a whole number of 16-byte vectors, rows
// that are not 16-byte aligned, and rows wider than 32 x 8 vectors (2,048
// bf16, 1,024 float32) take a scalar loop that reads x three times (the
// caller picks the route from the shape; the vector entry refuses what it
// cannot take).

#include <cstdint>

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;
using svt::from_f32;
using svt::to_f32;
using svt::warp_sum;

constexpr int ROWS = 8;                 // rows in flight per block, one warp each
constexpr int THREADS = 32 * ROWS;
constexpr int MAX_NV = 8;               // 16-byte vectors a lane holds
constexpr int BLOCKS_PER_SM = 8;        // 2,048 threads: an SM's most

// 16 bytes of T as E floats, and back (round to nearest even)
template <typename T> struct Vec;
template <> struct Vec<bf16> {
  static constexpr int E = 8;
  // a 32-bit word holds two bf16, the first in its low half; bf16 -> float
  // is exact, the high 16 bits of the float's pattern
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
      w[i] = static_cast<unsigned>(__bfloat16_as_ushort(h.x)) |
             (static_cast<unsigned>(__bfloat16_as_ushort(h.y)) << 16);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Vec<float> {
  static constexpr int E = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* f) {
    f[0] = __uint_as_float(v.x);
    f[1] = __uint_as_float(v.y);
    f[2] = __uint_as_float(v.z);
    f[3] = __uint_as_float(v.w);
  }
  __device__ __forceinline__ static uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                      __float_as_uint(f[3]));
  }
};

// y = (x - mean) * rstd * s + b, each product and the sum rounded on its own
__device__ __forceinline__ float normalise(float x, float mean, float rstd, float s, float b) {
  return __fadd_rn(__fmul_rn(__fmul_rn(x - mean, rstd), s), b);
}

// The vector route: NV 16-byte vectors of a row per lane (V = D / E in all,
// lane l holding vectors l, l + 32, ...).
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
layer_norm_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                       const float* __restrict__ bias, T* __restrict__ y, int M, int D,
                       long long ldx, float eps) {
  constexpr int E = Vec<T>::E;
  constexpr int Q = E / 4;             // float4s of scale (or bias) per vector
  const int V = D / E;
  extern __shared__ float4 sb[];       // scale, then bias: float4 q of vector j at q * V + j
  float4* s4 = sb;
  float4* b4 = sb + Q * V;
  float* sf = reinterpret_cast<float*>(s4);
  float* bf = reinterpret_cast<float*>(b4);
  for (int i = threadIdx.x; i < D; i += THREADS) {
    const int j = i / E, e = i % E;
    const int at = ((e / 4) * V + j) * 4 + e % 4;
    sf[at] = scale[i];
    bf[at] = bias[i];
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  for (long long row = (long long)blockIdx.x * ROWS + threadIdx.x / 32; row < M;
       row += (long long)gridDim.x * ROWS) {
    const uint4* xr = reinterpret_cast<const uint4*>(x + row * ldx);
    uint4 v[NV];
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = lane + 32 * i;
      if (j < V) v[i] = xr[j];
    }
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < V) {
        float f[E];
        Vec<T>::unpack(v[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) sum += f[e];
      }
    }
    const float mean = warp_sum(sum) / static_cast<float>(D);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      if (lane + 32 * i < V) {
        float f[E];
        Vec<T>::unpack(v[i], f);
#pragma unroll
        for (int e = 0; e < E; ++e) {
          const float c = f[e] - mean;
          sq = __fadd_rn(sq, __fmul_rn(c, c));
        }
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + row * D);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = lane + 32 * i;
      if (j < V) {
        float f[E], o[E];
        Vec<T>::unpack(v[i], f);
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          const float4 s = s4[q * V + j], b = b4[q * V + j];
          o[4 * q] = normalise(f[4 * q], mean, rstd, s.x, b.x);
          o[4 * q + 1] = normalise(f[4 * q + 1], mean, rstd, s.y, b.y);
          o[4 * q + 2] = normalise(f[4 * q + 2], mean, rstd, s.z, b.z);
          o[4 * q + 3] = normalise(f[4 * q + 3], mean, rstd, s.w, b.w);
        }
        yr[j] = Vec<T>::pack(o);
      }
    }
  }
}

// The scalar route: any width, stride and alignment; x read three times.
template <typename T>
__global__ void __launch_bounds__(THREADS)
layer_norm_rows_scalar_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                              const float* __restrict__ bias, T* __restrict__ y, int M, int D,
                              long long ldx, float eps) {
  const int lane = threadIdx.x % 32;
  for (long long row = (long long)blockIdx.x * ROWS + threadIdx.x / 32; row < M;
       row += (long long)gridDim.x * ROWS) {
    const T* xr = x + row * ldx;
    float sum = 0.f;
    for (int d = lane; d < D; d += 32) sum += to_f32(xr[d]);
    const float mean = warp_sum(sum) / static_cast<float>(D);
    float sq = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float c = to_f32(xr[d]) - mean;
      sq = __fadd_rn(sq, __fmul_rn(c, c));
    }
    const float rstd = rsqrtf(warp_sum(sq) / static_cast<float>(D) + eps);
    T* yr = y + row * D;
    for (int d = lane; d < D; d += 32) yr[d] = from_f32<T>(normalise(to_f32(xr[d]), mean, rstd, scale[d], bias[d]));
  }
}

bool is_aligned(const void* p, int bytes) { return reinterpret_cast<std::uintptr_t>(p) % bytes == 0; }

template <typename T, int NV>
int launch_vector(const T* x, const float* s, const float* b, T* y, int M, int D, long long ldx, float eps,
                  unsigned grid, cudaStream_t st) {
  const size_t smem = 2 * static_cast<size_t>(D) * sizeof(float);
  layer_norm_rows_kernel<T, NV><<<grid, THREADS, smem, st>>>(x, s, b, y, M, D, ldx, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* x, const float* s, const float* b, T* y, int M, int D, long long ldx, float eps, int vector,
           cudaStream_t st) {
  if (M < 0 || D <= 0 || ldx < D) return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0) return 0;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (M + ROWS - 1) / ROWS;
  const unsigned grid = static_cast<unsigned>(blocks < (long long)sms * BLOCKS_PER_SM ? blocks
                                                                                      : (long long)sms * BLOCKS_PER_SM);
  if (!vector) {
    layer_norm_rows_scalar_kernel<T><<<grid, THREADS, 0, st>>>(x, s, b, y, M, D, ldx, eps);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr int E = Vec<T>::E;
  if (D % E || ldx % E || !is_aligned(x, 16) || !is_aligned(y, 16)) return static_cast<int>(cudaErrorInvalidValue);
  switch ((D / E + 31) / 32) {
    case 1: return launch_vector<T, 1>(x, s, b, y, M, D, ldx, eps, grid, st);
    case 2: return launch_vector<T, 2>(x, s, b, y, M, D, ldx, eps, grid, st);
    case 3: return launch_vector<T, 3>(x, s, b, y, M, D, ldx, eps, grid, st);
    case 4: return launch_vector<T, 4>(x, s, b, y, M, D, ldx, eps, grid, st);
    case 5: return launch_vector<T, 5>(x, s, b, y, M, D, ldx, eps, grid, st);
    case 6: return launch_vector<T, 6>(x, s, b, y, M, D, ldx, eps, grid, st);
    case 7: return launch_vector<T, 7>(x, s, b, y, M, D, ldx, eps, grid, st);
    case MAX_NV: return launch_vector<T, MAX_NV>(x, s, b, y, M, D, ldx, eps, grid, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// y [M, D] (contiguous) = LN of the rows of x (row stride ldx elements) with
// float32 scale [D] and bias [D]. vector = 1: the 16-byte vector route (D
// and ldx whole vectors, x and y 16-byte aligned, D at most 2,048; else
// cudaErrorInvalidValue, before any launch); vector = 0: the scalar route.
int svt_layer_norm_bf16(const void* x, const void* scale, const void* bias, void* y, int M, int D,
                        long long ldx, float eps, int vector, void* stream) {
  return launch(static_cast<const bf16*>(x), static_cast<const float*>(scale), static_cast<const float*>(bias),
                static_cast<bf16*>(y), M, D, ldx, eps, vector, static_cast<cudaStream_t>(stream));
}

// the same in float32 (D at most 1,024 on the vector route)
int svt_layer_norm_f32(const void* x, const void* scale, const void* bias, void* y, int M, int D,
                       long long ldx, float eps, int vector, void* stream) {
  return launch(static_cast<const float*>(x), static_cast<const float*>(scale), static_cast<const float*>(bias),
                static_cast<float*>(y), M, D, ldx, eps, vector, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
