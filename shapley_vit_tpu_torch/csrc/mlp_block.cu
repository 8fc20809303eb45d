// Fused LayerNorm -> MLP -> residual for Hopper (sm_90a).
//
// Replaces: shapley_vit_tpu/ops/mlp_block.py, _mlp_kernel (Pallas, entry
// fused_mlp_block). out = x + GELU(LN(x) W1 + b1) W2 + b2 over [M, D] tokens:
// LN with float32 statistics and the caller's eps; y cast to the weights'
// dtype before the first product; erf GELU (or the tanh form) in float32;
// h cast to the weights' dtype before the second product; float32
// accumulation; the residual added in float32; the output in x's dtype. The
// [M, 4D] hidden activation is never written to device memory.
//
// Bound on an H100 SXM at the main-path shape (M = 176,512 tokens =
// 7 coalitions x 128 images x 197, D = 768, hidden 3072, bf16):
// 4*M*D*3072 = 1.67 TFLOP over 989 TFLOP/s = 1.68 ms, against 0.55 GB of
// tokens and weights over 3.35 TB/s = 0.16 ms; so bound by operations.
//
// Design: the Pallas kernel keeps all of W1 and W2 on chip (9.4 MB in bf16),
// far past the 227 KB of shared memory a Hopper block can use, so this
// kernel streams the hidden dimension instead. One block of 256 threads
// takes 32 tokens: it applies LN once and keeps y (rounded through the
// weight dtype) in shared memory; then for each chunk of hidden units it
// computes gelu(y W1[:, c] + b1[c]), rounds it through the weight dtype,
// and accumulates it times W2[c, :] into a float32 [32, D] accumulator held
// in registers (D/8 values a thread: 96 for D = 768).
//  * bf16 (the main path, when the hidden width is a multiple of 128 and
//    the weights are 32-byte aligned): both products run on the tensor
//    cores through WMMA 16x16x16 bf16 fragments with float32 accumulation;
//    each warp owns one 16-column tile of the chunk's hidden units and a
//    32 x D/8 slice of the output (2 x D/128 accumulator fragments); the
//    weight fragments are read straight from device memory (L2), with no
//    staging, TMA or pipelining yet.
//  * float32 (the parity path) and other shapes: the same tiling on the
//    FMA units, from W1/W2 tiles staged in shared memory.
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int TT = 32;        // tokens per block
constexpr int HC = 64;        // hidden units per chunk
constexpr int KS = 32;        // k slice of the staged W1 tile
constexpr int JS = 16;        // hidden rows of the staged W2 tile
constexpr int THREADS = 256;
constexpr int YPAD = 4;       // ys row padding (floats): keeps 16-byte rows, spreads banks

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)TT * (D + YPAD) + KS * HC + HC * TT + (size_t)JS * D);
}

__device__ __forceinline__ float gelu(float x, int approximate) {
  if (approximate) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
  }
  return 0.5f * x * erfcf(-x * 0.7071067811865476f);  // jax.nn.gelu's exact form
}

// LayerNorm of tokens m0 .. m0+TT-1 into the shared tile ys (row stride
// ys_stride), float32 statistics, y rounded through T (rows past M are 0).
// Warp w normalizes rows 4w .. 4w+3.
template <typename T, int D, typename Y>
__device__ __forceinline__ void layer_norm_tile(const T* __restrict__ x, const T* __restrict__ ln_s,
                                                const T* __restrict__ ln_b, Y* ys, int ys_stride,
                                                int M, int m0, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int rr = 0; rr < TT / 8; ++rr) {
    const int r = warp * (TT / 8) + rr;
    const int m = m0 + r;
    Y* yrow = ys + r * ys_stride;
    if (m >= M) {
      for (int d = lane; d < D; d += 32) yrow[d] = svt::from_f32<Y>(0.f);
      continue;
    }
    const T* xrow = x + (size_t)m * D;
    float sum = 0.f;
    for (int d = lane; d < D; d += 32) sum += svt::to_f32(xrow[d]);
    const float mean = svt::warp_sum(sum) / D;
    float sq = 0.f;
    for (int d = lane; d < D; d += 32) {
      const float c = svt::to_f32(xrow[d]) - mean;
      sq = fmaf(c, c, sq);
    }
    const float rstd = rsqrtf(svt::warp_sum(sq) / D + eps);
    for (int d = lane; d < D; d += 32) {
      const float y = (svt::to_f32(xrow[d]) - mean) * rstd * svt::to_f32(ln_s[d]) +
                      svt::to_f32(ln_b[d]);
      yrow[d] = svt::from_f32<Y>(svt::round_to<T>(y));
    }
  }
}

// NC = D / 128: each thread owns NC groups of 4 output columns
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS, 1)
mlp_block_kernel(const T* __restrict__ x, const T* __restrict__ ln_s,
                 const T* __restrict__ ln_b, const T* __restrict__ w1,
                 const T* __restrict__ b1, const T* __restrict__ w2,
                 const T* __restrict__ b2, T* __restrict__ out, int M, int Hd,
                 float eps, int approximate) {
  constexpr int D = 128 * NC;
  constexpr int YS = D + YPAD;
  extern __shared__ __align__(16) float smem[];
  float* ys = smem;              // [TT][YS]  LN(x), rounded through T
  float* w1s = ys + TT * YS;     // [KS][HC]
  float* hs = w1s + KS * HC;     // [HC][TT]  gelu(h), rounded through T
  float* w2s = hs + HC * TT;     // [JS][D]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * TT;

  // 1. LN(x) into ys
  layer_norm_tile<T, D>(x, ln_s, ln_b, ys, YS, M, m0, eps);
  __syncthreads();

  // second-product mapping: warp = 4 rows, lane = column groups
  float acc[4][NC][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < NC; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][i][e] = 0.f;

  // first-product mapping: rows 2*ty, 2*ty+1; hidden units 4*tx .. 4*tx+3
  const int ty = tid / 16, tx = tid % 16;

  for (int c0 = 0; c0 < Hd; c0 += HC) {
    // 2. h = y W1[:, c0:c0+HC]
    float hacc[2][4];
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) hacc[r][j] = 0.f;
    for (int k0 = 0; k0 < D; k0 += KS) {
      for (int i = tid; i < KS * HC; i += THREADS) {
        const int kk = i / HC, n = i % HC;
        const int col = c0 + n;
        w1s[i] = col < Hd ? svt::to_f32(w1[(size_t)(k0 + kk) * Hd + col]) : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < KS; ++kk) {
        const float a0 = ys[(2 * ty) * YS + k0 + kk];
        const float a1 = ys[(2 * ty + 1) * YS + k0 + kk];
        const float4 bv = *reinterpret_cast<const float4*>(w1s + kk * HC + 4 * tx);
        hacc[0][0] = fmaf(a0, bv.x, hacc[0][0]);
        hacc[0][1] = fmaf(a0, bv.y, hacc[0][1]);
        hacc[0][2] = fmaf(a0, bv.z, hacc[0][2]);
        hacc[0][3] = fmaf(a0, bv.w, hacc[0][3]);
        hacc[1][0] = fmaf(a1, bv.x, hacc[1][0]);
        hacc[1][1] = fmaf(a1, bv.y, hacc[1][1]);
        hacc[1][2] = fmaf(a1, bv.z, hacc[1][2]);
        hacc[1][3] = fmaf(a1, bv.w, hacc[1][3]);
      }
      __syncthreads();
    }
    // 3. gelu(h + b1), rounded through T, into hs[unit][row]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = c0 + 4 * tx + j;
      const float bias = col < Hd ? svt::to_f32(b1[col]) : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float hv = col < Hd ? svt::round_to<T>(gelu(hacc[r][j] + bias, approximate)) : 0.f;
        hs[(4 * tx + j) * TT + 2 * ty + r] = hv;
      }
    }
    __syncthreads();

    // 4. acc += gelu(h) W2[c0:c0+HC, :], W2 staged JS rows at a time
    for (int j0 = 0; j0 < HC; j0 += JS) {
      for (int i = tid; i < JS * D; i += THREADS) {
        const int jj = i / D, d = i % D;
        const int unit = c0 + j0 + jj;
        w2s[i] = unit < Hd ? svt::to_f32(w2[(size_t)unit * D + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < JS; ++jj) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + (j0 + jj) * TT + 4 * warp);
        const float* wrow = w2s + jj * D + 4 * lane;
#pragma unroll
        for (int i = 0; i < NC; ++i) {
          const float4 wv = *reinterpret_cast<const float4*>(wrow + 128 * i);
          acc[0][i][0] = fmaf(hv.x, wv.x, acc[0][i][0]);
          acc[0][i][1] = fmaf(hv.x, wv.y, acc[0][i][1]);
          acc[0][i][2] = fmaf(hv.x, wv.z, acc[0][i][2]);
          acc[0][i][3] = fmaf(hv.x, wv.w, acc[0][i][3]);
          acc[1][i][0] = fmaf(hv.y, wv.x, acc[1][i][0]);
          acc[1][i][1] = fmaf(hv.y, wv.y, acc[1][i][1]);
          acc[1][i][2] = fmaf(hv.y, wv.z, acc[1][i][2]);
          acc[1][i][3] = fmaf(hv.y, wv.w, acc[1][i][3]);
          acc[2][i][0] = fmaf(hv.z, wv.x, acc[2][i][0]);
          acc[2][i][1] = fmaf(hv.z, wv.y, acc[2][i][1]);
          acc[2][i][2] = fmaf(hv.z, wv.z, acc[2][i][2]);
          acc[2][i][3] = fmaf(hv.z, wv.w, acc[2][i][3]);
          acc[3][i][0] = fmaf(hv.w, wv.x, acc[3][i][0]);
          acc[3][i][1] = fmaf(hv.w, wv.y, acc[3][i][1]);
          acc[3][i][2] = fmaf(hv.w, wv.z, acc[3][i][2]);
          acc[3][i][3] = fmaf(hv.w, wv.w, acc[3][i][3]);
        }
      }
      __syncthreads();
    }
  }

  // 5. out = x + (acc + b2), in float32, stored in T
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int m = m0 + 4 * warp + r;
    if (m >= M) continue;
    const T* xrow = x + (size_t)m * D;
    T* orow = out + (size_t)m * D;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 128 * i + 4 * lane + e;
        orow[d] = svt::from_f32<T>(svt::to_f32(xrow[d]) + (acc[r][i][e] + svt::to_f32(b2[d])));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int TC_HC = 128;  // hidden units per chunk: one 16-unit tile per warp

__host__ __device__ constexpr size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }

// shared layout: ys bf16 [TT][D+8] | hf f32 [TT][TC_HC+4] | hb bf16 [TT][TC_HC+8]
// | of f32 [TT][D+4]; every fragment's first element stays 32-byte aligned
size_t tc_smem_bytes(int D) {
  return align128((size_t)TT * (D + 8) * 2) + align128((size_t)TT * (TC_HC + 4) * 4) +
         align128((size_t)TT * (TC_HC + 8) * 2) + align128((size_t)TT * (D + 4) * 4);
}

template <int NC>
__global__ void __launch_bounds__(THREADS, 1)
mlp_block_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ln_s,
                    const bf16* __restrict__ ln_b, const bf16* __restrict__ w1,
                    const bf16* __restrict__ b1, const bf16* __restrict__ w2,
                    const bf16* __restrict__ b2, bf16* __restrict__ out, int M, int Hd,
                    float eps, int approximate) {
  constexpr int D = 128 * NC;
  constexpr int YS = D + 8;        // bf16 elements
  constexpr int HFS = TC_HC + 4;   // floats
  constexpr int HBS = TC_HC + 8;   // bf16 elements
  constexpr int OS = D + 4;        // floats
  constexpr int WCOLS = 16 * NC;   // output columns a warp owns
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* ys = reinterpret_cast<bf16*>(smem_tc);
  float* hf = reinterpret_cast<float*>(smem_tc + align128((size_t)TT * YS * 2));
  bf16* hb = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(hf) +
                                     align128((size_t)TT * HFS * 4));
  float* of = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(hb) +
                                       align128((size_t)TT * HBS * 2));

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int m0 = blockIdx.x * TT;

  // 1. LN(x) into ys (bf16)
  layer_norm_tile<bf16, D>(x, ln_s, ln_b, ys, YS, M, m0, eps);
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NC];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j) wmma::fill_fragment(acc[r][j], 0.f);

  for (int c0 = 0; c0 < Hd; c0 += TC_HC) {
    // 2. h = y W1[:, c0:c0+128]: warp w computes hidden units c0+16w .. c0+16w+15
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> hacc[2];
    wmma::fill_fragment(hacc[0], 0.f);
    wmma::fill_fragment(hacc[1], 0.f);
    const bf16* w1c = w1 + c0 + 16 * warp;
#pragma unroll 4
    for (int k = 0; k < D; k += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
      wmma::load_matrix_sync(bw, w1c + (size_t)k * Hd, Hd);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ay;
        wmma::load_matrix_sync(ay, ys + 16 * r * YS + k, YS);
        wmma::mma_sync(hacc[r], ay, bw, hacc[r]);
      }
    }
    wmma::store_matrix_sync(hf + 16 * warp, hacc[0], HFS, wmma::mem_row_major);
    wmma::store_matrix_sync(hf + 16 * HFS + 16 * warp, hacc[1], HFS, wmma::mem_row_major);
    __syncthreads();

    // 3. gelu(h + b1) in float32, rounded to bf16, into hb
    for (int i = tid; i < TT * TC_HC; i += THREADS) {
      const int r = i / TC_HC, n = i % TC_HC;
      const float h = hf[r * HFS + n] + svt::to_f32(b1[c0 + n]);
      hb[r * HBS + n] = svt::from_f32<bf16>(gelu(h, approximate));
    }
    __syncthreads();

    // 4. acc += gelu(h) W2[c0:c0+128, warp's columns]
    const bf16* w2c = w2 + (size_t)c0 * D + warp * WCOLS;
#pragma unroll 2
    for (int kk = 0; kk < TC_HC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ah[2];
      wmma::load_matrix_sync(ah[0], hb + kk, HBS);
      wmma::load_matrix_sync(ah[1], hb + 16 * HBS + kk, HBS);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
        wmma::load_matrix_sync(bw, w2c + (size_t)kk * D + 16 * j, D);
        wmma::mma_sync(acc[0][j], ah[0], bw, acc[0][j]);
        wmma::mma_sync(acc[1][j], ah[1], bw, acc[1][j]);
      }
    }
    __syncthreads();  // hf and hb are rewritten by the next chunk
  }

  // 5. out = x + (acc + b2), in float32, stored in bf16
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < NC; ++j)
      wmma::store_matrix_sync(of + 16 * r * OS + warp * WCOLS + 16 * j, acc[r][j], OS,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < TT * D; i += THREADS) {
    const int r = i / D, d = i % D;
    const int m = m0 + r;
    if (m < M) {
      const size_t g = (size_t)m * D + d;
      out[g] = svt::from_f32<bf16>(svt::to_f32(x[g]) + (of[r * OS + d] + svt::to_f32(b2[d])));
    }
  }
}

template <typename T, int NC>
int launch_nc(const void* x, const void* ln_s, const void* ln_b, const void* w1,
              const void* b1, const void* w2, const void* b2, void* out, int M,
              int Hd, float eps, int approximate, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((M + TT - 1) / TT);
  if constexpr (std::is_same_v<T, bf16>) {
    // WMMA fragments need 32-byte aligned tiles: whole 128-unit chunks and
    // aligned weight tensors
    const bool aligned = ((reinterpret_cast<std::uintptr_t>(w1) |
                           reinterpret_cast<std::uintptr_t>(w2)) % 32) == 0;
    if (Hd % TC_HC == 0 && aligned) {
      const size_t smem = tc_smem_bytes(128 * NC);
      cudaError_t err = cudaFuncSetAttribute(mlp_block_tc_kernel<NC>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      mlp_block_tc_kernel<NC><<<grid, THREADS, smem, st>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(ln_s),
          static_cast<const bf16*>(ln_b), static_cast<const bf16*>(w1),
          static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
          static_cast<const bf16*>(b2), static_cast<bf16*>(out), M, Hd, eps, approximate);
      return static_cast<int>(cudaGetLastError());
    }
  }
  const size_t smem = smem_bytes(128 * NC);
  cudaError_t err = cudaFuncSetAttribute(mlp_block_kernel<T, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mlp_block_kernel<T, NC><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(ln_s), static_cast<const T*>(ln_b),
      static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
      static_cast<const T*>(b2), static_cast<T*>(out), M, Hd, eps, approximate);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* x, const void* ln_s, const void* ln_b, const void* w1,
           const void* b1, const void* w2, const void* b2, void* out, int M, int D,
           int Hd, float eps, int approximate, void* stream) {
  switch (D) {
    case 384:
      return launch_nc<T, 3>(x, ln_s, ln_b, w1, b1, w2, b2, out, M, Hd, eps, approximate, stream);
    case 768:
      return launch_nc<T, 6>(x, ln_s, ln_b, w1, b1, w2, b2, out, M, Hd, eps, approximate, stream);
    case 1024:
      return launch_nc<T, 8>(x, ln_s, ln_b, w1, b1, w2, b2, out, M, Hd, eps, approximate, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

int svt_mlp_block_f32(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                      const void* b1, const void* w2, const void* b2, void* out, int M,
                      int D, int Hd, float eps, int approximate, void* stream) {
  return launch<float>(x, ln_s, ln_b, w1, b1, w2, b2, out, M, D, Hd, eps, approximate, stream);
}

int svt_mlp_block_bf16(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                       const void* b1, const void* w2, const void* b2, void* out, int M,
                       int D, int Hd, float eps, int approximate, void* stream) {
  return launch<__nv_bfloat16>(x, ln_s, ln_b, w1, b1, w2, b2, out, M, D, Hd, eps,
                               approximate, stream);
}

}  // extern "C"
