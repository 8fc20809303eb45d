// Multi-head attention for Hopper (sm_90a), forward only: one kernel body
// and one entry point, svt_attention_bhnd_*, which takes q, k, v, o as
// [B, H, N, d] through their batch, head and row strides.
//
// Replaces (shapley_vit_tpu/ops/attention.py):
//  * _attn_v2_kernel (Pallas, entry fused_attention_packed): q, k, v, o are
//    [B, N, H*d], heads packed in the last axis, keys at or past N masked to
//    -1e30. The wrapper passes the packed layout's strides.
//  * _attn_kernel (Pallas, entry fused_attention, the LoRA training path):
//    q, k, v, o are [B, H, N, d] views, keys past N masked to -inf (the
//    Pallas kernel pads N and d to 128; padded d columns are zeros and add
//    nothing). The view that a head split (reshape + transpose) makes of a
//    packed [B, N, H*d] tensor has the packed strides and is read in place,
//    with no copy.
// Both compute, per (batch, head), o = softmax(mask(q k^T / sqrt(d))) v with
// softmax and both products in float32 and the output stored in q's dtype.
// Masking: the kernel never forms a score for a key past N, which is what
// both -1e30 and -inf give (exp of either, less the row max, is 0).
//
// Bound on an H100 SXM, bf16: at the Shapley round's packed shape (B = 896 =
// 7 coalitions x 128 images, N = 197, H = 12, d = 64) 4*B*H*N^2*d = 0.107
// TFLOP over 989 TFLOP/s = 0.108 ms against q, k, v read and o written
// once, 1.08 GB over 3.35 TB/s = 0.324 ms; at the training step's
// [64, 12, 197, 64], 7.6 GFLOP (0.008 ms) against 77 MB (0.023 ms). Both
// are bound by memory in bf16 (in float32 by the 67 TFLOP/s FMA rate). The
// scores never leave the chip.
//
// Design: the block loads K and V of its (batch, head) — N x 64 each — into
// shared memory, reading them through the strides, and masks keys at or
// past N itself (there are no padded copies).
//  * bf16 with 16-byte aligned pointers and strides (the main paths): one
//    block per (batch, head, 128 query rows),
//    8 warps of 16 rows. q k^T runs on the tensor cores (WMMA bf16
//    fragments, float32 accumulation: bf16 products are exact in float32,
//    so the scores are the Pallas kernel's float32 scores); each warp
//    keeps its 16 x N score rows in shared memory, takes the row max and
//    sum with warp reductions, overwrites the scores with the float32
//    probabilities, and accumulates p v on the FMA units (each lane two
//    output columns of the 16 rows, p read four keys at a time).
//  * float32 (the parity path, and bf16 tensors that are not 16-byte
//    aligned): one block per (batch, head, 64 query rows),
//    all on the FMA units: each of the 8 warps takes 4 query rows at a
//    time, lane l owning keys l, l+32, ..., so one float4 of K feeds the 4
//    rows; K rows are padded to 68 floats so the lanes' float4 reads hit
//    distinct banks.
// No TMA, wgmma or pipelining yet.
#include <mma.h>

#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int HD = 64;          // head dim
constexpr int KSTR = HD + 4;    // K row stride in shared memory (floats)
constexpr int NJ = 7;           // keys per lane: N <= 32 * NJ = 224
constexpr int R = 4;            // query rows a warp handles at once
constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int QT = 64;          // query rows per block
constexpr float MASK = -1e30f;  // the Pallas kernel's mask value

size_t smem_bytes(int N) {
  return sizeof(float) * ((size_t)N * KSTR + (size_t)N * HD + WARPS * R * HD + (size_t)WARPS * N * R);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int N, long long sb,
                 long long sh, long long row_stride, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                    // [N][KSTR]
  float* Vs = Ks + (size_t)N * KSTR;   // [N][HD]
  float* Qs = Vs + (size_t)N * HD;     // [WARPS][R][HD]
  float* Ps = Qs + WARPS * R * HD;     // [WARPS][N][R]

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * QT;
  const size_t base = (size_t)b * sb + (size_t)h * sh;

  for (int i = threadIdx.x; i < N * HD; i += THREADS) {
    const int j = i / HD, d = i % HD;
    const size_t g = base + (size_t)j * row_stride + d;
    Ks[j * KSTR + d] = svt::to_f32(k[g]);
    Vs[j * HD + d] = svt::to_f32(v[g]);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* Qw = Qs + warp * R * HD;
  float* Pw = Ps + (size_t)warp * N * R;
  const int q_end = min(q0 + QT, N);

  for (int r0 = q0 + warp * R; r0 < q_end; r0 += WARPS * R) {
    for (int i = lane; i < R * HD; i += 32) {
      const int r = i / HD, d = i % HD;
      const int row = r0 + r;
      Qw[i] = row < N ? svt::to_f32(q[base + (size_t)row * row_stride + d]) : 0.f;
    }
    __syncwarp();

    float s[R][NJ];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int t = 0; t < NJ; ++t) s[r][t] = 0.f;

#pragma unroll
    for (int t = 0; t < NJ; ++t) {
      const int j = lane + 32 * t;
      if (j < N) {
        const float* kr = Ks + j * KSTR;
#pragma unroll 4
        for (int d = 0; d < HD; d += 4) {
          const float4 kv = *reinterpret_cast<const float4*>(kr + d);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 qv = *reinterpret_cast<const float4*>(Qw + r * HD + d);
            float acc = s[r][t];
            acc = fmaf(qv.x, kv.x, acc);
            acc = fmaf(qv.y, kv.y, acc);
            acc = fmaf(qv.z, kv.z, acc);
            acc = fmaf(qv.w, kv.w, acc);
            s[r][t] = acc;
          }
        }
      }
    }

#pragma unroll
    for (int r = 0; r < R; ++r) {
      float m = MASK;
#pragma unroll
      for (int t = 0; t < NJ; ++t) {
        const int j = lane + 32 * t;
        s[r][t] = j < N ? s[r][t] * scale : MASK;
        m = fmaxf(m, s[r][t]);
      }
      m = svt::warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < NJ; ++t) {
        const float e = expf(s[r][t] - m);  // masked keys: exp(-1e30 - m) == 0
        s[r][t] = e;
        sum += e;
      }
      sum = svt::warp_sum(sum);
#pragma unroll
      for (int t = 0; t < NJ; ++t) {
        const int j = lane + 32 * t;
        if (j < N) Pw[j * R + r] = s[r][t] / sum;
      }
    }
    __syncwarp();

    float acc[R][2];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int j = 0; j < N; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(Pw + j * R);
      const float2 vv = *reinterpret_cast<const float2*>(Vs + j * HD + 2 * lane);
      acc[0][0] = fmaf(p.x, vv.x, acc[0][0]);
      acc[0][1] = fmaf(p.x, vv.y, acc[0][1]);
      acc[1][0] = fmaf(p.y, vv.x, acc[1][0]);
      acc[1][1] = fmaf(p.y, vv.y, acc[1][1]);
      acc[2][0] = fmaf(p.z, vv.x, acc[2][0]);
      acc[2][1] = fmaf(p.z, vv.y, acc[2][1]);
      acc[3][0] = fmaf(p.w, vv.x, acc[3][0]);
      acc[3][1] = fmaf(p.w, vv.y, acc[3][1]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r0 + r;
      if (row < N) {
        T* orow = o + base + (size_t)row * row_stride + 2 * lane;
        orow[0] = svt::from_f32<T>(acc[r][0]);
        orow[1] = svt::from_f32<T>(acc[r][1]);
      }
    }
    __syncwarp();  // Qw and Pw are rewritten by the next pass
  }
}

// ---------------------------------------------------------------------------
// bf16: scores on the tensor cores
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;

constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_QT = 16 * TC_WARPS;  // query rows per block
constexpr int KP = HD + 8;            // K and Q row stride in shared memory (bf16)

__host__ __device__ constexpr size_t align128(size_t bytes) { return (bytes + 127) / 128 * 128; }
__host__ __device__ constexpr int padded(int n) { return (n + 15) / 16 * 16; }

// shared layout: K bf16 [NP][KP] | V bf16 [NP][HD] | Q bf16 [TC_QT][KP] |
// S f32 [TC_WARPS][16][NP+4]; rows past N are zero
size_t tc_smem_bytes(int N) {
  const size_t NP = padded(N);
  return align128(NP * KP * 2) + align128(NP * HD * 2) + align128((size_t)TC_QT * KP * 2) +
         align128((size_t)TC_WARPS * 16 * (NP + 4) * 4);
}

__global__ void __launch_bounds__(TC_THREADS)
attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, int N, long long sb,
                    long long sh, long long row_stride, float scale) {
  extern __shared__ __align__(128) unsigned char smem_tc[];
  const int NP = padded(N);
  const int SS = NP + 4;  // score row stride (floats)
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* Vs = reinterpret_cast<bf16*>(smem_tc + align128((size_t)NP * KP * 2));
  bf16* Qs = reinterpret_cast<bf16*>(reinterpret_cast<unsigned char*>(Vs) +
                                     align128((size_t)NP * HD * 2));
  float* Ss = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(Qs) +
                                       align128((size_t)TC_QT * KP * 2));

  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * TC_QT;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);

  // K, V and the query tile, 16 bytes (8 values) at a time
  for (int i = threadIdx.x; i < NP * (HD / 8); i += TC_THREADS) {
    const int j = i / (HD / 8), c = 8 * (i % (HD / 8));
    uint4 kv = zero, vv = zero;
    if (j < N) {
      const size_t g = base + (size_t)j * row_stride + c;
      kv = *reinterpret_cast<const uint4*>(k + g);
      vv = *reinterpret_cast<const uint4*>(v + g);
    }
    *reinterpret_cast<uint4*>(Ks + j * KP + c) = kv;
    *reinterpret_cast<uint4*>(Vs + j * HD + c) = vv;
  }
  for (int i = threadIdx.x; i < TC_QT * (HD / 8); i += TC_THREADS) {
    const int r = i / (HD / 8), c = 8 * (i % (HD / 8));
    const int row = q0 + r;
    *reinterpret_cast<uint4*>(Qs + r * KP + c) =
        row < N ? *reinterpret_cast<const uint4*>(q + base + (size_t)row * row_stride + c) : zero;
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = q0 + 16 * warp;  // this warp's first query row
  if (r0 >= N) return;            // no __syncthreads follows
  float* Sw = Ss + (size_t)warp * 16 * SS;

  // scores: S[16, NP] = Q[16, 64] K[NP, 64]^T
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[HD / 16];
#pragma unroll
  for (int kd = 0; kd < HD / 16; ++kd)
    wmma::load_matrix_sync(qa[kd], Qs + 16 * warp * KP + 16 * kd, KP);
  for (int jt = 0; jt < NP / 16; ++jt) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> sacc;
    wmma::fill_fragment(sacc, 0.f);
#pragma unroll
    for (int kd = 0; kd < HD / 16; ++kd) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kb;  // K^T
      wmma::load_matrix_sync(kb, Ks + 16 * jt * KP + 16 * kd, KP);
      wmma::mma_sync(sacc, qa[kd], kb, sacc);
    }
    wmma::store_matrix_sync(Sw + 16 * jt, sacc, SS, wmma::mem_row_major);
  }
  __syncwarp();

  // softmax over the N real keys, in float32; probabilities replace the
  // scores, zero for the padded keys N .. NP-1
  for (int r = 0; r < 16; ++r) {
    float* srow = Sw + r * SS;
    float sv[NJ];
    float m = MASK;
#pragma unroll
    for (int t = 0; t < NJ; ++t) {
      const int j = lane + 32 * t;
      sv[t] = j < N ? srow[j] * scale : MASK;
      m = fmaxf(m, sv[t]);
    }
    m = svt::warp_max(m);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < NJ; ++t) {
      sv[t] = expf(sv[t] - m);  // masked keys: exp(-1e30 - m) == 0
      sum += sv[t];
    }
    sum = svt::warp_sum(sum);
#pragma unroll
    for (int t = 0; t < NJ; ++t) {
      const int j = lane + 32 * t;
      if (j < NP) srow[j] = j < N ? sv[t] / sum : 0.f;
    }
  }
  __syncwarp();

  // o[16, 64] = P V: lane owns columns 2*lane, 2*lane+1 of the 16 rows
  float acc[16][2];
#pragma unroll
  for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
  for (int j = 0; j < NP; j += 4) {
    float2 vv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      vv[u] = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(Vs + (j + u) * HD + 2 * lane));
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float4 p = *reinterpret_cast<const float4*>(Sw + r * SS + j);
      acc[r][0] = fmaf(p.w, vv[3].x, fmaf(p.z, vv[2].x, fmaf(p.y, vv[1].x, fmaf(p.x, vv[0].x, acc[r][0]))));
      acc[r][1] = fmaf(p.w, vv[3].y, fmaf(p.z, vv[2].y, fmaf(p.y, vv[1].y, fmaf(p.x, vv[0].y, acc[r][1]))));
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int row = r0 + r;
    if (row < N)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)row * row_stride + 2 * lane) =
          __floats2bfloat162_rn(acc[r][0], acc[r][1]);
  }
}

// q, k, v and o share the strides (in elements) sb of the batch, sh of the
// head and sn of the row; the head dim is contiguous.
template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
           long long sb, long long sh, long long sn, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // the tensor-core path moves 16-byte vectors: it needs aligned pointers
  // and strides that keep every row 16-byte aligned
  const bool aligned = ((reinterpret_cast<std::uintptr_t>(q) | reinterpret_cast<std::uintptr_t>(k) |
                         reinterpret_cast<std::uintptr_t>(v) | reinterpret_cast<std::uintptr_t>(o)) %
                        16) == 0 &&
                       ((sb | sh | sn) % 8) == 0;
  if (std::is_same_v<T, bf16> && aligned) {
    const size_t smem = tc_smem_bytes(N);
    cudaError_t err = cudaFuncSetAttribute(attention_tc_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    dim3 grid((N + TC_QT - 1) / TC_QT, H, B);
    attention_tc_kernel<<<grid, TC_THREADS, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), N, sb, sh, sn, scale);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(attention_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + QT - 1) / QT, H, B);
  attention_kernel<T><<<grid, THREADS, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), N, sb, sh, sn, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest sequence length the kernel takes (keys per lane x 32).
int svt_attention_max_seq(void) { return 32 * NJ; }
int svt_attention_head_dim(void) { return HD; }

// [B, H, N, d] views with the given strides (elements); the packed
// [B, N, H*d] layout is batch stride N*H*d, head stride d, row stride H*d
int svt_attention_bhnd_f32(const void* q, const void* k, const void* v, void* o, int B,
                           int H, int N, long long sb, long long sh, long long sn,
                           float scale, void* stream) {
  return launch<float>(q, k, v, o, B, N, H, sb, sh, sn, scale, stream);
}

int svt_attention_bhnd_bf16(const void* q, const void* k, const void* v, void* o, int B,
                            int H, int N, long long sb, long long sh, long long sn,
                            float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, N, H, sb, sh, sn, scale, stream);
}

}  // extern "C"
