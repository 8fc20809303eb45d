// Patch embedding for Hopper (sm_90a): NHWC images -> [B, N, D] patch tokens.
//
// Replaces: shapley_vit_tpu/ops/patch_embed.py, _patch_embed_kernel (Pallas,
// entry patch_embed). out[b, n, :] = patch(b, n) @ W + bias, where patch(b, n)
// is the n-th P x P patch of image b (row-major grid) flattened in HF
// (ph, pw, C) order, float32 accumulation, stored in the image dtype.
//
// Bound on an H100 SXM at the main-path shape (B = 128, 224 px, P = 16,
// D = 768, bf16): 2*B*196*768*768 = 29.6 GFLOP over 989 TFLOP/s = 0.030 ms
// against ~78 MB of images, weights and tokens over 3.35 TB/s = 0.023 ms;
// so bound by operations, at a size where launch and tail effects matter.
//
// Design: one block per (image, tile of 32 patches, tile of 64 output
// columns). The block gathers its patch rows straight from the NHWC image
// into shared memory, 32 columns of K = P*P*C at a time (for a fixed patch
// row ph the P*C values (pw, c) are contiguous in the image), so the
// [B*N, P*P*C] patch matrix is never written to device memory: the fusion
// the Pallas kernel was after, which it could not compile at 224 px. The
// product runs on the FMA units in float32 from shared-memory tiles, each
// thread holding a 2 x 4 block of outputs. No tensor cores, TMA or
// pipelining yet: this is the simple, right first version.
#include "common.cuh"

namespace {

constexpr int TM = 32;        // patches per block
constexpr int TN = 64;        // output columns per block
constexpr int KS = 32;        // K slice staged per step
constexpr int THREADS = 256;  // 16 x 16: rows 2*ty, 2*ty+1; columns 4*tx .. 4*tx+3

template <typename T>
__global__ void __launch_bounds__(THREADS)
patch_embed_kernel(const T* __restrict__ img, const T* __restrict__ w,
                   const T* __restrict__ bias, T* __restrict__ out,
                   int H, int W, int C, int P, int D) {
  __shared__ float As[KS][TM + 1];  // As[k][patch]
  __shared__ __align__(16) float Bs[KS][TN];

  const int b = blockIdx.z;
  const int m0 = blockIdx.x * TM;
  const int n0 = blockIdx.y * TN;
  const int gw = W / P;
  const int Np = (H / P) * gw;
  const int K = P * P * C;
  const int PC = P * C;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const T* imgb = img + (size_t)b * H * W * C;

  float acc[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += KS) {
    // gather the A tile: consecutive threads take consecutive k, i.e.
    // neighbouring (pw, c) values of one image row
    for (int i = tid; i < TM * KS; i += THREADS) {
      const int m = i / KS, kk = i % KS;
      const int p = m0 + m, k = k0 + kk;
      float v = 0.f;
      if (p < Np && k < K) {
        const int gy = p / gw, gx = p % gw;
        const int ph = k / PC, rem = k % PC;  // rem = pw * C + c
        v = svt::to_f32(imgb[((size_t)(gy * P + ph) * W + (size_t)gx * P) * C + rem]);
      }
      As[kk][m] = v;
    }
    for (int i = tid; i < KS * TN; i += THREADS) {
      const int kk = i / TN, n = i % TN;
      const int k = k0 + kk, col = n0 + n;
      Bs[kk][n] = (k < K && col < D) ? svt::to_f32(w[(size_t)k * D + col]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KS; ++kk) {
      const float a0 = As[kk][2 * ty];
      const float a1 = As[kk][2 * ty + 1];
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][4 * tx]);
      acc[0][0] = fmaf(a0, bv.x, acc[0][0]);
      acc[0][1] = fmaf(a0, bv.y, acc[0][1]);
      acc[0][2] = fmaf(a0, bv.z, acc[0][2]);
      acc[0][3] = fmaf(a0, bv.w, acc[0][3]);
      acc[1][0] = fmaf(a1, bv.x, acc[1][0]);
      acc[1][1] = fmaf(a1, bv.y, acc[1][1]);
      acc[1][2] = fmaf(a1, bv.z, acc[1][2]);
      acc[1][3] = fmaf(a1, bv.w, acc[1][3]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int p = m0 + 2 * ty + r;
    if (p >= Np) continue;
    T* orow = out + ((size_t)b * Np + p) * D;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + 4 * tx + j;
      if (col < D) orow[col] = svt::from_f32<T>(acc[r][j] + svt::to_f32(bias[col]));
    }
  }
}

template <typename T>
int launch(const void* img, const void* w, const void* bias, void* out, int B,
           int H, int W, int C, int P, int D, void* stream) {
  const int Np = (H / P) * (W / P);
  dim3 grid((Np + TM - 1) / TM, (D + TN - 1) / TN, B);
  patch_embed_kernel<T><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(img), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(out), H, W, C, P, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int svt_patch_embed_f32(const void* img, const void* w, const void* bias, void* out,
                        int B, int H, int W, int C, int P, int D, void* stream) {
  return launch<float>(img, w, bias, out, B, H, W, C, P, D, stream);
}

int svt_patch_embed_bf16(const void* img, const void* w, const void* bias, void* out,
                         int B, int H, int W, int C, int P, int D, void* stream) {
  return launch<__nv_bfloat16>(img, w, bias, out, B, H, W, C, P, D, stream);
}

}  // extern "C"
