// Patch embedding for Hopper (sm_90a): NHWC images -> [B, N, D] patch tokens.
//
// Replaces: shapley_vit_tpu/ops/patch_embed.py, _patch_embed_kernel (Pallas,
// entry patch_embed). out[b, n, :] = patch(b, n) @ W + bias, where patch(b, n)
// is the n-th P x P patch of image b (row-major grid) flattened in HF
// (ph, pw, C) order, float32 accumulation, float32 bias, stored in the image
// dtype. The [B*N, P*P*C] patch matrix is never written to device memory:
// both kernels below gather their patch rows straight from the image (for
// a fixed patch row ph the P*C values (pw, c) are contiguous in the image),
// the fusion the Pallas kernel was after.
//
// Bound on an H100 SXM at the main-path shape (B = 128, 224 px, P = 16,
// D = 768, bf16): a [25,088 x 768] x [768 x 768] product, 2*B*196*768*768 =
// 29.6 GFLOP over 989 TFLOP/s = 0.030 ms, against ~77 MB of images, weights
// and tokens read or written once over 3.35 TB/s = 0.023 ms: bound by
// operations, so the product belongs on the tensor cores.
//
// bf16 design: one GEMM over M = B*N rows (row r is patch r % N of image
// r / N, so the output is one contiguous [M, D] matrix; every tile but the
// last is full, and a tile may span two images), in block tiles of 128 rows
// x 128 columns, 1,176 of them at the main shape, two blocks on each SM.
//  * Products: two warpgroups, 64 rows each, wgmma m64n128k16 with float32
//    accumulators in registers, 4 steps per stage of 64 k.
//  * Loads: a 3-stage ring of (A 128 x 64, W 64 x 128) tiles in shared
//    memory, both 128-byte swizzled, two stages in flight while the tensor
//    cores work on the third. A (the patches) is gathered with cp.async:
//    each copy is V consecutive k of one image-row segment (V = 8, 16 bytes,
//    when P*C and W*C are multiples of 8, as at 224 px with 3 channels;
//    narrower shapes take 8-, 4- or 2-byte copies, V a template parameter),
//    at image offsets computed once per row and tile; rows past M and k
//    past K are zero-filled (src-size 0). TMA cannot take A: its im2col mode
//    needs 16-byte pixels (3 channels are 6 bytes), and a tiled map over
//    [B, gh, P, gw, P*C] gives boxes of one grid row of 14 patches, which do
//    not fill 64-row wgmma tiles. W is [K, D] row-major, an MN-major
//    ("trans-b") operand stored as two 64-column atoms per stage: TMA loads
//    them (a 2-D map, 128-byte swizzle, k past K zero-filled) where D is a
//    multiple of 8 and W 16-byte aligned, otherwise cp.async does, in the
//    same layout. cp.async writes through the generic proxy and wgmma reads
//    through the async proxy: each thread waits for its copies, fences the
//    proxies, and a block barrier then orders every thread's copies before
//    the next wgmma chain (and every warpgroup's last chain before the
//    stage is loaded again).
//  * Epilogue: accumulator + float(bias), rounded to bf16 (round to nearest
//    even) and stored from registers as bf16 pairs; rows past M and columns
//    past D are not stored.
// float32 (the parity path): the FMA kernel below, unchanged since the first
// port; TF32 would not hold the float32 1e-4 parity bar.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace svt;  // the Hopper primitives (hopper.cuh)

// ---------------------------------------------------------------------------
// float32: FMA units, one block per (image, 32 patches, 64 output columns)
// ---------------------------------------------------------------------------

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

int launch_fma(const float* img, const float* w, const float* bias, float* out, int B, int H,
               int W, int C, int P, int D, cudaStream_t st) {
  const int Np = (H / P) * (W / P);
  dim3 grid((Np + TM - 1) / TM, (D + TN - 1) / TN, B);
  patch_embed_kernel<float><<<grid, THREADS, 0, st>>>(img, w, bias, out, H, W, C, P, D);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: cp.async/TMA ring, wgmma
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int BM = 128;                      // rows (patches) of a block tile
constexpr int BN = 128;                      // output columns of a block tile
constexpr int BK = 64;                       // k per stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 3;
constexpr int HP_THREADS = BM / 64 * 128;    // a warpgroup for each 64 rows
constexpr int BLOCKS_PER_SM = 2;             // one block's loads overlap the other's products
constexpr int A_BYTES = BM * BK * 2;         // [128 rows][64 k]
constexpr int ATOM_BYTES = BK * 64 * 2;      // [64 k][64 columns] of W
constexpr int B_BYTES = 2 * ATOM_BYTES;      // [64 k][128 columns] as two atoms
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// alignment slack (swizzle atoms: 1024 bytes), the ring, each row's image
// offset, one mbarrier per stage (the TMA route)
constexpr size_t HP_SMEM = 1024 + (size_t)STAGES * STAGE_BYTES + BM * 8 + STAGES * 8;

// V bf16 values (2 V bytes) from global to shared memory, zeros where
// !valid: cp.async for 4, 8 and 16 bytes, a register copy for 2
template <int V>
__device__ __forceinline__ void copy_in(uint32_t dst, const bf16* src, bool valid) {
  if constexpr (V == 1) {
    const unsigned short v = valid ? *reinterpret_cast<const unsigned short*>(src) : 0;
    asm volatile("st.shared.u16 [%0], %1;" ::"r"(dst), "h"(v) : "memory");
  } else {
    cp_async<2 * V>(dst, src, valid);
  }
}

// One block tile: rows m0 .. m0 + 127 of the [M, K] patch matrix times
// columns n0 .. n0 + 127 of W. V: values per copy of the cp.async gathers;
// TMA_B: W comes by TMA (else by cp.async, V values a copy). Every wgmma
// chain is straight-line code: a branch inside one makes the compiler wait
// for each wgmma in turn.
template <int V, bool TMA_B>
__global__ void __launch_bounds__(HP_THREADS, BLOCKS_PER_SM)
patch_embed_hopper_kernel(const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ img,
                          const bf16* __restrict__ w, const bf16* __restrict__ bias,
                          bf16* __restrict__ out, int H, int W, int C, int P, int D, int M,
                          int col_tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  long long* rowoff = reinterpret_cast<long long*>(smem_raw + (base - raw) + STAGES * STAGE_BYTES);
  const uint32_t full_bar = base + STAGES * STAGE_BYTES + BM * 8;  // full[s] = full_bar + 8 s

  const int tid = threadIdx.x;
  // column tiles of one row tile are neighbours in the grid: they run
  // together and read the same patches from L2
  const int m0 = (blockIdx.x / col_tiles) * BM, n0 = (blockIdx.x % col_tiles) * BN;
  const int PC = P * C, K = P * PC, WC = W * C;
  const int chunks = (K + BK - 1) / BK;

  // image offset of each row's patch (its top-left pixel), -1 past M
  if (tid < BM) {
    const int r = m0 + tid;
    long long off = -1;
    if (r < M) {
      const int gw = W / P, np = (H / P) * gw;
      const int b = r / np, n = r % np;
      off = ((long long)b * H + (long long)(n / gw) * P) * WC + (long long)(n % gw) * PC;
    }
    rowoff[tid] = off;
  }
  if (TMA_B && tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full_bar + 8 * s, 1);  // the expect_tx
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // this thread's copies in every stage: piece aj (V values of k) of A rows
  // ar0, ar0 + A_STEP, ...; piece bj (V columns) of W rows br0, br0 + B_STEP, ...
  constexpr int A_PIECES = BK / V, A_STEP = HP_THREADS / A_PIECES;
  constexpr int B_PIECES = BN / V, B_STEP = HP_THREADS / B_PIECES;
  const int aj = tid % A_PIECES, ar0 = tid / A_PIECES;
  const int bj = tid % B_PIECES, br0 = tid / B_PIECES;
  const int halves = n0 + 64 < D ? 2 : 1;  // W atoms holding a column < D

  // chunk kc (k = 64 kc ...) into stage kc % STAGES; one cp.async group per
  // call, empty past the last chunk, so that the groups count stages
  auto load = [&](int kc) {
    if (kc < chunks) {
      const uint32_t as = base + (kc % STAGES) * STAGE_BYTES, bs = as + A_BYTES;
      const int k = kc * BK + aj * V;
      const long long koff = (long long)(k / PC) * WC + k % PC;  // (ph, pw * C + c)
#pragma unroll 8
      for (int i = 0; i < BM / A_STEP; ++i) {
        const int r = ar0 + i * A_STEP;
        const long long ro = rowoff[r];
        const bool ok = k < K && ro >= 0;
        copy_in<V>(as + sw128_offset(r, aj * V / 8) + (aj * V % 8) * 2, ok ? img + ro + koff : img,
                   ok);
      }
      if constexpr (TMA_B) {
        if (tid == 0) {
          const uint32_t bar = full_bar + 8 * (kc % STAGES);
          mbar_expect_tx(bar, halves * ATOM_BYTES);
          for (int h = 0; h < halves; ++h)
            tma_load_2d(bs + h * ATOM_BYTES, &wmap, bar, n0 + 64 * h, kc * BK);
        }
      } else {
        const int c = bj * V;  // column in the tile
#pragma unroll 8
        for (int i = 0; i < BK / B_STEP; ++i) {
          const int kr = br0 + i * B_STEP, kg = kc * BK + kr;
          const bool ok = kg < K && n0 + c < D;
          copy_in<V>(bs + (c / 64) * ATOM_BYTES + sw128_offset(kr, c % 64 / 8) + (c % 8) * 2,
                     ok ? w + (long long)kg * D + n0 + c : w, ok);
        }
      }
    }
    cp_async_commit();
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  const int wg = tid / 128;
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  for (int kc = 0; kc < chunks; ++kc) {
    const uint32_t as = base + (kc % STAGES) * STAGE_BYTES, bs = as + A_BYTES;
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk kc have landed
    fence_proxy_async();          // ... and are ordered before wgmma's reads
    if constexpr (TMA_B) mbar_wait(full_bar + 8 * (kc % STAGES), (kc / STAGES) & 1);
    // every thread's copies of chunk kc are in, and both warpgroups are done
    // with chunk kc - 1, whose stage is loaded next
    __syncthreads();
    load(kc + STAGES - 1);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < BK / 16; ++kd)
      wgmma_m64n128k16_ss(acc, sw128_desc(as + wg * 64 * 128 + 32 * kd),
                          sw128_desc(bs + kd * 16 * 128, ATOM_BYTES), 1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
  }

  // epilogue: acc[4 j + 2 h + e] is row 16 warp + lane / 4 + 8 h of this
  // warpgroup's 64, column 8 j + 2 (lane % 4) + e
  const int warp = (tid % 128) / 32, lane = tid % 32;
  const int row0 = m0 + wg * 64 + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
    const float b0 = col < D ? to_f32(bias[col]) : 0.f;
    const float b1 = col + 1 < D ? to_f32(bias[col + 1]) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M || col >= D) continue;
      bf16* o = out + (size_t)row * D + col;
      const float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
      if (D % 2 == 0) {  // col is even: the pair is 4-byte aligned and inside the row
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        o[0] = from_f32<bf16>(v0);
        if (col + 1 < D) o[1] = from_f32<bf16>(v1);
      }
    }
  }
}

using HopperKernel = void (*)(const CUtensorMap, const bf16*, const bf16*, const bf16*, bf16*, int,
                              int, int, int, int, int, int);

// the kernel instance of copy width v and W route; v = 8 comes only with
// the TMA route (both need D % 8 == 0 and W 16-byte aligned)
HopperKernel hopper_kernel(int v, bool tma) {
  switch (v) {
    case 8: return patch_embed_hopper_kernel<8, true>;
    case 4: return tma ? patch_embed_hopper_kernel<4, true> : patch_embed_hopper_kernel<4, false>;
    case 2: return tma ? patch_embed_hopper_kernel<2, true> : patch_embed_hopper_kernel<2, false>;
    default: return tma ? patch_embed_hopper_kernel<1, true> : patch_embed_hopper_kernel<1, false>;
  }
}

// the widest copy (8, 4, 2 or 1 values) that every copy of a row can take:
// `run` values contiguous in global memory, each run starting a multiple of
// `stride` values after `p`
int widest(const void* p, int run, int stride) {
  const std::uintptr_t addr = reinterpret_cast<std::uintptr_t>(p);
  int v = 8;
  while (v > 1 && (run % v || stride % v || addr % (2 * v))) v /= 2;
  return v;
}

// Kernel slots of prepare_launch (hopper.cuh): 4 (TMA route) + log2(v).
constexpr int SLOTS = 8;

int launch_hopper(const bf16* img, const bf16* w, const bf16* bias, bf16* out, int B, int H, int W,
                  int C, int P, int D, cudaStream_t st) {
  const int M = B * (H / P) * (W / P), K = P * P * C;
  // A's runs are one image-row segment of a patch (P*C values), at
  // multiples of W*C (image rows) and P*C (patches); W's are its rows
  const int va = widest(img, P * C, W * C), vb = widest(w, D, D);
  const bool tma = vb == 8;
  const int v = tma ? va : std::min(va, vb);
  CUtensorMap wmap{};
  if (tma) {
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(K)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
    const cuuint32_t box[2] = {64, BK}, unit[2] = {1, 1};
    const CUresult r = encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<bf16*>(w), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  const HopperKernel kernel = hopper_kernel(v, tma);
  int slot = tma ? 4 : 0, sms = 0;
  for (int x = v; x > 1; x /= 2) ++slot;
  const cudaError_t err =
      prepare_launch<SLOTS>(reinterpret_cast<const void*>(kernel), slot, HP_SMEM, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int col_tiles = (D + BN - 1) / BN;
  const long long tiles = (long long)col_tiles * ((M + BM - 1) / BM);
  kernel<<<static_cast<unsigned>(tiles), HP_THREADS, HP_SMEM, st>>>(wmap, img, w, bias, out, H, W, C,
                                                                     P, D, M, col_tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int svt_patch_embed_f32(const void* img, const void* w, const void* bias, void* out,
                        int B, int H, int W, int C, int P, int D, void* stream) {
  return launch_fma(static_cast<const float*>(img), static_cast<const float*>(w),
                    static_cast<const float*>(bias), static_cast<float*>(out), B, H, W, C, P, D,
                    static_cast<cudaStream_t>(stream));
}

int svt_patch_embed_bf16(const void* img, const void* w, const void* bias, void* out,
                         int B, int H, int W, int C, int P, int D, void* stream) {
  return launch_hopper(static_cast<const bf16*>(img), static_cast<const bf16*>(w),
                       static_cast<const bf16*>(bias), static_cast<bf16*>(out), B, H, W, C, P, D,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
