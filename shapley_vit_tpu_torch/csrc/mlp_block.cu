// Fused LayerNorm -> MLP -> residual for Hopper (sm_90a).
//
// Replaces: shapley_vit_tpu/ops/mlp_block.py, _mlp_kernel (Pallas, entry
// fused_mlp_block). out = x + GELU(LN(x) W1 + b1) W2 + b2 over [M, D] tokens:
// LN with float32 statistics and the caller's eps; y cast to the weights'
// dtype before the first product; erf GELU (or the tanh form) in float32;
// h cast to the weights' dtype before the second product; float32
// accumulation; the residual added in float32; the output in x's dtype.
//
// Bound on an H100 SXM at the main-path shape (M = 176,512 tokens =
// 7 coalitions x 128 images x 197, D = 768, hidden 3072): 4*M*D*3072 =
// 1.67 TFLOP, over 989 TFLOP/s in bf16 = 1.68 ms, against 0.55 GB of tokens
// and weights over 3.35 TB/s = 0.16 ms; in float32 as 3xTF32 (below), three
// TF32 products over 495 TFLOP/s = 10.1 ms. Bound by operations in both.
//
// bf16 (the main path): three kernels on the caller's stream, with the two
// intermediates in caller-provided device memory, y [M, D] and h [M, Hd]:
//  * mlp_block_ln_kernel: y = bf16(LN(x)), one warp per row.
//  * mlp_block_gemm_kernel<Fc1>: h = bf16(GELU(y W1 + b1)).
//  * mlp_block_gemm_kernel<Fc2>: out = bf16(x + (h W2 + b2)).
// The Pallas kernel keeps the hidden on chip, but the work is bound by
// operations: h written once and read once in bf16 is 2 x 1.08 GB, about
// 0.65 ms at 3.35 TB/s, and the rounding of y and h to bf16 is the Pallas
// kernel's own. Each GEMM takes block tiles of 128 rows x 128 columns, two
// blocks on each SM (one block's loads and epilogue run under the other's
// products):
//  * Products: two warpgroups, 64 rows each, wgmma m64n128k16 with float32
//    accumulators in registers, 4 steps per stage of 64 k.
//  * Loads: a 3-stage ring of (A 128 x 64, B 64 x 128) tiles in shared
//    memory, both by 2-D TMA maps with the 128-byte swizzle, on one
//    mbarrier per stage; two stages in flight while the tensor cores work on
//    the third. A (y or h, row-major) is K-major; B (W1 or W2, row-major
//    [K, N]) is MN-major, two 64-column atoms per stage. Rows past M,
//    columns past N and k past K arrive as TMA's out-of-bounds zeros, so one
//    kernel serves every width that TMA can address (D and Hd multiples of 8,
//    16-byte aligned weights and workspaces).
//  * Epilogue: from the accumulator registers, bias and GELU (fc1) or bias
//    and residual (fc2) in float32, rounded to bf16 (round to nearest even)
//    and stored as bf16 pairs; rows past M and columns past N are not stored.
// float32 (the parity path, and the float32 round): the same three stages
// on the tensor cores in 3xTF32, with float32 workspaces y [M, D], h [M, Hd]
// and the weights' TF32 pairs wt [4, D, Hd]. TF32 keeps 10 mantissa bits, so
// each operand a is split into hi = tf32(a) and lo = tf32(a - hi) (round to
// nearest, ties away), and each product is A_hi B_hi + A_hi B_lo + A_lo B_hi
// in float32 accumulators: only lo lo (about 2^-22 relative) is dropped, so
// the result keeps float32's accuracy where one TF32 product (2^-11) would
// not. Three times the bf16 route's tensor-core work at half its rate:
//  * mlp_block_split_kernel: W1 and W2 transposed into their hi and lo
//    halves, K-major ([Hd, D] and [D, Hd]), since TF32 wgmma has no
//    transpose bit; about 38 MB of traffic a call.
//  * mlp_block_ln_kernel<float>: y = LN(x) in float32.
//  * mlp_block_tf32x3_kernel<Fc1>, <Fc2>: 128 x 128 tiles, two consumer
//    warpgroups of 64 rows and one producer warp that keeps a 4-stage TMA
//    ring of (A 128 x 32, B_hi 128 x 32, B_lo 128 x 32) float32 tiles full
//    (48 KB a stage, 193 KB in all: one block per SM), each stage handed
//    back by its own mbarrier once the eight consumer warps' products have
//    read it. A arrives as float32: each thread loads its wgmma fragments
//    of a stage from shared memory (16 values, conflict-free under the
//    swizzle) and splits them in registers, and the products take A from
//    registers and B_hi, B_lo from shared memory. So A's lo costs no
//    workspace, no L2 traffic and no shared memory, and the shared-memory
//    reads per product are B's alone: 12 wgmma m64n128k8 per stage (4
//    k-steps x 3 products). The tensor cores add into their accumulator
//    with truncation, so each stage's products go to an accumulator of
//    their own that is added to a float32 sum in registers.
//    h is stored in float32, unrounded, as the Pallas kernel's
//    h.astype(float32) leaves it.
// The FMA units take the hidden widths the TMA routes do not take (not a
// multiple of 8 in bf16 or 4 in float32; weights that are not 16-byte
// aligned are copied by the caller and stay on the TMA routes): one kernel
// that keeps the hidden on chip. A block of 256 threads takes 32 tokens, applies LN once into
// shared memory, and for each chunk of 64 hidden units computes
// gelu(y W1[:, c] + b1[c]) (rounded through the storage type) and
// accumulates it times W2[c, :] into a float32 [32, D] accumulator in
// registers, from W1/W2 tiles staged in shared memory. It takes D a
// multiple of 32 up to 1024 (NC = ceil(D / 128) a template parameter) and
// any hidden width.
#include <cstdint>
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace svt;  // the Hopper primitives (hopper.cuh)
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float gelu(float x, int approximate) {
  if (approximate) {
    const float c = 0.7978845608028654f;  // sqrt(2 / pi)
    return 0.5f * x * (1.f + tanhf(c * (x + 0.044715f * x * x * x)));
  }
  return 0.5f * x * erfcf(-x * 0.7071067811865476f);  // jax.nn.gelu's exact form
}

// LayerNorm of one row of D values by one warp: float32 statistics, y
// rounded through T, stored as Y
template <typename T, typename Y>
__device__ __forceinline__ void layer_norm_row(const T* __restrict__ xrow, const T* __restrict__ ln_s,
                                               const T* __restrict__ ln_b, Y* yrow, int D, float eps) {
  const int lane = threadIdx.x % 32;
  float sum = 0.f;
  for (int d = lane; d < D; d += 32) sum += to_f32(xrow[d]);
  const float mean = warp_sum(sum) / D;
  float sq = 0.f;
  for (int d = lane; d < D; d += 32) {
    const float c = to_f32(xrow[d]) - mean;
    sq = fmaf(c, c, sq);
  }
  const float rstd = rsqrtf(warp_sum(sq) / D + eps);
  for (int d = lane; d < D; d += 32) {
    const float y = (to_f32(xrow[d]) - mean) * rstd * to_f32(ln_s[d]) + to_f32(ln_b[d]);
    yrow[d] = from_f32<Y>(round_to<T>(y));
  }
}

// ---------------------------------------------------------------------------
// FMA units: the hidden widths the TMA routes do not take
// ---------------------------------------------------------------------------

constexpr int TT = 32;        // tokens per block
constexpr int HC = 64;        // hidden units per chunk
constexpr int KS = 32;        // k slice of the staged W1 tile
constexpr int JS = 16;        // hidden rows of the staged W2 tile
constexpr int THREADS = 256;
constexpr int YPAD = 4;       // ys row padding (floats): keeps 16-byte rows, spreads banks
constexpr int MAX_NC = 8;     // D up to 1024

// shared memory of the instance that pads D to DP = 128 NC columns
size_t smem_bytes(int DP) {
  return sizeof(float) * ((size_t)TT * (DP + YPAD) + KS * HC + HC * TT + (size_t)JS * DP);
}

// NC = ceil(D / 128): each thread owns NC groups of 4 output columns,
// 4 lane + 128 i; D a multiple of 32. The shared tiles are laid out for
// DP = 128 NC columns, W2's zero past D, so that the product loops keep
// compile-time strides and no per-column test; columns past D are not stored.
template <typename T, int NC>
__global__ void __launch_bounds__(THREADS, 1)
mlp_block_kernel(const T* __restrict__ x, const T* __restrict__ ln_s,
                 const T* __restrict__ ln_b, const T* __restrict__ w1,
                 const T* __restrict__ b1, const T* __restrict__ w2,
                 const T* __restrict__ b2, T* __restrict__ out, int M, int D, int Hd,
                 float eps, int approximate) {
  constexpr int DP = 128 * NC;
  constexpr int YS = DP + YPAD;
  extern __shared__ __align__(16) float smem[];
  float* ys = smem;              // [TT][YS]  LN(x), rounded through T
  float* w1s = ys + TT * YS;     // [KS][HC]
  float* hs = w1s + KS * HC;     // [HC][TT]  gelu(h), rounded through T
  float* w2s = hs + HC * TT;     // [JS][DP]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int m0 = blockIdx.x * TT;

  // 1. LN(x) into ys: warp w normalizes rows 4w .. 4w+3 (rows past M are 0)
  for (int rr = 0; rr < TT / 8; ++rr) {
    const int r = warp * (TT / 8) + rr;
    if (m0 + r < M) {
      layer_norm_row<T>(x + (size_t)(m0 + r) * D, ln_s, ln_b, ys + r * YS, D, eps);
    } else {
      for (int d = lane; d < D; d += 32) ys[r * YS + d] = 0.f;
    }
  }
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
        w1s[i] = col < Hd ? to_f32(w1[(size_t)(k0 + kk) * Hd + col]) : 0.f;
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
      const float bias = col < Hd ? to_f32(b1[col]) : 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float hv = col < Hd ? round_to<T>(gelu(hacc[r][j] + bias, approximate)) : 0.f;
        hs[(4 * tx + j) * TT + 2 * ty + r] = hv;
      }
    }
    __syncthreads();

    // 4. acc += gelu(h) W2[c0:c0+HC, :], W2 staged JS rows at a time
    for (int j0 = 0; j0 < HC; j0 += JS) {
      for (int i = tid; i < JS * DP; i += THREADS) {
        const int jj = i / DP, d = i % DP;
        const int unit = c0 + j0 + jj;
        w2s[i] = unit < Hd && d < D ? to_f32(w2[(size_t)unit * D + d]) : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int jj = 0; jj < JS; ++jj) {
        const float4 hv = *reinterpret_cast<const float4*>(hs + (j0 + jj) * TT + 4 * warp);
        const float* wrow = w2s + jj * DP + 4 * lane;
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
      if (4 * lane + 128 * i >= D) continue;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = 128 * i + 4 * lane + e;
        orow[d] = from_f32<T>(to_f32(xrow[d]) + (acc[r][i][e] + to_f32(b2[d])));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16: LN, then two GEMMs on a TMA ring feeding wgmma
// ---------------------------------------------------------------------------

constexpr int LN_ROWS = 8;                   // rows (one warp each) per block of the LN kernel

template <typename T>
__global__ void __launch_bounds__(32 * LN_ROWS)
mlp_block_ln_kernel(const T* __restrict__ x, const T* __restrict__ ln_s,
                    const T* __restrict__ ln_b, T* __restrict__ y, int M, int D, float eps) {
  const int row = blockIdx.x * LN_ROWS + threadIdx.x / 32;
  if (row < M) layer_norm_row<T>(x + (size_t)row * D, ln_s, ln_b, y + (size_t)row * D, D, eps);
}

constexpr int BM = 128;                      // rows of a block tile
constexpr int BN = 128;                      // output columns of a block tile
constexpr int BK = 64;                       // k per stage: one 128-byte swizzle row of bf16
constexpr int STAGES = 3;
constexpr int GEMM_THREADS = BM / 64 * 128;  // a warpgroup for each 64 rows
constexpr int BLOCKS_PER_SM = 2;
constexpr int A_BYTES = BM * BK * 2;         // [128 rows][64 k]
constexpr int ATOM_BYTES = BK * 64 * 2;      // [64 k][64 columns] of B
constexpr int B_BYTES = 2 * ATOM_BYTES;      // [64 k][128 columns] as two atoms
constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
// alignment slack (swizzle atoms: 1024 bytes), the ring, one mbarrier per stage
constexpr size_t GEMM_SMEM = 1024 + (size_t)STAGES * STAGE_BYTES + STAGES * 8;

// fc1's epilogue: GELU(acc + b1), to be stored into h in T
template <typename T>
struct Fc1 {
  const T* b1;
  int approximate;
  __device__ __forceinline__ float operator()(float acc, size_t, int col) const {
    return gelu(acc + to_f32(b1[col]), approximate);
  }
};

// fc2's epilogue: x + (acc + b2), to be stored into out in T
template <typename T>
struct Fc2 {
  const T* x;
  const T* b2;
  __device__ __forceinline__ float operator()(float acc, size_t idx, int col) const {
    return to_f32(x[idx]) + (acc + to_f32(b2[col]));
  }
};

// two neighbouring outputs: bf16 rounded to nearest even, float32 as they are
__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// A warpgroup's 64 x 128 accumulator tile through the epilogue into C
// [M, N] at rows m0 .. m0 + 63, columns n0 .. n0 + 127: acc[4 j + 2 h + e]
// is row 16 warp + lane / 4 + 8 h, column 8 j + 2 (lane % 4) + e. N is even,
// so a pair whose first column is < N lies inside the row, aligned to the
// pair. Rows past M and columns past N are not stored.
template <typename T, typename Epilogue>
__device__ __forceinline__ void store_tile(T* __restrict__ c, const float (&acc)[64], int m0, int n0,
                                           int M, int N, const Epilogue& epilogue) {
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int row0 = m0 + 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * (lane % 4);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M || col >= N) continue;
      const size_t idx = (size_t)row * N + col;
      store_pair(c + idx, epilogue(acc[4 * j + 2 * h], idx, col),
                 epilogue(acc[4 * j + 2 * h + 1], idx + 1, col + 1));
    }
  }
}

// One block tile of C [M, N] = epilogue(A [M, K] B [K, N]): rows m0 ..
// m0 + 127, columns n0 .. n0 + 127. A and B come by the tensor maps amap
// (dims {K, M}, box {64, 128}) and bmap (dims {N, K}, box {64, 64}). Every
// wgmma chain is straight-line code: a branch inside one makes the compiler
// wait for each wgmma in turn.
template <typename Epilogue>
__global__ void __launch_bounds__(GEMM_THREADS, BLOCKS_PER_SM)
mlp_block_gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bmap,
                      bf16* __restrict__ c, int M, int N, int K, int col_tiles, Epilogue epilogue) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_bar = base + STAGES * STAGE_BYTES;  // full[s] = full_bar + 8 s

  const int tid = threadIdx.x;
  // column tiles of one row tile are neighbours in the grid: they run
  // together and read the same A rows from L2
  const int m0 = (blockIdx.x / col_tiles) * BM, n0 = (blockIdx.x % col_tiles) * BN;
  const int chunks = (K + BK - 1) / BK;
  const int halves = n0 + 64 < N ? 2 : 1;  // B atoms holding a column < N
  const uint32_t stage_tx = A_BYTES + halves * ATOM_BYTES;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(full_bar + 8 * s, 1);  // the expect_tx
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // chunk kc (k = 64 kc ...) into stage kc % STAGES, by thread 0
  auto load = [&](int kc) {
    if (tid == 0 && kc < chunks) {
      const uint32_t as = base + (kc % STAGES) * STAGE_BYTES, bs = as + A_BYTES;
      const uint32_t bar = full_bar + 8 * (kc % STAGES);
      mbar_expect_tx(bar, stage_tx);
      tma_load_2d(as, &amap, bar, kc * BK, m0);
      for (int h = 0; h < halves; ++h) tma_load_2d(bs + h * ATOM_BYTES, &bmap, bar, n0 + 64 * h, kc * BK);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  const int wg = tid / 128;
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  for (int kc = 0; kc < chunks; ++kc) {
    const uint32_t as = base + (kc % STAGES) * STAGE_BYTES, bs = as + A_BYTES;
    mbar_wait(full_bar + 8 * (kc % STAGES), (kc / STAGES) & 1);
    // chunk kc is in, and both warpgroups are done with chunk kc - 1, whose
    // stage is loaded next
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

  store_tile(c, acc, m0 + wg * 64, n0, M, N, epilogue);
}

// ---------------------------------------------------------------------------
// float32: the same LN and two GEMMs, on the tensor cores in 3xTF32
// ---------------------------------------------------------------------------

constexpr int TF_BK = 32;                          // k per stage: one 128-byte swizzle row of float32
constexpr int TF_STAGES = 4;
constexpr int TF_TILE_BYTES = BM * TF_BK * 4;      // [128 rows][32 k]: A, or a half of B's pair
constexpr int TF_STAGE_BYTES = 3 * TF_TILE_BYTES;  // A, B_hi, B_lo
constexpr int TF_CONSUMERS = BM / 64 * 128;        // a warpgroup for each 64 rows
constexpr int TF_THREADS = TF_CONSUMERS + 32;      // and the producer warp
constexpr int TF_CONSUMER_WARPS = TF_CONSUMERS / 32;
// alignment slack, the ring, a full and an empty mbarrier per stage
constexpr size_t TF_SMEM = 1024 + (size_t)TF_STAGES * TF_STAGE_BYTES + 2 * TF_STAGES * 8;
static_assert(TF_SMEM <= 232448, "the TF32 ring must fit a block's 227 KB of shared memory");

// a float32 as its TF32 pair: hi = tf32(a), lo = tf32(a - hi) (a - hi is
// exact in float32)
__device__ __forceinline__ float2 split_tf32(float a) {
  const float hi = to_tf32(a);
  return make_float2(hi, to_tf32(a - hi));
}

constexpr int SPLIT_TILE = 32;

// W [R, C] (row-major, C a multiple of 4, 16-byte aligned) into its
// transposed TF32 pair hi, lo [C, R]: B of the GEMM whose weight W is, in
// the K-major layout TF32 wgmma reads. A block moves a 32 x 32 tile through
// shared memory: float4 loads along W's rows, stores along R.
__global__ void __launch_bounds__(256)
mlp_block_split_kernel(const float* __restrict__ w, float* __restrict__ hi, float* __restrict__ lo,
                       int R, int C) {
  __shared__ float tile[SPLIT_TILE][SPLIT_TILE + 1];
  const int r0 = blockIdx.y * SPLIT_TILE, c0 = blockIdx.x * SPLIT_TILE;
  const int tid = threadIdx.x;
  const int r = tid / 8, c = 4 * (tid % 8);
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (r0 + r < R && c0 + c < C) v = *reinterpret_cast<const float4*>(w + (size_t)(r0 + r) * C + c0 + c);
  tile[r][c] = v.x;
  tile[r][c + 1] = v.y;
  tile[r][c + 2] = v.z;
  tile[r][c + 3] = v.w;
  __syncthreads();
  for (int i = tid; i < SPLIT_TILE * SPLIT_TILE; i += 256) {
    const int cc = i / SPLIT_TILE, rr = i % SPLIT_TILE;
    if (c0 + cc >= C || r0 + rr >= R) continue;
    const float2 p = split_tf32(tile[rr][cc]);
    const size_t o = (size_t)(c0 + cc) * R + r0 + rr;
    hi[o] = p.x;
    lo[o] = p.y;
  }
}

// One block tile of C [M, N] = epilogue(A [M, K] B [K, N]) in 3xTF32: rows
// m0 .. m0 + 127, columns n0 .. n0 + 127. A (float32, row-major) comes by
// amap (dims {K, M}, box {32, 128}); B's TF32 pair, transposed to [N, K],
// by bhi and blo (dims {K, N}, box {32, 128}). Warps 0-7 are the two
// consumer warpgroups, warp 8 the producer. Every wgmma chain is
// straight-line code.
template <typename Epilogue>
__global__ void __launch_bounds__(TF_THREADS, 1)
mlp_block_tf32x3_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap bhi,
                        const __grid_constant__ CUtensorMap blo, float* __restrict__ c, int M, int N, int K,
                        int col_tiles, Epilogue epilogue) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full_bar = base + TF_STAGES * TF_STAGE_BYTES;  // full[s] = full_bar + 8 s
  const uint32_t empty_bar = full_bar + 8 * TF_STAGES;          // empty[s] = empty_bar + 8 s

  const int tid = threadIdx.x;
  // column tiles of one row tile are neighbours in the grid: they run
  // together and read the same A rows from L2
  const int m0 = (blockIdx.x / col_tiles) * BM, n0 = (blockIdx.x % col_tiles) * BN;
  const int chunks = (K + TF_BK - 1) / TF_BK;

  if (tid == 0) {
    for (int s = 0; s < TF_STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);                     // the producer's expect_tx
      mbar_init(empty_bar + 8 * s, TF_CONSUMER_WARPS);    // each consumer warp, done reading
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= TF_CONSUMERS) {
    // the producer: chunk kc (k = 32 kc ...) into stage kc % TF_STAGES once
    // the consumers have handed back its last chunk
    if (tid == TF_CONSUMERS) {
      for (int kc = 0; kc < chunks; ++kc) {
        const int s = kc % TF_STAGES;
        if (kc >= TF_STAGES) mbar_wait(empty_bar + 8 * s, (kc / TF_STAGES - 1) & 1);
        const uint32_t as = base + s * TF_STAGE_BYTES, bar = full_bar + 8 * s;
        mbar_expect_tx(bar, TF_STAGE_BYTES);
        tma_load_2d(as, &amap, bar, kc * TF_BK, m0);
        tma_load_2d(as + TF_TILE_BYTES, &bhi, bar, kc * TF_BK, n0);
        tma_load_2d(as + 2 * TF_TILE_BYTES, &blo, bar, kc * TF_BK, n0);
      }
    }
    return;
  }

  // acc: one chunk's products (wgmma's accumulator); sum: the float32 sum
  // of the chunks. The tensor cores add into their accumulator with
  // truncation, so over K = 3072 (1,152 wgmma) the error would grow to about
  // 1e-4 of the result; summed per chunk, in round-to-nearest adds, it stays
  // near float32's own.
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;

  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  // this thread's A elements of a chunk: rows r and r + 8 of the stage's
  // 128-byte rows (16 warp + g of its warpgroup's 64), k = 8 kd + q (+ 4):
  // 16-byte chunk 2 kd (+ 1) of the row, which the swizzle stores at
  // chunk ^ (row % 8), row % 8 being g for both rows
  const uint32_t a_row = (wg * 64 + 16 * warp + g) * 128 + 4 * q;
  for (int kc = 0; kc < chunks; ++kc) {
    const int s = kc % TF_STAGES;
    const unsigned char* as = smem_raw + (base - raw) + s * TF_STAGE_BYTES;
    const uint32_t bh = base + s * TF_STAGE_BYTES + TF_TILE_BYTES, bl = bh + TF_TILE_BYTES;
    mbar_wait(full_bar + 8 * s, (kc / TF_STAGES) & 1);
    // A's fragments of the chunk, split into their TF32 pairs in registers
    uint32_t a_hi[TF_BK / 8][4], a_lo[TF_BK / 8][4];
#pragma unroll
    for (int kd = 0; kd < TF_BK / 8; ++kd)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t off = a_row + (j % 2) * 8 * 128 + (((2 * kd + j / 2) ^ g) << 4);
        const float v = *reinterpret_cast<const float*>(as + off);
        const float2 p = split_tf32(v);
        a_hi[kd][j] = __float_as_uint(p.x);
        a_lo[kd][j] = __float_as_uint(p.y);
      }
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < TF_BK / 8; ++kd) {
      const uint64_t bhd = sw128_desc(bh + 32 * kd), bld = sw128_desc(bl + 32 * kd);
      // the small terms first; the chunk's first product overwrites acc
      wgmma_m64n128k8_tf32_rs(acc, a_lo[kd], bhd, kd > 0);
      wgmma_m64n128k8_tf32_rs(acc, a_hi[kd], bld, 1);
      wgmma_m64n128k8_tf32_rs(acc, a_hi[kd], bhd, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(empty_bar + 8 * s);  // this warp is done with the stage
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
  }

  store_tile(c, sum, m0 + wg * 64, n0, M, N, epilogue);
}

// Kernel slots of prepare_launch (hopper.cuh): the two bf16 GEMMs, the two
// TF32 GEMMs, then the FMA kernel's instances, MAX_NC for each storage type.
constexpr int SLOT_FC1 = 0, SLOT_FC2 = 1, SLOT_TF_FC1 = 2, SLOT_TF_FC2 = 3, SLOT_FMA = 4;
constexpr int SLOTS = SLOT_FMA + 2 * MAX_NC;

// a 2-D tensor map of a row-major [rows, cols] matrix of `type` (elements
// of `bytes` bytes), boxes of box_rows x one 128-byte row with the 128-byte
// swizzle; zeros out of bounds
int encode_map(CUtensorMap* map, CUtensorMapDataType type, int bytes, const void* p, int rows, int cols,
               int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / bytes), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(map, type, 2, const_cast<void*>(p), dims, strides, box, unit,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// C [M, N] = epilogue(A [M, K] B [K, N]), all row-major bf16
template <typename Epilogue>
int launch_gemm(const bf16* a, const bf16* b, bf16* c, int M, int N, int K, Epilogue epilogue,
                int slot, cudaStream_t st) {
  CUtensorMap amap{}, bmap{};
  int err = encode_map(&amap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, a, M, K, BM);
  if (err == 0) err = encode_map(&bmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, K, N, BK);
  if (err != 0) return err;
  const auto kernel = mlp_block_gemm_kernel<Epilogue>;
  int sms = 0;
  const cudaError_t set = prepare_launch<SLOTS>(reinterpret_cast<const void*>(kernel), slot, GEMM_SMEM, &sms);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int col_tiles = (N + BN - 1) / BN;
  const long long tiles = (long long)col_tiles * ((M + BM - 1) / BM);
  kernel<<<static_cast<unsigned>(tiles), GEMM_THREADS, GEMM_SMEM, st>>>(amap, bmap, c, M, N, K, col_tiles,
                                                                          epilogue);
  return static_cast<int>(cudaGetLastError());
}

bool is_aligned(const void* p, int bytes) { return reinterpret_cast<std::uintptr_t>(p) % bytes == 0; }

int launch_wgmma(const bf16* x, const bf16* ln_s, const bf16* ln_b, const bf16* w1, const bf16* b1,
                 const bf16* w2, const bf16* b2, bf16* out, bf16* y, bf16* h, int M, int D, int Hd,
                 float eps, int approximate, cudaStream_t st) {
  // TMA: 16-byte strides and bases for y, h, W1 and W2; pair stores into
  // h and out
  if (D % 8 || Hd % 8 || !is_aligned(w1, 16) || !is_aligned(w2, 16) || !is_aligned(y, 16) || !is_aligned(h, 16) ||
      !is_aligned(out, 4))
    return static_cast<int>(cudaErrorInvalidValue);
  mlp_block_ln_kernel<<<(M + LN_ROWS - 1) / LN_ROWS, 32 * LN_ROWS, 0, st>>>(x, ln_s, ln_b, y, M, D, eps);
  int err = static_cast<int>(cudaGetLastError());
  if (err == 0) err = launch_gemm(y, w1, h, M, Hd, D, Fc1<bf16>{b1, approximate}, SLOT_FC1, st);
  if (err == 0) err = launch_gemm(h, w2, out, M, D, Hd, Fc2<bf16>{x, b2}, SLOT_FC2, st);
  return err;
}

// C [M, N] = epilogue(A [M, K] B [K, N]) in 3xTF32: A row-major float32, B
// as its TF32 pair transposed to [N, K]
template <typename Epilogue>
int launch_tf32x3_gemm(const float* a, const float* b_hi, const float* b_lo, float* c, int M, int N, int K,
                       Epilogue epilogue, int slot, cudaStream_t st) {
  CUtensorMap amap{}, hmap{}, lmap{};
  int err = encode_map(&amap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a, M, K, BM);
  if (err == 0) err = encode_map(&hmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, b_hi, N, K, BN);
  if (err == 0) err = encode_map(&lmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, b_lo, N, K, BN);
  if (err != 0) return err;
  const auto kernel = mlp_block_tf32x3_kernel<Epilogue>;
  int sms = 0;
  const cudaError_t set = prepare_launch<SLOTS>(reinterpret_cast<const void*>(kernel), slot, TF_SMEM, &sms);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int col_tiles = (N + BN - 1) / BN;
  const long long tiles = (long long)col_tiles * ((M + BM - 1) / BM);
  kernel<<<static_cast<unsigned>(tiles), TF_THREADS, TF_SMEM, st>>>(amap, hmap, lmap, c, M, N, K, col_tiles,
                                                                      epilogue);
  return static_cast<int>(cudaGetLastError());
}

int launch_tf32x3(const float* x, const float* ln_s, const float* ln_b, const float* w1, const float* b1,
                  const float* w2, const float* b2, float* out, float* y, float* h, float* wt, int M, int D,
                  int Hd, float eps, int approximate, cudaStream_t st) {
  // float4 loads of W1 and W2; TMA: 16-byte strides and bases for y, h and
  // wt's four [D, Hd] parts; pair stores into h and out
  if (D % 4 || Hd % 4 || !is_aligned(w1, 16) || !is_aligned(w2, 16) || !is_aligned(y, 16) || !is_aligned(h, 16) ||
      !is_aligned(wt, 16) || !is_aligned(out, 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t part = (size_t)D * Hd;
  float* w1_hi = wt;           // [Hd, D]
  float* w1_lo = wt + part;
  float* w2_hi = wt + 2 * part;  // [D, Hd]
  float* w2_lo = wt + 3 * part;
  const dim3 split_block(256);
  mlp_block_split_kernel<<<dim3((Hd + SPLIT_TILE - 1) / SPLIT_TILE, (D + SPLIT_TILE - 1) / SPLIT_TILE),
                           split_block, 0, st>>>(w1, w1_hi, w1_lo, D, Hd);
  mlp_block_split_kernel<<<dim3((D + SPLIT_TILE - 1) / SPLIT_TILE, (Hd + SPLIT_TILE - 1) / SPLIT_TILE),
                           split_block, 0, st>>>(w2, w2_hi, w2_lo, Hd, D);
  mlp_block_ln_kernel<<<(M + LN_ROWS - 1) / LN_ROWS, 32 * LN_ROWS, 0, st>>>(x, ln_s, ln_b, y, M, D, eps);
  int err = static_cast<int>(cudaGetLastError());
  if (err == 0) err = launch_tf32x3_gemm(y, w1_hi, w1_lo, h, M, Hd, D, Fc1<float>{b1, approximate}, SLOT_TF_FC1, st);
  if (err == 0) err = launch_tf32x3_gemm(h, w2_hi, w2_lo, out, M, D, Hd, Fc2<float>{x, b2}, SLOT_TF_FC2, st);
  return err;
}

template <typename T, int NC>
int launch_fma_nc(const T* x, const T* ln_s, const T* ln_b, const T* w1, const T* b1, const T* w2,
                  const T* b2, T* out, int M, int D, int Hd, float eps, int approximate, cudaStream_t st) {
  const auto kernel = mlp_block_kernel<T, NC>;
  const int slot = SLOT_FMA + (std::is_same_v<T, bf16> ? MAX_NC : 0) + NC - 1;
  int sms = 0;
  const size_t smem = smem_bytes(128 * NC);
  const cudaError_t set = prepare_launch<SLOTS>(reinterpret_cast<const void*>(kernel), slot, smem, &sms);
  if (set != cudaSuccess) return static_cast<int>(set);
  kernel<<<(M + TT - 1) / TT, THREADS, smem, st>>>(x, ln_s, ln_b, w1, b1, w2, b2, out, M, D, Hd,
                                                             eps, approximate);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fma(const void* x, const void* ln_s, const void* ln_b, const void* w1, const void* b1,
               const void* w2, const void* b2, void* out, int M, int D, int Hd, float eps,
               int approximate, void* stream) {
  if (D % 32 || D <= 0 || D > 128 * MAX_NC) return static_cast<int>(cudaErrorInvalidValue);
  const auto run = [&](auto nc) {
    return launch_fma_nc<T, decltype(nc)::value>(
        static_cast<const T*>(x), static_cast<const T*>(ln_s), static_cast<const T*>(ln_b),
        static_cast<const T*>(w1), static_cast<const T*>(b1), static_cast<const T*>(w2),
        static_cast<const T*>(b2), static_cast<T*>(out), M, D, Hd, eps, approximate,
        static_cast<cudaStream_t>(stream));
  };
  switch ((D + 127) / 128) {
    case 1: return run(std::integral_constant<int, 1>{});
    case 2: return run(std::integral_constant<int, 2>{});
    case 3: return run(std::integral_constant<int, 3>{});
    case 4: return run(std::integral_constant<int, 4>{});
    case 5: return run(std::integral_constant<int, 5>{});
    case 6: return run(std::integral_constant<int, 6>{});
    case 7: return run(std::integral_constant<int, 7>{});
    default: return run(std::integral_constant<int, 8>{});
  }
}

}  // namespace

extern "C" {

// the FMA kernel: float32, D a multiple of 32 up to 1024, any hidden width
int svt_mlp_block_fma_f32(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                      const void* b1, const void* w2, const void* b2, void* out, int M,
                      int D, int Hd, float eps, int approximate, void* stream) {
  return launch_fma<float>(x, ln_s, ln_b, w1, b1, w2, b2, out, M, D, Hd, eps, approximate, stream);
}

// the FMA kernel on bf16 storage: for shapes the TMA route does not take
int svt_mlp_block_fma_bf16(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                           const void* b1, const void* w2, const void* b2, void* out, int M,
                           int D, int Hd, float eps, int approximate, void* stream) {
  return launch_fma<bf16>(x, ln_s, ln_b, w1, b1, w2, b2, out, M, D, Hd, eps, approximate, stream);
}

// the bf16 route: LN into the workspace y [M, D], fc1 into the workspace
// h [M, Hd], fc2 into out; D and Hd multiples of 8, W1, W2, y and h
// 16-byte aligned (else cudaErrorInvalidValue, before any launch)
int svt_mlp_block_bf16(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                       const void* b1, const void* w2, const void* b2, void* out, void* y, void* h,
                       int M, int D, int Hd, float eps, int approximate, void* stream) {
  return launch_wgmma(static_cast<const bf16*>(x), static_cast<const bf16*>(ln_s),
                      static_cast<const bf16*>(ln_b), static_cast<const bf16*>(w1),
                      static_cast<const bf16*>(b1), static_cast<const bf16*>(w2),
                      static_cast<const bf16*>(b2), static_cast<bf16*>(out), static_cast<bf16*>(y),
                      static_cast<bf16*>(h), M, D, Hd, eps, approximate, static_cast<cudaStream_t>(stream));
}

// the float32 route: W1 and W2's transposed TF32 pairs into the workspace
// wt [4, D, Hd], LN into the workspace y [M, D], fc1 into the workspace
// h [M, Hd], fc2 into out, in 3xTF32; D and Hd multiples of 4, W1, W2, y, h
// and wt 16-byte aligned (else cudaErrorInvalidValue, before any launch)
int svt_mlp_block_tf32x3(const void* x, const void* ln_s, const void* ln_b, const void* w1,
                         const void* b1, const void* w2, const void* b2, void* out, void* y, void* h,
                         void* wt, int M, int D, int Hd, float eps, int approximate, void* stream) {
  return launch_tf32x3(static_cast<const float*>(x), static_cast<const float*>(ln_s),
                       static_cast<const float*>(ln_b), static_cast<const float*>(w1),
                       static_cast<const float*>(b1), static_cast<const float*>(w2),
                       static_cast<const float*>(b2), static_cast<float*>(out), static_cast<float*>(y),
                       static_cast<float*>(h), static_cast<float*>(wt), M, D, Hd, eps, approximate,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
