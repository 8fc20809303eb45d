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
// D = 768): a [25,088 x 768] x [768 x 768] product, 2*B*196*768*768 =
// 29.6 GFLOP. In bf16, over 989 TFLOP/s = 0.030 ms, against ~77 MB of
// images, weights and tokens read or written once over 3.35 TB/s =
// 0.023 ms. In float32 as 3xTF32 (below), three TF32 products over
// 495 TFLOP/s = 0.179 ms, against ~156 MB over 3.35 TB/s = 0.046 ms. Bound
// by operations in both, so the product belongs on the tensor cores.
//
// Both dtypes run one GEMM over M = B*N rows (row r is patch r % N of
// image r / N, so the output is one contiguous [M, D] matrix; every tile
// but the last is full, and a tile may span two images), in block tiles of
// 128 rows x 128 columns, 1,176 of them at the main shape, with two
// warpgroups of 64 rows each. A (the patches) is gathered with cp.async:
// each copy is V consecutive k of one image-row segment (16 bytes where
// P*C and W*C allow it, as at 224 px with 3 channels; narrower shapes take
// 8-, 4- or, in bf16, 2-byte copies, V a template parameter), at image
// offsets computed once per row and tile; rows past M and k past K are
// zero-filled (src-size 0). TMA cannot take A: its im2col mode needs
// 16-byte pixels (3 channels are 6 or 12 bytes), and a tiled map over
// [B, gh, P, gw, P*C] gives boxes of one grid row of 14 patches, which do
// not fill 64-row wgmma tiles. Rows past M and columns past D are not
// stored.
//
// bf16 (the main path), two blocks on each SM:
//  * Products: wgmma m64n128k16 with float32 accumulators in registers,
//    4 steps per stage of 64 k.
//  * Loads: a 3-stage ring of (A 128 x 64, W 64 x 128) tiles in shared
//    memory, both 128-byte swizzled, two stages in flight while the tensor
//    cores work on the third. W is [K, D] row-major, an MN-major
//    ("trans-b") operand stored as two 64-column atoms per stage: TMA loads
//    them (a 2-D map, 128-byte swizzle, k past K zero-filled) where D is a
//    multiple of 8 and W 16-byte aligned, otherwise cp.async does, in the
//    same layout. cp.async writes through the generic proxy and wgmma reads
//    through the async proxy: each thread waits for its copies, fences the
//    proxies, and a block barrier then orders every thread's copies before
//    the next wgmma chain (and every warpgroup's last chain before the
//    stage is loaded again).
//  * Epilogue: accumulator + float(bias), rounded to bf16 (round to nearest
//    even) and stored from registers as bf16 pairs.
//
// float32 (the reference's numerics: the float32 round, the parity
// checks), on the tensor cores in 3xTF32, one block on each SM. TF32 keeps
// 10 mantissa bits, so each operand a is split into hi = tf32(a) and
// lo = tf32(a - hi), and each product is A_lo B_hi + A_hi B_lo + A_hi B_hi:
// only lo lo (about 2^-22 relative) is dropped, which keeps float32's
// accuracy where one TF32 product (2^-11) would not (the MLP's and
// attention's float32 routes do the same).
//  * patch_embed_split_kernel: W [K, D] into its transposed TF32 pair
//    hi, lo [D, Kpad] (K-major, since TF32 wgmma has no transpose bit; K
//    zero-padded to Kpad, a multiple of 4, so that a row is a multiple of
//    16 bytes for TMA), into a caller-provided workspace: 2.4 MB read and
//    4.7 MB written at the main shape, on every call.
//  * patch_embed_tf32x3_kernel: a 4-stage ring of (A 128 x 32, W_hi
//    128 x 32, W_lo 128 x 32) float32 tiles, 128-byte swizzled (48 KB a
//    stage); A gathered by cp.async as above (V = 4, 2 or 1 floats), the
//    pair by TMA on one mbarrier per stage. Each thread loads its wgmma
//    fragments of A from the stage (conflict-free under the swizzle) and
//    splits them in registers; each k-step of 8 issues wgmma m64n128k8
//    three times, A from registers, the pair from shared memory. The
//    tensor cores add into their accumulator with truncation, so each
//    stage's 12 products go to an accumulator of their own that is added
//    to a float32 sum in registers.
//  * Epilogue: sum + bias, stored as float32 pairs.
#include <algorithm>
#include <cstdint>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace svt;  // the Hopper primitives (hopper.cuh)

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

// the widest copy (16 bytes or fewer: 8, 4, 2 or 1 values of `bytes`
// bytes) that every copy of a row can take: `run` values contiguous in
// global memory, each run starting a multiple of `stride` values after `p`
int widest(const void* p, int run, int stride, int bytes = 2) {
  const std::uintptr_t addr = reinterpret_cast<std::uintptr_t>(p);
  int v = 16 / bytes;
  while (v > 1 && (run % v || stride % v || addr % (bytes * v))) v /= 2;
  return v;
}

// Kernel slots of prepare_launch (hopper.cuh): bf16 4 (TMA route) +
// log2(v), float32 TF_SLOT + log2(v).
constexpr int TF_SLOT = 8;
constexpr int SLOTS = TF_SLOT + 3;

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

// ---------------------------------------------------------------------------
// float32: cp.async ring for the patches, TMA for W's TF32 pair, 3xTF32
// ---------------------------------------------------------------------------

constexpr int TF_BK = 32;                          // k per stage: one 128-byte swizzle row of float32
constexpr int TF_STAGES = 4;
constexpr int TF_TILE_BYTES = BM * TF_BK * 4;      // [128 rows][32 k]: A, or a half of W's pair
constexpr int TF_STAGE_BYTES = 3 * TF_TILE_BYTES;  // A, W_hi, W_lo
// alignment slack, the ring, each row's image offset, one mbarrier per stage
constexpr size_t TF_SMEM = 1024 + (size_t)TF_STAGES * TF_STAGE_BYTES + BM * 8 + TF_STAGES * 8;
static_assert(TF_SMEM <= 232448, "the TF32 ring must fit a block's 227 KB of shared memory");

// a float32 as its TF32 pair: hi = tf32(a), lo = tf32(a - hi) (a - hi is
// exact in float32), as mlp_block.cu splits its operands
__device__ __forceinline__ float2 split_tf32(float a) {
  const float hi = to_tf32(a);
  return make_float2(hi, to_tf32(a - hi));
}

constexpr int SPLIT_TILE = 32;

// W [K, D] (row-major, any D) into its transposed TF32 pair hi, lo
// [D, Kpad], zero for k past K: B of the GEMM in the K-major layout TF32
// wgmma reads. A block moves a 32 x 32 tile through shared memory: loads
// along W's rows, stores along K.
__global__ void __launch_bounds__(256)
patch_embed_split_kernel(const float* __restrict__ w, float* __restrict__ hi, float* __restrict__ lo,
                         int K, int D, int Kpad) {
  __shared__ float tile[SPLIT_TILE][SPLIT_TILE + 1];
  const int k0 = blockIdx.y * SPLIT_TILE, d0 = blockIdx.x * SPLIT_TILE;
  for (int i = threadIdx.x; i < SPLIT_TILE * SPLIT_TILE; i += 256) {
    const int kk = i / SPLIT_TILE, dd = i % SPLIT_TILE;
    tile[kk][dd] = k0 + kk < K && d0 + dd < D ? w[(size_t)(k0 + kk) * D + d0 + dd] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < SPLIT_TILE * SPLIT_TILE; i += 256) {
    const int dd = i / SPLIT_TILE, kk = i % SPLIT_TILE;
    if (d0 + dd >= D || k0 + kk >= Kpad) continue;
    const float2 p = split_tf32(tile[kk][dd]);
    const size_t o = (size_t)(d0 + dd) * Kpad + k0 + kk;
    hi[o] = p.x;
    lo[o] = p.y;
  }
}

// One block tile in 3xTF32: rows m0 .. m0 + 127 of the [M, K] patch matrix
// times columns n0 .. n0 + 127 of W, whose TF32 pair comes by whi and wlo
// (dims {Kpad, D}, box {32, 128}). V: floats per copy of the cp.async
// gathers. Every wgmma chain is straight-line code.
template <int V>
__global__ void __launch_bounds__(HP_THREADS, 1)
patch_embed_tf32x3_kernel(const __grid_constant__ CUtensorMap whi, const __grid_constant__ CUtensorMap wlo,
                          const float* __restrict__ img, const float* __restrict__ bias,
                          float* __restrict__ out, int H, int W, int C, int P, int D, int M,
                          int col_tiles) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* ring = smem_raw + (base - raw);
  long long* rowoff = reinterpret_cast<long long*>(smem_raw + (base - raw) + TF_STAGES * TF_STAGE_BYTES);
  const uint32_t full_bar = base + TF_STAGES * TF_STAGE_BYTES + BM * 8;  // full[s] = full_bar + 8 s

  const int tid = threadIdx.x;
  // column tiles of one row tile are neighbours in the grid: they run
  // together and read the same patches from L2
  const int m0 = (blockIdx.x / col_tiles) * BM, n0 = (blockIdx.x % col_tiles) * BN;
  const int PC = P * C, K = P * PC, WC = W * C;
  const int chunks = (K + TF_BK - 1) / TF_BK;

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
  if (tid == 0) {
    for (int s = 0; s < TF_STAGES; ++s) mbar_init(full_bar + 8 * s, 1);  // the expect_tx
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // this thread's copies in every stage: piece aj (V values of k) of A rows
  // ar0, ar0 + A_STEP, ...
  constexpr int A_PIECES = TF_BK / V, A_STEP = HP_THREADS / A_PIECES;
  const int aj = tid % A_PIECES, ar0 = tid / A_PIECES;

  // chunk kc (k = 32 kc ...) into stage kc % TF_STAGES; one cp.async group
  // per call, empty past the last chunk, so that the groups count stages
  auto load = [&](int kc) {
    if (kc < chunks) {
      const uint32_t as = base + (kc % TF_STAGES) * TF_STAGE_BYTES;
      const int k = kc * TF_BK + aj * V;
      const long long koff = (long long)(k / PC) * WC + k % PC;  // (ph, pw * C + c)
#pragma unroll
      for (int i = 0; i < BM / A_STEP; ++i) {
        const int r = ar0 + i * A_STEP;
        const long long ro = rowoff[r];
        const bool ok = k < K && ro >= 0;
        cp_async<4 * V>(as + sw128_offset(r, aj * V / 4) + (aj * V % 4) * 4, ok ? img + ro + koff : img,
                        ok);
      }
      if (tid == 0) {
        const uint32_t bar = full_bar + 8 * (kc % TF_STAGES);
        mbar_expect_tx(bar, 2 * TF_TILE_BYTES);
        tma_load_2d(as + TF_TILE_BYTES, &whi, bar, kc * TF_BK, n0);
        tma_load_2d(as + 2 * TF_TILE_BYTES, &wlo, bar, kc * TF_BK, n0);
      }
    }
    cp_async_commit();
  };

  // acc: one chunk's products (wgmma's accumulator); sum: the float32 sum
  // of the chunks
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
  for (int s = 0; s < TF_STAGES - 1; ++s) load(s);
  for (int kc = 0; kc < chunks; ++kc) {
    const int s = kc % TF_STAGES;
    const unsigned char* as = ring + s * TF_STAGE_BYTES;
    const uint32_t bh = base + s * TF_STAGE_BYTES + TF_TILE_BYTES, bl = bh + TF_TILE_BYTES;
    cp_async_wait<TF_STAGES - 2>();  // this thread's copies of chunk kc have landed
    mbar_wait(full_bar + 8 * s, (kc / TF_STAGES) & 1);
    // every thread's copies of chunk kc are in, and both warpgroups are done
    // with chunk kc - 1, whose stage is loaded next (A is read by plain
    // loads below, so it needs no proxy fence)
    __syncthreads();
    load(kc + TF_STAGES - 1);
    // A's fragments of the chunk, split into their TF32 pairs in registers
    uint32_t a_hi[TF_BK / 8][4], a_lo[TF_BK / 8][4];
#pragma unroll
    for (int kd = 0; kd < TF_BK / 8; ++kd)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t off = a_row + (j % 2) * 8 * 128 + (((2 * kd + j / 2) ^ g) << 4);
        const float2 p = split_tf32(*reinterpret_cast<const float*>(as + off));
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
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] += acc[i];
  }

  // epilogue: sum[4 j + 2 h + e] is row 16 warp + g + 8 h of this
  // warpgroup's 64, column 8 j + 2 q + e
  const int row0 = m0 + wg * 64 + 16 * warp + g;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = n0 + 8 * j + 2 * q;
    const float b0 = col < D ? bias[col] : 0.f;
    const float b1 = col + 1 < D ? bias[col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= M || col >= D) continue;
      float* o = out + (size_t)row * D + col;
      const float v0 = sum[4 * j + 2 * h] + b0, v1 = sum[4 * j + 2 * h + 1] + b1;
      if (D % 2 == 0) {  // col is even: the pair is 8-byte aligned and inside the row
        *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
      } else {
        o[0] = v0;
        if (col + 1 < D) o[1] = v1;
      }
    }
  }
}

using Tf32Kernel = void (*)(const CUtensorMap, const CUtensorMap, const float*, const float*, float*, int,
                            int, int, int, int, int, int);

// the kernel instance of copy width v (4, 2 or 1 floats)
Tf32Kernel tf32x3_kernel(int v) {
  switch (v) {
    case 4: return patch_embed_tf32x3_kernel<4>;
    case 2: return patch_embed_tf32x3_kernel<2>;
    default: return patch_embed_tf32x3_kernel<1>;
  }
}

int launch_tf32x3(const float* img, const float* w, const float* bias, float* out, float* wt, int B, int H,
                  int W, int C, int P, int D, cudaStream_t st) {
  const int M = B * (H / P) * (W / P), K = P * P * C, Kpad = (K + 3) / 4 * 4;
  // TMA: the pair's base and rows 16-byte aligned; float pair stores
  const std::uintptr_t wt_addr = reinterpret_cast<std::uintptr_t>(wt);
  if (wt_addr % 16 || reinterpret_cast<std::uintptr_t>(out) % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  float* w_hi = wt;  // [D, Kpad]
  float* w_lo = wt + (size_t)D * Kpad;
  patch_embed_split_kernel<<<dim3((D + SPLIT_TILE - 1) / SPLIT_TILE, (Kpad + SPLIT_TILE - 1) / SPLIT_TILE),
                             256, 0, st>>>(w, w_hi, w_lo, K, D, Kpad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  CUtensorMap maps[2];
  for (int i = 0; i < 2; ++i) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Kpad), static_cast<cuuint64_t>(D)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Kpad) * 4};
    const cuuint32_t box[2] = {TF_BK, BN}, unit[2] = {1, 1};
    const CUresult r = encode(&maps[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, i ? w_lo : w_hi, dims, strides,
                              box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  // A's runs are one image-row segment of a patch (P*C values), at
  // multiples of W*C (image rows) and P*C (patches)
  const int v = widest(img, P * C, W * C, 4);
  const Tf32Kernel kernel = tf32x3_kernel(v);
  int slot = TF_SLOT, sms = 0;
  for (int x = v; x > 1; x /= 2) ++slot;
  err = prepare_launch<SLOTS>(reinterpret_cast<const void*>(kernel), slot, TF_SMEM, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int col_tiles = (D + BN - 1) / BN;
  const long long tiles = (long long)col_tiles * ((M + BM - 1) / BM);
  kernel<<<static_cast<unsigned>(tiles), HP_THREADS, TF_SMEM, st>>>(maps[0], maps[1], img, bias, out, H, W,
                                                                     C, P, D, M, col_tiles);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" {

// the float32 route: W's TF32 pair into the workspace wt [2, D, Kpad]
// (Kpad = P*P*C rounded up to a multiple of 4), then the 3xTF32 GEMM; wt
// 16-byte aligned and out 8-byte aligned (else cudaErrorInvalidValue,
// before any launch)
int svt_patch_embed_tf32x3(const void* img, const void* w, const void* bias, void* out, void* wt,
                           int B, int H, int W, int C, int P, int D, void* stream) {
  return launch_tf32x3(static_cast<const float*>(img), static_cast<const float*>(w),
                       static_cast<const float*>(bias), static_cast<float*>(out), static_cast<float*>(wt),
                       B, H, W, C, P, D, static_cast<cudaStream_t>(stream));
}

int svt_patch_embed_bf16(const void* img, const void* w, const void* bias, void* out,
                         int B, int H, int W, int C, int P, int D, void* stream) {
  return launch_hopper(static_cast<const bf16*>(img), static_cast<const bf16*>(w),
                       static_cast<const bf16*>(bias), static_cast<bf16*>(out), B, H, W, C, P, D,
                       static_cast<cudaStream_t>(stream));
}

}  // extern "C"
