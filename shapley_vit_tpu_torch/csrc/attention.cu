// Multi-head attention for Hopper (sm_90a), forward only: one entry point
// per route, svt_attention_bhnd_*, each of which takes q, k, v, o as
// [B, H, N, d] through their batch, head and row strides: _bf16 the
// tensor-core kernel (16-byte aligned bf16; it refuses other inputs),
// _fma_bf16 and _f32 the FMA kernel. The caller picks the route
// (ops/attention.attention_route).
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
// Masking: a key at or past N gets weight exactly 0, which is what both
// -1e30 and -inf give (exp of either, less the row max, is 0).
//
// Bound on an H100 SXM, bf16: at the Shapley round's packed shape (B = 896 =
// 7 coalitions x 128 images, N = 197, H = 12, d = 64) 4*B*H*N^2*d = 0.107
// TFLOP over 989 TFLOP/s = 0.108 ms against q, k, v read and o written
// once, 1.08 GB over 3.35 TB/s = 0.324 ms; at the training step's
// [64, 12, 197, 64], 7.6 GFLOP (0.008 ms) against 77 MB (0.023 ms). Both
// are bound by memory in bf16 (in float32 by the 67 TFLOP/s FMA rate). The
// scores never leave the chip.
//
// Design. bf16 with 16-byte aligned pointers and strides (the main paths):
// one unit of work is one (image, head) — all of its query rows, with K and
// V loaded once — and a persistent grid of one block per SM walks the B*H
// units, unit u = image u / H, head u % H, so the blocks in flight at one
// time read the heads of the same images (shared DRAM pages and L2 lines).
//  * Loads: a producer thread issues TMA loads of the next unit's Q [qr x 64],
//    K and V [nk x 64] (qr = N rounded to 64, nk = N rounded to 16) into a
//    2-stage ring while the consumers compute the current one (mbarriers
//    full and empty per stage). The tensor map has N as an axis of its own,
//    so rows at or past N arrive as zeros and are never the next image's.
//    Rows are 128 bytes with the 128-byte swizzle, as wgmma reads them.
//    173 KB of shared memory at N = 197 (181 KB at N = 224): one block per
//    SM, which the ring keeps busy instead of a second block.
//  * Two consumer warpgroups take the unit's 64-row query tiles in turn,
//    and take turns (two named barriers) at S and its softmax: one runs
//    them while the other runs P V and hands over its output, so the
//    tensor cores and the FMA/MUFU units work at once. setmaxnreg moves
//    registers from the producer warpgroup (24 a thread) to the consumers
//    (240).
//    S = Q K^T: wgmma chains of 64 keys (m64n64k16; the last chain 16, 32
//    or 48 keys wide; 4 steps over d). The float32 accumulator stays in
//    registers: bf16 products are exact in float32, so these are the
//    Pallas kernel's float32 scores. Softmax in registers: keys at or past
//    N set to -inf before the row max (the zero-filled keys would score
//    0), row max and sum over the 4 lanes of a row, exp in float32 (ex2 of
//    the scaled score). The scores never touch shared memory.
//  * O = P V on the tensor cores without rounding p to bf16: p = p_hi +
//    p_lo (p_hi = bf16(p), p_lo = bf16(p - p_hi)), two wgmma m64n64k16
//    products per 16 keys into one float32 accumulator, A from registers
//    (the S accumulator's layout is wgmma's A fragment), B = V in shared
//    memory, MN-major. Each product with bf16 v is exact, and p keeps 16
//    bits (|p - p_hi - p_lo| <= 2^-18 p), well under the output's bf16
//    step, though not float32's 24: about 0.2 % of the bf16 outputs land
//    one step from the float32 p v's value, against about 0.02 % for a
//    float32 p v summed in another order. p is not normalised
//    before P V; O is multiplied by 1 / row sum after it. The split doubles
//    the P V operations: about 0.16 TFLOP at the round's shape, 0.16 ms,
//    still under the memory bound.
//  * Outputs: O times 1 / row sum, in bf16, over the Q tile in shared memory
//    (S has read it), swizzled as the output's tensor map expects; an
//    mbarrier per tile tells the producer, which issues one TMA store per
//    64-row tile (it drops the rows at or past N), so no consumer waits on
//    the store's issue.
// float32 (the parity path, and bf16 tensors that are not 16-byte aligned):
// one block per (batch, head, 64 query rows), all on the FMA units: K and V
// of the (batch, head) in shared memory read through the strides; each of
// the 8 warps takes 4 query rows at a time, lane l owning keys l, l+32, ...,
// so one float4 of K feeds the 4 rows; K rows are padded to 68 floats so the
// lanes' float4 reads hit distinct banks.
#include <cuda.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>
#include <utility>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace svt;  // the Hopper primitives (hopper.cuh)

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
// bf16: TMA loads, wgmma products, one persistent block per SM
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int WG_CONSUMERS = 2;                        // consumer warpgroups
constexpr int HP_THREADS = 128 * (WG_CONSUMERS + 1);  // + the producer warpgroup
constexpr int STAGES = 2;
constexpr int KC = 16;                 // keys per wgmma chunk (the k16 of p v)
constexpr int MAX_KC = 32 * NJ / KC;   // 14 chunks: N <= 224
constexpr int ROW = HD * 2;            // bytes of one bf16 row = one 128-byte swizzle row
constexpr int QTILE = 64;              // query rows of one wgmma tile
constexpr int MAX_TILES = 4;           // query tiles of a unit: N <= 256
// mbarriers per stage: full, empty, and one per query tile whose output is
// ready in shared memory for the producer's TMA store
constexpr int BARRIERS = STAGES * (2 + MAX_TILES);

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// one stage holds Q [qr][64], K [nk][64] and V [nk][64] of one (image, head),
// each row 128 bytes, 128-byte swizzled; qr = 64 * tiles, nk = N rounded to 16
__host__ __device__ constexpr int stage_bytes(int qr, int nk) { return (qr + 2 * nk) * ROW; }
size_t hp_smem_bytes(int qr, int nk) {
  return 1024 /* alignment slack */ + (size_t)STAGES * stage_bytes(qr, nk) + BARRIERS * 8;
}

// tensor-map coordinates of axes 1-3 (axis 0 is d) of row `row` of unit
// (image b, head h); pos packs the axis of the head (bits 0-1) and of the
// image (bits 2-3), and the row axis is the one left
struct Coords { int c1, c2, c3; };
__device__ __forceinline__ Coords unit_coords(int pos, int b, int h, int row) {
  const int ph = pos & 3, pb = pos >> 2, pn = 6 - ph - pb;
  auto at = [&](int axis) {
    return (ph == axis ? h : 0) + (pb == axis ? b : 0) + (pn == axis ? row : 0);
  };
  return {at(1), at(2), at(3)};
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         Coords c) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(0), "r"(c.c1), "r"(c.c2), "r"(c.c3)
      : "memory");
}

// one bulk group: a box of shared memory to the tensor, clipped at its edges
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, Coords c) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(0), "r"(c.c1), "r"(c.c2), "r"(c.c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void st_shared(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;" ::"r"(addr), "r"(v) : "memory");
}

// d[64 x W] (+)= A[64 x 16] B[W x 16]^T, A (Q) and B (K) K-major in shared
// memory; d holds the W / 2 accumulator registers of a thread (columns
// 8 (i / 4) + 2 (lane % 4) + i % 2, rows lane / 4 + 8 ((i % 4) / 2) of its warp)
template <int W>
__device__ __forceinline__ void wgmma_qk(float* d, uint64_t a, uint64_t b, int accumulate) {
  static_assert(W == 16 || W == 32 || W == 48 || W == 64, "key block of 16, 32, 48 or 64");
  if constexpr (W == 16)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(accumulate));
  if constexpr (W == 32)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  if constexpr (W == 48)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, %24, %25, p, 1, 1, 0, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
        : "l"(a), "l"(b), "r"(accumulate));
  if constexpr (W == 64)
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64], A (p) from registers, B (V) in
// shared memory with the 64 output columns contiguous (MN-major: trans-b)
__device__ __forceinline__ void wgmma_pv(float (&d)[32], const uint32_t* a, uint64_t b,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// turns of the two consumer warpgroups at the tensor cores: warpgroup w
// waits at named barrier 1 + w, which the other warpgroup's pass completes
__device__ __forceinline__ void turn_wait(int w) {
  asm volatile("bar.sync %0, 256;" ::"r"(1 + w) : "memory");
}
__device__ __forceinline__ void turn_pass(int w) {
  asm volatile("bar.arrive %0, 256;" ::"r"(2 - w) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo_col, float hi_col) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo_col, hi_col);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Warps 0-7 are two consumer warpgroups, warps 8-11 the producer's. The block
// walks the units u = blockIdx.x, blockIdx.x + gridDim.x, ... (unit u is
// image u / H, head u % H). pos places the head and image axes in the
// tensor maps (unit_coords). NCH = nk / 16 is a template parameter so that
// every wgmma chain is straight-line code: a branch inside a chain makes the
// compiler wait for each wgmma in turn.
template <int NCH>
__global__ void __launch_bounds__(HP_THREADS, 1)
attention_hopper_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap omap, int N, int H, int units, int qr,
                        int nk, int pos, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024 bytes
  const uint32_t stage = stage_bytes(qr, nk);
  const uint32_t full_bar = base + STAGES * stage;  // full[s] = full_bar + 8 s
  const uint32_t empty_bar = full_bar + 8 * STAGES;
  const uint32_t ready_bar = empty_bar + 8 * STAGES;  // ready[s][t] = ready_bar + 8 (4 s + t)
  const int tiles = qr / QTILE;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);                  // the producer's expect_tx
      mbar_init(empty_bar + 8 * s, 128 * WG_CONSUMERS);  // every consumer thread
      for (int t = 0; t < MAX_TILES; ++t)
        mbar_init(ready_bar + 8 * (MAX_TILES * s + t), 128);  // the tile's warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * WG_CONSUMERS) {
    // producer: one thread keeps the next units' Q, K and V in flight and
    // stores each output tile as its warpgroup has it ready in shared
    // memory; its warpgroup hands its registers to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (threadIdx.x != 128 * WG_CONSUMERS) return;
    auto load = [&](int iu) {
      const int s = iu % STAGES, u = blockIdx.x + iu * gridDim.x;
      const Coords c = unit_coords(pos, u / H, u % H, 0);
      const uint32_t bar = full_bar + 8 * s, qs = base + s * stage;
      mbar_expect_tx(bar, stage);  // rows at or past N arrive zero-filled and count
      tma_load(qs, &qmap, bar, c);
      tma_load(qs + qr * ROW, &kmap, bar, c);
      tma_load(qs + (qr + nk) * ROW, &vmap, bar, c);
    };
    const int count = (units - blockIdx.x + gridDim.x - 1) / gridDim.x;  // this block's units
    for (int iu = 0; iu < min(count, STAGES); ++iu) load(iu);
    for (int iu = 0; iu < count; ++iu) {
      const int s = iu % STAGES, u = blockIdx.x + iu * gridDim.x;
      const uint32_t parity = (iu / STAGES) & 1;
      for (int t = 0; t < tiles; ++t) {
        mbar_wait(ready_bar + 8 * (MAX_TILES * s + t), parity);
        tma_store(&omap, base + s * stage + t * QTILE * ROW, unit_coords(pos, u / H, u % H, t * QTILE));
      }
      if (iu + STAGES < count) {
        mbar_wait(empty_bar + 8 * s, parity);  // the consumers are done with the stage
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");  // and the stores
        load(iu + STAGES);
      }
    }
    asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    return;
  }

  // consumers: warpgroup wg takes the unit's query tiles wg, wg + 2, ...
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = threadIdx.x / 128, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int quad = lane % 4;
  if (wg == 1) turn_pass(1);  // warpgroup 0 takes the first turn
  for (int iu = 0, u = blockIdx.x; u < units; ++iu, u += gridDim.x) {
    const int s = iu % STAGES;
    mbar_wait(full_bar + 8 * s, (iu / STAGES) & 1);
    const uint32_t qs = base + s * stage, ks = qs + qr * ROW, vs = ks + nk * ROW;

    // The two warpgroups take turns (named barriers 1 and 2) at S and its
    // softmax: one runs them while the other runs P V and its stores, so
    // the tensor cores and the FMA/MUFU units work at once. Both pass
    // through every turn: where the tiles are odd in number, warpgroup 1
    // computes the last tile again and stores nothing (a branch around the
    // products would make the compiler serialise them).
    for (int it = 0; it < (tiles + WG_CONSUMERS - 1) / WG_CONSUMERS; ++it) {
      const int t = min(WG_CONSUMERS * it + wg, tiles - 1);
      const bool store = WG_CONSUMERS * it + wg < tiles;
      // S[64, nk] = Q_t K^T in blocks of 64 keys (the last one 16, 32 or 48),
      // each a chain of 4 wgmma steps of 16 over d. Element e of chunk c (16
      // keys) is sc[8 c + e]: row 16 warp + lane / 4 + 8 ((e % 4) / 2), key
      // 16 c + 8 (e / 4) + 2 (lane % 4) + e % 2.
      constexpr int FULL = NCH / 4, REM = NCH % 4;
      float sc[NCH * 8];  // the first step of each chain overwrites (scale-d 0)
      turn_wait(wg);
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int blk = 0; blk < FULL; ++blk)
#pragma unroll
        for (int kd = 0; kd < HD / 16; ++kd)
          wgmma_qk<64>(sc + 32 * blk, sw128_desc(qs + t * QTILE * ROW + 32 * kd),
                       sw128_desc(ks + blk * 64 * ROW + 32 * kd), kd);
      if constexpr (REM > 0) {
#pragma unroll
        for (int kd = 0; kd < HD / 16; ++kd)
          wgmma_qk<16 * REM>(sc + 32 * FULL, sw128_desc(qs + t * QTILE * ROW + 32 * kd),
                             sw128_desc(ks + FULL * 64 * ROW + 32 * kd), kd);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);

      // softmax in registers; keys at or past N (only in the last chunk:
      // nk < N + 16) get -inf, since the zero-filled keys would score 0
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (KC * (NCH - 1) + 8 * (e / 4) + 2 * quad + e % 2 >= N) sc[8 * (NCH - 1) + e] = -INFINITY;
      float mx[2] = {-INFINITY, -INFINITY};  // of the raw scores: scale > 0
#pragma unroll
      for (int i = 0; i < NCH * 8; ++i) mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], sc[i]);
      const float l2 = scale * 1.4426950408889634f;  // exp(x scale) = 2^(x scale log2 e)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        mx[r] *= l2;
      }
      // p v without rounding p to bf16: p = p_hi + p_lo, p_hi = bf16(p),
      // p_lo = bf16(p - p_hi); the products with bf16 v are exact in float32
      uint32_t phi[NCH * 4], plo[NCH * 4];
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < NCH * 8; i += 2) {
        const float a = ex2(fmaf(sc[i], l2, -mx[(i % 4) / 2]));  // masked keys: 2^-inf == 0
        const float b = ex2(fmaf(sc[i + 1], l2, -mx[(i % 4) / 2]));
        sum[(i % 4) / 2] += a + b;
        phi[i / 2] = pack_bf16(a, b);
        plo[i / 2] = pack_bf16(a - __uint_as_float(phi[i / 2] << 16),
                               b - __uint_as_float(phi[i / 2] & 0xffff0000u));
      }
      turn_pass(wg);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        sum[r] = 1.f / sum[r];
      }

      // O[64, 64] = P V over 16-key steps, hi and lo into one accumulator
      float oc[32];
      fence_regs(oc);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const uint64_t vd = sw128_desc(vs + c * KC * ROW);
        wgmma_pv(oc, phi + 4 * c, vd, c);
        wgmma_pv(oc, plo + 4 * c, vd, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(oc);

      // O / row sum in bf16 over Q_t in shared memory (S_t has read it), in
      // the 128-byte swizzle of the output's tensor map, for the producer's
      // TMA store, which drops rows at or past N
      if (store) {
        const uint32_t ot = qs + t * QTILE * ROW;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = 16 * warp + lane / 4 + 8 * hr;
#pragma unroll
          for (int j = 0; j < HD / 8; ++j)
            st_shared(ot + row * ROW + ((j ^ (row % 8)) * 16) + 4 * quad,
                      pack_bf16(oc[4 * j + 2 * hr] * sum[hr], oc[4 * j + 2 * hr + 1] * sum[hr]));
        }
        fence_proxy_async();
        mbar_arrive(ready_bar + 8 * (MAX_TILES * s + t));
      }
    }
    mbar_arrive(empty_bar + 8 * s);  // this thread is done with the stage
  }
  if (wg == 0) turn_wait(0);  // takes up warpgroup 1's last pass
}

// Kernel slots of prepare_launch (hopper.cuh), each allowed the dynamic
// shared memory of its largest N: attention_hopper_kernel<nch> is nch - 1,
// attention_kernel<T> MAX_KC (float) and MAX_KC + 1 (bf16).
constexpr int SLOTS = MAX_KC + 2;

// The [B, H, N, d] view as a 4-D tensor map: d innermost, then the row,
// head and image axes in order of stride. An axis of extent 1 other than
// the row (its stride may be anything) goes outermost with a stride that
// extends the layout. Rows at or past N read as zeros.
struct Axis { long long stride; long long extent; int role; };  // role 0 row, 1 head, 2 image

using HopperKernel = void (*)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                              const CUtensorMap, int, int, int, int, int, int, float);

// attention_hopper_kernel<nch> for nch = 1 .. MAX_KC
template <int... I>
HopperKernel hopper_kernel(int nch, std::integer_sequence<int, I...>) {
  static constexpr HopperKernel kernels[] = {attention_hopper_kernel<I + 1>...};
  return kernels[nch - 1];
}

int launch_hopper(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int N, int H,
                  long long sb, long long sh, long long sn, float scale, cudaStream_t st) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  Axis ax[3] = {{sn, N, 0}, {sh, H, 1}, {sb, B, 2}};
  auto filler = [](const Axis& a) { return a.extent == 1 && a.role != 0; };
  std::sort(ax, ax + 3, [&](const Axis& a, const Axis& b) {
    if (filler(a) != filler(b)) return filler(b);
    return a.stride < b.stride;
  });
  cuuint64_t dims[4] = {HD, 0, 0, 0}, strides[3];
  int pos[3] = {0, 0, 0};
  for (int i = 0; i < 3; ++i) {
    long long bytes = 2 * ax[i].stride;
    if (filler(ax[i])) bytes = i == 0 ? ROW : static_cast<long long>(strides[i - 1]) * dims[i];
    dims[i + 1] = static_cast<cuuint64_t>(ax[i].extent);
    strides[i] = static_cast<cuuint64_t>(bytes);
    pos[ax[i].role] = i + 1;
  }
  const int tiles = (N + QTILE - 1) / QTILE, qr = tiles * QTILE, nk = round_up(N, KC);
  // q: whole units of qr rows; k, v: nk rows; o: one query tile at a time
  CUtensorMap maps[4];
  const void* ptrs[4] = {q, k, v, o};
  const int rows[4] = {qr, nk, nk, QTILE};
  for (int m = 0; m < 4; ++m) {
    cuuint32_t box[4] = {HD, 1, 1, 1}, unit[4] = {1, 1, 1, 1};
    box[pos[0]] = rows[m];
    const CUresult r = encode(&maps[m], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptrs[m]),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nch = nk / KC;
  const HopperKernel kernel = hopper_kernel(nch, std::make_integer_sequence<int, MAX_KC>{});
  int sms = 0;
  const cudaError_t err = prepare_launch<SLOTS>(reinterpret_cast<const void*>(kernel), nch - 1,
                                         hp_smem_bytes(round_up(nk, QTILE), nk), &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = B * H;
  kernel<<<std::min(units, sms), HP_THREADS, hp_smem_bytes(qr, nk), st>>>(
      maps[0], maps[1], maps[2], maps[3], N, H, units, qr, nk, pos[1] | (pos[2] << 2), scale);
  return static_cast<int>(cudaGetLastError());
}

// q, k, v and o share the strides (in elements) sb of the batch, sh of the
// head and sn of the row; the head dim is contiguous.
template <typename T>
int launch_fma(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
               long long sb, long long sh, long long sn, float scale, void* stream) {
  int sms = 0;
  const cudaError_t err = prepare_launch<SLOTS>(reinterpret_cast<const void*>(attention_kernel<T>),
                                         MAX_KC + (std::is_same_v<T, bf16> ? 1 : 0),
                                         smem_bytes(32 * NJ), &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((N + QT - 1) / QT, H, B);
  attention_kernel<T><<<grid, THREADS, smem_bytes(N), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), N, sb, sh, sn, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// The largest sequence length the kernels take (keys per lane x 32).
int svt_attention_max_seq(void) { return 32 * NJ; }

// [B, H, N, d] views with the given strides (elements); the packed
// [B, N, H*d] layout is batch stride N*H*d, head stride d, row stride H*d
int svt_attention_bhnd_f32(const void* q, const void* k, const void* v, void* o, int B,
                           int H, int N, long long sb, long long sh, long long sn,
                           float scale, void* stream) {
  return launch_fma<float>(q, k, v, o, B, N, H, sb, sh, sn, scale, stream);
}

int svt_attention_bhnd_fma_bf16(const void* q, const void* k, const void* v, void* o, int B,
                                int H, int N, long long sb, long long sh, long long sn,
                                float scale, void* stream) {
  return launch_fma<__nv_bfloat16>(q, k, v, o, B, N, H, sb, sh, sn, scale, stream);
}

// The tensor-core route. The TMA needs 16-byte aligned addresses and
// strides (the strides of axes of extent 1 are never used); other inputs
// are refused, not sent to another kernel.
int svt_attention_bhnd_bf16(const void* q, const void* k, const void* v, void* o, int B,
                            int H, int N, long long sb, long long sh, long long sn,
                            float scale, void* stream) {
  const bool aligned =
      ((reinterpret_cast<std::uintptr_t>(q) | reinterpret_cast<std::uintptr_t>(k) |
        reinterpret_cast<std::uintptr_t>(v) | reinterpret_cast<std::uintptr_t>(o)) % 16) == 0 &&
      sn > 0 && sn % 8 == 0 && (H == 1 || (sh > 0 && sh % 8 == 0)) &&
      (B == 1 || (sb > 0 && sb % 8 == 0));
  if (!aligned || B <= 0 || H <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return launch_hopper(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<bf16*>(o), B, N, H, sb, sh, sn,
                       scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
