// Multi-head attention for Hopper (sm_90a), forward only: one entry point
// per route, svt_attention_bhnd_*, each of which takes q, k, v, o as
// [B, H, N, d] through their batch, head and row strides: _bf16 the bf16
// tensor-core kernel of the main paths (16-byte aligned, head dim 64, N <=
// 224), _bf16_kl the bf16 tensor-core kernel with a key loop (16-byte
// aligned, head dim 64 or 128, any N), _bf16_wide the bf16 tensor-core
// kernel past head dim 128 (16-byte aligned, head dim 192, 256, ..., 512,
// any N), _bf16_stream the bf16 tensor-core kernel past head dim 512
// (16-byte aligned, any head dim past 512 that is a multiple of 64, any N),
// _tf32x3 the float32 tensor-core kernel (16-byte aligned, head dim 64 or
// 128, any N), _tf32x3_wide the float32 tensor-core kernel past head dim
// 128 (16-byte aligned, any head dim from 192 that is a multiple of 64, any
// N). Each entry refuses other inputs. The caller picks the route
// (ops/attention.attention_route), pads head dims to 64, to 128 or past 128
// to a multiple of 64, and copies tensors that the TMA cannot read.
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
// are bound by memory in bf16. In float32 3xTF32 does three TF32 products
// for each: 0.32 TFLOP over 495 TFLOP/s = 0.647 ms at the round's shape,
// and 2.17 GB of q, k, v and o over 3.35 TB/s = 0.647 ms (on the FMA units
// the 67 TFLOP/s would bound it at 1.59 ms). The scores never leave the
// chip.
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
// bf16 past 224 keys or at head dim 128 (the caller copies tensors that
// the TMA cannot read): attention_wgmma_kl_kernel, a persistent grid over
// units of (image, head, 128 query rows), each walking the keys in blocks
// of 64 with an online softmax, S and P V on wgmma with the p_hi + p_lo
// split above; see the kernel for the design. At 64 images of N = 577 and
// 12 heads of 64 (a 384 px ViT-B/16) 4*B*H*N^2*d = 65 GFLOP, 0.066 ms at
// 989 TFLOP/s (the split's tensor-core work, 98 GFLOP, 0.099 ms), against
// 0.23 GB of q, k, v and o, 0.068 ms over 3.35 TB/s.
// float32 (the float32 round and checks; the caller copies tensors that the
// TMA cannot read to aligned ones): attention_tf32x3_kernel, flash-style on the tensor cores in
// 3xTF32 (each float32 operand a as hi = tf32(a), lo = tf32(a - hi), each
// product as A_lo B_hi + A_hi B_lo + A_hi B_hi), one block per (image, head,
// 128 query rows) walking the keys in blocks of 64 (32 at head dim 128)
// with an online softmax; see the kernel for the design.
// bf16 at head dims 192 to 512: attention_wgmma_wide_kernel, the key-loop
// kernel's unit, grid and key blocks with the output in 128-column panels,
// S recomputed over all of d for each panel, so each consumer warpgroup
// keeps the key-loop kernel's registers; see the kernel for the design. At
// 64 images of N = 197 and 3 heads of 256 the bytes bound it: 77 MB of q,
// k, v and o, 0.023 ms over 3.35 TB/s, against 4*B*H*N^2*d = 7.6 GFLOP:
// 15 GFLOP of tensor-core work with S done once for each of the two output
// panels and the p split, 0.015 ms at 989 TFLOP/s.
// float32 past head dim 128: attention_tf32x3_wide_kernel, 3xTF32 as
// above, the output in 128-column panels with S recomputed over all of d
// for each, and Q and K streamed together in 32-column panels of d, so
// that shared memory does not grow with d and the head dim is a runtime
// count of panels, with no cap; see the kernel for the design. At 64
// images of N = 197 and 3 heads of 256, 4*B*H*N^2*d = 7.6 GFLOP, three
// TF32 products each, 0.046 ms at 495 TFLOP/s, against 0.155 GB of q, k, v
// and o, 0.046 ms over 3.35 TB/s.
// bf16 past head dim 512: attention_wgmma_stream_kernel, the wide kernel's
// unit, key blocks, output panels and p split, with Q and K streamed
// together through a ring in 64-column panels of d (as the float32 wide
// kernel streams them), so that shared memory does not grow with d and the
// head dim is a runtime count of panels, with no cap; see the kernel for
// the design. At 64 images of N = 197 and one head of 576, 4*B*H*N^2*d =
// 5.7 GFLOP, 0.006 ms at 989 TFLOP/s (with S done once for each of the 5
// output panels and the p split, 21 GFLOP of tensor-core work, 0.021 ms),
// against 58 MB of q, k, v and o, 0.017 ms over 3.35 TB/s.
#include <cuda.h>

#include <algorithm>
#include <cstdint>
#include <utility>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace svt;  // the Hopper primitives (hopper.cuh)

using bf16 = __nv_bfloat16;

constexpr int HD = 64;  // head dim of the bf16 tensor-core kernel

// ---------------------------------------------------------------------------
// bf16: TMA loads, wgmma products, one persistent block per SM
// ---------------------------------------------------------------------------

constexpr int WG_CONSUMERS = 2;                        // consumer warpgroups
constexpr int HP_THREADS = 128 * (WG_CONSUMERS + 1);  // + the producer warpgroup
constexpr int STAGES = 2;
constexpr int KC = 16;                 // keys per wgmma chunk (the k16 of p v)
constexpr int MAX_KC = 14;             // 14 chunks: N <= 224 (ops/attention.WGMMA_MAX_SEQ)
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

// a box of the 4-D map at d offset c0 (elements)
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, Coords c,
                                         int c0 = 0) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c.c1), "r"(c.c2), "r"(c.c3)
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

// ---------------------------------------------------------------------------
// float32: 3xTF32 on wgmma, a loop over key blocks with an online softmax
// ---------------------------------------------------------------------------

// The shapes of attention_tf32x3_kernel<D> (head dim D = 64 or 128).
template <int D>
struct Tf32 {
  static constexpr int BK = D == 64 ? 64 : 32;    // keys per block
  static constexpr int QROWS = 128;               // query rows of a unit: 64 per warpgroup
  static constexpr int PANELS = D / 32;           // 128-byte swizzle rows (32 float32) per row of d
  static constexpr int Q_BYTES = QROWS * D * 4;
  static constexpr int KV_BYTES = BK * D * 4;     // one of K, V, K_hi, K_lo, Vt_hi, Vt_lo
  static constexpr int RAW = D == 64 ? 2 : 1;     // raw K and V blocks in flight
  static constexpr int PAIRS = 4 * KV_BYTES;      // K_hi, K_lo, Vt_hi, Vt_lo of one block
  static constexpr int CONSUMERS = 256;           // two warpgroups
  static constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
  // Q | RAW x (K, V) | 2 x PAIRS | mbarriers: Q, raw[RAW], ready[2], free[2]
  static constexpr size_t SMEM =
      1024 + Q_BYTES + (size_t)RAW * 2 * KV_BYTES + 2 * (size_t)PAIRS + 8 * (1 + RAW + 4);
};
static_assert(Tf32<64>::SMEM <= 232448 && Tf32<128>::SMEM <= 232448,
              "a unit must fit a block's 227 KB of shared memory");

// d[64 x W] (+)= A[64 x 8] B[8 x W] in TF32, A in registers (hopper.cuh)
template <int W>
__device__ __forceinline__ void wgmma_tf32(float (&d)[W / 2], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  static_assert(W == 8 || W == 16 || W == 32 || W == 64 || W == 128, "n of 8, 16, 32, 64 or 128");
  if constexpr (W == 8) wgmma_m64n8k8_tf32_rs(d, a, b, accumulate);
  if constexpr (W == 16) wgmma_m64n16k8_tf32_rs(d, a, b, accumulate);
  if constexpr (W == 32) wgmma_m64n32k8_tf32_rs(d, a, b, accumulate);
  if constexpr (W == 64) wgmma_m64n64k8_tf32_rs(d, a, b, accumulate);
  if constexpr (W == 128) wgmma_m64n128k8_tf32_rs(d, a, b, accumulate);
}

// the producer warpgroup's threads meet (the consumers do not take part)
__device__ __forceinline__ void producers_sync() { asm volatile("bar.sync 1, 128;" ::: "memory"); }

// to_tf32 (cvt.rna) in two integer operations: half of the 13 dropped bits
// added to the magnitude's bits, then the 13 bits cleared. The same value
// for every finite float32; a NaN may turn into an infinity, which gives a
// NaN all the same wherever it enters a score or an output.
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

__device__ __forceinline__ float4 tf32_hi(float4 x) {
  return make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
}

__device__ __forceinline__ float4 minus(float4 a, float4 b) {
  return make_float4(a.x - b.x, a.y - b.y, a.z - b.z, a.w - b.w);
}

// Raw K and V (TMA's 128-byte swizzled boxes of [BK keys][32 columns])
// into the TF32 pairs the products read, hi = tf32(x), lo = tf32(x - hi), a
// float4 i at a time by the producer warpgroup. split_k4: K into K_hi and
// K_lo in the same layout (the K-major B of S = Q K^T). split_v4: V's key
// i % BK, columns 4 (i / BK) .. + 3, into Vt [ROWS][BK] transposed, in
// panels of [ROWS][32 keys] (the K-major B of P V: TF32 wgmma has no
// transpose bit). Within each 8 keys Vt stores keys (0, 2, 4, 6, 1, 3, 5,
// 7): the S accumulator gives a thread keys 2q and 2q + 1 of each 8, which
// are then the k = q and q + 4 of the A fragment, so p goes from S's
// registers to P V's A operand without a shuffle. With consecutive i on a
// warp's lanes every access is free of bank conflicts: a warp's V reads are
// 8 rows' distinct 16-byte chunks, and its Vt writes 32 keys of one row of d.
__device__ __forceinline__ void split_k4(unsigned char* sm, uint32_t k, uint32_t khi, uint32_t klo, int i) {
  const float4 x = *reinterpret_cast<const float4*>(sm + k + 16 * i);
  const float4 hi = tf32_hi(x);
  *reinterpret_cast<float4*>(sm + khi + 16 * i) = hi;
  *reinterpret_cast<float4*>(sm + klo + 16 * i) = tf32_hi(minus(x, hi));
}

template <int BK, int ROWS>
__device__ __forceinline__ void split_v4(unsigned char* sm, uint32_t v, uint32_t vhi, uint32_t vlo, int i) {
  static_assert(BK % 32 == 0, "whole panels of 32 keys");
  const int j = i % BK, d0 = 4 * (i / BK);  // key j, columns d0 .. d0 + 3
  const float4 x =
      *reinterpret_cast<const float4*>(sm + v + (d0 / 32) * BK * 128 + sw128_offset(j, (d0 % 32) / 4));
  const int kx = (j & ~7) | ((j & 1) << 2) | ((j & 7) >> 1);  // key j's column in Vt
  const uint32_t col = (kx / 32) * ROWS * 128 + 4 * (kx % 4);
  const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const uint32_t off = col + sw128_offset(d0 + e, (kx % 32) / 4);
    const float hi = tf32_rna(xs[e]);
    *reinterpret_cast<float*>(sm + vhi + off) = hi;
    *reinterpret_cast<float*>(sm + vlo + off) = tf32_rna(xs[e] - hi);
  }
}

// The block's raw K and V into their pairs at `pairs` (K_hi, K_lo, Vt_hi,
// Vt_lo), by the producer warpgroup's 128 threads.
template <int D>
__device__ __forceinline__ void split_block(unsigned char* sm, uint32_t k, uint32_t v, uint32_t pairs,
                                            int tid) {
  using S = Tf32<D>;
  const uint32_t khi = pairs, klo = khi + S::KV_BYTES, vhi = klo + S::KV_BYTES, vlo = vhi + S::KV_BYTES;
  static_assert(S::KV_BYTES % (16 * 128) == 0, "whole passes of the warpgroup");
#pragma unroll 2
  for (int it = 0; it < S::KV_BYTES / (16 * 128); ++it) split_k4(sm, k, khi, klo, tid + it * 128);
#pragma unroll 2
  for (int it = 0; it < S::BK * D / (4 * 128); ++it) split_v4<S::BK, D>(sm, v, vhi, vlo, tid + it * 128);
}

// The online softmax of a key block's scores sc [64, W] (S's accumulator
// layout: element e is row 16 warp + lane / 4 + 8 ((e % 4) / 2), key 8 (e /
// 4) + 2 qd + e % 2): keys at or past N (rem keys of the block are below
// it) get -inf, since their zero rows would score 0; the row max m over
// the 4 lanes of a row, p = 2^(s l2 - m), the thread's share of the row
// sum l, and alpha = 2^(m_old - m_new), by which the caller rescales O.
// p's TF32 pair (hi = tf32(p), lo = tf32(p - hi)) is P V's A fragment, 8
// keys a step: registers (4c, 4c + 2, 4c + 1, 4c + 3) of S's.
template <int W>
__device__ __forceinline__ void tf32_softmax(float (&sc)[W / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], uint32_t (&phi)[W / 8][4],
                                             uint32_t (&plo)[W / 8][4], int rem, int qd, float l2) {
#pragma unroll
  for (int e = 0; e < W / 2; ++e)
    if (8 * (e / 4) + 2 * qd + e % 2 >= rem) sc[e] = -INFINITY;
  float mx[2] = {-INFINITY, -INFINITY};  // of the raw scores: scale > 0
#pragma unroll
  for (int e = 0; e < W / 2; ++e) mx[(e % 4) / 2] = fmaxf(mx[(e % 4) / 2], sc[e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r] * l2);  // finite: the block has a key below N
    alpha[r] = ex2(m[r] - mn);                 // 0 for the first block
    m[r] = mn;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int c = 0; c < W / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int x = 4 * c + (e == 1 ? 2 : e == 2 ? 1 : e), r = (x % 4) / 2;
      const float p = ex2(fmaf(sc[x], l2, -m[r]));  // masked keys: 2^-inf == 0
      l[r] += p;
      const float hi = tf32_rna(p);
      phi[c][e] = __float_as_uint(hi);
      plo[c][e] = __float_as_uint(tf32_rna(p - hi));
    }
}

// One key block of a consumer warpgroup: S = Q K^T over the block's first W
// keys (a multiple of 8), the online softmax, and O += P V. W is a template
// parameter so that every wgmma chain is straight-line code.
template <int D>
struct KeyBlock {
  unsigned char* sm;  // generic address of the block's shared memory base
  uint32_t pairs;     // shared address of the block's TF32 pairs (K_hi, K_lo, Vt_hi, Vt_lo)
  uint32_t a_row;     // this thread's first A element of Q, from the base
  int g, qd;          // lane / 4, lane % 4
  int rem;            // keys of the block below N
  float l2;           // scale log2 e

  template <int W>
  __device__ __forceinline__ void run(float (&oc)[D / 2], float (&m)[2], float (&l)[2]) const {
    using S = Tf32<D>;
    constexpr int BK = S::BK;
    const uint32_t khi = pairs, klo = khi + S::KV_BYTES, vhi = klo + S::KV_BYTES, vlo = vhi + S::KV_BYTES;

    // S [64, W] = Q K^T; a chain covers two panels (64 d), its Q fragments
    // in registers until it completes. Element e is row 16 warp + g + 8
    // ((e % 4) / 2), key 8 (e / 4) + 2 qd + e % 2.
    float sc[W / 2];
#pragma unroll
    for (int p0 = 0; p0 < S::PANELS; p0 += 2) {
      uint32_t a_hi[8][4], a_lo[8][4];
#pragma unroll
      for (int kd = 0; kd < 8; ++kd)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t off = (p0 + kd / 4) * S::QROWS * 128 + a_row + (j % 2) * 8 * 128 +
                               (((2 * (kd % 4) + j / 2) ^ g) << 4);
          const float x = *reinterpret_cast<const float*>(sm + off);
          const float hi = tf32_rna(x);
          a_hi[kd][j] = __float_as_uint(hi);
          a_lo[kd][j] = __float_as_uint(tf32_rna(x - hi));
        }
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < 8; ++kd) {
        const uint32_t kp = (p0 + kd / 4) * BK * 128 + 32 * (kd % 4);
        const uint64_t bhd = sw128_desc(khi + kp), bld = sw128_desc(klo + kp);
        // the small terms first; the chain's first product overwrites sc
        wgmma_tf32<W>(sc, a_lo[kd], bhd, p0 > 0 || kd > 0);
        wgmma_tf32<W>(sc, a_hi[kd], bld, 1);
        wgmma_tf32<W>(sc, a_hi[kd], bhd, 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
    }

    // the online softmax; p's pair as P V's A fragment
    float alpha[2];
    uint32_t phi[W / 8][4], plo[W / 8][4];
    tf32_softmax<W>(sc, m, l, alpha, phi, plo, rem, qd, l2);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) oc[e] *= alpha[(e % 4) / 2];

    // P V [64, D] over 8-key steps into a fresh accumulator
    float pv[D / 2];
    fence_regs(pv);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < W / 8; ++c) {
      const uint32_t vp = (c / 4) * D * 128 + 32 * (c % 4);
      const uint64_t vhd = sw128_desc(vhi + vp), vld = sw128_desc(vlo + vp);
      wgmma_tf32<D>(pv, plo[c], vhd, c > 0);
      wgmma_tf32<D>(pv, phi[c], vld, 1);
      wgmma_tf32<D>(pv, phi[c], vhd, 1);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pv);
#pragma unroll
    for (int e = 0; e < D / 2; ++e) oc[e] += pv[e];
  }
};

// One unit per block: (image b, head h, query rows q0 .. q0 + 127). Warps
// 0-7 are two consumer warpgroups of 64 rows each (setmaxnreg gives them 232
// registers a thread), warps 8-11 the producer warpgroup. One producer
// thread TMA-loads the unit's Q once and keeps RAW raw K and V blocks (BK
// keys) in flight; the producer warpgroup splits each block into its TF32
// pairs (split_block), two blocks' pairs in shared memory at a time, handed
// over by mbarriers (ready, free), so the split runs beside the consumers'
// products and the two consumer warpgroups never wait for each other. Per
// key block each consumer warpgroup runs (KeyBlock; the last block's
// products only span its keys below N, rounded up to 8, 16, 32 or BK)
//   S = Q K^T: Q's fragments loaded from shared memory and split in
//     registers, 64 d at a time; per 8 d the products
//     Q_lo K_hi + Q_hi K_lo + Q_hi K_hi into one float32 accumulator;
//   the online softmax: keys at or past N (zero rows from the tensor map)
//     to -inf, the row max m over the 4 lanes of a row, p = 2^(s scale
//     log2 e - m), the thread's share of the row sum l and O rescaled by
//     2^(m_old - m_new);
//   P V into a fresh accumulator, P split hi/lo in registers (A), Vt's
//     pair in shared memory (B), then added to O in float32 round-to-nearest
//     adds: the tensor cores add into their accumulator with truncation,
//     and one block's 3 BK / 8 products keep that error small.
// O / l goes from registers to global memory, rows at or past N dropped.
// Every wgmma chain is straight-line code.
template <int D>
__global__ void __launch_bounds__(Tf32<D>::THREADS, 1)
attention_tf32x3_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap, float* __restrict__ o, int N, int H,
                        int qtiles, long long sb, long long sh, long long sn, int pos, float scale) {
  using S = Tf32<D>;
  constexpr int BK = S::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 bytes
  unsigned char* const sm = smem_raw + (base - raw);
  // offsets from base: raw block r's K at RING + 2 r KV_BYTES, V after it;
  // the pairs of block kb at PAIRS0 + (kb % 2) PAIRS
  constexpr uint32_t RING = S::Q_BYTES, PAIRS0 = RING + 2 * S::RAW * S::KV_BYTES;
  const uint32_t q_bar = base + PAIRS0 + 2 * S::PAIRS;
  const uint32_t raw_bar = q_bar + 8, ready_bar = raw_bar + 8 * S::RAW, free_bar = ready_bar + 16;

  const int tid = threadIdx.x;
  const int qt = blockIdx.x % qtiles, bh = blockIdx.x / qtiles, h = bh % H, b = bh / H;
  const int q0 = qt * S::QROWS, blocks = (N + BK - 1) / BK;

  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int r = 0; r < S::RAW; ++r) mbar_init(raw_bar + 8 * r, 1);  // the expect_tx
    for (int i = 0; i < 2; ++i) {
      mbar_init(ready_bar + 8 * i, 128);            // each producer thread, its split written
      mbar_init(free_bar + 8 * i, S::CONSUMERS);    // each consumer thread, its products done
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= S::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int pt = tid - S::CONSUMERS;
    auto load = [&](int kb) {  // raw block kb, by thread 0 of the warpgroup
      const uint32_t bar = raw_bar + 8 * (kb % S::RAW), ks = base + RING + 2 * (kb % S::RAW) * S::KV_BYTES;
      mbar_expect_tx(bar, 2 * S::KV_BYTES);  // rows at or past N arrive zero-filled and count
      const Coords c = unit_coords(pos, b, h, kb * BK);
#pragma unroll
      for (int p = 0; p < S::PANELS; ++p) {
        tma_load(ks + p * BK * 128, &kmap, bar, c, 32 * p);
        tma_load(ks + S::KV_BYTES + p * BK * 128, &vmap, bar, c, 32 * p);
      }
    };
    if (pt == 0) {
      mbar_expect_tx(q_bar, S::Q_BYTES);
      const Coords cq = unit_coords(pos, b, h, q0);
#pragma unroll
      for (int p = 0; p < S::PANELS; ++p) tma_load(base + p * S::QROWS * 128, &qmap, q_bar, cq, 32 * p);
      for (int kb = 0; kb < min(blocks, S::RAW); ++kb) load(kb);
    }
    for (int kb = 0; kb < blocks; ++kb) {
      const int r = kb % S::RAW, i = kb % 2;
      mbar_wait(raw_bar + 8 * r, (kb / S::RAW) & 1);
      if (kb >= 2) mbar_wait(free_bar + 8 * i, (kb / 2 - 1) & 1);  // block kb - 2's products are done
      const uint32_t ks = RING + 2 * r * S::KV_BYTES;
      split_block<D>(sm, ks, ks + S::KV_BYTES, PAIRS0 + i * S::PAIRS, pt);
      fence_proxy_async();  // the generic-proxy writes, before wgmma reads them
      mbar_arrive(ready_bar + 8 * i);
      producers_sync();  // every producer thread has read the raw block
      if (pt == 0 && kb + S::RAW < blocks) load(kb + S::RAW);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
  // this thread's A elements of Q: rows 16 warp + g (+ 8) of its
  // warpgroup's 64, k = 8 kd + qd (+ 4) of a panel: 16-byte chunk 2 kd (+ 1)
  // of the row, which the swizzle stores at chunk ^ (row % 8) = chunk ^ g
  const uint32_t a_row = (wg * 64 + 16 * warp + g) * 128 + 4 * qd;
  const float l2 = scale * 1.4426950408889634f;  // exp(x scale) = 2^(x scale log2 e)
  float oc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8

  mbar_wait(q_bar, 0);
  for (int kb = 0; kb < blocks; ++kb) {
    const int i = kb % 2;
    const uint32_t pairs = base + PAIRS0 + i * S::PAIRS;
    mbar_wait(ready_bar + 8 * i, (kb / 2) & 1);
    // the products span the block's keys below N, rounded up to 8, 16, 32
    // or BK: the last block of a ViT's N (197, 257, 577) has 1 to 5
    const int rem = N - kb * BK;
    const KeyBlock<D> kbk{sm, pairs, a_row, g, qd, rem, l2};
    if (rem > BK / 2) kbk.template run<BK>(oc, m, l);
    else if (BK == 64 && rem > 16) kbk.template run<32>(oc, m, l);
    else if (rem > 8) kbk.template run<16>(oc, m, l);
    else kbk.template run<8>(oc, m, l);
    mbar_arrive(free_bar + 8 * i);  // this thread's products of the block are done
  }

  // O / l, float2 stores of columns 8 c + 2 qd, + 1
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / l[r];
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * 64 + 16 * warp + g + 8 * r;
    if (row >= N) continue;
    float* orow = o + (size_t)b * sb + (size_t)h * sh + (size_t)row * sn + 2 * qd;
#pragma unroll
    for (int c = 0; c < D / 8; ++c)
      *reinterpret_cast<float2*>(orow + 8 * c) =
          make_float2(oc[4 * c + 2 * r] * l[r], oc[4 * c + 2 * r + 1] * l[r]);
  }
}

// ---------------------------------------------------------------------------
// bf16 at head dim 64 or 128 and any N: wgmma, a loop over key blocks with
// an online softmax
// ---------------------------------------------------------------------------

// The shapes of attention_wgmma_kl_kernel<D> (head dim D = 64 or 128).
template <int D>
struct Kl {
  static constexpr int BK = 64;                   // keys per block
  static constexpr int QROWS = 128;               // query rows of a unit: 64 per warpgroup
  static constexpr int PANELS = D / 64;           // 128-byte swizzle rows (64 bf16) per row of d
  static constexpr int Q_BYTES = QROWS * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;     // one of K, V
  static constexpr int PANEL_BYTES = BK * 128;    // one 64-column panel of K or V
  static constexpr int OCOLS = D;                 // columns of V and O a block's P V covers
  static constexpr int STAGES = D == 64 ? 4 : 3;  // K and V blocks in flight
  static constexpr int CONSUMERS = 256;           // two warpgroups
  static constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
  // 2 x Q | STAGES x (K, V) | mbarriers: Q full[2], Q empty[2], full[STAGES], empty[STAGES]
  static constexpr size_t SMEM = 1024 + 2 * Q_BYTES + (size_t)STAGES * 2 * KV_BYTES + 8 * (4 + 2 * STAGES);
};
static_assert(Kl<64>::SMEM <= 232448 && Kl<128>::SMEM <= 232448,
              "a unit must fit a block's 227 KB of shared memory");

// O[64 x OC] (+)= P[64 x 16] V[16 x OC], P (bf16 pairs) from registers, V
// in shared memory MN-major (trans-b); at OC = 128 its two 64-column panels
// lie PANEL bytes apart
template <int OC, int PANEL>
__device__ __forceinline__ void wgmma_pv_kl(float (&d)[OC / 2], const uint32_t* a, uint32_t v) {
  if constexpr (OC == 64) wgmma_pv(d, a, sw128_desc(v), 1);
  else wgmma_m64n128k16_rs(d, a, sw128_desc(v, PANEL), 1);
}

// One key block of a consumer warpgroup: S = Q K^T over the block's first W
// keys (a multiple of 16) and all of d (run), the online softmax, and O +=
// P V over the S::OCOLS columns of V at v (softmax_pv). W is a template
// parameter so that every wgmma chain is straight-line code. S holds the
// kernel's shapes (Kl<D>, Wide<NP> or Ts): the 64-column panels of d
// (PANELS), the rows of a Q buffer (QROWS) and the bytes of one 64-column
// panel of a K or V block (PANEL_BYTES); Ts, whose S is streamed, calls
// softmax_pv alone.
template <class S>
struct KlBlock {
  uint32_t q;       // shared address of this warpgroup's 64 rows of Q (panel 0)
  uint32_t k;       // the block's K
  uint32_t v;       // the block's V, the columns of this O
  int qd;           // lane % 4
  int rem;          // keys of the block below N
  float l2;         // scale log2 e
  uint32_t s_done;  // an mbarrier to arrive at once S has read Q, or 0

  template <int W>
  __device__ __forceinline__ void run(float (&oc)[S::OCOLS / 2], float (&m)[2], float (&l)[2]) const {
    // S [64, W] = Q K^T, one chain of 4 PANELS steps. Element e is row
    // 16 warp + lane / 4 + 8 ((e % 4) / 2), key 8 (e / 4) + 2 qd + e % 2.
    float sc[W / 2];
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < S::PANELS; ++p)
#pragma unroll
      for (int kd = 0; kd < 4; ++kd)
        wgmma_qk<W>(sc, sw128_desc(q + p * S::QROWS * 128 + 32 * kd),
                    sw128_desc(k + p * S::PANEL_BYTES + 32 * kd), p > 0 || kd > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    if (s_done) mbar_arrive(s_done);
    softmax_pv<W>(sc, oc, m, l);
  }

  // the online softmax of the block's scores sc, and O += P V
  template <int W>
  __device__ __forceinline__ void softmax_pv(float (&sc)[W / 2], float (&oc)[S::OCOLS / 2], float (&m)[2],
                                             float (&l)[2]) const {
    // keys at or past N (only in the last block) get -inf, since their
    // zero-filled rows would score 0
    if (rem < W) {
#pragma unroll
      for (int e = 0; e < W / 2; ++e)
        if (8 * (e / 4) + 2 * qd + e % 2 >= rem) sc[e] = -INFINITY;
    }
    float mx[2] = {-INFINITY, -INFINITY};  // of the raw scores: scale > 0
#pragma unroll
    for (int e = 0; e < W / 2; ++e) mx[(e % 4) / 2] = fmaxf(mx[(e % 4) / 2], sc[e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float mn = fmaxf(m[r], mx[r] * l2);  // finite: the block has a key below N
      alpha[r] = ex2(m[r] - mn);                 // 0 for the first block
      m[r] = mn;
      l[r] *= alpha[r];
    }
    // p v without rounding p to bf16: p = p_hi + p_lo, p_hi = bf16(p),
    // p_lo = bf16(p - p_hi); S's registers, in pairs, are P V's A fragment
    uint32_t phi[W / 4], plo[W / 4];
#pragma unroll
    for (int e = 0; e < W / 2; e += 2) {
      const int r = (e % 4) / 2;
      const float a = ex2(fmaf(sc[e], l2, -m[r]));  // masked keys: 2^-inf == 0
      const float b = ex2(fmaf(sc[e + 1], l2, -m[r]));
      l[r] += a + b;
      phi[e / 2] = pack_bf16(a, b);
      plo[e / 2] = pack_bf16(a - __uint_as_float(phi[e / 2] << 16),
                             b - __uint_as_float(phi[e / 2] & 0xffff0000u));
    }
#pragma unroll
    for (int e = 0; e < S::OCOLS / 2; ++e) oc[e] *= alpha[(e % 4) / 2];

    // O += P V over 16-key steps, hi and lo
    fence_regs(oc);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < W / 16; ++c) {
      const uint32_t vc = v + c * 16 * 128;
      wgmma_pv_kl<S::OCOLS, S::PANEL_BYTES>(oc, phi + 4 * c, vc);
      wgmma_pv_kl<S::OCOLS, S::PANEL_BYTES>(oc, plo + 4 * c, vc);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(oc);
  }
};

// A unit is (image b, head h, query rows q0 .. q0 + 127); a persistent
// grid of one block per SM walks the units u = blockIdx.x, blockIdx.x +
// gridDim.x, ... (unit u: query tile u % qtiles of (image, head) u /
// qtiles, so the blocks in flight at one time share K and V in L2). Warps
// 0-7 are two consumer warpgroups of 64 query rows each (setmaxnreg gives
// them 240 registers a thread), warps 8-11 the producer warpgroup, whose
// one thread TMA-loads each unit's Q into one of two buffers and keeps
// STAGES blocks of K and V (64 keys) in flight, handed over by mbarriers
// (full: loaded, empty: both consumer warpgroups' products done). The ring
// runs on from one unit to the next, so the next unit's Q and first blocks
// load while the consumers finish the last one and store its outputs. The
// tensor maps have N as an axis of its own, so rows at or past N arrive as
// zeros and are never the next image's. Per key block each consumer
// warpgroup runs (KlBlock; the last block's products span only its keys
// below N, rounded up to 16)
//   S = Q K^T: wgmma m64nWk16, Q and K K-major in shared memory, D / 16
//     steps; bf16 products are exact in float32;
//   the online softmax in registers, in float32: keys at or past N to
//     -inf, the row max m over the 4 lanes of a row, p = 2^(s scale log2 e
//     - m), the thread's share of the row sum l, O rescaled by 2^(m_old -
//     m_new);
//   O += P V: p = p_hi + p_lo in bf16, two products per 16 keys, A from
//     registers, V MN-major (trans-b): attention_hopper_kernel's precision,
//     whatever N is.
// O / l goes from registers to global memory in bf16, rows at or past N
// dropped. Every wgmma chain is straight-line code.
template <int D>
__global__ void __launch_bounds__(Kl<D>::THREADS, 1)
attention_wgmma_kl_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, int N, int H,
                          int qtiles, int units, long long sb, long long sh, long long sn, int pos,
                          float scale) {
  using S = Kl<D>;
  constexpr int BK = S::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024 bytes
  const uint32_t ring = base + 2 * S::Q_BYTES;  // stage s: K at ring + 2 s KV_BYTES, V after it
  // mbarriers: Q full[2], Q empty[2], full[STAGES], empty[STAGES]
  const uint32_t qfull_bar = ring + 2 * S::STAGES * S::KV_BYTES, qempty_bar = qfull_bar + 16;
  const uint32_t full_bar = qempty_bar + 16, empty_bar = full_bar + 8 * S::STAGES;
  const int tid = threadIdx.x, blocks = (N + BK - 1) / BK;

  if (tid == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(qfull_bar + 8 * i, 1);               // the producer's expect_tx
      mbar_init(qempty_bar + 8 * i, S::CONSUMERS);   // each consumer thread, its last S done
    }
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, S::CONSUMERS);    // each consumer thread, its products done
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= S::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid != S::CONSUMERS) return;
    int it = 0;  // K and V blocks loaded so far, over all of the block's units
    for (int i = 0, u = blockIdx.x; u < units; ++i, u += gridDim.x) {
      const int bh = u / qtiles, b = bh / H, h = bh % H;
      const uint32_t qb = qfull_bar + 8 * (i % 2);
      if (i >= 2) mbar_wait(qempty_bar + 8 * (i % 2), (i / 2 - 1) & 1);
      mbar_expect_tx(qb, S::Q_BYTES);  // rows at or past N arrive zero-filled and count
      const Coords cq = unit_coords(pos, b, h, (u % qtiles) * S::QROWS);
#pragma unroll
      for (int p = 0; p < S::PANELS; ++p)
        tma_load(base + (i % 2) * S::Q_BYTES + p * S::QROWS * 128, &qmap, qb, cq, 64 * p);
      for (int kb = 0; kb < blocks; ++kb, ++it) {
        const int s = it % S::STAGES;
        if (it >= S::STAGES) mbar_wait(empty_bar + 8 * s, (it / S::STAGES - 1) & 1);
        const uint32_t bar = full_bar + 8 * s, ks = ring + 2 * s * S::KV_BYTES;
        mbar_expect_tx(bar, 2 * S::KV_BYTES);
        const Coords c = unit_coords(pos, b, h, kb * BK);
#pragma unroll
        for (int p = 0; p < S::PANELS; ++p) {
          tma_load(ks + p * S::PANEL_BYTES, &kmap, bar, c, 64 * p);
          tma_load(ks + S::KV_BYTES + p * S::PANEL_BYTES, &vmap, bar, c, 64 * p);
        }
      }
    }
    // stay until the consumers are done with the last blocks: every load
    // has landed before the thread that issued it exits
    for (int j = max(it - S::STAGES, 0); j < it; ++j)
      mbar_wait(empty_bar + 8 * (j % S::STAGES), (j / S::STAGES) & 1);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const float l2 = scale * 1.4426950408889634f;  // exp(x scale) = 2^(x scale log2 e)
  int it = 0;
  for (int i = 0, u = blockIdx.x; u < units; ++i, u += gridDim.x) {
    const int bh = u / qtiles, b = bh / H, h = bh % H, q0 = (u % qtiles) * S::QROWS;
    float oc[D / 2];
#pragma unroll
    for (int e = 0; e < D / 2; ++e) oc[e] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
    mbar_wait(qfull_bar + 8 * (i % 2), (i / 2) & 1);
    const uint32_t qw = base + (i % 2) * S::Q_BYTES + wg * 64 * 128;  // this warpgroup's rows
    for (int kb = 0; kb < blocks; ++kb, ++it) {
      const int s = it % S::STAGES;
      mbar_wait(full_bar + 8 * s, (it / S::STAGES) & 1);
      // the products span the block's keys below N, rounded up to 16: the
      // last block of a ViT's N (197, 257, 577) has 1 to 5
      const int rem = N - kb * BK;
      const uint32_t ks = ring + 2 * s * S::KV_BYTES;
      const KlBlock<S> blk{qw, ks, ks + S::KV_BYTES, qd, rem, l2, 0};
      if (rem > 48) blk.template run<64>(oc, m, l);
      else if (rem > 32) blk.template run<48>(oc, m, l);
      else if (rem > 16) blk.template run<32>(oc, m, l);
      else blk.template run<16>(oc, m, l);
      mbar_arrive(empty_bar + 8 * s);  // this thread's products of the block are done
    }
    mbar_arrive(qempty_bar + 8 * (i % 2));  // and its reads of Q

    // O / l in bf16, pairs of columns 8 c + 2 qd, + 1
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = 1.f / l[r];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wg * 64 + 16 * warp + g + 8 * r;
      if (row >= N) continue;
      bf16* orow = o + (size_t)b * sb + (size_t)h * sh + (size_t)row * sn + 2 * qd;
#pragma unroll
      for (int c = 0; c < D / 8; ++c)
        *reinterpret_cast<uint32_t*>(orow + 8 * c) =
            pack_bf16(oc[4 * c + 2 * r] * l[r], oc[4 * c + 2 * r + 1] * l[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 at head dims 192 to 512 and any N: the key loop above, per 128-column
// panel of the output
// ---------------------------------------------------------------------------

constexpr int WIDE_MIN_NP = 3;   // the narrowest head dim of the wide kernel, in 64-column panels
constexpr int WIDE_MAX = 512;    // its widest head dim (ops/attention.WIDE_MAX)
constexpr int WIDE_NP = WIDE_MAX / 64 - WIDE_MIN_NP + 1;  // its instances

// The shapes of attention_wgmma_wide_kernel<NP> (head dim D = 64 NP). Q is
// loaded once per unit and stays for all of its output panels; a ring stage
// holds one K block (BK keys x D) and the V block's 128 columns of one
// output panel. What fits a block's 232,448 bytes of shared memory with the
// 1,024 bytes of alignment and mbarriers decides BK, the Q buffers and the
// stages (pinned below). At d = 256 two Q buffers and two stages took 3.7 %
// less time than one Q buffer and three stages on an H100
// (tools/torch_attention_ab.py --wide).
template <int NP>
struct Wide {
  static constexpr int D = 64 * NP;
  static constexpr int BK = NP <= 6 ? 64 : 32;     // keys per block
  static constexpr int QROWS = 128;                // query rows of a unit: 64 per warpgroup
  static constexpr int PANELS = NP;                // 128-byte swizzle rows (64 bf16) per row of d
  static constexpr int OCOLS = 128;                // columns of an output panel
  static constexpr int OPANELS = (NP + 1) / 2;     // output panels; an odd NP's last is half past d
  static constexpr int PANEL_BYTES = BK * 128;     // one 64-column panel of a K or V block
  static constexpr int Q_BYTES = QROWS * D * 2;
  static constexpr int K_BYTES = BK * D * 2;
  static constexpr int V_BYTES = BK * OCOLS * 2;
  static constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
  static constexpr int QBUF = NP <= 4 ? 2 : 1;     // Q buffers: two where they fit
  static constexpr int STAGES = NP == 3 || NP == 7 ? 3 : 2;
  static constexpr int CONSUMERS = 256;            // two warpgroups
  static constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
  static constexpr int BYTES = QBUF * Q_BYTES + STAGES * STAGE_BYTES;
  // QBUF x Q | STAGES x (K, V panel) | mbarriers: Q full[QBUF], Q empty[QBUF], full[STAGES], empty[STAGES]
  static constexpr size_t SMEM = 1024 + (size_t)BYTES + 8 * (2 * QBUF + 2 * STAGES);
};
static_assert(Wide<3>::BYTES == 2 * 49152 + 3 * 40960, "d 192: BK 64, 2 Q + 3 stages");
static_assert(Wide<4>::BYTES == 2 * 65536 + 2 * 49152, "d 256: BK 64, 2 Q + 2 stages");
static_assert(Wide<5>::BYTES == 81920 + 2 * 57344, "d 320: BK 64, 1 Q + 2 stages");
static_assert(Wide<6>::BYTES == 98304 + 2 * 65536, "d 384: BK 64, 1 Q + 2 stages");
static_assert(Wide<7>::BYTES == 114688 + 3 * 36864, "d 448: BK 32, 1 Q + 3 stages");
static_assert(Wide<8>::BYTES == 131072 + 2 * 40960, "d 512: BK 32, 1 Q + 2 stages");
static_assert(Wide<3>::SMEM <= 232448 && Wide<4>::SMEM <= 232448 && Wide<5>::SMEM <= 232448 &&
                  Wide<6>::SMEM <= 232448 && Wide<7>::SMEM <= 232448 && Wide<8>::SMEM <= 232448,
              "a unit must fit a block's 227 KB of shared memory");
static_assert(WIDE_MAX / 64 == 8 && WIDE_MAX % 64 == 0, "Wide<NP> is pinned up to NP = 8");

// attention_wgmma_kl_kernel's unit, grid, warpgroups and key blocks, with
// the output in panels: a unit is (image b, head h, query rows q0 .. q0 +
// 127), a persistent grid of one block per SM walks the units in the same
// order, two consumer warpgroups take 64 query rows each (240 registers a
// thread) and the producer warpgroup's one thread loads by TMA. Q is loaded
// once per unit, NP panels of 64 columns, and stays for the unit. For each
// 128-column panel c of O the consumers walk the key blocks (KlBlock: S =
// Q K^T over all of d, NP x 4 wgmma steps; the online softmax; O_c += P V_c
// with the p_hi + p_lo split), m and l starting again: every panel computes
// the same S, so they come out the same. O_c / l is stored in bf16, rows at
// or past N and columns at or past d dropped. Each panel re-reads the K
// blocks (from L2 after the first panel), which costs tensor-core work, not
// bytes: S is recomputed OPANELS times, so at d = 256 the work is twice
// SDPA's and stays under the bytes' time. Each consumer warpgroup keeps
// Kl<128>'s registers: O 64, S 32, the p pairs 32.
// The ring (one K block and V_c's 128 columns a stage) runs on across
// panels and units. The tensor maps' d extent is d, so V_c's columns past
// d (an odd NP's last panel from column 64) arrive as zeros without a read
// of memory, and a packed layout's next head is never read. The next
// unit's Q loads as soon as the last panel's last S has read Q (one Q
// buffer) or at once (two).
template <int NP>
__global__ void __launch_bounds__(Wide<NP>::THREADS, 1)
attention_wgmma_wide_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                            const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, int N, int H,
                            int qtiles, int units, long long sb, long long sh, long long sn, int pos,
                            float scale) {
  using S = Wide<NP>;
  constexpr int BK = S::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024 bytes
  const uint32_t ring = base + S::QBUF * S::Q_BYTES;  // stage s: K at ring + s STAGE_BYTES, V_c after it
  const uint32_t qfull_bar = ring + S::STAGES * S::STAGE_BYTES, qempty_bar = qfull_bar + 8 * S::QBUF;
  const uint32_t full_bar = qempty_bar + 8 * S::QBUF, empty_bar = full_bar + 8 * S::STAGES;
  const int tid = threadIdx.x, blocks = (N + BK - 1) / BK;

  if (tid == 0) {
    for (int i = 0; i < S::QBUF; ++i) {
      mbar_init(qfull_bar + 8 * i, 1);               // the producer's expect_tx
      mbar_init(qempty_bar + 8 * i, S::CONSUMERS);   // each consumer thread, its last S done
    }
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, S::CONSUMERS);    // each consumer thread, its products done
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= S::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid != S::CONSUMERS) return;
    int it = 0;  // K and V blocks loaded so far, over all of the block's units and panels
    for (int i = 0, u = blockIdx.x; u < units; ++i, u += gridDim.x) {
      const int bh = u / qtiles, b = bh / H, h = bh % H;
      const uint32_t qb = qfull_bar + 8 * (i % S::QBUF);
      if (i >= S::QBUF) mbar_wait(qempty_bar + 8 * (i % S::QBUF), (i / S::QBUF - 1) & 1);
      mbar_expect_tx(qb, S::Q_BYTES);  // rows at or past N arrive zero-filled and count
      const Coords cq = unit_coords(pos, b, h, (u % qtiles) * S::QROWS);
#pragma unroll
      for (int p = 0; p < NP; ++p)
        tma_load(base + (i % S::QBUF) * S::Q_BYTES + p * S::QROWS * 128, &qmap, qb, cq, 64 * p);
      for (int c = 0; c < S::OPANELS; ++c) {
        for (int kb = 0; kb < blocks; ++kb, ++it) {
          const int s = it % S::STAGES;
          if (it >= S::STAGES) mbar_wait(empty_bar + 8 * s, (it / S::STAGES - 1) & 1);
          const uint32_t bar = full_bar + 8 * s, ks = ring + s * S::STAGE_BYTES;
          mbar_expect_tx(bar, S::STAGE_BYTES);  // columns past d arrive zero-filled and count
          const Coords ck = unit_coords(pos, b, h, kb * BK);
#pragma unroll
          for (int p = 0; p < NP; ++p) tma_load(ks + p * S::PANEL_BYTES, &kmap, bar, ck, 64 * p);
          tma_load(ks + S::K_BYTES, &vmap, bar, ck, 128 * c);
          tma_load(ks + S::K_BYTES + S::PANEL_BYTES, &vmap, bar, ck, 128 * c + 64);
        }
      }
    }
    // stay until the consumers are done with the last blocks: every load
    // has landed before the thread that issued it exits
    for (int j = max(it - S::STAGES, 0); j < it; ++j)
      mbar_wait(empty_bar + 8 * (j % S::STAGES), (j / S::STAGES) & 1);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const float l2 = scale * 1.4426950408889634f;  // exp(x scale) = 2^(x scale log2 e)
  int it = 0;
  for (int i = 0, u = blockIdx.x; u < units; ++i, u += gridDim.x) {
    const int bh = u / qtiles, b = bh / H, h = bh % H, q0 = (u % qtiles) * S::QROWS;
    mbar_wait(qfull_bar + 8 * (i % S::QBUF), (i / S::QBUF) & 1);
    const uint32_t qw = base + (i % S::QBUF) * S::Q_BYTES + wg * 64 * 128;  // this warpgroup's rows
#pragma unroll 1
    for (int c = 0; c < S::OPANELS; ++c) {
      float oc[S::OCOLS / 2];
#pragma unroll
      for (int e = 0; e < S::OCOLS / 2; ++e) oc[e] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
      for (int kb = 0; kb < blocks; ++kb, ++it) {
        const int s = it % S::STAGES;
        mbar_wait(full_bar + 8 * s, (it / S::STAGES) & 1);
        // the products span the block's keys below N, rounded up to 16
        const int rem = N - kb * BK;
        const uint32_t ks = ring + s * S::STAGE_BYTES;
        const bool last = c == S::OPANELS - 1 && kb == blocks - 1;  // the unit's last S
        const KlBlock<S> blk{qw, ks, ks + S::K_BYTES, qd, rem, l2,
                             last ? qempty_bar + 8 * (i % S::QBUF) : 0u};
        if constexpr (BK == 64) {
          if (rem > 48) blk.template run<64>(oc, m, l);
          else if (rem > 32) blk.template run<48>(oc, m, l);
          else if (rem > 16) blk.template run<32>(oc, m, l);
          else blk.template run<16>(oc, m, l);
        } else {
          if (rem > 16) blk.template run<32>(oc, m, l);
          else blk.template run<16>(oc, m, l);
        }
        mbar_arrive(empty_bar + 8 * s);  // this thread's products of the block are done
      }

      // O_c / l in bf16, pairs of columns 128 c + 8 j + 2 qd, + 1 below d
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = 1.f / l[r];
      }
      const int cols = min(S::OCOLS, S::D - 128 * c);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + wg * 64 + 16 * warp + g + 8 * r;
        if (row >= N) continue;
        bf16* orow = o + (size_t)b * sb + (size_t)h * sh + (size_t)row * sn + 128 * c + 2 * qd;
#pragma unroll
        for (int j = 0; j < S::OCOLS / 8; ++j)
          if (8 * j < cols)
            *reinterpret_cast<uint32_t*>(orow + 8 * j) =
                pack_bf16(oc[4 * j + 2 * r] * l[r], oc[4 * j + 2 * r + 1] * l[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 past head dim 512: the wide kernel's key loop and output panels, with
// Q and K streamed in 64-column panels of d
// ---------------------------------------------------------------------------

constexpr int STREAM_DP = 64;  // columns of d in a streamed panel (ops/attention.WIDE_STEP)

// The shapes of attention_wgmma_stream_kernel, the same at every head dim.
// A resident Q of 128 rows grows with d (144 KB at 576, 256 KB at 1024,
// past a block's 227 KB), so nothing of a unit stays in shared memory for
// all of d: Q and K come together in panels of 64 columns of d
// (one 128-byte swizzle row of bf16), one panel of each a stage, through a
// ring of RING stages, and V's block in the output panel's 128 columns
// (two 64-column panels) into one of VBUF buffers, loaded before the key
// block's first stage. Every region is a multiple of 1,024 bytes (the
// swizzle atom):
//   ring   RING x (Q [128][64], K [64 keys][64])   8 x 24 KB
//   V      VBUF x V [64 keys][128] as 2 x [64][64]  2 x 16 KB
// 224 KB and 20 mbarriers, pinned below.
struct Ts {
  static constexpr int BK = 64;                        // keys per block
  static constexpr int QROWS = 128;                    // query rows of a unit: 64 per consumer warpgroup
  static constexpr int DP = STREAM_DP;                 // columns of d in a panel
  static constexpr int OCOLS = 128;                    // columns of an output panel
  static constexpr int PANEL_BYTES = BK * DP * 2;      // a panel of K, or a 64-column half of V's block
  static constexpr int Q_BYTES = QROWS * DP * 2;       // a panel of Q
  static constexpr int STAGE_BYTES = Q_BYTES + PANEL_BYTES;
  static constexpr int V_BYTES = 2 * PANEL_BYTES;      // V's block in an output panel
  static constexpr int RING = 8;                       // stages of the ring
  static constexpr int VBUF = 2;                       // V buffers
  static constexpr int CONSUMERS = 256;                // two warpgroups
  static constexpr int THREADS = CONSUMERS + 128;      // and the producer warpgroup
  static constexpr int V0 = RING * STAGE_BYTES;        // offsets from the 1,024-aligned base
  static constexpr int BYTES = V0 + VBUF * V_BYTES;
  // mbarriers: full[RING], empty[RING], V full[VBUF], V empty[VBUF]
  static constexpr int FULL = BYTES, EMPTY = FULL + 8 * RING, VFULL = EMPTY + 8 * RING,
                       VEMPTY = VFULL + 8 * VBUF;
  static constexpr size_t SMEM = 1024 + (size_t)VEMPTY + 8 * VBUF;
};
static_assert(Ts::BYTES == 8 * (16384 + 8192) + 2 * 16384, "ring 8 x 24 KB, V 2 x 16 KB");
static_assert(Ts::STAGE_BYTES % 1024 == 0 && Ts::Q_BYTES % 1024 == 0 && Ts::V_BYTES % 1024 == 0,
              "every tile starts on a swizzle atom");
static_assert(Ts::SMEM == 1024 + 229376 + 8 * 20 && Ts::SMEM <= 232448,
              "a block's 227 KB of shared memory, whatever the head dim");
static_assert(Ts::DP * 2 == 128, "a panel row is one 128-byte swizzle row");

// One key block of a consumer warpgroup in one output panel: S = Q K^T over
// the block's first W keys (a multiple of 16) and all of d, a panel at a
// time, then KlBlock's online softmax and O += P V with the p split. it and
// jv count the stages and V blocks this thread has taken, over the block's
// units; every barrier's phase follows from them. W is a template parameter
// so that every wgmma chain is straight-line code.
struct TsBlock {
  uint32_t base;  // shared address of the aligned base
  uint32_t qoff;  // this warpgroup's 64 rows of a Q panel, from the panel
  int qd;         // lane % 4
  int rem;        // keys of the block below N
  int panels;     // 64-column panels of d
  float l2;       // scale log2 e

  template <int W>
  __device__ __forceinline__ void run(float (&oc)[Ts::OCOLS / 2], float (&m)[2], float (&l)[2], int& it,
                                      int& jv) const {
    // S [64, W] = Q K^T: one chain of 4 k16 steps a panel, each panel's
    // stage handed back once its products are done; bf16 products are
    // exact in float32, summed in the accumulator over all of d, as the
    // wide kernel's one chain sums them. Element e is row 16 warp + lane /
    // 4 + 8 ((e % 4) / 2), key 8 (e / 4) + 2 qd + e % 2.
    float sc[W / 2];
#pragma unroll 1
    for (int p = 0; p < panels; ++p, ++it) {
      const int s = it % Ts::RING;
      mbar_wait(base + Ts::FULL + 8 * s, (it / Ts::RING) & 1);
      const uint32_t q = base + s * Ts::STAGE_BYTES + qoff, k = base + s * Ts::STAGE_BYTES + Ts::Q_BYTES;
      fence_regs(sc);
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < 4; ++kd)
        wgmma_qk<W>(sc, sw128_desc(q + 32 * kd), sw128_desc(k + 32 * kd), p > 0 || kd > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      mbar_arrive(base + Ts::EMPTY + 8 * s);  // this thread's products of the stage are done
    }
    const int vb = jv % Ts::VBUF;
    mbar_wait(base + Ts::VFULL + 8 * vb, (jv / Ts::VBUF) & 1);
    const KlBlock<Ts> blk{0u, 0u, base + Ts::V0 + vb * Ts::V_BYTES, qd, rem, l2, 0u};
    blk.template softmax_pv<W>(sc, oc, m, l);
    mbar_arrive(base + Ts::VEMPTY + 8 * vb);  // this thread's products of the V block are done
    ++jv;
  }
};

// A unit is (image b, head h, query rows q0 .. q0 + 127); a persistent grid
// of one block per SM walks the units u = blockIdx.x, blockIdx.x +
// gridDim.x, ... (unit u: query tile u % qtiles of (image, head) u /
// qtiles), as the key-loop and wide kernels do. Warps 0-7 are two consumer
// warpgroups of 64 query rows each (setmaxnreg gives them 240 registers a
// thread), warps 8-11 the producer warpgroup, whose one thread loads by TMA.
// For each 128-column panel c of O (the last one 64 wide where d is an odd
// multiple of 64) and each key block (64 keys), in this order:
//   V's block in the panel's columns, into a V buffer (columns past d
//     arrive as zeros without a read of memory);
//   the panels of d: Q's 128 rows and K's 64 keys of each 64-column panel
//     into a stage of the ring; each consumer warpgroup adds its 64 rows of
//     Q times K^T, 4 wgmma k16 steps, to S (TsBlock);
//   the online softmax and O_c += P V_c with the p_hi + p_lo split
//     (KlBlock::softmax_pv), m and l in float32.
// O_c / l goes from registers to global memory in bf16, rows at or past N
// and columns at or past d dropped, and m and l start again for the next
// panel: every panel computes the same S, so they come out the same. The
// ring and the V buffers run on across key blocks, panels and units.
// Shared memory is the same at every d (Ts). Q is read from L2 again for
// every key block and output panel: at 1 head of 576 and N = 197, 4 key
// blocks x 5 panels = 20 reads of each unit's Q, 20 x 144 KB a unit. The
// tensor maps' d extent is d and their N extent N, so nothing past either
// is read: a packed layout's next head and the next image never are. Every
// wgmma chain is straight-line code.
__global__ void __launch_bounds__(Ts::THREADS, 1)
attention_wgmma_stream_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                              const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ o, int N, int H, int d,
                              int qtiles, int units, long long sb, long long sh, long long sn, int pos,
                              float scale) {
  constexpr int BK = Ts::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;  // swizzle atoms: 1024 bytes
  const int tid = threadIdx.x, blocks = (N + BK - 1) / BK;
  const int panels = d / Ts::DP, opanels = (d + Ts::OCOLS - 1) / Ts::OCOLS;

  if (tid == 0) {
    for (int s = 0; s < Ts::RING; ++s) {
      mbar_init(base + Ts::FULL + 8 * s, 1);                // the producer's expect_tx
      mbar_init(base + Ts::EMPTY + 8 * s, Ts::CONSUMERS);   // each consumer thread, its products done
    }
    for (int x = 0; x < Ts::VBUF; ++x) {
      mbar_init(base + Ts::VFULL + 8 * x, 1);
      mbar_init(base + Ts::VEMPTY + 8 * x, Ts::CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= Ts::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;");
    if (tid != Ts::CONSUMERS) return;
    int it = 0, jv = 0;  // stages and V blocks loaded so far, over all of the block's units and panels
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int bh = u / qtiles, b = bh / H, h = bh % H;
      const Coords cq = unit_coords(pos, b, h, (u % qtiles) * Ts::QROWS);
      for (int c = 0; c < opanels; ++c) {
        for (int kb = 0; kb < blocks; ++kb) {
          const Coords ck = unit_coords(pos, b, h, kb * BK);
          const int vb = jv % Ts::VBUF;
          if (jv >= Ts::VBUF) mbar_wait(base + Ts::VEMPTY + 8 * vb, (jv / Ts::VBUF - 1) & 1);
          const uint32_t vbar = base + Ts::VFULL + 8 * vb, vs = base + Ts::V0 + vb * Ts::V_BYTES;
          mbar_expect_tx(vbar, Ts::V_BYTES);  // columns past d and rows past N arrive zero-filled and count
          tma_load(vs, &vmap, vbar, ck, Ts::OCOLS * c);
          tma_load(vs + Ts::PANEL_BYTES, &vmap, vbar, ck, Ts::OCOLS * c + Ts::DP);
          ++jv;
          for (int p = 0; p < panels; ++p, ++it) {
            const int s = it % Ts::RING;
            if (it >= Ts::RING) mbar_wait(base + Ts::EMPTY + 8 * s, (it / Ts::RING - 1) & 1);
            const uint32_t bar = base + Ts::FULL + 8 * s, dst = base + s * Ts::STAGE_BYTES;
            mbar_expect_tx(bar, Ts::STAGE_BYTES);  // rows at or past N arrive zero-filled and count
            tma_load(dst, &qmap, bar, cq, Ts::DP * p);
            tma_load(dst + Ts::Q_BYTES, &kmap, bar, ck, Ts::DP * p);
          }
        }
      }
    }
    // stay until the consumers are done with the last loads: every load
    // has landed before the thread that issued it exits
    for (int j = max(it - Ts::RING, 0); j < it; ++j)
      mbar_wait(base + Ts::EMPTY + 8 * (j % Ts::RING), (j / Ts::RING) & 1);
    for (int j = max(jv - Ts::VBUF, 0); j < jv; ++j)
      mbar_wait(base + Ts::VEMPTY + 8 * (j % Ts::VBUF), (j / Ts::VBUF) & 1);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;");
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
  const float l2 = scale * 1.4426950408889634f;  // exp(x scale) = 2^(x scale log2 e)
  int it = 0, jv = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int bh = u / qtiles, b = bh / H, h = bh % H, q0 = (u % qtiles) * Ts::QROWS;
#pragma unroll 1
    for (int c = 0; c < opanels; ++c) {
      float oc[Ts::OCOLS / 2];
#pragma unroll
      for (int e = 0; e < Ts::OCOLS / 2; ++e) oc[e] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
      for (int kb = 0; kb < blocks; ++kb) {
        // the products span the block's keys below N, rounded up to 16
        const int rem = N - kb * BK;
        const TsBlock blk{base, static_cast<uint32_t>(wg * 64 * 128), qd, rem, panels, l2};
        if (rem > 48) blk.run<64>(oc, m, l, it, jv);
        else if (rem > 32) blk.run<48>(oc, m, l, it, jv);
        else if (rem > 16) blk.run<32>(oc, m, l, it, jv);
        else blk.run<16>(oc, m, l, it, jv);
      }

      // O_c / l in bf16, pairs of columns 128 c + 8 j + 2 qd, + 1 below d
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = 1.f / l[r];
      }
      const int cols = min(Ts::OCOLS, d - Ts::OCOLS * c);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + wg * 64 + 16 * warp + g + 8 * r;
        if (row >= N) continue;
        bf16* orow = o + (size_t)b * sb + (size_t)h * sh + (size_t)row * sn + Ts::OCOLS * c + 2 * qd;
#pragma unroll
        for (int j = 0; j < Ts::OCOLS / 8; ++j)
          if (8 * j < cols)
            *reinterpret_cast<uint32_t*>(orow + 8 * j) =
                pack_bf16(oc[4 * j + 2 * r] * l[r], oc[4 * j + 2 * r + 1] * l[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// float32 past head dim 128: 3xTF32 on wgmma, Q and K streamed in 32-column
// panels of d, the output in 128-column panels
// ---------------------------------------------------------------------------

// The shapes of attention_tf32x3_wide_kernel, the same at every head dim.
// A float32 Q of 128 rows does not fit beside K, V and their TF32 pairs
// past d = 128 (96 KB at d = 192), so nothing of a unit stays in shared
// memory for all of d: Q and K come together in panels of 32 columns of d
// (one 128-byte swizzle row of float32), SP panels a stage, through a ring
// of RAW stages, and V's block in the output panel's 128 columns after its
// key block's last stage. Every region is a multiple of 1,024 bytes (the
// swizzle atom):
//   raw ring   RAW x (Q [128][32] x 2, K [32][32] x 2)    3 x 40 KB   TMA
//   K pairs    KPAIRS x (K_hi, K_lo [32][32] x 2)         3 x 16 KB   split by the producer
//   V          V [32 keys][128] as 4 x [32][32]               16 KB   TMA
//   Vt pairs   Vt_hi, Vt_lo [128][32 keys]                    32 KB   split and transposed by the producer
// 216 KB and 16 mbarriers, pinned below. What bounds the kernel is each
// stage's hand-overs (the waits, the producer's split, the chains'
// completion, one after another; tools/torch_attention_ablate.py builds
// the kernel with parts cut out by the SVT_ABLATE_* macros), so a
// stage carries two panels and the raw ring holds three stages, with one
// Vt buffer to make room: on an H100 each of the two was faster than one
// panel a stage in six stages with two Vt buffers. The key block is 32
// keys for the registers:
// ptxas gives the kernel's 384 threads 168 each, and S's chains hold O
// (64), S (16), the panel's fresh sum (16) and Q's pair (32), P V's O, a
// fresh 64-column sum (32) and P's pair (32). At 64 keys each held 32
// more, and ptxas serialised the chains (C7511).
struct Tw {
  static constexpr int BK = 32;                         // keys per block
  static constexpr int QROWS = 128;                     // query rows of a unit: 64 per consumer warpgroup
  static constexpr int DP = 32;                         // columns of d in a panel
  static constexpr int SP = 2;                          // panels a stage: d is a multiple of 64
  static constexpr int OCOLS = 128;                     // columns of an output panel
  static constexpr int Q_BYTES = QROWS * DP * 4;        // a panel of Q
  static constexpr int K_BYTES = BK * DP * 4;           // a panel of K (or K_hi, K_lo), a 32-column box of V
  static constexpr int RAW_BYTES = SP * (Q_BYTES + K_BYTES);  // a stage: SP panels of Q, then of K
  static constexpr int KP_BYTES = 2 * SP * K_BYTES;     // a stage's K_hi panels, then its K_lo panels
  static constexpr int V_BYTES = BK * OCOLS * 4;        // V's block in an output panel (or Vt_hi, Vt_lo)
  static constexpr int RAW = 3;                         // stages of the raw ring
  static constexpr int KPAIRS = 3;                      // stages of the K pairs
  static constexpr int CONSUMERS = 256;                 // two warpgroups
  static constexpr int SPLITTERS = 96;                  // producer warps 1-3; warp 0 loads
  static constexpr int THREADS = CONSUMERS + 128;       // and the producer warpgroup
  static constexpr int KP0 = RAW * RAW_BYTES;           // offsets from the 1,024-aligned base
  static constexpr int V0 = KP0 + KPAIRS * KP_BYTES;
  static constexpr int VT0 = V0 + V_BYTES;
  static constexpr int BYTES = VT0 + 2 * V_BYTES;
  // mbarriers: raw full[RAW], raw free[RAW], K ready[KPAIRS], K free[KPAIRS], V full, V free,
  // Vt ready, Vt free
  static constexpr int RFULL = BYTES, RFREE = RFULL + 8 * RAW, KREADY = RFREE + 8 * RAW,
                       KFREE = KREADY + 8 * KPAIRS, VFULL = KFREE + 8 * KPAIRS, VFREE = VFULL + 8,
                       VTREADY = VFREE + 8, VTFREE = VTREADY + 8;
  static constexpr size_t SMEM = 1024 + (size_t)VTFREE + 8;
};
static_assert(Tw::BYTES == 3 * 2 * (16384 + 4096) + 3 * 4 * 4096 + 16384 + 2 * 16384,
              "raw ring 3 x 40 KB, K pairs 3 x 16 KB, V 16 KB, Vt pairs 32 KB");
static_assert(Tw::RAW_BYTES % 1024 == 0 && Tw::K_BYTES % 1024 == 0 && Tw::V_BYTES % 1024 == 0,
              "every tile starts on a swizzle atom");
static_assert(Tw::SMEM == 1024 + 221184 + 8 * 16 && Tw::SMEM <= 232448,
              "a block's 227 KB of shared memory, whatever the head dim");
static_assert(64 % (Tw::SP * Tw::DP) == 0, "a stage's panels divide every head dim the entry takes");

// One key block of a consumer warpgroup in one output panel: S = Q K^T over
// the block's first W keys (a multiple of 8) and all of d, the online
// softmax, and O += P V over the panel's columns. jq and jv count the
// stages and V blocks this thread has taken, over the block's units;
// every barrier's phase follows from them. W is a template parameter so
// that every wgmma chain is straight-line code.
struct TwBlock {
  unsigned char* sm;  // generic address of the aligned base
  uint32_t base;      // its shared address
  uint32_t a_row;     // this thread's first A element of Q in a panel, from the panel
  int g, qd;          // lane / 4, lane % 4
  int rem;            // keys of the block below N
  int panels;         // 32-column panels of d, a multiple of SP
  bool half2;         // whether the output panel's columns 64-127 are below d
  float l2;           // scale log2 e

  template <int W>
  __device__ __forceinline__ void run(float (&oc)[64], float (&m)[2], float (&l)[2], int& jq, int& jv) const {
    // S [64, W] = Q K^T, a stage of SP panels of d at a time: Q's fragments
    // from the raw ring, split in registers, a panel at a time; each
    // panel's 12 products into a fresh accumulator, then added to S in
    // float32 (the tensor cores truncate their sums). Element e is row
    // 16 warp + g + 8 ((e % 4) / 2), key 8 (e / 4) + 2 qd + e % 2.
    float sc[W / 2];
#pragma unroll
    for (int e = 0; e < W / 2; ++e) sc[e] = 0.f;
#pragma unroll 1
    for (int p = 0; p < panels; p += Tw::SP, ++jq) {
      const int s = jq % Tw::RAW, t = jq % Tw::KPAIRS;
      mbar_wait(base + Tw::RFULL + 8 * s, (jq / Tw::RAW) & 1);
#pragma unroll
      for (int sp = 0; sp < Tw::SP; ++sp) {
      uint32_t a_hi[4][4], a_lo[4][4];
      const uint32_t qp = s * Tw::RAW_BYTES + sp * Tw::Q_BYTES + a_row;
#pragma unroll
      for (int kd = 0; kd < 4; ++kd)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float x = *reinterpret_cast<const float*>(sm + qp + (j % 2) * 8 * 128 +
                                                          (((2 * kd + j / 2) ^ g) << 4));
          const float hi = tf32_rna(x);
          a_hi[kd][j] = __float_as_uint(hi);
          a_lo[kd][j] = __float_as_uint(tf32_rna(x - hi));
        }
      if (sp == Tw::SP - 1) mbar_arrive(base + Tw::RFREE + 8 * s);  // this thread has read its Q of the stage
      if (sp == 0) mbar_wait(base + Tw::KREADY + 8 * t, (jq / Tw::KPAIRS) & 1);
      const uint32_t khi = base + Tw::KP0 + t * Tw::KP_BYTES + sp * Tw::K_BYTES, klo = khi + Tw::SP * Tw::K_BYTES;
      float st[W / 2];
      fence_regs(st);
      wgmma_fence();
#pragma unroll
      for (int kd = 0; kd < 4; ++kd) {
        const uint64_t bhd = sw128_desc(khi + 32 * kd), bld = sw128_desc(klo + 32 * kd);
        // the small terms first; the chain's first product overwrites st
#ifndef SVT_ABLATE_NO_S_PRODUCTS
        wgmma_tf32<W>(st, a_lo[kd], bhd, kd > 0);
        wgmma_tf32<W>(st, a_hi[kd], bld, 1);
        wgmma_tf32<W>(st, a_hi[kd], bhd, 1);
#else
        if (kd == 0) wgmma_tf32<W>(st, a_lo[kd], bhd, 0);
#endif
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      if (sp == Tw::SP - 1) mbar_arrive(base + Tw::KFREE + 8 * t);  // this thread's products of the stage are done
#pragma unroll
      for (int e = 0; e < W / 2; ++e) sc[e] += st[e];
      }
    }

    // the online softmax; p's pair as P V's A fragment
    float alpha[2];
    uint32_t phi[W / 8][4], plo[W / 8][4];
    tf32_softmax<W>(sc, m, l, alpha, phi, plo, rem, qd, l2);
#pragma unroll
    for (int e = 0; e < 64; ++e) oc[e] *= alpha[(e % 4) / 2];

    // O += P V, 64 columns at a time (the second half only below d), each
    // half over 8-key steps into a fresh accumulator added in float32
    mbar_wait(base + Tw::VTREADY, jv & 1);
    const uint32_t vhi = base + Tw::VT0, vlo = vhi + Tw::V_BYTES;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !half2) break;
      float pv[32];
      fence_regs(pv);
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < W / 8; ++c) {
        const uint32_t vp = h * 64 * 128 + 32 * c;
        const uint64_t vhd = sw128_desc(vhi + vp), vld = sw128_desc(vlo + vp);
        wgmma_tf32<64>(pv, plo[c], vhd, c > 0);
#ifndef SVT_ABLATE_NO_PV_PRODUCTS
        wgmma_tf32<64>(pv, phi[c], vld, 1);
        wgmma_tf32<64>(pv, phi[c], vhd, 1);
#endif
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(pv);
#pragma unroll
      for (int e = 0; e < 32; ++e) oc[32 * h + e] += pv[e];
    }
    mbar_arrive(base + Tw::VTFREE);  // this thread's products of the V block are done
    ++jv;
  }
};

// A unit is (image b, head h, query rows q0 .. q0 + 127); a persistent grid
// of one block per SM walks the units u = blockIdx.x, blockIdx.x +
// gridDim.x, ... (unit u: query tile u % qtiles of (image, head) u /
// qtiles). Warps 0-7 are two consumer warpgroups of 64 query rows each
// (setmaxnreg gives them 232 registers a thread), warps 8-11 the producer
// warpgroup: one thread of warp 8 loads by TMA, warps 9-11 split. For each
// 128-column panel c of O (the last one only 64 wide where d is an odd
// multiple of 64) and each key block (32 keys), in this order:
//   the stages of d, SP panels of 32 columns each: the loader TMA-loads
//     Q's panels (128 rows) and K's (32 keys) into a stage of the raw ring;
//     the splitters write K's TF32 pairs (split_k4's hi = tf32(x), lo =
//     tf32(x - hi)) into a stage of the K pairs; for each panel, each
//     consumer warpgroup reads its 64 rows of Q into registers, splits them
//     there, and adds Q_lo K_hi + Q_hi K_lo + Q_hi K_hi, 4 steps of 8
//     columns, to S (TwBlock);
//   V's block in the panel's columns: the loader TMA-loads it (the 32-column
//     boxes below d), the splitters write its pair transposed (Vt), and the
//     consumers run the online softmax and O_c += P V_c (TwBlock).
// O_c / l goes from registers to global memory, rows at or past N and
// columns at or past d dropped, and m and l start again for the next
// panel: every panel computes the same S, so they come out the same.
// mbarriers hand each stage over (full: loaded; ready: split; free: read),
// and each thread counts the stages it has taken, so the rings run on
// across key blocks, panels and units. Shared memory is the same at every
// d (Tw). Q is read from L2 again for every key block and output panel:
// at 3 heads of 256 and N = 197, 7 key blocks x 2 panels = 14 reads of each
// unit's Q, 14 x 128 KB a unit. The tensor maps' d extent is d and their N
// extent N, so nothing past either is read: a packed layout's next head and
// the next image never are. Every wgmma chain is straight-line code.
__global__ void __launch_bounds__(Tw::THREADS, 1)
attention_tf32x3_wide_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                             const __grid_constant__ CUtensorMap vmap, float* __restrict__ o, int N, int H,
                             int d, int qtiles, int units, long long sb, long long sh, long long sn, int pos,
                             float scale) {
  constexpr int BK = Tw::BK;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzle atoms: 1024 bytes
  unsigned char* const sm = smem_raw + (base - raw);
  const int tid = threadIdx.x, blocks = (N + BK - 1) / BK;
  const int panels = d / Tw::DP, opanels = (d + Tw::OCOLS - 1) / Tw::OCOLS;

  if (tid == 0) {
    for (int s = 0; s < Tw::RAW; ++s) {
      mbar_init(base + Tw::RFULL + 8 * s, 1);                               // the loader's expect_tx
      mbar_init(base + Tw::RFREE + 8 * s, Tw::SPLITTERS + Tw::CONSUMERS);  // K split, Q read
    }
    for (int t = 0; t < Tw::KPAIRS; ++t) {
      mbar_init(base + Tw::KREADY + 8 * t, Tw::SPLITTERS);
      mbar_init(base + Tw::KFREE + 8 * t, Tw::CONSUMERS);
    }
    mbar_init(base + Tw::VFULL, 1);
    mbar_init(base + Tw::VFREE, Tw::SPLITTERS);
    mbar_init(base + Tw::VTREADY, Tw::SPLITTERS);
    mbar_init(base + Tw::VTFREE, Tw::CONSUMERS);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (tid >= Tw::CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    const int pt = tid - Tw::CONSUMERS - 32;  // the splitters' index, 0 .. 95
    int jq = 0, jv = 0;                       // streamed panels and V blocks so far
    if (pt < 0) {
      // the loader: one thread
      if (pt != -32) return;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int bh = u / qtiles, b = bh / H, h = bh % H;
        const Coords cq = unit_coords(pos, b, h, (u % qtiles) * Tw::QROWS);
        for (int c = 0; c < opanels; ++c) {
          const int boxes = min(Tw::OCOLS, d - Tw::OCOLS * c) / Tw::DP;  // V's boxes below d: 2 or 4
          for (int kb = 0; kb < blocks; ++kb) {
            const Coords ck = unit_coords(pos, b, h, kb * BK);
            for (int p = 0; p < panels; p += Tw::SP, ++jq) {
              const int s = jq % Tw::RAW;
              if (jq >= Tw::RAW) mbar_wait(base + Tw::RFREE + 8 * s, (jq / Tw::RAW - 1) & 1);
              const uint32_t bar = base + Tw::RFULL + 8 * s, dst = base + s * Tw::RAW_BYTES;
#ifndef SVT_ABLATE_NO_Q_LOAD
              mbar_expect_tx(bar, Tw::RAW_BYTES);  // rows at or past N arrive zero-filled and count
#else
              mbar_expect_tx(bar, Tw::SP * Tw::K_BYTES);
#endif
              for (int sp = 0; sp < Tw::SP; ++sp) {
#ifndef SVT_ABLATE_NO_Q_LOAD
                tma_load(dst + sp * Tw::Q_BYTES, &qmap, bar, cq, Tw::DP * (p + sp));
#endif
                tma_load(dst + Tw::SP * Tw::Q_BYTES + sp * Tw::K_BYTES, &kmap, bar, ck, Tw::DP * (p + sp));
              }
            }
            if (jv > 0) mbar_wait(base + Tw::VFREE, (jv - 1) & 1);
            mbar_expect_tx(base + Tw::VFULL, boxes * Tw::K_BYTES);
            for (int x = 0; x < boxes; ++x)
              tma_load(base + Tw::V0 + x * Tw::K_BYTES, &vmap, base + Tw::VFULL, ck,
                       Tw::OCOLS * c + Tw::DP * x);
            ++jv;
          }
        }
      }
      // stay until the last loads have been taken: every load has landed
      // before the thread that issued it exits
      for (int j = max(jq - Tw::RAW, 0); j < jq; ++j)
        mbar_wait(base + Tw::RFREE + 8 * (j % Tw::RAW), (j / Tw::RAW) & 1);
      if (jv > 0) mbar_wait(base + Tw::VFREE, (jv - 1) & 1);
      return;
    }
    // the splitters: K's panels into their pairs, V's blocks into Vt's
    for (int u = blockIdx.x; u < units; u += gridDim.x)
      for (int c = 0; c < opanels; ++c) {
        const int cols = min(Tw::OCOLS, d - Tw::OCOLS * c);  // V's columns below d
        for (int kb = 0; kb < blocks; ++kb) {
          for (int p = 0; p < panels; p += Tw::SP, ++jq) {
            const int s = jq % Tw::RAW, t = jq % Tw::KPAIRS;
            mbar_wait(base + Tw::RFULL + 8 * s, (jq / Tw::RAW) & 1);
            if (jq >= Tw::KPAIRS) mbar_wait(base + Tw::KFREE + 8 * t, (jq / Tw::KPAIRS - 1) & 1);
            const uint32_t khi = Tw::KP0 + t * Tw::KP_BYTES;
#ifndef SVT_ABLATE_NO_SPLIT
#pragma unroll 2
            for (int i = pt; i < Tw::SP * Tw::K_BYTES / 16; i += Tw::SPLITTERS)
              split_k4(sm, s * Tw::RAW_BYTES + Tw::SP * Tw::Q_BYTES, khi, khi + Tw::SP * Tw::K_BYTES, i);
#endif
            fence_proxy_async();  // the generic-proxy writes, before wgmma reads them
            mbar_arrive(base + Tw::KREADY + 8 * t);
            mbar_arrive(base + Tw::RFREE + 8 * s);
          }
          // Vt [128][32 keys]
          mbar_wait(base + Tw::VFULL, jv & 1);
          if (jv > 0) mbar_wait(base + Tw::VTFREE, (jv - 1) & 1);
#ifndef SVT_ABLATE_NO_SPLIT
#pragma unroll 2
          for (int i = pt; i < BK * cols / 4; i += Tw::SPLITTERS)
            split_v4<BK, Tw::OCOLS>(sm, Tw::V0, Tw::VT0, Tw::VT0 + Tw::V_BYTES, i);
#endif
          fence_proxy_async();
          mbar_arrive(base + Tw::VTREADY);
          mbar_arrive(base + Tw::VFREE);
          ++jv;
        }
      }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32, g = lane / 4, qd = lane % 4;
  // this thread's A elements of Q: rows 16 warp + g (+ 8) of its
  // warpgroup's 64, k = 8 kd + qd (+ 4) of a panel: 16-byte chunk 2 kd (+ 1)
  // of the row, which the swizzle stores at chunk ^ (row % 8) = chunk ^ g
  const uint32_t a_row = (wg * 64 + 16 * warp + g) * 128 + 4 * qd;
  const float l2 = scale * 1.4426950408889634f;  // exp(x scale) = 2^(x scale log2 e)
  int jq = 0, jv = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int bh = u / qtiles, b = bh / H, h = bh % H, q0 = (u % qtiles) * Tw::QROWS;
#pragma unroll 1
    for (int c = 0; c < opanels; ++c) {
      float oc[64];
#pragma unroll
      for (int e = 0; e < 64; ++e) oc[e] = 0.f;
      float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
      for (int kb = 0; kb < blocks; ++kb) {
        // the products span the block's keys below N, rounded up to 8, 16
        // or 32: the last block of a ViT's N (197, 257, 577) has 1 to 5
        const int rem = N - kb * BK;
        const TwBlock blk{sm, base, a_row, g, qd, rem, panels, Tw::OCOLS * c + 64 < d, l2};
        if (rem > 16) blk.run<32>(oc, m, l, jq, jv);
        else if (rem > 8) blk.run<16>(oc, m, l, jq, jv);
        else blk.run<8>(oc, m, l, jq, jv);
      }

      // O_c / l, float2 stores of columns 128 c + 8 j + 2 qd, + 1 below d
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
        l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
        l[r] = 1.f / l[r];
      }
      const int cols = min(Tw::OCOLS, d - Tw::OCOLS * c);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + wg * 64 + 16 * warp + g + 8 * r;
        if (row >= N) continue;
        float* orow = o + (size_t)b * sb + (size_t)h * sh + (size_t)row * sn + Tw::OCOLS * c + 2 * qd;
#pragma unroll
        for (int j = 0; j < Tw::OCOLS / 8; ++j)
          if (8 * j < cols)
            *reinterpret_cast<float2*>(orow + 8 * j) =
                make_float2(oc[4 * j + 2 * r] * l[r], oc[4 * j + 2 * r + 1] * l[r]);
      }
    }
  }
}

// Kernel slots of prepare_launch (hopper.cuh), each allowed the dynamic
// shared memory of its largest instance: attention_hopper_kernel<nch> is
// nch - 1; then attention_tf32x3_kernel<64 | 128>,
// attention_wgmma_kl_kernel<64 | 128>, attention_wgmma_wide_kernel<3 .. 8>,
// attention_tf32x3_wide_kernel and attention_wgmma_stream_kernel.
constexpr int SLOT_TF32 = MAX_KC, SLOT_KL = MAX_KC + 2, SLOT_WIDE = MAX_KC + 4;
constexpr int SLOT_TF32_WIDE = SLOT_WIDE + WIDE_NP, SLOT_STREAM = SLOT_TF32_WIDE + 1;
constexpr int SLOTS = SLOT_STREAM + 1;

// The [B, H, N, d] view as a 4-D tensor map: d innermost, then the row,
// head and image axes in order of stride. An axis of extent 1 other than
// the row (its stride may be anything) goes outermost with a stride that
// extends the layout. Rows at or past N read as zeros.
struct Axis { long long stride; long long extent; int role; };  // role 0 row, 1 head, 2 image

// dims and byte strides of the map of elements of `esize` bytes with head
// dim d; pos[role] is the map axis (1-3) of each role
void bhnd_axes(int B, int N, int H, long long sb, long long sh, long long sn, int d, int esize,
               cuuint64_t (&dims)[4], cuuint64_t (&strides)[3], int (&pos)[3]) {
  Axis ax[3] = {{sn, N, 0}, {sh, H, 1}, {sb, B, 2}};
  auto filler = [](const Axis& a) { return a.extent == 1 && a.role != 0; };
  std::sort(ax, ax + 3, [&](const Axis& a, const Axis& b) {
    if (filler(a) != filler(b)) return filler(b);
    return a.stride < b.stride;
  });
  dims[0] = static_cast<cuuint64_t>(d);
  for (int i = 0; i < 3; ++i) {
    long long bytes = esize * ax[i].stride;
    if (filler(ax[i]))
      bytes = i == 0 ? (long long)d * esize : static_cast<long long>(strides[i - 1]) * dims[i];
    dims[i + 1] = static_cast<cuuint64_t>(ax[i].extent);
    strides[i] = static_cast<cuuint64_t>(bytes);
    pos[ax[i].role] = i + 1;
  }
}

// maps[m]: ptrs[m] laid out as bhnd_axes lays it out, in boxes of one
// 128-byte row of d (128 / esize elements) by rows[m] rows, 128-byte
// swizzle. Returns a cudaError_t code.
template <int M>
int encode_bhnd_maps(const void* const (&ptrs)[M], const int (&rows)[M], CUtensorMapDataType type,
                     int esize, int B, int N, int H, long long sb, long long sh, long long sn, int d,
                     CUtensorMap (&maps)[M], int (&pos)[3]) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  cuuint64_t dims[4], strides[3];
  bhnd_axes(B, N, H, sb, sh, sn, d, esize, dims, strides, pos);
  for (int m = 0; m < M; ++m) {
    cuuint32_t box[4] = {static_cast<cuuint32_t>(128 / esize), 1, 1, 1}, unit[4] = {1, 1, 1, 1};
    box[pos[0]] = rows[m];
    const CUresult r = encode(&maps[m], type, 4, const_cast<void*>(ptrs[m]), dims, strides, box, unit,
                              CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaSuccess);
}

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
  const int tiles = (N + QTILE - 1) / QTILE, qr = tiles * QTILE, nk = round_up(N, KC);
  // q: whole units of qr rows; k, v: nk rows; o: one query tile at a time
  CUtensorMap maps[4];
  int pos[3] = {0, 0, 0};
  const void* const ptrs[4] = {q, k, v, o};
  const int rows[4] = {qr, nk, nk, QTILE};
  const int enc = encode_bhnd_maps(ptrs, rows, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, N, H, sb, sh,
                                   sn, HD, maps, pos);
  if (enc != cudaSuccess) return enc;
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

template <int D>
int launch_tf32x3(const float* q, const float* k, const float* v, float* o, int B, int N, int H,
                  long long sb, long long sh, long long sn, float scale, cudaStream_t st) {
  using S = Tf32<D>;
  // boxes of one 128-byte row of d (32 float32) by QROWS query rows or BK keys
  CUtensorMap maps[3];
  int pos[3] = {0, 0, 0};
  const void* const ptrs[3] = {q, k, v};
  const int rows[3] = {S::QROWS, S::BK, S::BK};
  const int enc = encode_bhnd_maps(ptrs, rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B, N, H, sb, sh,
                                   sn, D, maps, pos);
  if (enc != cudaSuccess) return enc;
  const auto kernel = attention_tf32x3_kernel<D>;
  int sms = 0;
  const cudaError_t err = prepare_launch<SLOTS>(reinterpret_cast<const void*>(kernel),
                                                SLOT_TF32 + (D == 128 ? 1 : 0), S::SMEM, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qtiles = (N + S::QROWS - 1) / S::QROWS;
  const long long units = (long long)B * H * qtiles;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(units), S::THREADS, S::SMEM, st>>>(
      maps[0], maps[1], maps[2], o, N, H, qtiles, sb, sh, sn, pos[1] | (pos[2] << 2), scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_kl(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int N, int H, long long sb,
              long long sh, long long sn, float scale, cudaStream_t st) {
  using S = Kl<D>;
  // boxes of one 128-byte row of d (64 bf16) by QROWS query rows or BK keys
  CUtensorMap maps[3];
  int pos[3] = {0, 0, 0};
  const void* const ptrs[3] = {q, k, v};
  const int rows[3] = {S::QROWS, S::BK, S::BK};
  const int enc = encode_bhnd_maps(ptrs, rows, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, N, H, sb, sh,
                                   sn, D, maps, pos);
  if (enc != cudaSuccess) return enc;
  const auto kernel = attention_wgmma_kl_kernel<D>;
  int sms = 0;
  const cudaError_t err = prepare_launch<SLOTS>(reinterpret_cast<const void*>(kernel),
                                                SLOT_KL + (D == 128 ? 1 : 0), S::SMEM, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qtiles = (N + S::QROWS - 1) / S::QROWS;
  const long long units = (long long)B * H * qtiles;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(std::min<long long>(units, sms)), S::THREADS, S::SMEM, st>>>(
      maps[0], maps[1], maps[2], o, N, H, qtiles, static_cast<int>(units), sb, sh, sn,
      pos[1] | (pos[2] << 2), scale);
  return static_cast<int>(cudaGetLastError());
}

template <int NP>
int launch_wide(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int N, int H, long long sb,
                long long sh, long long sn, float scale, cudaStream_t st) {
  using S = Wide<NP>;
  // boxes of one 128-byte row of d (64 bf16) by QROWS query rows or BK keys
  CUtensorMap maps[3];
  int pos[3] = {0, 0, 0};
  const void* const ptrs[3] = {q, k, v};
  const int rows[3] = {S::QROWS, S::BK, S::BK};
  const int enc = encode_bhnd_maps(ptrs, rows, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, N, H, sb, sh,
                                   sn, S::D, maps, pos);
  if (enc != cudaSuccess) return enc;
  const auto kernel = attention_wgmma_wide_kernel<NP>;
  int sms = 0;
  const cudaError_t err = prepare_launch<SLOTS>(reinterpret_cast<const void*>(kernel),
                                                SLOT_WIDE + NP - WIDE_MIN_NP, S::SMEM, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qtiles = (N + S::QROWS - 1) / S::QROWS;
  const long long units = (long long)B * H * qtiles;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(std::min<long long>(units, sms)), S::THREADS, S::SMEM, st>>>(
      maps[0], maps[1], maps[2], o, N, H, qtiles, static_cast<int>(units), sb, sh, sn,
      pos[1] | (pos[2] << 2), scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_tf32x3_wide(const float* q, const float* k, const float* v, float* o, int B, int N, int H, int d,
                       long long sb, long long sh, long long sn, float scale, cudaStream_t st) {
  // boxes of one 128-byte row of d (32 float32) by QROWS query rows or BK keys
  CUtensorMap maps[3];
  int pos[3] = {0, 0, 0};
  const void* const ptrs[3] = {q, k, v};
  const int rows[3] = {Tw::QROWS, Tw::BK, Tw::BK};
  const int enc = encode_bhnd_maps(ptrs, rows, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, B, N, H, sb, sh, sn, d,
                                   maps, pos);
  if (enc != cudaSuccess) return enc;
  const auto kernel = attention_tf32x3_wide_kernel;
  int sms = 0;
  const cudaError_t err =
      prepare_launch<SLOTS>(reinterpret_cast<const void*>(kernel), SLOT_TF32_WIDE, Tw::SMEM, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qtiles = (N + Tw::QROWS - 1) / Tw::QROWS;
  const long long units = (long long)B * H * qtiles;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(std::min<long long>(units, sms)), Tw::THREADS, Tw::SMEM, st>>>(
      maps[0], maps[1], maps[2], o, N, H, d, qtiles, static_cast<int>(units), sb, sh, sn,
      pos[1] | (pos[2] << 2), scale);
  return static_cast<int>(cudaGetLastError());
}

using WideLaunch = int (*)(const bf16*, const bf16*, const bf16*, bf16*, int, int, int, long long, long long,
                           long long, float, cudaStream_t);

// launch_wide<NP> for NP = WIDE_MIN_NP .. WIDE_MAX / 64
template <int... I>
WideLaunch wide_launch(int np, std::integer_sequence<int, I...>) {
  static constexpr WideLaunch launches[] = {launch_wide<WIDE_MIN_NP + I>...};
  return launches[np - WIDE_MIN_NP];
}

int launch_stream(const bf16* q, const bf16* k, const bf16* v, bf16* o, int B, int N, int H, int d, long long sb,
                  long long sh, long long sn, float scale, cudaStream_t st) {
  // boxes of one 128-byte row of d (64 bf16) by QROWS query rows or BK keys
  CUtensorMap maps[3];
  int pos[3] = {0, 0, 0};
  const void* const ptrs[3] = {q, k, v};
  const int rows[3] = {Ts::QROWS, Ts::BK, Ts::BK};
  const int enc = encode_bhnd_maps(ptrs, rows, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, B, N, H, sb, sh, sn, d,
                                   maps, pos);
  if (enc != cudaSuccess) return enc;
  const auto kernel = attention_wgmma_stream_kernel;
  int sms = 0;
  const cudaError_t err =
      prepare_launch<SLOTS>(reinterpret_cast<const void*>(kernel), SLOT_STREAM, Ts::SMEM, &sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int qtiles = (N + Ts::QROWS - 1) / Ts::QROWS;
  const long long units = (long long)B * H * qtiles;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  kernel<<<static_cast<unsigned>(std::min<long long>(units, sms)), Ts::THREADS, Ts::SMEM, st>>>(
      maps[0], maps[1], maps[2], o, N, H, d, qtiles, static_cast<int>(units), sb, sh, sn,
      pos[1] | (pos[2] << 2), scale);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* q, const void* k, const void* v, const void* o) {
  return ((reinterpret_cast<std::uintptr_t>(q) | reinterpret_cast<std::uintptr_t>(k) |
           reinterpret_cast<std::uintptr_t>(v) | reinterpret_cast<std::uintptr_t>(o)) % 16) == 0;
}

// strides (elements) that are multiples of `m` where their extent is over 1
bool strides_of(int B, int H, long long sb, long long sh, long long sn, int m) {
  return sn > 0 && sn % m == 0 && (H == 1 || (sh > 0 && sh % m == 0)) && (B == 1 || (sb > 0 && sb % m == 0));
}

}  // namespace

extern "C" {

// [B, H, N, d] views with the given strides (elements); the packed
// [B, N, H*d] layout is batch stride N*H*d, head stride d, row stride H*d.

// The float32 tensor-core route: head dim d = 64 or 128, any N. The TMA
// needs 16-byte aligned addresses and strides that are multiples of 4
// elements (those of axes of extent 1 are never used); other inputs are
// refused, not sent to another kernel.
int svt_attention_bhnd_tf32x3(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                              int d, long long sb, long long sh, long long sn, float scale, void* stream) {
  if (!aligned16(q, k, v, o) || !strides_of(B, H, sb, sh, sn, 4) || B <= 0 || H <= 0 || N <= 0 ||
      (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(o);
  return d == 64 ? launch_tf32x3<64>(qf, kf, vf, of, B, N, H, sb, sh, sn, scale, st)
                 : launch_tf32x3<128>(qf, kf, vf, of, B, N, H, sb, sh, sn, scale, st);
}

// The float32 tensor-core route past head dim 128: any head dim d from 192
// that is a multiple of 64, any N. The same TMA requirements as
// svt_attention_bhnd_tf32x3; other inputs are refused, not sent to another
// kernel.
int svt_attention_bhnd_tf32x3_wide(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                                   int d, long long sb, long long sh, long long sn, float scale, void* stream) {
  if (!aligned16(q, k, v, o) || !strides_of(B, H, sb, sh, sn, 4) || B <= 0 || H <= 0 || N <= 0 ||
      d % 64 != 0 || d < 192)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_tf32x3_wide(static_cast<const float*>(q), static_cast<const float*>(k),
                            static_cast<const float*>(v), static_cast<float*>(o), B, N, H, d, sb, sh, sn,
                            scale, static_cast<cudaStream_t>(stream));
}

// The bf16 tensor-core route of the main paths: head dim 64, N <= 224. The
// TMA needs 16-byte aligned addresses and strides (the strides of axes of
// extent 1 are never used); other inputs are refused, not sent to another
// kernel.
int svt_attention_bhnd_bf16(const void* q, const void* k, const void* v, void* o, int B,
                            int H, int N, long long sb, long long sh, long long sn,
                            float scale, void* stream) {
  if (!aligned16(q, k, v, o) || !strides_of(B, H, sb, sh, sn, 8) || B <= 0 || H <= 0 || N <= 0 ||
      N > MAX_KC * KC)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_hopper(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                       static_cast<const bf16*>(v), static_cast<bf16*>(o), B, N, H, sb, sh, sn,
                       scale, static_cast<cudaStream_t>(stream));
}

// The bf16 tensor-core route with a key loop: head dim d = 64 or 128, any
// N. The same TMA requirements as svt_attention_bhnd_bf16; other inputs are
// refused, not sent to another kernel.
int svt_attention_bhnd_bf16_kl(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                               int d, long long sb, long long sh, long long sn, float scale, void* stream) {
  if (!aligned16(q, k, v, o) || !strides_of(B, H, sb, sh, sn, 8) || B <= 0 || H <= 0 || N <= 0 ||
      (d != 64 && d != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* qb = static_cast<const bf16*>(q);
  const auto* kb = static_cast<const bf16*>(k);
  const auto* vb = static_cast<const bf16*>(v);
  auto* ob = static_cast<bf16*>(o);
  return d == 64 ? launch_kl<64>(qb, kb, vb, ob, B, N, H, sb, sh, sn, scale, st)
                 : launch_kl<128>(qb, kb, vb, ob, B, N, H, sb, sh, sn, scale, st);
}

// The bf16 tensor-core route past head dim 128: head dim d = 192, 256, ...,
// WIDE_MAX, any N. The same TMA requirements as svt_attention_bhnd_bf16;
// other inputs are refused, not sent to another kernel.
int svt_attention_bhnd_bf16_wide(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                                 int d, long long sb, long long sh, long long sn, float scale, void* stream) {
  if (!aligned16(q, k, v, o) || !strides_of(B, H, sb, sh, sn, 8) || B <= 0 || H <= 0 || N <= 0 ||
      d % 64 != 0 || d < 64 * WIDE_MIN_NP || d > WIDE_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  return wide_launch(d / 64, std::make_integer_sequence<int, WIDE_NP>{})(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), B, N, H, sb, sh, sn, scale, static_cast<cudaStream_t>(stream));
}

// The bf16 tensor-core route past WIDE_MAX: any head dim d past 512 that is
// a multiple of 64, any N. The same TMA requirements as
// svt_attention_bhnd_bf16; other inputs are refused, not sent to another
// kernel. Built with -DSVT_STREAM_FROM_192 it also takes the wide kernel's
// head dims, from 192 (tools/torch_attention_ab.py --wide times the two
// kernels there).
int svt_attention_bhnd_bf16_stream(const void* q, const void* k, const void* v, void* o, int B, int H, int N,
                                   int d, long long sb, long long sh, long long sn, float scale, void* stream) {
#ifdef SVT_STREAM_FROM_192
  const int narrowest = 64 * WIDE_MIN_NP;
#else
  const int narrowest = WIDE_MAX + STREAM_DP;
#endif
  if (!aligned16(q, k, v, o) || !strides_of(B, H, sb, sh, sn, 8) || B <= 0 || H <= 0 || N <= 0 ||
      d % STREAM_DP != 0 || d < narrowest)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_stream(static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
                       static_cast<bf16*>(o), B, N, H, d, sb, sh, sn, scale, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
