// Shared helpers of the Hopper kernels: float32 <-> storage-type conversion
// and warp reductions. Every kernel is templated on its storage type T
// (float for the parity checks, __nv_bfloat16 for the main path) and
// computes in float32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace svt {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even, as torch's .to(torch.bfloat16) and JAX's astype do
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// round_to and warp_max: no kernel of this tree calls them, but
// tools/torch_kernel_ab.py builds other versions of the sources against
// these headers, and older ones do.

// x rounded through T: what a cast to T and back to float32 gives
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace svt
