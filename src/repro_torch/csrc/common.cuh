// Helpers shared by the port's Hopper kernels: element conversion and warp
// reductions. Every kernel computes in f32 and stores in the input's type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace xaas {

// dtype codes of the C entry points (kernels/build.py::DTYPE_CODES)
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even, as torch's .to(torch.bfloat16)
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One step of the online softmax for a score `s` (-inf when masked) held by
// each lane: updates the running max `m` and sum `l` (uniform across the
// warp) and returns this lane's probability and the rescale factor `alpha`
// for the accumulator. A row that has seen no visible key keeps m = -inf,
// l = 0, and contributes p = 0.
__device__ __forceinline__ float online_softmax_step(float s, float& m,
                                                     float& l, float& alpha) {
  const float m_new = fmaxf(m, warp_max(s));
  const float p = (s == -INFINITY) ? 0.f : expf(s - m_new);
  alpha = (m == -INFINITY) ? 0.f : expf(m - m_new);
  l = l * alpha + warp_sum(p);
  m = m_new;
  return p;
}

}  // namespace xaas
