// RMSNorm for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/rmsnorm.py::rmsnorm (_rmsnorm_kernel, the
// pl.pallas_call at line 50). Computes y = x * rsqrt(mean(x^2) + eps) * (1 + w)
// over the last axis, f32 math, y in x's type.
//
// Bound on the H100: bytes. One read of x and w and one write of y; about
// four operations per element, far below the card's ~295 operations per byte
// where compute would start to bound.
//
// Design: one warp per row, so the mean of squares is a warp shuffle and
// never crosses warps or blocks (the TPU kernel tiled (rows, D) blocks into
// VMEM for the same reason). Lanes stride the row, so each warp load is
// coalesced; at D = 896 each lane holds 28 elements. The row is read twice;
// the second read is served by L1/L2, since a row is a few KB.
#include "common.cuh"

namespace {

constexpr int kWarpsPerBlock = 8;

template <typename T>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const T* __restrict__ w, T* __restrict__ y,
                               int rows, int d, float eps) {
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + static_cast<size_t>(row) * d;
  T* yr = y + static_cast<size_t>(row) * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = xaas::to_f32(xr[i]);
    ss += v * v;
  }
  const float inv = rsqrtf(xaas::warp_sum(ss) / d + eps);
  for (int i = lane; i < d; i += 32) {
    const float v = xaas::to_f32(xr[i]) * inv;
    yr[i] = xaas::from_f32<T>(v * (1.f + xaas::to_f32(w[i])));
  }
}

template <typename T>
void launch(const void* x, const void* w, void* y, int rows, int d, float eps,
            cudaStream_t stream) {
  const dim3 grid((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  rmsnorm_kernel<T><<<grid, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(y),
      rows, d, eps);
}

}  // namespace

extern "C" int xaas_rmsnorm(const void* x, const void* w, void* y, int rows,
                            int d, float eps, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return cudaErrorInvalidValue;
  switch (dtype) {
    case xaas::kF32: launch<float>(x, w, y, rows, d, eps, s); break;
    case xaas::kBF16: launch<__nv_bfloat16>(x, w, y, rows, d, eps, s); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}
