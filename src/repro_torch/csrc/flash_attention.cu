// Flash attention (prefill) for Hopper (sm_90a).
//
// Replaces: src/repro/kernels/flash_attention.py::flash_attention
// (_attn_kernel, the pl.pallas_call at line 156). Same function: online-
// softmax attention of q (B, Sq, Hq, D) against k, v (B, Skv, Hkv, D), with
// suffix-aligned causality (query i sits at key i + Skv - Sq), an optional
// window (keys > qpos - window) and tanh softcap, GQA by kv head h / G without
// expanding K/V, and zeros for a row with no visible key.
//
// Bound on the H100: operations at the slice's prefill shapes (4*D flops per
// visible (query, key) pair against 4 bytes per key row per head read once).
// This first kernel runs its products on the f32 CUDA cores, not on the
// tensor cores, so its ceiling is the card's 67 TFLOP/s f32 rate, and its
// inner loops read one shared-memory word per FMA; wgmma tiles are later
// work.
//
// Design: one block per (tile of kBQ query rows, kv head, batch row), one
// warp per query head of the group. Each K/V tile of 32 keys is staged once
// in shared memory as f32 and used by all G heads x kBQ rows, so K/V are read
// from device memory Sq/kBQ times per kv head instead of Sq*G times. Lane i
// scores key i of the tile for each of the warp's kBQ rows; the online-
// softmax state (max, sum) of each row lives in registers, uniform across the
// warp, and each lane accumulates D/32 output dims of each row. Tiles wholly
// above the causal diagonal of the block's last row, or wholly left of its
// first row's window, are never read; the ragged tail of Skv and rows past Sq
// are masked.
#include "common.cuh"

namespace {

constexpr int kBK = 32;  // keys per tile: one per lane
constexpr int kBQ = 8;   // query rows per warp (and per block)

template <typename T, int D>
__global__ void flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, T* __restrict__ out,
                             int Sq, int Skv, int Hq, int Hkv, int causal,
                             int window, float softcap, float scale) {
  constexpr int kDPL = (D + 31) / 32;
  const int i0 = blockIdx.x * kBQ, kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int h = kvh * G + g;
  const int nthreads = blockDim.x;
  const int off = Skv - Sq;  // suffix alignment

  extern __shared__ float smem[];
  float* k_s = smem;                  // [kBK][D + 1]
  float* v_s = k_s + kBK * (D + 1);   // [kBK][D]
  float* q_s = v_s + kBK * D;         // [G][kBQ][D], pre-scaled
  float* p_s = q_s + G * kBQ * D;     // [G][kBQ][kBK]

  for (int i = threadIdx.x; i < G * kBQ * D; i += nthreads) {
    const int gg = i / (kBQ * D), r = (i / D) % kBQ, dd = i % D;
    const int row = i0 + r;
    q_s[i] = row < Sq ? xaas::to_f32(q[((static_cast<size_t>(b) * Sq + row) * Hq +
                                        kvh * G + gg) * D + dd]) * scale
                      : 0.f;
  }

  const int rows = min(kBQ, Sq - i0);
  const int first_q = i0 + off, last_q = i0 + rows - 1 + off;
  const int t_end = causal ? min(Skv, last_q + 1) : Skv;
  const int t_lo = window > 0 ? max(0, first_q - window + 1) : 0;

  float m[kBQ], l[kBQ], acc[kBQ][kDPL];
#pragma unroll
  for (int r = 0; r < kBQ; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) acc[r][i] = 0.f;
  }

  for (int t0 = (t_lo / kBK) * kBK; t0 < t_end; t0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and q_s written)
    for (int i = threadIdx.x; i < kBK * D; i += nthreads) {
      const int tt = i / D, dd = i % D, t = t0 + tt;
      float kv = 0.f, vv = 0.f;
      if (t < Skv) {
        const size_t o = ((static_cast<size_t>(b) * Skv + t) * Hkv + kvh) * D + dd;
        kv = xaas::to_f32(k[o]);
        vv = xaas::to_f32(v[o]);
      }
      k_s[tt * (D + 1) + dd] = kv;
      v_s[tt * D + dd] = vv;
    }
    __syncthreads();

    const int t = t0 + lane;
    float dot[kBQ];
#pragma unroll
    for (int r = 0; r < kBQ; ++r) dot[r] = 0.f;
    const float* kr = k_s + lane * (D + 1);
    const float* qg = q_s + g * kBQ * D;
#pragma unroll 4
    for (int dd = 0; dd < D; ++dd) {
      const float kv = kr[dd];
#pragma unroll
      for (int r = 0; r < kBQ; ++r) dot[r] += qg[r * D + dd] * kv;
    }
    float* pg = p_s + g * kBQ * kBK;
#pragma unroll
    for (int r = 0; r < kBQ; ++r) {
      const int qpos = i0 + r + off;
      const bool visible = r < rows && t < Skv && (!causal || t <= qpos) &&
                           (window <= 0 || t > qpos - window);
      float s = -INFINITY;
      if (visible) s = softcap > 0.f ? softcap * tanhf(dot[r] / softcap) : dot[r];
      float alpha;
      pg[r * kBK + lane] = xaas::online_softmax_step(s, m[r], l[r], alpha);
#pragma unroll
      for (int i = 0; i < kDPL; ++i) acc[r][i] *= alpha;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int dd = lane + 32 * i;
      if (dd < D) {
        for (int tt = 0; tt < kBK; ++tt) {
          const float vv = v_s[tt * D + dd];
#pragma unroll
          for (int r = 0; r < kBQ; ++r) acc[r][i] += pg[r * kBK + tt] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kBQ; ++r) {
    if (r >= rows) break;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    T* o = out + ((static_cast<size_t>(b) * Sq + i0 + r) * Hq + h) * D;
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int dd = lane + 32 * i;
      if (dd < D) o[dd] = xaas::from_f32<T>(acc[r][i] * inv);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Sq, int Skv, int Hq, int Hkv, int causal, int window,
           float softcap, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) *
      (kBK * (D + 1) + kBK * D + G * kBQ * D + G * kBQ * kBK);
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        227 * 1024);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, Hkv, B);
  flash_kernel<T, D><<<grid, G * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), Sq, Skv, Hq, Hkv,
      causal, window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v, void* out,
               int B, int Sq, int Skv, int Hq, int Hkv, int causal, int window,
               float softcap, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    case 32: return launch<T, 32>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    case 64: return launch<T, 64>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    case 128: return launch<T, 128>(q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Sq, Hq, D); k, v (B, Skv, Hkv, D); out (B, Sq, Hq, D).
// window <= 0: none; softcap <= 0: none. Contiguous tensors only.
extern "C" int xaas_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int B, int Sq,
                                    int Skv, int Hq, int Hkv, int D,
                                    int causal, int window, float softcap,
                                    float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || Sq <= 0 || Skv <= 0 || Hkv <= 0 || Hq % Hkv || Hq / Hkv > 16)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case xaas::kF32:
      return dispatch_d<float>(D, q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    case xaas::kBF16:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, out, B, Sq, Skv, Hq, Hkv, causal, window, softcap, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
