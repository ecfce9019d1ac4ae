// Decode attention for Hopper (sm_90a): one query token per row against a
// contiguous KV cache.
//
// Replaces: src/repro/kernels/decode_attention.py::decode_attention
// (_decode_kernel, the pl.pallas_call at line 130). Same function: all G =
// Hq/Hkv query heads of a kv head attend the cache; positions >= length are
// masked (length counts the current token), a window keeps positions >=
// length - window, an optional tanh softcap bounds the logits, and a row with
// no visible position (length 0) gives zeros.
//
// Bound on the H100: bytes. Each cache entry is read once and used for
// 2*G*D operations per kv head, about 7 operations per bf16 byte at G = 7,
// far below the card's ~295.
//
// Design: one block per (kv head, batch row), one warp per query head of the
// group, so every K/V tile read from device memory is shared by all G heads
// (the reason GQA exists; the TPU kernel did the same with a (G, D) q tile).
// A tile of 32 keys is staged in shared memory as f32 (K rows padded by one
// float so the per-lane row reads hit distinct banks); lane i scores key i of
// the tile, the warp runs the online softmax with shuffles, and each lane
// accumulates D/32 output dims. Tiles past the row's length, and tiles wholly
// below the window, are never read, so a short row costs what it holds.
// Known limit: the grid has only B*Hkv blocks (16 at 8 slots x 2 kv heads on
// 132 SMs); splitting the sequence over more blocks is later work.
#include "common.cuh"

namespace {

constexpr int kBK = 32;  // keys per tile: one per lane

template <typename T, int D>
__global__ void decode_kernel(const T* __restrict__ q,
                              const T* __restrict__ kc,
                              const T* __restrict__ vc,
                              const int* __restrict__ lengths,
                              T* __restrict__ out, int S, int Hq, int Hkv,
                              int window, float softcap, float scale) {
  constexpr int kDPL = (D + 31) / 32;  // output dims per lane
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = Hq / Hkv;
  const int g = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nthreads = blockDim.x;

  extern __shared__ float smem[];
  float* k_s = smem;                // [kBK][D + 1]
  float* v_s = k_s + kBK * (D + 1); // [kBK][D]
  float* q_s = v_s + kBK * D;       // [G][D], pre-scaled
  float* p_s = q_s + G * D;         // [G][kBK]

  for (int i = threadIdx.x; i < G * D; i += nthreads) {
    q_s[i] = xaas::to_f32(q[(static_cast<size_t>(b) * Hq + kvh * G) * D + i]) *
             scale;
  }
  const int length = min(max(lengths[b], 0), S);
  const int lo = window > 0 ? max(0, length - window) : 0;

  float m = -INFINITY, l = 0.f, acc[kDPL];
#pragma unroll
  for (int i = 0; i < kDPL; ++i) acc[i] = 0.f;

  for (int t0 = (lo / kBK) * kBK; t0 < length; t0 += kBK) {
    __syncthreads();  // previous tile fully consumed (and q_s written)
    for (int i = threadIdx.x; i < kBK * D; i += nthreads) {
      const int tt = i / D, dd = i % D, t = t0 + tt;
      float kv = 0.f, vv = 0.f;
      if (t < length) {
        const size_t off = ((static_cast<size_t>(b) * S + t) * Hkv + kvh) * D + dd;
        kv = xaas::to_f32(kc[off]);
        vv = xaas::to_f32(vc[off]);
      }
      k_s[tt * (D + 1) + dd] = kv;
      v_s[tt * D + dd] = vv;
    }
    __syncthreads();

    const int t = t0 + lane;
    float s = -INFINITY;
    if (t < length && t >= lo) {
      const float* qr = q_s + g * D;
      const float* kr = k_s + lane * (D + 1);
      float dot = 0.f;
#pragma unroll
      for (int dd = 0; dd < D; ++dd) dot += qr[dd] * kr[dd];
      s = softcap > 0.f ? softcap * tanhf(dot / softcap) : dot;
    }
    float alpha;
    const float p = xaas::online_softmax_step(s, m, l, alpha);
    p_s[g * kBK + lane] = p;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kDPL; ++i) {
      const int dd = lane + 32 * i;
      if (dd < D) {
        float a = acc[i] * alpha;
#pragma unroll 8
        for (int tt = 0; tt < kBK; ++tt) a += p_s[g * kBK + tt] * v_s[tt * D + dd];
        acc[i] = a;
      }
    }
  }

  const float inv = l > 0.f ? 1.f / l : 0.f;
  T* o = out + (static_cast<size_t>(b) * Hq + kvh * G + g) * D;
#pragma unroll
  for (int i = 0; i < kDPL; ++i) {
    const int dd = lane + 32 * i;
    if (dd < D) o[dd] = xaas::from_f32<T>(acc[i] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           void* out, int B, int S, int Hq, int Hkv, int window, float softcap,
           float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = sizeof(float) * (kBK * (D + 1) + kBK * D + G * D + G * kBK);
  decode_kernel<T, D><<<dim3(Hkv, B), G * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), lengths, static_cast<T*>(out), S, Hq, Hkv,
      window, softcap, scale);
  return cudaGetLastError();
}

template <typename T>
int dispatch_d(int D, const void* q, const void* k, const void* v,
               const int* lengths, void* out, int B, int S, int Hq, int Hkv,
               int window, float softcap, float scale, cudaStream_t s) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, lengths, out, B, S, Hq, Hkv, window, softcap, scale, s);
    case 32: return launch<T, 32>(q, k, v, lengths, out, B, S, Hq, Hkv, window, softcap, scale, s);
    case 64: return launch<T, 64>(q, k, v, lengths, out, B, S, Hq, Hkv, window, softcap, scale, s);
    case 128: return launch<T, 128>(q, k, v, lengths, out, B, S, Hq, Hkv, window, softcap, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, D); k, v (B, S, Hkv, D); lengths (B,) int32; out (B, Hq, D).
// window <= 0: none; softcap <= 0: none. Contiguous tensors only.
extern "C" int xaas_decode_attention(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* out, int B, int S, int Hq, int Hkv,
                                     int D, int window, float softcap,
                                     float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(lengths);
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv || Hq / Hkv > 16)
    return cudaErrorInvalidValue;
  switch (dtype) {
    case xaas::kF32:
      return dispatch_d<float>(D, q, k, v, lens, out, B, S, Hq, Hkv, window, softcap, scale, s);
    case xaas::kBF16:
      return dispatch_d<__nv_bfloat16>(D, q, k, v, lens, out, B, S, Hq, Hkv, window, softcap, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
