// Fused decode-step attention over a stacked KV cache, for sm_90a.
//
// Replaces the Pallas TPU kernel `decode_attention_step`
// (go_pocket_tts_tpu/ops/pallas/decode_attention.py). One launch per layer
// of an AR step (T = 1) does all of it:
//   1. RoPE of q and k_new at `offset`, in the duplicated-trig / pair-swap
//      form: rope(x)[2j] = x[2j]cos - x[2j+1]sin, rope(x)[2j+1] =
//      x[2j+1]cos + x[2j]sin; the rotated q is rounded to the activation
//      type, as the reference rounds it before its kernel;
//   2. the append of rope(k_new) and v_new at row `offset` of layer
//      `layer`, in place on the [L,B,H,C,D] caches (Mosaic could not prove
//      that dynamic single-row store aligned, so the TPU kernel left it to
//      XLA; on Hopper it is an ordinary store);
//   3. per (b, h): softmax(q.K^T / sqrt(D) masked to slots <= offset).V.
// `offset` is read from device memory, so the AR loop never syncs with the
// host to launch it.
//
// What bounds it on an H100: the KV read. At C = 320, bf16, 16 heads that is
// 16*320*64*2*2 B = 1.3 MB per layer, ~0.4 us at 3.35 TB/s, well under the
// launch latency, so a first kernel only has to avoid wasting bytes. Design:
// one block per (b, h); slots past `offset` are masked, so they are never
// read; each warp walks its share of the visible rows with one coalesced row
// read per slot (64 elements across 32 lanes); the scores stay in shared
// memory, the softmax and the weighted V sum run in float32, and the
// per-warp partial outputs are summed once at the end. A __syncthreads()
// orders the append before the read of the same row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_new,
                        const T* __restrict__ v_new, T* k_cache, T* v_cache,
                        const int32_t* __restrict__ offset_ptr,
                        const float* __restrict__ rope_cos,
                        const float* __restrict__ rope_sin, T* __restrict__ out,
                        int BH, int C, int layer, int max_seq, float scale) {
  static_assert(D % 32 == 0 && D <= kThreads, "head dim");
  constexpr int EPL = D / 32;  // elements of a row per lane

  extern __shared__ float scores[];  // [C]
  __shared__ float q_s[D];
  __shared__ float red[kWarps];
  __shared__ float part[kWarps][D];

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int off = *offset_ptr;
  // Out-of-range offsets clamp as the reference's dynamic slices do.
  const int row = min(max(off, 0), C - 1);
  const int rope_row = min(max(off, 0), max_seq - 1);
  const size_t tile = ((size_t)layer * BH + bh) * (size_t)C * D;
  T* kc = k_cache + tile;
  T* vc = v_cache + tile;

  if (tid < D) {
    const int j = tid >> 1;
    const float c = rope_cos[(size_t)rope_row * (D / 2) + j];
    const float s = (tid & 1) ? rope_sin[(size_t)rope_row * (D / 2) + j]
                              : -rope_sin[(size_t)rope_row * (D / 2) + j];
    const size_t base = (size_t)bh * D;
    const float qx = to_f32(q[base + tid]), qp = to_f32(q[base + (tid ^ 1)]);
    q_s[tid] = to_f32(from_f32<T>(qx * c + qp * s));
    const float kx = to_f32(k_new[base + tid]), kp = to_f32(k_new[base + (tid ^ 1)]);
    kc[(size_t)row * D + tid] = from_f32<T>(kx * c + kp * s);
    vc[(size_t)row * D + tid] = v_new[base + tid];
  }
  __syncthreads();

  // Visible slots: 0 .. min(off, C-1).
  const int n = min(off, C - 1) + 1;
  float qreg[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) qreg[e] = q_s[lane * EPL + e];

  float m_local = -INFINITY;
  for (int s = warp; s < n; s += kWarps) {
    const T* krow = kc + (size_t)s * D + lane * EPL;
    float dot = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) dot += qreg[e] * to_f32(krow[e]);
    dot = warp_sum(dot) * scale;
    if (lane == 0) scores[s] = dot;
    m_local = fmaxf(m_local, dot);
  }
  if (lane == 0) red[warp] = m_local;
  __syncthreads();
  float m = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
  __syncthreads();

  float sum_local = 0.f;
  for (int s = tid; s < n; s += kThreads) {
    const float e = expf(scores[s] - m);
    scores[s] = e;
    sum_local += e;
  }
  sum_local = warp_sum(sum_local);
  if (lane == 0) red[warp] = sum_local;
  __syncthreads();
  float denom = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) denom += red[w];

  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  for (int s = warp; s < n; s += kWarps) {
    const float p = scores[s];
    const T* vrow = vc + (size_t)s * D + lane * EPL;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] += p * to_f32(vrow[e]);
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) part[warp][lane * EPL + e] = acc[e];
  __syncthreads();

  if (tid < D) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += part[w][tid];
    out[(size_t)bh * D + tid] = from_f32<T>(n > 0 && denom > 0.f ? o / denom : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, void* k_cache,
           void* v_cache, const void* offset, const void* rope_cos,
           const void* rope_sin, void* out, int BH, int C, int D, int layer,
           int max_seq, cudaStream_t stream) {
  if (D != 64) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)C * sizeof(float);
  decode_attention_kernel<T, 64><<<BH, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(k_cache),
      static_cast<T*>(v_cache), static_cast<const int32_t*>(offset),
      static_cast<const float*>(rope_cos), static_cast<const float*>(rope_sin),
      static_cast<T*>(out), BH, C, layer, max_seq, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success). Caches are [L, B*H, C, D]; q/k_new/v_new/out
// [B*H, D]; rope tables [max_seq, D/2] float32; offset one int32.
extern "C" int decode_attention_step(int dtype, const void* q, const void* k_new,
                                     const void* v_new, void* k_cache, void* v_cache,
                                     const void* offset, const void* rope_cos,
                                     const void* rope_sin, void* out, int BH, int C,
                                     int D, int layer, int max_seq, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_new, v_new, k_cache, v_cache, offset, rope_cos, rope_sin,
                         out, BH, C, D, layer, max_seq, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, offset, rope_cos,
                                 rope_sin, out, BH, C, D, layer, max_seq, s);
  return (int)cudaErrorInvalidValue;
}
