// Batched decode-step attention with per-lane offsets, for sm_90a.
//
// Replaces the Pallas TPU kernel `batched_decode_attention`
// (go_pocket_tts_tpu/ops/pallas/batched_decode_attention.py), both of its
// variants. For one layer `layer` of the stacked [L,B,H,C,D] caches and one
// AR step of the continuous batcher, per lane b and head h:
//
//   out[b,h] = softmax(q[b,h].K[b,h]^T / sqrt(D) masked to slots <= offsets[b]).V[b,h]
//
// The caller has already rotated q and scattered the step's K/V rows into
// the caches; the kernel only reads them. Offsets come from device memory,
// so the batcher's AR block never syncs with the host to launch it.
//   - float variant: caches bfloat16 or float32, the type of q;
//   - int8 variant: int8 caches with one float32 scale per row
//     ([L,B,H,C]); as in the reference's int8 kernel the scales distribute
//     over the products, scores = (k_i8 . q) * k_scale / sqrt(D) and
//     out = sum_t p_t * v_scale_t * v_i8_t, so no row is dequantized to
//     memory.
// Math is float32 throughout; the output is rounded once to q's type.
//
// What bounds it on an H100: the read of each lane's visible rows. At
// B = 8, H = 16, C = 384 a full read is 12.6 MB of bf16 K+V (3.8 us at
// 3.35 TB/s) or 6.7 MB of int8 rows plus scales (2.0 us). Design: one block
// of 8 warps per (lane, head) pair, 128 blocks for the 132 SMs at that
// shape; rows past the lane's offset are never read.
//   1. scores: each thread takes whole K rows (slot = thread, thread + 256,
//      ...), reads a row with 16-byte loads and dots it with q, held in
//      registers; the scores stay in shared memory;
//   2. softmax: block-wide max and sum of exp over the scores;
//   3. P.V: each warp takes every 8th slot and reads the V row coalesced (2
//      elements a lane); the 8 warps' partial outputs are summed once and
//      divided by the softmax sum.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kD = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

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

// Block-wide reduction of one value a thread (all threads call it).
template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = kMax ? warp_max(v) : warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = kMax ? fmaxf(r, red[w]) : r + red[w];
  __syncthreads();
  return r;
}

// QT: type of q and out (float or bfloat16); CT: cache element type (QT, or
// int8_t with row scales).
template <typename QT, typename CT, bool kInt8>
__global__ void __launch_bounds__(kThreads)
batched_decode_attention_kernel(const QT* __restrict__ q, const CT* __restrict__ k_cache,
                                const CT* __restrict__ v_cache,
                                const float* __restrict__ k_scale,
                                const float* __restrict__ v_scale,
                                const int32_t* __restrict__ offsets, QT* __restrict__ out,
                                int B, int H, int C, int layer, float sm_scale) {
  constexpr int kPer = 16 / sizeof(CT);  // cache elements per 16-byte load
  extern __shared__ float scores[];      // [C]
  __shared__ float red[kWarps];
  __shared__ float part[kWarps][kD];

  const int bh = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int off = offsets[bh / H];
  const int n = min(off, C - 1) + 1;  // visible slots 0 .. n-1
  const size_t tile = ((size_t)layer * B * H + bh) * (size_t)C;
  const CT* kc = k_cache + tile * kD;
  const CT* vc = v_cache + tile * kD;

  float qr[kD];
#pragma unroll
  for (int d = 0; d < kD; ++d) qr[d] = to_f32(q[(size_t)bh * kD + d]);

  float m_local = -INFINITY;
  for (int s = tid; s < n; s += kThreads) {
    const uint4* row = reinterpret_cast<const uint4*>(kc + (size_t)s * kD);
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < kD / kPer; ++c) {
      const uint4 u = row[c];
      const CT* e = reinterpret_cast<const CT*>(&u);
#pragma unroll
      for (int j = 0; j < kPer; ++j) dot += qr[c * kPer + j] * to_f32(e[j]);
    }
    if constexpr (kInt8) dot *= k_scale[tile + s];
    dot *= sm_scale;
    scores[s] = dot;
    m_local = fmaxf(m_local, dot);
  }
  const float m = block_reduce<true>(m_local, red);

  float sum_local = 0.f;
  for (int s = tid; s < n; s += kThreads) {
    const float e = expf(scores[s] - m);
    scores[s] = e;
    sum_local += e;
  }
  const float denom = block_reduce<false>(sum_local, red);  // also orders the writes above

  const int d0 = lane * 2;
  float acc0 = 0.f, acc1 = 0.f;
#pragma unroll 4
  for (int s = warp; s < n; s += kWarps) {
    float p = scores[s];
    if constexpr (kInt8) p *= v_scale[tile + s];
    const CT* vrow = vc + (size_t)s * kD + d0;
    acc0 += p * to_f32(vrow[0]);
    acc1 += p * to_f32(vrow[1]);
  }
  part[warp][d0] = acc0;
  part[warp][d0 + 1] = acc1;
  __syncthreads();

  if (tid < kD) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += part[w][tid];
    out[(size_t)bh * kD + tid] = from_f32<QT>(n > 0 && denom > 0.f ? o / denom : 0.f);
  }
}

template <typename QT, typename CT, bool kInt8>
int launch(const void* q, const void* k_cache, const void* v_cache, const void* k_scale,
           const void* v_scale, const void* offsets, void* out, int B, int H, int C, int D,
           int layer, cudaStream_t stream) {
  if (D != kD) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)C * sizeof(float);
  batched_decode_attention_kernel<QT, CT, kInt8><<<B * H, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k_cache),
      static_cast<const CT*>(v_cache), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int32_t*>(offsets),
      static_cast<QT*>(out), B, H, C, layer, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of q, out and (float variant) the caches: 0 = float32, 1 = bfloat16.
// q/out [B*H, D]; caches [L, B*H, C, D]; row scales [L, B*H, C] float32;
// offsets [B] int32. Each returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int batched_decode_attention(int dtype, const void* q, const void* k_cache,
                                        const void* v_cache, const void* offsets, void* out,
                                        int B, int H, int C, int D, int layer, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, float, false>(q, k_cache, v_cache, nullptr, nullptr, offsets, out,
                                       B, H, C, D, layer, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false>(q, k_cache, v_cache, nullptr,
                                                       nullptr, offsets, out, B, H, C, D,
                                                       layer, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int batched_decode_attention_int8(int dtype, const void* q, const void* k_cache,
                                             const void* k_scale, const void* v_cache,
                                             const void* v_scale, const void* offsets,
                                             void* out, int B, int H, int C, int D, int layer,
                                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float, int8_t, true>(q, k_cache, v_cache, k_scale, v_scale, offsets, out,
                                       B, H, C, D, layer, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t, true>(q, k_cache, v_cache, k_scale, v_scale,
                                               offsets, out, B, H, C, D, layer, s);
  return (int)cudaErrorInvalidValue;
}
