// Device code shared by the fused SEANet decode kernels (seanet_tail.cu,
// seanet_up2.cu) in float32, the parity dtype (bfloat16 runs on the
// tensor-core stages of seanet_mma.cuh): the up3 block stage and the res3 +
// final-conv stages, computed in time order over one block of 128 output
// samples in shared memory, with causal zeros before absolute position 0.
//
// Block geometry (256 threads). A block owns output samples [t0, t0+128)
// and reads the up3 input (128 channels) at columns [m0-3, m0+32), m0 = t0/4:
//   xs [kCin][kXc]  up3 input tile, column c <-> m = m0-3+c
//   ys [kC][kNsP]   y = up3(x) over t in [t0-8, t0+128), zero padded to kNsP
//   hs [kC][kNsP]   elu(y), then z = elu(y + res3(y)) over [t0-6, t0+128)
//   h2 [kCr][kNzP]  elu(res3.conv1), over [t0-6, t0+128)
// Masks take the block's ABSOLUTE first sample `t_abs0`: the whole-sequence
// kernels pass t0, the streaming cascade the block's position in the stream.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace seanet {

constexpr int kThreads = 256;
constexpr int kCin = 128;           // up3 input channels
constexpr int kC = 64;              // tail channels
constexpr int kCr = 32;             // res3 hidden channels
constexpr int kTo = 128;            // output samples per block
constexpr int kTb = kTo / 4;        // up3 input columns per block
constexpr int kNs = kTo + 8;        // y samples per block: t in [t0-8, t0+kTo)
constexpr int kNsP = kNs + 4;       // row stride of y / elu(y) / z (zero pad)
constexpr int kXc = kTb + 3;        // x columns: m in [m0-3, m0+kTb)
constexpr int kNz = kTo + 6;        // conv1 / z samples: t in [t0-6, t0+kTo)
constexpr int kNzP = kNs;           // row stride of elu(conv1): 8 x 17 columns
constexpr int kRegion = kCin * kXc > kCr * kNzP ? kCin * kXc : kCr * kNzP;
// Floats of shared memory: ys, hs, then the x tile / elu(conv1) region.
constexpr int kSmemTailFloats = 2 * kC * kNsP + kRegion;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : expm1f(v); }

template <typename T>
struct TailWeights {
  const T* w1;  // [32, 64, 3]
  const T* b1;  // [32]
  const T* w2;  // [64, 32, 1]
  const T* b2;  // [64]
  const T* wf;  // [1, 64, 7]
  const T* bf;  // [1]
};

// Stage A: ys = up3(xs), hs = elu(ys) over t in [t0-8, t0+kTo), zero before
// absolute t = 0 and in the row padding; ends with a barrier.
//   y[o][4j+r] (t = t0-8+4j+r, input column m = m0-2+j) =
//     bu[o] + sum_i wu[o][i][j1] x[i][m-1] + wu[o][i][j1+4] x[i][m],
//   j1 = (7-r) mod 4 (wu is the repacked, flipped forward-conv kernel).
// Each thread owns one output channel and one phase r, so its two weights
// per input channel serve 34 columns and every x read is a broadcast.
template <typename T>
__device__ void up3_stage(const float* xs, const T* __restrict__ wu, const T* __restrict__ bu,
                          float* ys, float* hs, int t_abs0) {
  const int tid = threadIdx.x;
  for (int e = tid; e < kC * (kNsP - kNs); e += kThreads) {
    const int o = e / (kNsP - kNs), c = kNs + e % (kNsP - kNs);
    ys[o * kNsP + c] = 0.f;
    hs[o * kNsP + c] = 0.f;
  }
  const int o = tid >> 2;
  const int r = tid & 3;
  const int j1 = (7 - r) & 3;
  constexpr int kJ = kNs / 4;
  float acc[kJ];
  const float bias = to_f32(bu[o]);
#pragma unroll
  for (int j = 0; j < kJ; ++j) acc[j] = bias;
  for (int i = 0; i < kCin; ++i) {
    const float wa = to_f32(wu[(o * kCin + i) * 8 + j1]);
    const float wb = to_f32(wu[(o * kCin + i) * 8 + j1 + 4]);
    const float* xr = xs + i * kXc;
    float prev = xr[0];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      const float cur = xr[j + 1];
      acc[j] += wa * prev + wb * cur;
      prev = cur;
    }
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    const int s = 4 * j + r;
    const float v = t_abs0 - 8 + s >= 0 ? acc[j] : 0.f;
    ys[o * kNsP + s] = v;
    hs[o * kNsP + s] = elu(v);
  }
  __syncthreads();
}

// Stages B-D. On entry ys holds y and hs holds elu(y) over t in
// [t0-8, t0+kTo) (zero before t = 0, zero padding past kNs); h2 is scratch.
// Writes the block's kTo samples to out[0 .. kTo).
template <typename T>
__device__ void tail_stages(const TailWeights<T>& w, float* ys, float* hs, float* h2,
                            int t_abs0, T* __restrict__ out) {
  const int tid = threadIdx.x;

  // B: h2[c][s] = elu(b1[c] + sum_{i,d} w1[c][i][d] * hs[i][s+d]); s <-> t0-6+s.
  {
    const int c = tid >> 3;
    const int s0 = (tid & 7) * 17;
    float acc[17];
    const float bias = to_f32(w.b1[c]);
#pragma unroll
    for (int k = 0; k < 17; ++k) acc[k] = bias;
    for (int i = 0; i < kC; ++i) {
      const T* wr = w.w1 + (c * kC + i) * 3;
      const float a = to_f32(wr[0]), b = to_f32(wr[1]), d = to_f32(wr[2]);
      const float* hr = hs + i * kNsP + s0;
      float hv[19];
#pragma unroll
      for (int k = 0; k < 19; ++k) hv[k] = hr[k];
#pragma unroll
      for (int k = 0; k < 17; ++k) acc[k] += a * hv[k] + b * hv[k + 1] + d * hv[k + 2];
    }
#pragma unroll
    for (int k = 0; k < 17; ++k) h2[c * kNzP + s0 + k] = elu(acc[k]);
  }
  __syncthreads();

  // C: z[o][s] = elu(y[o][s+2] + b2[o] + sum_c w2[o][c] * h2[c][s]), zero
  // before t = 0; written over hs (elu(y) is no longer read).
  {
    const int o0 = (tid >> 3) * 2;
    const int s0 = (tid & 7) * 17;
    float acc0[17], acc1[17];
    const float bias0 = to_f32(w.b2[o0]), bias1 = to_f32(w.b2[o0 + 1]);
#pragma unroll
    for (int k = 0; k < 17; ++k) {
      acc0[k] = bias0;
      acc1[k] = bias1;
    }
    for (int c = 0; c < kCr; ++c) {
      const float a = to_f32(w.w2[o0 * kCr + c]), b = to_f32(w.w2[(o0 + 1) * kCr + c]);
      const float* hr = h2 + c * kNzP + s0;
#pragma unroll
      for (int k = 0; k < 17; ++k) {
        const float h = hr[k];
        acc0[k] += a * h;
        acc1[k] += b * h;
      }
    }
    __syncthreads();  // every thread is done reading hs (stage B) and h2
#pragma unroll
    for (int k = 0; k < 17; ++k) {
      const int s = s0 + k;
      if (s < kNz) {
        const bool live = t_abs0 - 6 + s >= 0;
        hs[o0 * kNsP + s] = live ? elu(ys[o0 * kNsP + s + 2] + acc0[k]) : 0.f;
        hs[(o0 + 1) * kNsP + s] = live ? elu(ys[(o0 + 1) * kNsP + s + 2] + acc1[k]) : 0.f;
      }
    }
  }
  __syncthreads();

  // D: out[n] = bf + sum_{o,d} wf[o][d] * z[o][n+d]; two threads per n.
  {
    const int n = tid >> 1;
    const int half = tid & 1;
    float acc = 0.f;
    for (int o = half * (kC / 2); o < (half + 1) * (kC / 2); ++o) {
      const T* wr = w.wf + o * 7;
      const float* zr = hs + o * kNsP + n;
#pragma unroll
      for (int d = 0; d < 7; ++d) acc += to_f32(wr[d]) * zr[d];
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (half == 0) out[n] = from_f32<T>(acc + to_f32(w.bf[0]));
  }
}

template <typename T>
TailWeights<T> tail_weights(const void* w1, const void* b1, const void* w2, const void* b2,
                            const void* wf, const void* bf) {
  return TailWeights<T>{static_cast<const T*>(w1), static_cast<const T*>(b1),
                        static_cast<const T*>(w2), static_cast<const T*>(b2),
                        static_cast<const T*>(wf), static_cast<const T*>(bf)};
}

}  // namespace seanet
