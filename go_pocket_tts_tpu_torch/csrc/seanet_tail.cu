// Fused SEANet decode tail of the Mimi decoder, for sm_90a.
//
// Replaces two Pallas TPU kernels of go_pocket_tts_tpu/ops/pallas/seanet_tail.py:
//   seanet_up_tail  <- `fused_seanet_up_tail`:
//       y = up3(x)   (ConvTranspose1d 128->64, k=8, stride 4, right trim 4)
//       z = elu(y + conv2(elu(conv1(elu(y)))))   (res3: k3 64->32, k1 32->64)
//       out = final(z)                           (k7 64->1)
//     x [B,128,T_in] -> out [B,1,4*T_in]
//   seanet_tail     <- `fused_seanet_tail`: the same chain from y = x,
//     x [B,64,T] -> out [B,1,T]
// All convolutions are causal: positions before t = 0 are zeros.
//
// What bounds it on an H100: operations. The up3 tail does ~50 kFLOP per
// output sample (up3 32 kFLOP, conv1 12, conv2 4, final 1) against 1 byte of
// input per output sample in bf16, far above the card's ~295 FLOP/byte
// ridge. The only HBM traffic is x in and PCM out: every intermediate
// ([64, t] activations at the full 24 kHz rate) lives in shared memory.
//
// Design. The TPU kernel walked 512-column blocks in order and kept 4 phases
// x 64 channels of f32 intermediates in VMEM, then wrote phases-major output
// that XLA transposed; neither the block size nor the transpose carries over.
// Here each block owns 128 consecutive output samples (32 input columns for
// the up3 tail), computes in time order, and reads its own causal halo
// (3 input columns; 8 samples of y), so blocks are independent and run in
// parallel. Stage by stage, in shared memory (float32):
//   A  y, elu(y) over t in [t0-8, t0+128)   (up3: each thread owns one
//      output channel and one phase r of t = 4m + r, whose two taps read
//      input columns m-1 and m; every x read is a warp-wide broadcast)
//   B  elu(conv1) over t in [t0-6, t0+128)  (x-tile buffer reused)
//   C  z = elu(y + conv2) over the same range, written over elu(y)
//   D  final conv, two threads per output sample
// This is plain SIMT float32 arithmetic; moving the up3 and conv1
// contractions onto tensor cores (wgmma/mma.sync) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
constexpr size_t kSmemUp = sizeof(float) * (2 * kC * kNsP + kRegion);
constexpr size_t kSmemTail = sizeof(float) * (2 * kC * kNsP + kCr * kNzP);

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

// Stages B-D. On entry ys holds y and hs holds elu(y) over t in
// [t0-8, t0+kTo) (zero before t = 0, zero padding past kNs); h2 is scratch.
template <typename T>
__device__ void tail_stages(const TailWeights<T>& w, float* ys, float* hs, float* h2,
                            int t0, T* __restrict__ out) {
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
        const bool live = t0 - 6 + s >= 0;
        hs[o0 * kNsP + s] = live ? elu(ys[o0 * kNsP + s + 2] + acc0[k]) : 0.f;
        hs[(o0 + 1) * kNsP + s] = live ? elu(ys[(o0 + 1) * kNsP + s + 2] + acc1[k]) : 0.f;
      }
    }
  }
  __syncthreads();

  // D: out[t0+n] = bf + sum_{o,d} wf[o][d] * z[o][n+d]; two threads per n.
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
    if (half == 0) out[t0 + n] = from_f32<T>(acc + to_f32(w.bf[0]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
seanet_up_tail_kernel(const T* __restrict__ x, const T* __restrict__ wu,
                      const T* __restrict__ bu, TailWeights<T> w, T* __restrict__ out,
                      int t_in) {
  extern __shared__ float smem[];
  float* ys = smem;
  float* hs = ys + kC * kNsP;
  float* xs = hs + kC * kNsP;  // stage A; then elu(conv1)
  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kTb;
  const int t0 = 4 * m0;
  const T* xb = x + (size_t)b * kCin * t_in;

  for (int e = tid; e < kCin * kXc; e += kThreads) {
    const int i = e / kXc, c = e % kXc;
    const int m = m0 - 3 + c;
    xs[e] = m >= 0 ? to_f32(xb[(size_t)i * t_in + m]) : 0.f;
  }
  for (int e = tid; e < kC * (kNsP - kNs); e += kThreads) {
    const int o = e / (kNsP - kNs), c = kNs + e % (kNsP - kNs);
    ys[o * kNsP + c] = 0.f;
    hs[o * kNsP + c] = 0.f;
  }
  __syncthreads();

  // A: y[o][4j+r] (t = t0-8+4j+r, input column m = m0-2+j) =
  //    bu[o] + sum_i wu[o][i][j1] x[i][m-1] + wu[o][i][j1+4] x[i][m],
  //    j1 = (7-r) mod 4 (wu is the repacked, flipped forward-conv kernel).
  {
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
      const float v = t0 - 8 + s >= 0 ? acc[j] : 0.f;
      ys[o * kNsP + s] = v;
      hs[o * kNsP + s] = elu(v);
    }
  }
  __syncthreads();

  tail_stages<T>(w, ys, hs, xs, t0, out + (size_t)b * 4 * t_in);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
seanet_tail_kernel(const T* __restrict__ x, TailWeights<T> w, T* __restrict__ out, int t) {
  extern __shared__ float smem[];
  float* ys = smem;
  float* hs = ys + kC * kNsP;
  float* h2 = hs + kC * kNsP;
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTo;
  const T* xb = x + (size_t)b * kC * t;

  for (int e = threadIdx.x; e < kC * kNsP; e += kThreads) {
    const int o = e / kNsP, s = e % kNsP;
    const int ts = t0 - 8 + s;
    const float v = (s < kNs && ts >= 0) ? to_f32(xb[(size_t)o * t + ts]) : 0.f;
    ys[e] = v;
    hs[e] = elu(v);
  }
  __syncthreads();

  tail_stages<T>(w, ys, hs, h2, t0, out + (size_t)b * t);
}

template <typename T>
TailWeights<T> tail_weights(const void* w1, const void* b1, const void* w2,
                            const void* b2, const void* wf, const void* bf) {
  return TailWeights<T>{static_cast<const T*>(w1), static_cast<const T*>(b1),
                        static_cast<const T*>(w2), static_cast<const T*>(b2),
                        static_cast<const T*>(wf), static_cast<const T*>(bf)};
}

template <typename T>
int launch_up(const void* x, const void* wu, const void* bu, const void* w1,
              const void* b1, const void* w2, const void* b2, const void* wf,
              const void* bf, void* out, int B, int t_in, cudaStream_t stream) {
  if (t_in % kTb != 0) return (int)cudaErrorInvalidValue;
  // Raised once per process, so launches stay legal inside a graph capture.
  static const cudaError_t attr = cudaFuncSetAttribute(
      seanet_up_tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemUp);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(t_in / kTb, B);
  seanet_up_tail_kernel<T><<<grid, kThreads, kSmemUp, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wu), static_cast<const T*>(bu),
      tail_weights<T>(w1, b1, w2, b2, wf, bf), static_cast<T*>(out), t_in);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_tail(const void* x, const void* w1, const void* b1, const void* w2,
                const void* b2, const void* wf, const void* bf, void* out, int B, int t,
                cudaStream_t stream) {
  if (t % kTo != 0) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      seanet_tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemTail);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(t / kTo, B);
  seanet_tail_kernel<T><<<grid, kThreads, kSmemTail, stream>>>(
      static_cast<const T*>(x), tail_weights<T>(w1, b1, w2, b2, wf, bf),
      static_cast<T*>(out), t);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor in that type). Returns
// cudaGetLastError() after the launch (0 on success). Weights in the
// reference layouts: wu [64,128,8] repacked, w1 [32,64,3], w2 [64,32,1],
// wf [1,64,7]; all tensors contiguous.
extern "C" int seanet_up_tail(int dtype, const void* x, const void* wu, const void* bu,
                              const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* wf, const void* bf, void* out,
                              int B, int t_in, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_up<float>(x, wu, bu, w1, b1, w2, b2, wf, bf, out, B, t_in, s);
  if (dtype == 1)
    return launch_up<__nv_bfloat16>(x, wu, bu, w1, b1, w2, b2, wf, bf, out, B, t_in, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int seanet_tail(int dtype, const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* wf, const void* bf,
                           void* out, int B, int t, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_tail<float>(x, w1, b1, w2, b2, wf, bf, out, B, t, s);
  if (dtype == 1)
    return launch_tail<__nv_bfloat16>(x, w1, b1, w2, b2, wf, bf, out, B, t, s);
  return (int)cudaErrorInvalidValue;
}
