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

#include "seanet_tail.cuh"

namespace {

using namespace seanet;

constexpr size_t kSmemUp = sizeof(float) * kSmemTailFloats;
constexpr size_t kSmemTail = sizeof(float) * (2 * kC * kNsP + kCr * kNzP);

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
  __syncthreads();

  up3_stage<T>(xs, wu, bu, ys, hs, t0);
  tail_stages<T>(w, ys, hs, xs, t0, out + (size_t)b * 4 * t_in + t0);
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

  tail_stages<T>(w, ys, hs, h2, t0, out + (size_t)b * t + t0);
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
