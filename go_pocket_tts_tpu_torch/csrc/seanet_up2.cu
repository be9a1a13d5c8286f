// The up2 stage of the Mimi decoder's SEANet, and the whole up2 -> up3 ->
// tail cascade, for sm_90a.
//
// Replaces two Pallas TPU kernels of go_pocket_tts_tpu/ops/pallas/seanet_tail.py:
//   up2_res       <- `fused_up2_res`:
//       y = up2(x)   (ConvTranspose1d 256->128, k=10, stride 5, right trim 5)
//       h = elu(y + conv2(elu(conv1(elu(y)))))   (res2: k3 128->64, k1 64->128)
//     x [B,256,T_in] -> h [B,128,5*T_in]
//   up2_up3_tail  <- `fused_up2_up3_tail`: h as above, then the up3 tail of
//     seanet_tail.cu (up3 128->64 k8 s4, res3, ELU, final k7 conv):
//     x [B,256,T_in] -> PCM [B,1,20*T_in]
// All convolutions are causal: positions before t = 0 are zeros.
//
// What bounds it on an H100: operations. up2 + res2 is ~49 kFLOP per PCM
// sample (up2 ~33 k, conv1 ~12 k, conv2 ~4 k at 1/4 of the PCM rate), the
// cascade ~99 kFLOP per sample, against one input byte per 10 (bf16)
// samples. The TPU kernels stayed in phase space and left the interleave
// to XLA ([B,128,T]x5 stacked and reshaped; the cascade phases-major); on
// v5e neither fit Mosaic's 16 MB scoped VMEM at their block sizes. Here:
//
//   up2_res: a block owns 8 input columns (40 output columns) and writes
//     them in time order. Stages, all float32 in shared memory:
//       U   y2 over 9 input columns (the 8 plus one to the left, for the
//           k3 causal conv's 2-sample halo), from a 10-column x tile: each
//           thread owns one output channel and 5 of the 9 columns (the two
//           halves of the block overlap by one); per input channel its 10
//           weights serve 25 outputs. A warp's 32 lanes are 32 consecutive
//           output channels: weights are stored output channel last, so
//           each load is one coalesced row, and every x read is a broadcast
//       R1  elu(res2.conv1) over the block's 40 columns
//       R2  h = elu(y2 + res2.conv2), in place over y2, then a coalesced
//           copy to the output
//   up2_up3_tail: a block owns 128 PCM samples, the block of
//     seanet_tail.cu's up3 tail, which needs the up2 output at 35 columns
//     [m0-3, m0+32). U, R1 and R2 produce exactly those into the up3 tile
//     (the first two stages' scratch shares the shared memory of the tail
//     stages, which start after), then the tail stages of seanet_tail.cuh
//     run unchanged. Neither the up2 nor the up3 output reaches HBM: the
//     only traffic is x in and PCM out.
//
// Streaming. The Pallas cascade's grid is a block decoder: each block reads
// a 5-column causal halo of x from the block before it and masks positions
// before t = 0 by absolute position. The cascade here takes that state as
// arguments: `halo [B,256,5]` holds the five x columns before x[..., 0] and
// `start [B]` the absolute column of x[..., 0]; every mask is taken at the
// absolute position, so a stream of blocks concatenates to the whole decode.
// A null halo and start are zeros: the TPU function exactly.
//
// This is plain SIMT float32 arithmetic, as seanet_tail.cu; the up2
// contraction on tensor cores is the next step.

#include "seanet_tail.cuh"

namespace {

using namespace seanet;

constexpr int kXin = 256;          // up2 input channels
constexpr int kC2 = 128;           // up2 output channels (= kCin of the up3 tail)
constexpr int kCr2 = 64;           // res2 hidden channels
constexpr int kCols = 9;           // input columns of y2 per block
constexpr int kY2 = 5 * kCols;     // y2 positions per block (row stride)
constexpr int kXt = kCols + 1;     // x tile columns: [a_lo-1, a_lo+kCols)
constexpr int kHalo = 5;           // causal halo of the streaming form
constexpr int kUpCols = 8;         // input columns per up2_res block
constexpr int kNp7 = 5 * kUpCols;  // up2_res output columns per block (40)
constexpr int kNp8 = 36;           // cascade: 35 up3 input columns, rounded to 4

// Floats of the up2 stage's shared memory for a window of np positions.
__host__ __device__ constexpr int up2_floats(int np) {
  return kXin * kXt + 2 * kC2 * kY2 + kCr2 * np;
}
constexpr size_t kSmemUp2 = sizeof(float) * up2_floats(kNp7);
static_assert(up2_floats(kNp8) <= 2 * kC * kNsP, "up2 scratch must fit below the tail's x tile");
constexpr size_t kSmemCascade = sizeof(float) * kSmemTailFloats;

template <typename T>
struct Up2Weights {
  const T* wu;  // [256, 10, 128]: the repacked up2 kernel [128, 256, 10], output channel last
  const T* bu;  // [128]
  const T* w1;  // [128, 3, 64]: res2.conv1 [64, 128, 3], output channel last
  const T* b1;  // [64]
  const T* w2;  // [64, 128]: res2.conv2 [128, 64, 1], transposed
  const T* b2;  // [128]
};

// x tile: xs2[i][c] = x[i][a_lo-1+c] (local column), from x for columns in
// [0, t_in), from the halo for columns in [-5, 0) whose absolute position
// (start + column) is >= 0, else zero. Ends with a barrier.
template <typename T>
__device__ void load_x_tile(const T* __restrict__ xb, const T* __restrict__ halo_b, int start,
                            int a_lo, int t_in, float* xs2) {
  for (int e = threadIdx.x; e < kXin * kXt; e += kThreads) {
    const int i = e / kXt, c = e % kXt;
    const int a = a_lo - 1 + c;
    float v = 0.f;
    if (a >= 0 && a < t_in) {
      v = to_f32(xb[(size_t)i * t_in + a]);
    } else if (a < 0 && a >= -kHalo && start + a >= 0 && halo_b != nullptr) {
      v = to_f32(halo_b[i * kHalo + kHalo + a]);
    }
    xs2[e] = v;
  }
  __syncthreads();
}

// Stages U, R1, R2 for one block: y2 at local positions [0, kY2) <->
// absolute u = u_abs0 + p (u_abs0 = 5 * absolute column of a_lo); then
// h = elu(y2 + res2(y2)) at local [p0, p0+NP) written to dst[o*dst_stride+p]
// for p < n_out, zero before absolute u = 0. p0 >= 2 (the conv1 halo).
// Every stage maps consecutive lanes of a warp to consecutive output
// channels, so each weight load is one coalesced row of the channel-minor
// layouts (see Up2Weights) and every shared-memory activation read is a
// broadcast.
template <typename T, int NP>
__device__ void up2_res_stage(const float* xs2, const Up2Weights<T>& w, float* y2s, float* e2s,
                              float* h1s, int u_abs0, int p0, float* dst, int dst_stride,
                              int n_out) {
  const int tid = threadIdx.x;

  // U: y2[o][5a+s] = bu[o] + sum_i wu[i][4-s][o] x[i][a-1] + wu[i][9-s][o] x[i][a]
  //    (phase s of u = 5a+s; wu is the flipped forward-conv kernel). Thread
  //    (o, half) computes columns [4*half, 4*half + 5) over all input
  //    channels; column 4 is computed by both halves and kept by half 0.
  {
    constexpr int kA = 5;
    const int o = tid & (kC2 - 1);
    const int half = tid >> 7;
    const int a0 = 4 * half;
    float acc[kA][5];
#pragma unroll
    for (int a = 0; a < kA; ++a)
#pragma unroll
      for (int s = 0; s < 5; ++s) acc[a][s] = 0.f;
    const T* wo = w.wu + o;
#pragma unroll 2
    for (int i = 0; i < kXin; ++i) {
      float wv[10];
#pragma unroll
      for (int k = 0; k < 10; ++k) wv[k] = to_f32(wo[(i * 10 + k) * kC2]);
      const float* xr = xs2 + i * kXt + a0;
      float prev = xr[0];
#pragma unroll
      for (int a = 0; a < kA; ++a) {
        const float cur = xr[a + 1];
#pragma unroll
        for (int s = 0; s < 5; ++s) acc[a][s] += wv[4 - s] * prev + wv[9 - s] * cur;
        prev = cur;
      }
    }
    const float bias = to_f32(w.bu[o]);
#pragma unroll
    for (int a = 0; a < kA; ++a) {
      if (half == 1 && a == 0) continue;
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        const int p = 5 * (a0 + a) + s;
        const float y = u_abs0 + p >= 0 ? acc[a][s] + bias : 0.f;
        y2s[o * kY2 + p] = y;
        e2s[o * kY2 + p] = elu(y);
      }
    }
  }
  __syncthreads();

  // R1: h1[c][p] = elu(b1[c] + sum_{i,d} w1[i][d][c] * elu(y2)[i][p0+p-2+d]);
  //     thread (c, quarter) owns NP/4 positions.
  {
    constexpr int kQ = NP / 4;
    const int c = tid & (kCr2 - 1);
    const int q0 = (tid >> 6) * kQ;
    float acc[kQ];
    const float bias = to_f32(w.b1[c]);
#pragma unroll
    for (int k = 0; k < kQ; ++k) acc[k] = bias;
    const T* wc = w.w1 + c;
#pragma unroll 2
    for (int i = 0; i < kC2; ++i) {
      const float a = to_f32(wc[(3 * i) * kCr2]), b = to_f32(wc[(3 * i + 1) * kCr2]),
                  d = to_f32(wc[(3 * i + 2) * kCr2]);
      const float* er = e2s + i * kY2 + p0 - 2 + q0;
      float ev[kQ + 2];
#pragma unroll
      for (int k = 0; k < kQ + 2; ++k) ev[k] = er[k];
#pragma unroll
      for (int k = 0; k < kQ; ++k) acc[k] += a * ev[k] + b * ev[k + 1] + d * ev[k + 2];
    }
#pragma unroll
    for (int k = 0; k < kQ; ++k) h1s[c * NP + q0 + k] = elu(acc[k]);
  }
  __syncthreads();

  // R2: h[o][p] = elu(y2[o][p0+p] + b2[o] + sum_c w2[c][o] h1[c][p]);
  //     thread (o, half) owns NP/2 positions.
  {
    constexpr int kH = NP / 2;
    const int o = tid & (kC2 - 1);
    const int q0 = (tid >> 7) * kH;
    float acc[kH];
    const float bias = to_f32(w.b2[o]);
#pragma unroll
    for (int k = 0; k < kH; ++k) acc[k] = bias;
#pragma unroll 4
    for (int c = 0; c < kCr2; ++c) {
      const float wv = to_f32(w.w2[c * kC2 + o]);
      const float* hr = h1s + c * NP + q0;
#pragma unroll
      for (int k = 0; k < kH; ++k) acc[k] += wv * hr[k];
    }
#pragma unroll
    for (int k = 0; k < kH; ++k) {
      const int p = q0 + k;
      if (p < n_out) {
        const float y = y2s[o * kY2 + p0 + p];
        dst[o * dst_stride + p] = u_abs0 + p0 + p >= 0 ? elu(y + acc[k]) : 0.f;
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ int floor_div5(int v) { return v >= 0 ? v / 5 : -((4 - v) / 5); }

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
up2_res_kernel(const T* __restrict__ x, Up2Weights<T> w, T* __restrict__ out, int t_in) {
  extern __shared__ float smem[];
  float* xs2 = smem;
  float* y2s = xs2 + kXin * kXt;
  float* e2s = y2s + kC2 * kY2;
  float* h1s = e2s + kC2 * kY2;
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kUpCols;
  const int a_lo = a0 - 1;
  const int t_u = 5 * t_in;

  load_x_tile<T>(x + (size_t)b * kXin * t_in, nullptr, 0, a_lo, t_in, xs2);
  // The block's 40 columns are local [5, 45); h is written over y2 there.
  up2_res_stage<T, kNp7>(xs2, w, y2s, e2s, h1s, 5 * a_lo, 5, y2s + 5, kY2, kNp7);

  T* ob = out + (size_t)b * kC2 * t_u + 5 * a0;
  for (int e = threadIdx.x; e < kC2 * kNp7; e += kThreads) {
    const int o = e / kNp7, p = e % kNp7;
    ob[(size_t)o * t_u + p] = from_f32<T>(y2s[o * kY2 + 5 + p]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
up2_up3_tail_kernel(const T* __restrict__ x, const T* __restrict__ halo,
                    const int* __restrict__ start, Up2Weights<T> w2,
                    const T* __restrict__ wu3, const T* __restrict__ bu3, TailWeights<T> w3,
                    T* __restrict__ out, int t_in) {
  extern __shared__ float smem[];
  float* ys = smem;
  float* hs = ys + kC * kNsP;
  float* xs = hs + kC * kNsP;  // the up3 tile [128][35]; then elu(res3.conv1)
  // The up2 stage's scratch lies under ys/hs, written only after it is done.
  float* xs2 = smem;
  float* y2s = xs2 + kXin * kXt;
  float* e2s = y2s + kC2 * kY2;
  float* h1s = e2s + kC2 * kY2;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTo;   // local PCM sample
  const int m0 = t0 / 4;             // local up3 input column (up2 output)
  const int st = start != nullptr ? start[b] : 0;
  // y2 is needed at [m0-5, m0+32): 9 input columns from a_lo.
  const int a_lo = floor_div5(m0 - 5);

  load_x_tile<T>(x + (size_t)b * kXin * t_in, halo != nullptr ? halo + (size_t)b * kXin * kHalo : nullptr,
                 st, a_lo, t_in, xs2);
  up2_res_stage<T, kNp8>(xs2, w2, y2s, e2s, h1s, 5 * (st + a_lo), (m0 - 3) - 5 * a_lo, xs, kXc, kXc);

  const int t_abs0 = 20 * st + t0;
  up3_stage<T>(xs, wu3, bu3, ys, hs, t_abs0);
  tail_stages<T>(w3, ys, hs, xs, t_abs0, out + (size_t)b * 20 * t_in + t0);
}

template <typename T>
Up2Weights<T> up2_weights(const void* wu, const void* bu, const void* w1, const void* b1,
                          const void* w2, const void* b2) {
  return Up2Weights<T>{static_cast<const T*>(wu), static_cast<const T*>(bu),
                       static_cast<const T*>(w1), static_cast<const T*>(b1),
                       static_cast<const T*>(w2), static_cast<const T*>(b2)};
}

template <typename T>
int launch_up2(const void* x, const void* wu, const void* bu, const void* w1, const void* b1,
               const void* w2, const void* b2, void* out, int B, int t_in, cudaStream_t stream) {
  if (t_in <= 0 || t_in % kUpCols != 0) return (int)cudaErrorInvalidValue;
  // Raised once per process, so launches stay legal inside a graph capture.
  static const cudaError_t attr = cudaFuncSetAttribute(
      up2_res_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemUp2);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(t_in / kUpCols, B);
  up2_res_kernel<T><<<grid, kThreads, kSmemUp2, stream>>>(
      static_cast<const T*>(x), up2_weights<T>(wu, bu, w1, b1, w2, b2), static_cast<T*>(out), t_in);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_cascade(const void* x, const void* halo, const void* start, const void* const* w,
                   void* out, int B, int t_in, cudaStream_t stream) {
  // 20 * t_in samples in blocks of 128.
  if (t_in <= 0 || t_in % 32 != 0) return (int)cudaErrorInvalidValue;
  static const cudaError_t attr = cudaFuncSetAttribute(
      up2_up3_tail_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemCascade);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid(20 * t_in / kTo, B);
  up2_up3_tail_kernel<T><<<grid, kThreads, kSmemCascade, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(halo), static_cast<const int*>(start),
      up2_weights<T>(w[0], w[1], w[2], w[3], w[4], w[5]), static_cast<const T*>(w[6]),
      static_cast<const T*>(w[7]), tail_weights<T>(w[8], w[9], w[10], w[11], w[12], w[13]),
      static_cast<T*>(out), t_in);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every float tensor in that type).
// Returns cudaGetLastError() after the launch (0 on success). Weights all
// contiguous, output channel last (the wrapper transposes the reference
// layouts): wu [256,10,128] (repacked [128,256,10]), w1 [128,3,64]
// ([64,128,3]), w2 [64,128] ([128,64,1]).
extern "C" int up2_res(int dtype, const void* x, const void* wu, const void* bu, const void* w1,
                       const void* b1, const void* w2, const void* b2, void* out, int B,
                       int t_in, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_up2<float>(x, wu, bu, w1, b1, w2, b2, out, B, t_in, s);
  if (dtype == 1) return launch_up2<__nv_bfloat16>(x, wu, bu, w1, b1, w2, b2, out, B, t_in, s);
  return (int)cudaErrorInvalidValue;
}

// The cascade. `halo` [B,256,5] (same dtype as x) and `start` [B] int32 may
// be null (zeros). Weights, in order: up2 wu,bu; res2 w1,b1,w2,b2 (the
// layouts of up2_res); up3 wu [64,128,8] repacked, bu; res3 w1 [32,64,3],
// b1, w2 [64,32,1], b2; final wf [1,64,7], bf.
extern "C" int up2_up3_tail(int dtype, const void* x, const void* halo, const void* start,
                            const void* wu2, const void* bu2, const void* w1r2,
                            const void* b1r2, const void* w2r2, const void* b2r2,
                            const void* wu3, const void* bu3, const void* w1r3,
                            const void* b1r3, const void* w2r3, const void* b2r3,
                            const void* wf, const void* bf, void* out, int B, int t_in,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const void* w[14] = {wu2, bu2, w1r2, b1r2, w2r2, b2r2, wu3, bu3, w1r3, b1r3, w2r3, b2r3, wf, bf};
  if (dtype == 0) return launch_cascade<float>(x, halo, start, w, out, B, t_in, s);
  if (dtype == 1) return launch_cascade<__nv_bfloat16>(x, halo, start, w, out, B, t_in, s);
  return (int)cudaErrorInvalidValue;
}
