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
// Here each block owns consecutive output samples, computes in time order,
// and recomputes its own causal halo, so blocks are independent and run in
// parallel. Two implementations:
//
//   bfloat16 seanet_up_tail (the serving dtype): tensor cores, tc:: below.
//     Every stage is an implicit GEMM on mma.sync (seanet_mma.cuh): up3 as
//     4 phase GEMMs whose B operand is the x tile read at two column
//     offsets, conv1 as 3 shifted reads of elu(y), conv2 as a plain GEMM,
//     the float32 intermediates entering as hi/lo bf16 pairs (so the result
//     is the float32-intermediate function), y kept in registers from up3
//     to the residual add, and the final k7 64->1 conv with the samples as
//     M. A block owns 38 input columns (152 samples) and recomputes the 2
//     before them, so its 5 n-tiles of 8 columns carry 5% of halo, and two
//     blocks share an SM, so one block's CUDA-core work (the x tile, ELUs,
//     hi/lo stores) overlaps the other's MMAs.
//   bfloat16 seanet_tail: the same kernel body with U replaced by a load
//     (y = x, exact in bf16): what bounds it is bytes (x at 64 channels and
//     the full 24 kHz rate, 128 bytes per output sample, against 17 kFLOP),
//     so its x tile comes in by 16-byte async copies, in flight with the
//     resident weights, and every other stage is the up3 tail's.
//   float32 (parity): SIMT float32, each
//     block 128 output samples (32 input columns for the up3 tail) with a
//     3-column halo; stage by stage, in shared memory (seanet_tail.cuh):
//       A  y, elu(y) over t in [t0-8, t0+128)   (up3: each thread owns one
//          output channel and one phase r of t = 4m + r, whose two taps
//          read input columns m-1 and m; every x read is a broadcast)
//       B  elu(conv1) over t in [t0-6, t0+128)  (x-tile buffer reused)
//       C  z = elu(y + conv2) over the same range, written over elu(y)
//       D  final conv, two threads per output sample
//     Its stages are also the tail of seanet_up2.cu's cascade.

#include "seanet_mma.cuh"
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

// ---- the up3 tail and the res3 tail on tensor cores (bfloat16) ------------
// Block: kN input columns [m0, m0+kN) -> 4*kN PCM samples, 8 warps, over a
// window of kNW = kN + 2 columns from m0-2 (5 n-tiles; seanet_mma::UpTail):
//   U   seanet_up_tail: y = up3(x), 4 phase GEMMs (M 64, K 2 taps x 128,
//       N window columns): warp w owns m-tile w%4 of phases 2*(w/4) and
//       2*(w/4)+1 over the whole window; its 40 accumulators hold y in
//       registers up to R2.
//       seanet_tail: y = x, read exact from a [64][4*kNW] tile of x (time
//       order, from t0-8) that 16-byte async copies bring in with the
//       resident weights; the same registers, channels and phases (a
//       "column" is 4 samples).
//   E, R1, R2, F  seanet_mma::up_tail_stages: elu(y) hi/lo planes, res3 on
//       tensor cores onto the y registers, z planes, the final k7 conv with
//       the samples as M.
namespace tc {

// Declarations, not a directive: seanet's kThreads and elu stay out of sight.
using seanet_mma::bf16;
using seanet_mma::kThreads;
using seanet_mma::ld_b;
using seanet_mma::ld_b_pair;
using seanet_mma::FragRing;
using seanet_mma::cp_async16;
using seanet_mma::cp_async_commit;
using seanet_mma::ring_drain;
using seanet_mma::load_x_tile;
using seanet_mma::mma_frag;

constexpr int kNWT = 5;               // window n-tiles
using G = seanet_mma::UpTail<kNWT>;
constexpr int kN = G::kN;             // input columns per block (38)
constexpr int kXs = kCin + 8;         // x tile row stride (bf16)
constexpr int kXCols = G::kNW + 8;    // x tile columns: from m0-3 rounded down to 8
constexpr int kXRows = 1 + kXCols;    // zero row, then the x columns
constexpr int kYs = 4 * G::kNW + 8;   // seanet_tail: y tile row stride (samples)
constexpr int kKsU = 2 * kCin / 16;   // U k-steps
constexpr int kDepthU = 4;            // U k-steps per warp's ring (2 fragments each)
constexpr int kRing = kDepthU * 2 * 512;  // ring bytes per warp, under elu(y) during U
constexpr size_t kSmemAct = sizeof(bf16) * (G::kRegionE + G::kRegionH);
// Resident for the block's life, after the activations: res3's and the
// final conv's fragments, 17 KB.
constexpr size_t kSmem = kSmemAct + sizeof(uint4) * G::kW;
static_assert(8 * kRing <= G::kRegionE * (int)sizeof(bf16), "U's rings lie under elu(y)");
static_assert(kXRows * kXs <= G::kRegionH, "the x tile lies under h1");
static_assert(kC * kYs <= G::kRegionH, "the y tile lies under h1");

// Prepared weights (kernels/seanet_tail.py): A fragments [M/16][K/16][32
// lanes] of wu [4 phases][64][2*128] (K = tap*128 + i), w1 [32][3*64]
// (K = d*64 + i), w2 [64][32]; wf as B fragments [64/16][32 lanes] of a
// [64][8] matrix whose column d is tap d (K = o); biases as they are.
// kUp false (seanet_tail): x [B][64][4*t_in], no wu and bu.
template <bool kUp>
__global__ void __launch_bounds__(kThreads, 2)
up_tail_mma_kernel(const bf16* __restrict__ x, const uint4* __restrict__ wuf,
                   const bf16* __restrict__ bu, const uint4* __restrict__ w1f,
                   const bf16* __restrict__ b1, const uint4* __restrict__ w2f,
                   const bf16* __restrict__ b2, const bf16* __restrict__ wf,
                   const bf16* __restrict__ bf, bf16* __restrict__ out, int t_in) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* region_e = reinterpret_cast<bf16*>(smem_raw);
  bf16* region_h = region_e + G::kRegionE;
  bf16* xs = region_h;  // during U
  uint4* ws = reinterpret_cast<uint4*>(smem_raw + kSmemAct);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kN;
  const int mt = warp & 3, r0 = 2 * (warp >> 2);

  // The resident weights, then U's, are in flight first of all, while the
  // x tile loads.
  seanet_mma::up_tail_weights<kNWT>(ws, w1f, w2f, wf);
  float acc[2][kNWT][4];
  if constexpr (kUp) {
    cp_async_commit();
    uint4* ring = reinterpret_cast<uint4*>(smem_raw + warp * kRing) + lane;
    constexpr int kPhase = (kC / 16) * kKsU * 32;
    const FragRing<2, kDepthU> wru{ring, wuf + (r0 * (kC / 16) + mt) * kKsU * 32 + lane, 32, kPhase, kKsU};
    wru.start();
    // Window column cw is input column m0 - 2 + cw. The x tile holds
    // columns from c0 = m0 - 3 rounded down to 8 (16-byte loads), in rows
    // from 1; tap 0 of window column cw (column m - 1) is row xoff + cw,
    // tap 1 row xoff + cw + 1.
    const int c0 = (m0 - G::kHaloC - 1) & ~7;
    const int xoff = m0 - G::kHaloC - c0;
    load_x_tile<kCin, kXCols, kXs>(x + (size_t)b * kCin * t_in, t_in, c0, xs);
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < kNWT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < kKsU; ++ks) {
      uint4 af[2];
      wru.get(ks, af);
      const int tap = ks / (kCin / 16), k0 = (ks % (kCin / 16)) * 16;
      uint32_t bt[kNWT][2];
#pragma unroll
      for (int j = 0; j + 1 < kNWT; j += 2) {
        uint32_t r[4];
        ld_b_pair<kXs>(r, xs, 8 * j + xoff + tap, k0);
        bt[j][0] = r[0];
        bt[j][1] = r[1];
        bt[j + 1][0] = r[2];
        bt[j + 1][1] = r[3];
      }
      if (kNWT % 2) ld_b<kXs>(bt[kNWT - 1], xs, 8 * (kNWT - 1) + xoff + tap, k0);
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int j = 0; j < kNWT; ++j) mma_frag(acc[p][j], af[p], bt[j][0], bt[j][1]);
    }
    ring_drain();  // and the resident weights
  } else {
    // y at samples [t0-8, t0-8 + 4*kNW), t0 = 4*m0: x row i holds sample
    // t0-8+s at xs[i*kYs + s]; 8-sample groups wholly inside or outside
    // [0, 4*t_in) (t0 and 4*t_in are multiples of 8).
    const int s0 = 4 * (m0 - G::kHaloC), t_len = 4 * t_in;
    const bf16* xb = x + (size_t)b * kC * t_len;
    constexpr int kVecs = 4 * G::kNW / 8;
    for (int e = threadIdx.x; e < kC * kVecs; e += kThreads) {
      const int i = e / kVecs, v = e % kVecs;
      const int s = s0 + 8 * v;
      if (s >= 0 && s < t_len)
        cp_async16(xs + i * kYs + 8 * v, xb + (size_t)i * t_len + s);
      else
        *reinterpret_cast<uint4*>(xs + i * kYs + 8 * v) = make_uint4(0u, 0u, 0u, 0u);
    }
    cp_async_commit();
    ring_drain();
    __syncthreads();
    const bf16* y_lo = xs + (16 * mt + g) * kYs;
    const bf16* y_hi = y_lo + 8 * kYs;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < kNWT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int s = 4 * (8 * j + 2 * t + e) + r0 + p;
          acc[p][j][e] = __bfloat162float(y_lo[s]);
          acc[p][j][2 + e] = __bfloat162float(y_hi[s]);
        }
  }
  __syncthreads();  // every warp is done with its ring (or the y tile), which E overwrites
  seanet_mma::up_tail_stages<kNWT>(acc, region_e, region_h, ws, kUp ? bu : nullptr, b1, b2, bf,
                                   m0 - G::kHaloC, 4 * m0, 4 * t_in, out + (size_t)b * 4 * t_in);
}

// seanet_up_tail (kUp) on x [B,128,t_in], or seanet_tail on x [B,64,4*t_in].
template <bool kUp>
int launch(const void* x, const void* wu, const void* bu, const void* w1, const void* b1,
           const void* w2, const void* b2, const void* wf, const void* bf, void* out, int B,
           int t_in, cudaStream_t stream) {
  // Raised once per process, so launches stay legal inside a graph capture.
  static const cudaError_t attr = cudaFuncSetAttribute(
      up_tail_mma_kernel<kUp>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((t_in + kN - 1) / kN, B);
  up_tail_mma_kernel<kUp><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint4*>(wu), static_cast<const bf16*>(bu),
      static_cast<const uint4*>(w1), static_cast<const bf16*>(b1), static_cast<const uint4*>(w2),
      static_cast<const bf16*>(b2), static_cast<const bf16*>(wf), static_cast<const bf16*>(bf),
      static_cast<bf16*>(out), t_in);
  return (int)cudaGetLastError();
}

}  // namespace tc

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
// cudaGetLastError() after the launch (0 on success). All tensors
// contiguous; t_in a multiple of 32 (seanet_tail: t a multiple of 128).
// Weights:
//   float32: the reference layouts, wu [64,128,8] repacked, w1 [32,64,3],
//     w2 [64,32,1], wf [1,64,7];
//   bfloat16: wu, w1 and w2 as A fragments and wf as B fragments (see
//     tc::up_tail_mma_kernel; kernels/seanet_tail.py prepares them), wu
//     [4,4,16,32,8], w1 [2,12,32,8], w2 [4,2,32,8], wf [4,32,4]; the
//     biases as they are.
extern "C" int seanet_up_tail(int dtype, const void* x, const void* wu, const void* bu,
                              const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* wf, const void* bf, void* out,
                              int B, int t_in, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_in <= 0 || t_in % kTb != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_up<float>(x, wu, bu, w1, b1, w2, b2, wf, bf, out, B, t_in, s);
  if (dtype == 1) return tc::launch<true>(x, wu, bu, w1, b1, w2, b2, wf, bf, out, B, t_in, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int seanet_tail(int dtype, const void* x, const void* w1, const void* b1,
                           const void* w2, const void* b2, const void* wf, const void* bf,
                           void* out, int B, int t, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_tail<float>(x, w1, b1, w2, b2, wf, bf, out, B, t, s);
  if (dtype == 1) {
    if (t <= 0 || t % kTo != 0) return (int)cudaErrorInvalidValue;
    return tc::launch<false>(x, nullptr, nullptr, w1, b1, w2, b2, wf, bf, out, B, t / 4, s);
  }
  return (int)cudaErrorInvalidValue;
}
