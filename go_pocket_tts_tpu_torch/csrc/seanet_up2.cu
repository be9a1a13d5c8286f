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
//   up2_res in bfloat16 (the serving dtype): tensor cores, tc:: below. The
//     SIMT form's block of 8 input columns read all 704 KB of up2/res2
//     weights per block (1.35 GB from L2 per 160 frames) in 2-byte scalar
//     loads inside the FMA loop. Here a block owns 32 input columns and
//     every stage is an implicit GEMM on mma.sync (seanet_mma.cuh): up2 as
//     5 phase GEMMs on the x tile read at two column offsets, res2.conv1
//     as 3 shifted reads of elu(y2), res2.conv2 as a plain GEMM; float32
//     intermediates enter as hi/lo bf16 pairs, y2 stays in registers from
//     up2 to the residual add, and each warp streams its own rows of the
//     prepared weights through a cp.async ring, once per block (0.34 GB
//     from L2 per 160 frames).
//   up2_res in float32 (parity): a block owns 8 input columns (40 output
//     columns) and writes them in time order. Stages, all float32 in
//     shared memory:
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
//   up2_up3_tail in float32: a block owns 128 PCM samples, the block of
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
// The cascade in bfloat16 (the serving dtype) runs on tensor cores,
// tc::cascade_mma_kernel below: kernel 7's up2 + res2 stages and kernel 2's
// up3 tail stages (seanet_mma.cuh) in one block, handing h over in shared
// memory as a hi/lo pair, so no stage rounds; every mask is taken at the
// absolute position. In float32 (parity) it is the SIMT form above.

#include "seanet_mma.cuh"
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

// ---- up2_res on tensor cores (bfloat16) -----------------------------------
// Block: kN input columns [a0, a0+kN) -> 5*kN output columns, 8 warps.
//   U   y2 = up2(x), the 5 phase GEMMs (M 128, K 2 taps x 256, N columns):
//       warp w owns output channels [16w, 16w+16) of every phase over the
//       block's columns, plus phases 3 and 4 of column a0-1 (the k3 conv's
//       2-sample halo) from a halo n-tile; its 88 accumulators hold y2 in
//       registers up to R2. elu(y2) goes to shared memory as hi/lo planes.
//   R1  h1 = elu(res2.conv1(elu(y2))) (M 64, K 3 shifts x 128, N 5*kN):
//       warp w owns m-tile w%4 and half of the n-tiles; n-tiles run over
//       (phase, 8 columns), so a shift by one position moves to the phase
//       plane before (and one column back from phase 0).
//   R2  h = elu(y2 + res2.conv2(h1)) (M 128, K 64), accumulated onto the
//       y2 registers: warp w again owns channels [16w, 16w+16). Staged in
//       shared memory in time order and stored with 16-byte writes.
namespace tc {

// Declarations, not a directive: seanet's kThreads and elu stay out of sight.
using seanet_mma::bf16;
using seanet_mma::elu;
using seanet_mma::kThreads;
using seanet_mma::ld_b;
using seanet_mma::hi_lo_lane;
using seanet_mma::ldmatrix_x4;
using seanet_mma::ld_b_pair;
using seanet_mma::FragRing;
using seanet_mma::cp_async16;
using seanet_mma::cp_async_commit;
using seanet_mma::ring_drain;
using seanet_mma::load_x_tile;
using seanet_mma::mma_frag;
using seanet_mma::store_hi_lo_pair;

constexpr int kN = 32;                 // input columns per block
constexpr int kNT = kN / 8;            // their n-tiles
constexpr int kXs = kXin + 8;          // x tile row stride (bf16)
constexpr int kXRows = 1 + 8 + kN;     // zero row, halo n-tile, the block's columns
constexpr int kEs = kC2 + 8;           // elu(y2) row stride
constexpr int kERows = 1 + kN;         // per phase plane: column a0-1, then the block's
constexpr int kEPlane = 5 * kERows * kEs;
constexpr int kHs = kCr2 + 8;          // h1 row stride
constexpr int kHRows = 5 * kN;         // h1 rows, phase-major: 32*s + column
constexpr int kOs = 5 * kN + 8;        // staged output row stride
constexpr int kKsU = 2 * kXin / 16;    // U k-steps
constexpr int kKs1 = 3 * kC2 / 16;     // R1 k-steps
constexpr int kKs2 = kCr2 / 16;        // R2 k-steps
constexpr int kDepthU = 4;            // U k-steps per warp's ring (5 fragments each)
constexpr int kRing = kDepthU * 5 * 512;  // ring bytes per warp, under elu(y2) during U
constexpr size_t kSmemAct = sizeof(bf16) * (2 * kEPlane + 2 * kHRows * kHs);
// Resident for the block's life, after the activations: res2's A fragments
// (w1, w2), 64 KB.
constexpr int kW1 = (kCr2 / 16) * kKs1 * 32, kW2 = (kC2 / 16) * kKs2 * 32;  // uint4
constexpr size_t kSmem = kSmemAct + sizeof(uint4) * (kW1 + kW2);
static_assert(8 * kRing <= 2 * kEPlane * (int)sizeof(bf16), "U's rings lie under elu(y2)");
static_assert(kXRows * kXs <= 2 * kHRows * kHs, "the x tile lies under h1");
static_assert(kC2 * kOs <= 2 * kEPlane, "the staged output lies under elu(y2)");

// Prepared weights (kernels/seanet_tail.py): fragments [M/16][K/16][32 lanes]
// of wu [5 phases][128][2*256] (K = tap*256 + i), w1 [64][3*128]
// (K = d*128 + i), w2 [128][64].
__global__ void __launch_bounds__(kThreads, 1)
up2_res_mma_kernel(const bf16* __restrict__ x, const uint4* __restrict__ wuf,
                   const bf16* __restrict__ bu, const uint4* __restrict__ w1f,
                   const bf16* __restrict__ b1, const uint4* __restrict__ w2f,
                   const bf16* __restrict__ b2, bf16* __restrict__ out, int t_in) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* e2h = reinterpret_cast<bf16*>(smem_raw);
  bf16* e2l = e2h + kEPlane;
  bf16* h1h = e2l + kEPlane;
  bf16* h1l = h1h + kHRows * kHs;
  bf16* xs = h1h;  // during U
  bf16* os = e2h;  // after R1
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint4* ring = reinterpret_cast<uint4*>(smem_raw + warp * kRing) + lane;  // U only
  uint4* w1s = reinterpret_cast<uint4*>(smem_raw + kSmemAct);
  uint4* w2s = w1s + kW1;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kN;

  // The resident weights, then U's, are in flight first of all, while the
  // x tile loads.
  for (int i = threadIdx.x; i < kW1 + kW2; i += kThreads) cp_async16(w1s + i, i < kW1 ? w1f + i : w2f + (i - kW1));
  cp_async_commit();
  constexpr int kPhase = (kC2 / 16) * kKsU * 32;
  const FragRing<5, kDepthU> wru{ring, wuf + warp * kKsU * 32 + lane, 32, kPhase, kKsU};
  wru.start();
  // x at columns [a0-8, a0+kN): row 8*jw + n + 1 holds column a0-8+8*jw+n.
  load_x_tile<kXin, 8 + kN, kXs>(x + (size_t)b * kXin * t_in, t_in, a0 - 8, xs);

  // U. n-tile jw = 0 is the halo (columns a0-8 .. a0-1), jw = j+1 the
  // block's j-th; tap 0 reads column m-1, row 8*jw + n.
  float acc[5][kNT][4];
  float hacc[2][4];
#pragma unroll
  for (int s = 0; s < 5; ++s)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < 2; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) hacc[s][e] = 0.f;
  {
#pragma unroll 1
    for (int ks = 0; ks < kKsU; ++ks) {
      uint4 af[5];
      wru.get(ks, af);
      const int tap = ks / (kXin / 16), k0 = (ks % (kXin / 16)) * 16;
      uint32_t bt[kNT + 1][2];
#pragma unroll
      for (int j = 0; j < kNT; j += 2) {
        uint32_t r[4];
        ld_b_pair<kXs>(r, xs, 8 * (j + 1) + tap, k0);
        bt[j + 1][0] = r[0];
        bt[j + 1][1] = r[1];
        bt[j + 2][0] = r[2];
        bt[j + 2][1] = r[3];
      }
      ld_b<kXs>(bt[0], xs, tap, k0);
#pragma unroll
      for (int s = 0; s < 5; ++s)
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_frag(acc[s][j], af[s], bt[j + 1][0], bt[j + 1][1]);
      mma_frag(hacc[0], af[3], bt[0][0], bt[0][1]);
      mma_frag(hacc[1], af[4], bt[0][0], bt[0][1]);
    }
    ring_drain();  // and the resident weights
  }
  __syncthreads();  // every warp is done with its ring, which elu(y2) overwrites
  // y2 = acc + bu (every column of the block is at u >= 0); elu(y2) as hi/lo
  // planes [phase][row][channel], row 1 + column - a0.
  const int o_lo = 16 * warp + g, o_hi = o_lo + 8;
  {
    const float bl = __bfloat162float(bu[o_lo]), bh = __bfloat162float(bu[o_hi]);
#pragma unroll
    for (int s = 0; s < 5; ++s)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          acc[s][j][e] += bl;
          acc[s][j][2 + e] += bh;
          const int row = (s * kERows + 1 + 8 * j + 2 * t + e) * kEs;
          store_hi_lo_pair(e2h, e2l, row + 16 * warp + 2 * g, elu(acc[s][j][e]), elu(acc[s][j][2 + e]));
        }
    // Column a0-1 is n = 7 of the halo tile (lanes t = 3, c1 and c3); zero
    // before u = 0.
    if (t == 3) {
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float vl = a0 > 0 ? hacc[s][1] + bl : 0.f, vh = a0 > 0 ? hacc[s][3] + bh : 0.f;
        const int row = (3 + s) * kERows * kEs;
        store_hi_lo_pair(e2h, e2l, row + 16 * warp + 2 * g, elu(vl), elu(vh));
      }
    }
  }
  __syncthreads();

  // R1. n-tile q = 4*s + j: phase s, columns a0+8j ..; position u - 2 + d
  // is phase s+d-2 of the same column, or (below 0) phase s+d+3 of the one
  // before.
  {
    const int mt = warp & 3, nh = warp >> 2;
    constexpr int kQ = 5 * kNT / 2;
    float acc1[kQ][4];
#pragma unroll
    for (int q = 0; q < kQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[q][e] = 0.f;
    const uint4* wa = w1s + mt * kKs1 * 32 + lane;
    const bf16* e2 = hi_lo_lane(e2h, e2l);
#pragma unroll 1
    for (int d = 0; d < 3; ++d) {
      int off[kQ];  // this lane's row of each n-tile at shift d
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int tile = nh * kQ + q;
        const int s = tile / kNT, j = tile % kNT;
        int sp = s + d - 2, row = 1 + 8 * j + (lane & 7);
        if (sp < 0) {
          sp += 5;
          row -= 1;
        }
        off[q] = (sp * kERows + row) * kEs;
      }
#pragma unroll 1
      for (int kk = 0; kk < kC2 / 16; ++kk) {
        const uint4 af = wa[(d * (kC2 / 16) + kk) * 32];
        uint32_t bb[kQ][4];
#pragma unroll
        for (int q = 0; q < kQ; ++q) ldmatrix_x4(bb[q], e2 + off[q] + 16 * kk);
#pragma unroll
        for (int q = 0; q < kQ; ++q) mma_frag(acc1[q], af, bb[q][0], bb[q][1]);  // hi
#pragma unroll
        for (int q = 0; q < kQ; ++q) mma_frag(acc1[q], af, bb[q][2], bb[q][3]);  // lo
      }
    }
    const int c_lo = 16 * mt + g, c_hi = c_lo + 8;
    const float bl = __bfloat162float(b1[c_lo]), bh = __bfloat162float(b1[c_hi]);
#pragma unroll
    for (int q = 0; q < kQ; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = ((nh * kQ + q) * 8 + 2 * t + e) * kHs;
        store_hi_lo_pair(h1h, h1l, row + 16 * mt + 2 * g, elu(acc1[q][e] + bl), elu(acc1[q][2 + e] + bh));
      }
  }
  __syncthreads();

  // R2 onto the y2 registers, then h = elu(.) staged in time order.
  {
    const float bl = __bfloat162float(b2[o_lo]), bh = __bfloat162float(b2[o_hi]);
    const bf16* h1 = hi_lo_lane(h1h, h1l);
#pragma unroll
    for (int ks = 0; ks < kKs2; ++ks) {
      const uint4 af = w2s[(warp * kKs2 + ks) * 32 + lane];
#pragma unroll
      for (int s = 0; s < 5; ++s) {
        uint32_t bb[kNT][4];
#pragma unroll
        for (int j = 0; j < kNT; ++j) ldmatrix_x4(bb[j], h1 + ((s * kNT + j) * 8 + (lane & 7)) * kHs + ks * 16);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_frag(acc[s][j], af, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < kNT; ++j) mma_frag(acc[s][j], af, bb[j][2], bb[j][3]);
      }
    }
#pragma unroll
    for (int s = 0; s < 5; ++s)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int p = 5 * (8 * j + 2 * t + e) + s;
          os[o_lo * kOs + p] = __float2bfloat16(elu(acc[s][j][e] + bl));
          os[o_hi * kOs + p] = __float2bfloat16(elu(acc[s][j][2 + e] + bh));
        }
  }
  __syncthreads();

  // The block's 5 * (valid columns) outputs per channel, 16 bytes a store.
  const int t_u = 5 * t_in;
  const int n_vec = 5 * min(kN, t_in - a0) / 8;
  bf16* ob = out + (size_t)b * kC2 * t_u + 5 * a0;
  for (int e = threadIdx.x; e < kC2 * (5 * kN / 8); e += kThreads) {
    const int o = e / (5 * kN / 8), v = e % (5 * kN / 8);
    if (v < n_vec)
      *reinterpret_cast<uint4*>(ob + (size_t)o * t_u + 8 * v) = *reinterpret_cast<const uint4*>(os + o * kOs + 8 * v);
  }
}

int launch(const void* x, const void* wu, const void* bu, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, int B, int t_in, cudaStream_t stream) {
  // Raised once per process, so launches stay legal inside a graph capture.
  static const cudaError_t attr = cudaFuncSetAttribute(
      up2_res_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((t_in + kN - 1) / kN, B);
  up2_res_mma_kernel<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const uint4*>(wu), static_cast<const bf16*>(bu),
      static_cast<const uint4*>(w1), static_cast<const bf16*>(b1), static_cast<const uint4*>(w2),
      static_cast<const bf16*>(b2), static_cast<bf16*>(out), t_in);
  return (int)cudaGetLastError();
}

// ---- the whole cascade on tensor cores (bfloat16) --------------------------
// Block: kA = 14 input columns [a0, a0+kA) -> 5*kA = 70 up3-input columns
// [m0, m0+70), m0 = 5*a0 -> 280 PCM samples from t0 = 4*m0, 8 warps, in two
// stages that hand over in shared memory:
//   A (kernel 7's stages) over a y2 window of kAW = 16 input columns from
//     a0-2 (2 n-tiles): the block needs h at [m0-3, m0+70), which reads y2
//     from m0-5, all of column a0-1; column a0-2 fills the n-tile.
//     U   y2 = up2(x), 5 phase GEMMs (M 128, K 2 taps x 256): warp w owns
//         channels [16w, 16w+16) of every phase over the window; its 40
//         accumulators hold y2 up to R2. x comes from a tile with the
//         stream's causal state (seanet_mma::load_x_tile's halo rule).
//     E   y2 += bias, zero before absolute u = 0; elu(y2) as hi/lo planes.
//     R1  elu(res2.conv1(elu(y2))) (M 64, K 3 shifts x 128, N 10 n-tiles).
//     R2  h = elu(y2 + res2.conv2(.)), zero before u = 0, as hi/lo planes
//         [position][channel]: row r holds h at m0-3+r, float32 carried to
//         ~2^-17 as for every intermediate (no rounding between stages).
//   B (kernel 2's stages) over an up3 window of 72 columns from m0-2 (9
//     n-tiles; seanet_mma::UpTail<9>):
//     U   y3 = up3(h), 4 phase GEMMs (M 64, K 2 taps x 128) on the h planes:
//         h is float32, so each fragment is two MMAs (hi, lo) against the
//         same weight; the up3 weights' K is interleaved as h's channels
//         are ("up3_mma_il").
//     E, R1, R2, F  seanet_mma::up_tail_stages, masked at absolute samples.
// Why 14 columns. One latent frame is 96 x columns; the stream's blocks are
// 4, 8 and 16 frames (384, 768, 1536 columns at B = 1) and the first block
// is the stream's first audio. A block here reads all 0.87 MB of bf16
// weights from L2 once (up2's through a per-warp cp.async ring, res2's and
// res3's resident, up3's through a second ring), so narrower blocks cost L2
// traffic and wider ones wave fill: 14 columns give 28, 55 and 110 blocks
// (one wave of 132 SMs) for the stream's blocks, ~0.9 GB of L2 reads per
// 160 frames, and stage B's 9 n-tiles keep its halo at 2 of 72 columns.
// With kA = 8j - 2, A's window is exactly j n-tiles and B's 5j - 1; j = 2
// is the largest whose B accumulators (2 phases x 9 n-tiles) and hi/lo B
// fragments fit the registers.
// Shared memory (bytes, ~208 KB, one block an SM), over time:
//   [0, E3)        A: x tile, then elu(y2) and h1; then the h planes.
//                  B: its ring over A's h1 during U; elu(y3), then z.
//   [E3, +H3)      A: part of U's rings. B: h1 of res3, then F's partials.
//   [.., +17 KB)   res3 and final-conv weights, resident from the start.
//   [.., +64 KB)   res2 weights, resident from the start.
// A's rings run from the end of the x tile over everything up to the
// resident weights.
constexpr int kA = 14;                  // input columns per block
constexpr int kAW = kA + 2;             // y2 window columns, from a0-2
constexpr int kAWT = kAW / 8;           // y2 window n-tiles
using GB = seanet_mma::UpTail<(5 * kA + 2) / 8>;  // stage B: 9 n-tiles
constexpr int kNWT8 = GB::kNW / 8;
static_assert(GB::kN == 5 * kA && kAW % 8 == 0, "A's window is whole n-tiles, B owns A's h columns");
constexpr int kXCols8 = (kA + 3 + 7 + 7) / 8 * 8;  // x columns from (a0-3) rounded down to 8, to a0+kA-1
constexpr int kE2Rows = 1 + kAW;        // elu(y2) rows per phase plane: zero row, then the window
constexpr int kE2Plane = 5 * kE2Rows * kEs;
constexpr int kH2Rows = 5 * kAW;        // res2's h1 rows, phase-major
constexpr int kHts = kC2 + 8;           // h planes' row stride
constexpr int kHtRows = GB::kNW + 1;    // h at [m0-3, m0+kA*5)
constexpr int kKsU3 = 2 * kC2 / 16;     // stage B's U k-steps
constexpr int kDepthA = 5, kDepthB = 4;  // k-steps per warp's ring
constexpr int kRingA = kDepthA * 5 * 512, kRingB = kDepthB * 2 * 512;  // bytes per warp
// Byte offsets.
constexpr int kOffE3 = 0;
constexpr int kBytesE3 = (int)sizeof(bf16) * GB::kRegionE;
constexpr int kOffH3 = kOffE3 + kBytesE3;
constexpr int kOffW3 = kOffH3 + (int)sizeof(bf16) * GB::kRegionH;
constexpr int kOffW2 = kOffW3 + (int)sizeof(uint4) * GB::kW;
constexpr size_t kSmem8 = kOffW2 + sizeof(uint4) * (kW1 + kW2);
constexpr int kBytesX = (int)sizeof(bf16) * (1 + kXCols8) * kXs;
constexpr int kOffRingA = (kBytesX + 15) / 16 * 16;
constexpr int kBytesE2 = (int)sizeof(bf16) * 2 * kE2Plane;
constexpr int kOffH2 = kBytesE2;
constexpr int kBytesHt = (int)sizeof(bf16) * 2 * kHtRows * kHts;
constexpr int kOffRingB = kOffH2;
static_assert(kOffRingA + 8 * kRingA <= kOffW3, "A's rings end before the resident weights");
static_assert(kBytesE2 + (int)sizeof(bf16) * 2 * kH2Rows * kHs <= kOffW3, "elu(y2) and res2's h1 before the weights");
static_assert(kBytesHt <= kBytesE2, "the h planes lie under elu(y2)");
static_assert(kOffRingB + 8 * kRingB <= kOffW3 && kOffRingB >= kBytesHt, "B's rings lie beside the h planes");
static_assert(kSmem8 <= 232448, "one block an SM");

// Prepared weights (kernels/seanet_tail.py): up2 and res2 as kernel 7's
// (wu2 [5][8][32][32], w1 [4][24][32], w2 [8][4][32] fragments), up3 as
// [4 phases][4][16][32] fragments of [64][2*128] with K interleaved
// (K = tap*128 + i), res3 and the final conv as kernel 2's.
__global__ void __launch_bounds__(kThreads, 1)
cascade_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ halo, const int* __restrict__ start,
                   const uint4* __restrict__ wu2f, const bf16* __restrict__ bu2, const uint4* __restrict__ w1r2f,
                   const bf16* __restrict__ b1r2, const uint4* __restrict__ w2r2f, const bf16* __restrict__ b2r2,
                   const uint4* __restrict__ wu3f, const bf16* __restrict__ bu3, const uint4* __restrict__ w1r3f,
                   const bf16* __restrict__ b1r3, const uint4* __restrict__ w2r3f, const bf16* __restrict__ b2r3,
                   const bf16* __restrict__ wf, const bf16* __restrict__ bf, bf16* __restrict__ out, int t_in) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);                      // A's U
  bf16* e2h = reinterpret_cast<bf16*>(smem_raw);                     // A's E, R1
  bf16* e2l = e2h + kE2Plane;
  bf16* h2h = reinterpret_cast<bf16*>(smem_raw + kOffH2);            // A's R1, R2
  bf16* h2l = h2h + kH2Rows * kHs;
  bf16* hth = reinterpret_cast<bf16*>(smem_raw);                     // A's R2 -> B's U
  bf16* htl = hth + kHtRows * kHts;
  uint4* w3s = reinterpret_cast<uint4*>(smem_raw + kOffW3);
  uint4* w1s = reinterpret_cast<uint4*>(smem_raw + kOffW2);
  uint4* w2s = w1s + kW1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int a0 = blockIdx.x * kA;
  const int m0 = 5 * a0;
  const int st = start != nullptr ? start[b] : 0;
  const int a_abs_w = st + a0 - 2;  // absolute input column of y2 window column 0

  {
    // The x tile first, then A's ring, then every resident weight (a copy
    // group committed after the ring's first k-steps, so that it need only
    // have landed by k-step kDepthA - 2; res2's are read from R1 on): in
    // that order the tile's loads do not queue behind 160 KB of weights.
    // y2 window column wc is input column a0-2+wc; tap 0 reads column
    // a0-3+wc, at row xoff + wc of the tile (columns from c0 in rows from 1).
    const int c0 = (a0 - 3) & ~7;
    const int xoff = a0 - 2 - c0;
    load_x_tile<kXin, kXCols8, kXs>(x + (size_t)b * kXin * t_in, t_in, c0, xs,
                                    halo != nullptr ? halo + (size_t)b * kXin * kHalo : nullptr, st);
    constexpr int kPhase = (kC2 / 16) * kKsU * 32;
    uint4* ring = reinterpret_cast<uint4*>(smem_raw + kOffRingA + warp * kRingA) + lane;
    const FragRing<5, kDepthA> wra{ring, wu2f + warp * kKsU * 32 + lane, 32, kPhase, kKsU};
    wra.start();
    for (int i = threadIdx.x; i < kW1 + kW2; i += kThreads) cp_async16(w1s + i, i < kW1 ? w1r2f + i : w2r2f + (i - kW1));
    seanet_mma::up_tail_weights<kNWT8>(w3s, w1r3f, w2r3f, wf);
    cp_async_commit();

    // A: U.
    float acc[5][kAWT][4];
#pragma unroll
    for (int s = 0; s < 5; ++s)
#pragma unroll
      for (int j = 0; j < kAWT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;
#pragma unroll 1
    for (int ks = 0; ks < kKsU; ++ks) {
      uint4 af[5];
      wra.get(ks, af);
      const int tap = ks / (kXin / 16), k0 = (ks % (kXin / 16)) * 16;
      uint32_t bt[kAWT][2];
#pragma unroll
      for (int j = 0; j < kAWT; j += 2) {
        uint32_t r[4];
        ld_b_pair<kXs>(r, xs, 8 * j + xoff + tap, k0);
        bt[j][0] = r[0];
        bt[j][1] = r[1];
        bt[j + 1][0] = r[2];
        bt[j + 1][1] = r[3];
      }
#pragma unroll
      for (int s = 0; s < 5; ++s)
#pragma unroll
        for (int j = 0; j < kAWT; ++j) mma_frag(acc[s][j], af[s], bt[j][0], bt[j][1]);
    }
    ring_drain();  // and the resident weights
    __syncthreads();  // every warp is done with its ring and the x tile, which elu(y2) overwrites

    // A: E. y2 = acc + bu, zero before absolute u = 0 (a negative column).
    const int o_lo = 16 * warp + g, o_hi = o_lo + 8;
    {
      const float bl = __bfloat162float(bu2[o_lo]), bh = __bfloat162float(bu2[o_hi]);
#pragma unroll
      for (int s = 0; s < 5; ++s)
#pragma unroll
        for (int j = 0; j < kAWT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int wc = 8 * j + 2 * t + e;
            const bool live = a_abs_w + wc >= 0;
            acc[s][j][e] = live ? acc[s][j][e] + bl : 0.f;
            acc[s][j][2 + e] = live ? acc[s][j][2 + e] + bh : 0.f;
            const int row = (s * kE2Rows + 1 + wc) * kEs;
            store_hi_lo_pair(e2h, e2l, row + 16 * warp + 2 * g, elu(acc[s][j][e]), elu(acc[s][j][2 + e]));
          }
    }
    for (int i = threadIdx.x; i < 5 * kC2; i += kThreads) {  // the planes' zero rows
      const int idx = (i / kC2) * kE2Rows * kEs + i % kC2;
      e2h[idx] = __float2bfloat16(0.f);
      e2l[idx] = __float2bfloat16(0.f);
    }
    __syncthreads();

    // A: R1. n-tile q = kAWT*s + j; position u - 2 + d is phase s+d-2 of
    // the same column, or (below 0) phase s+d+3 of the one before.
    {
      const int mt = warp & 3, nh = warp >> 2;
      constexpr int kQ = 5 * kAWT / 2;
      float acc1[kQ][4];
#pragma unroll
      for (int q = 0; q < kQ; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[q][e] = 0.f;
      const uint4* wa = w1s + mt * kKs1 * 32 + lane;
      const bf16* e2 = hi_lo_lane(e2h, e2l);
#pragma unroll 1
      for (int d = 0; d < 3; ++d) {
        int off[kQ];
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int tile = nh * kQ + q;
          const int s = tile / kAWT, j = tile % kAWT;
          int sp = s + d - 2, row = 1 + 8 * j + (lane & 7);
          if (sp < 0) {
            sp += 5;
            row -= 1;
          }
          off[q] = (sp * kE2Rows + row) * kEs;
        }
#pragma unroll 1
        for (int kk = 0; kk < kC2 / 16; ++kk) {
          const uint4 af = wa[(d * (kC2 / 16) + kk) * 32];
          uint32_t bb[kQ][4];
#pragma unroll
          for (int q = 0; q < kQ; ++q) ldmatrix_x4(bb[q], e2 + off[q] + 16 * kk);
#pragma unroll
          for (int q = 0; q < kQ; ++q) mma_frag(acc1[q], af, bb[q][0], bb[q][1]);  // hi
#pragma unroll
          for (int q = 0; q < kQ; ++q) mma_frag(acc1[q], af, bb[q][2], bb[q][3]);  // lo
        }
      }
      const int c_lo = 16 * mt + g, c_hi = c_lo + 8;
      const float bl = __bfloat162float(b1r2[c_lo]), bh = __bfloat162float(b1r2[c_hi]);
#pragma unroll
      for (int q = 0; q < kQ; ++q)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int row = ((nh * kQ + q) * 8 + 2 * t + e) * kHs;
          store_hi_lo_pair(h2h, h2l, row + 16 * mt + 2 * g, elu(acc1[q][e] + bl), elu(acc1[q][2 + e] + bh));
        }
    }
    __syncthreads();

    // A: R2 onto the y2 registers; h = elu(.) into the h planes, row
    // 5*wc + s - 7 (position m0-3+row), from column a0-1's phase 2.
    {
      const float bl = __bfloat162float(b2r2[o_lo]), bh = __bfloat162float(b2r2[o_hi]);
      const bf16* h1 = hi_lo_lane(h2h, h2l);
#pragma unroll
      for (int ks = 0; ks < kKs2; ++ks) {
        const uint4 af = w2s[(warp * kKs2 + ks) * 32 + lane];
#pragma unroll
        for (int s = 0; s < 5; ++s) {
          uint32_t bb[kAWT][4];
#pragma unroll
          for (int j = 0; j < kAWT; ++j) ldmatrix_x4(bb[j], h1 + ((s * kAWT + j) * 8 + (lane & 7)) * kHs + ks * 16);
#pragma unroll
          for (int j = 0; j < kAWT; ++j) mma_frag(acc[s][j], af, bb[j][0], bb[j][1]);
#pragma unroll
          for (int j = 0; j < kAWT; ++j) mma_frag(acc[s][j], af, bb[j][2], bb[j][3]);
        }
      }
#pragma unroll
      for (int s = 0; s < 5; ++s)
#pragma unroll
        for (int j = 0; j < kAWT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int wc = 8 * j + 2 * t + e;
            const int row = 5 * wc + s - 7;
            if (row >= 0) {
              const bool live = a_abs_w + wc >= 0;
              store_hi_lo_pair(hth, htl, row * kHts + 16 * warp + 2 * g, live ? elu(acc[s][j][e] + bl) : 0.f,
                               live ? elu(acc[s][j][2 + e] + bh) : 0.f);
            }
          }
    }
  }
  __syncthreads();  // the h planes are whole; A's h1 (under B's rings) is read

  // B: U. Window column cw is up3-input column m0-2+cw; tap 0 reads h at
  // m0-3+cw (row cw), tap 1 row cw + 1.
  const int mt = warp & 3, r0 = 2 * (warp >> 2);
  float acc3[2][kNWT8][4];
  {
    constexpr int kPhase = (kC / 16) * kKsU3 * 32;
    uint4* ring = reinterpret_cast<uint4*>(smem_raw + kOffRingB + warp * kRingB) + lane;
    const FragRing<2, kDepthB> wrb{ring, wu3f + (r0 * (kC / 16) + mt) * kKsU3 * 32 + lane, 32, kPhase, kKsU3};
    wrb.start();
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < kNWT8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc3[p][j][e] = 0.f;
    const bf16* hp = hi_lo_lane(hth, htl) + (lane & 7) * kHts;
#pragma unroll 1
    for (int ks = 0; ks < kKsU3; ++ks) {
      uint4 af[2];
      wrb.get(ks, af);
      const int tap = ks / (kC2 / 16), k0 = (ks % (kC2 / 16)) * 16;
      uint32_t bb[kNWT8][4];
#pragma unroll
      for (int j = 0; j < kNWT8; ++j) ldmatrix_x4(bb[j], hp + (8 * j + tap) * kHts + k0);
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int j = 0; j < kNWT8; ++j) {
          mma_frag(acc3[p][j], af[p], bb[j][0], bb[j][1]);  // hi
          mma_frag(acc3[p][j], af[p], bb[j][2], bb[j][3]);  // lo
        }
    }
    ring_drain();
  }
  __syncthreads();  // every warp is done with the h planes and its ring, which E overwrites
  seanet_mma::up_tail_stages<kNWT8>(acc3, reinterpret_cast<bf16*>(smem_raw + kOffE3),
                                    reinterpret_cast<bf16*>(smem_raw + kOffH3), w3s, bu3, b1r3, b2r3, bf,
                                    5 * st + m0 - GB::kHaloC, 4 * m0, 20 * t_in, out + (size_t)b * 20 * t_in);
}

int launch_cascade(const void* x, const void* halo, const void* start, const void* const* w, void* out, int B,
                   int t_in, cudaStream_t stream) {
  // Raised once per process, so launches stay legal inside a graph capture.
  static const cudaError_t attr =
      cudaFuncSetAttribute(cascade_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem8);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((t_in + kA - 1) / kA, B);
  cascade_mma_kernel<<<grid, kThreads, kSmem8, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(halo), static_cast<const int*>(start),
      static_cast<const uint4*>(w[0]), static_cast<const bf16*>(w[1]), static_cast<const uint4*>(w[2]),
      static_cast<const bf16*>(w[3]), static_cast<const uint4*>(w[4]), static_cast<const bf16*>(w[5]),
      static_cast<const uint4*>(w[6]), static_cast<const bf16*>(w[7]), static_cast<const uint4*>(w[8]),
      static_cast<const bf16*>(w[9]), static_cast<const uint4*>(w[10]), static_cast<const bf16*>(w[11]),
      static_cast<const bf16*>(w[12]), static_cast<const bf16*>(w[13]), static_cast<bf16*>(out), t_in);
  return (int)cudaGetLastError();
}

}  // namespace tc

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
// Returns cudaGetLastError() after the launch (0 on success). Weights
// contiguous, in the wrapper's kernel layouts (kernels/seanet_tail.py):
//   float32: output channel last, wu [256,10,128] (repacked [128,256,10]),
//     w1 [128,3,64] ([64,128,3]), w2 [64,128] ([128,64,1]);
//   bfloat16: mma fragments (see tc::up2_res_mma_kernel), wu
//     [5,8,32,32,8], w1 [4,24,32,8], w2 [8,4,32,8].
// Biases [128], [64], [128] as they are. t_in a multiple of 8.
extern "C" int up2_res(int dtype, const void* x, const void* wu, const void* bu, const void* w1,
                       const void* b1, const void* w2, const void* b2, void* out, int B,
                       int t_in, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_in <= 0 || t_in % kUpCols != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_up2<float>(x, wu, bu, w1, b1, w2, b2, out, B, t_in, s);
  if (dtype == 1) return tc::launch(x, wu, bu, w1, b1, w2, b2, out, B, t_in, s);
  return (int)cudaErrorInvalidValue;
}

// The cascade. `halo` [B,256,5] (same dtype as x) and `start` [B] int32 may
// be null (zeros). Weights, in order: up2 wu,bu; res2 w1,b1,w2,b2 (the
// layouts of up2_res); up3 wu, bu; res3 w1, b1, w2, b2; final wf, bf:
//   float32: up3 wu [64,128,8] repacked, res3 w1 [32,64,3], w2 [64,32,1],
//     wf [1,64,7];
//   bfloat16: up3 wu as A fragments [4,4,16,32,8] with K interleaved (see
//     tc::cascade_mma_kernel), res3 and wf as seanet_tail.cu's
//     seanet_up_tail takes them. t_in a multiple of 32.
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
  if (dtype == 1) {
    if (t_in <= 0 || t_in % 32 != 0) return (int)cudaErrorInvalidValue;
    return tc::launch_cascade(x, halo, start, w, out, B, t_in, s);
  }
  return (int)cudaErrorInvalidValue;
}
