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
//   float32 (parity), and seanet_tail in both dtypes: SIMT float32, each
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

// ---- the up3 tail on tensor cores (bfloat16) ------------------------------
// Block: kN input columns [m0, m0+kN) -> 4*kN PCM samples, 8 warps, over a
// window of kNW = kN + 2 columns from m0-2 (5 n-tiles): the two columns
// before m0 are the causal halo (the final conv reads z at t0-6 .. t0-1,
// which reads y from t0-8).
//   U   y = up3(x), 4 phase GEMMs (M 64, K 2 taps x 128, N window columns):
//       warp w owns m-tile w%4 of phases 2*(w/4) and 2*(w/4)+1 over the
//       whole window; its 40 accumulators hold y in registers up to R2.
//       elu(y) goes to shared memory as hi/lo planes [phase][row][channel].
//   R1  h1 = elu(res3.conv1(elu(y))) (M 32, K 3 shifts x 64, N 4*kNW):
//       warp w owns m-tile w%2 and a quarter of the (phase, 8 columns)
//       n-tiles, read at the shifted rows of the phase planes.
//   R2  z = elu(y + res3.conv2(h1)) (M 64, K 32) onto the y registers,
//       zero before t = 0, into shared memory as hi/lo planes in time order.
//   F   out = final(z) (k7 64 -> 1) on tensor cores, samples as M: the z
//       planes read at 7 shifts against wf in column 0 of B.
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

constexpr int kHaloC = 2;             // causal halo: y at columns m0-2, m0-1 (t0-8 .. t0-1)
constexpr int kN = 38;                // input columns per block
constexpr int kNW = kN + kHaloC;      // window columns, from m0-2
constexpr int kNWT = kNW / 8;         // window n-tiles
constexpr int kXs = kCin + 8;         // x tile row stride (bf16)
constexpr int kXCols = kNW + 8;       // x tile columns: from m0-3 rounded down to 8
constexpr int kXRows = 1 + kXCols;    // zero row, then the x columns
constexpr int kEs = kC + 8;           // elu(y) row stride
constexpr int kERows = 1 + kNW;       // per phase plane: zero row, then the window
constexpr int kEPlane = 4 * kERows * kEs;
constexpr int kHs = kCr + 8;          // h1 row stride
constexpr int kHRows = 4 * kNW;       // h1 rows, phase-major: kNW*r + window column
constexpr int kOutP = (4 * kN + 15) / 16 * 16;  // samples the final conv computes, in m-tiles of 16
constexpr int kZ = kOutP + 8;         // z samples from t0-8 (past 4*kN+8 only read for dropped samples)
constexpr int kZs = kC + 8;           // z row stride (hi/lo planes [sample][channel])
constexpr int kKsF = 7 * kC / 16;     // final conv k-steps
constexpr int kKsU = 2 * kCin / 16;   // U k-steps
constexpr int kKs1 = 3 * kC / 16;     // R1 k-steps
constexpr int kKs2 = kCr / 16;        // R2 k-steps
constexpr int kDepthU = 4;            // U k-steps per warp's ring (2 fragments each)
constexpr int kRing = kDepthU * 2 * 512;  // ring bytes per warp, under elu(y) during U
constexpr int kRegionE = 2 * kEPlane > 2 * kZ * kZs ? 2 * kEPlane : 2 * kZ * kZs;  // elu(y), then z
constexpr size_t kSmemAct = sizeof(bf16) * (kRegionE + 2 * kHRows * kHs);
// Resident for the block's life, after the activations: res3's and the
// final conv's fragments (w1 A, w2 A, wf B), 23 KB.
constexpr int kW1 = (kCr / 16) * kKs1 * 32, kW2 = (kC / 16) * kKs2 * 32, kWf = kKsF * 32 / 2;  // uint4
constexpr size_t kSmem = kSmemAct + sizeof(uint4) * (kW1 + kW2 + kWf);
static_assert(kNW % 8 == 0 && 4 * kHaloC >= 8, "whole n-tiles, and the 8-sample halo of res3 and the final conv");
static_assert(8 * kRing <= kRegionE * (int)sizeof(bf16), "U's rings lie under elu(y)");
static_assert(kXRows * kXs <= 2 * kHRows * kHs, "the x tile lies under h1");

// Prepared weights (kernels/seanet_tail.py): A fragments [M/16][K/16][32
// lanes] of wu [4 phases][64][2*128] (K = tap*128 + i), w1 [32][3*64]
// (K = d*64 + i), w2 [64][32]; wf as B fragments [7*64/16][32 lanes] of a
// [7*64][8] matrix whose column 0 is wf (K = d*64 + o); biases as they are.
__global__ void __launch_bounds__(kThreads, 2)
up_tail_mma_kernel(const bf16* __restrict__ x, const uint4* __restrict__ wuf,
                   const bf16* __restrict__ bu, const uint4* __restrict__ w1f,
                   const bf16* __restrict__ b1, const uint4* __restrict__ w2f,
                   const bf16* __restrict__ b2, const bf16* __restrict__ wf,
                   const bf16* __restrict__ bf, bf16* __restrict__ out, int t_in) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* e2h = reinterpret_cast<bf16*>(smem_raw);
  bf16* e2l = e2h + kEPlane;
  bf16* h1h = e2h + kRegionE;
  bf16* h1l = h1h + kHRows * kHs;
  bf16* xs = h1h;                               // during U
  bf16* zh = e2h;                               // after R1: z, hi/lo planes
  bf16* zl = e2h + kZ * kZs;
  uint4* w1s = reinterpret_cast<uint4*>(smem_raw + kSmemAct);
  uint4* w2s = w1s + kW1;
  const uint2* wfs = reinterpret_cast<const uint2*>(w2s + kW2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int m0 = blockIdx.x * kN;
  uint4* ring = reinterpret_cast<uint4*>(smem_raw + warp * kRing) + lane;  // U only

  // The resident weights, then U's, are in flight first of all, while the
  // x tile loads.
  for (int i = threadIdx.x; i < kW1 + kW2 + kWf; i += kThreads)
    cp_async16(w1s + i, i < kW1 ? w1f + i : i < kW1 + kW2 ? w2f + (i - kW1) : reinterpret_cast<const uint4*>(wf) + (i - kW1 - kW2));
  cp_async_commit();
  const int mt = warp & 3, r0 = 2 * (warp >> 2);
  constexpr int kPhase = (kC / 16) * kKsU * 32;
  const FragRing<2, kDepthU> wru{ring, wuf + (r0 * (kC / 16) + mt) * kKsU * 32 + lane, 32, kPhase, kKsU};
  wru.start();
  // Window column cw is input column m0 - kHaloC + cw. The x tile holds
  // columns from c0 = m0 - kHaloC - 1 rounded down to 8 (16-byte loads), in
  // rows from 1; tap 0 of window column cw (column m - 1) is row xoff + cw,
  // tap 1 row xoff + cw + 1.
  const int c0 = (m0 - kHaloC - 1) & ~7;
  const int xoff = m0 - kHaloC - c0;
  load_x_tile<kCin, kXCols, kXs>(x + (size_t)b * kCin * t_in, t_in, c0, xs);

  // U.
  float acc[2][kNWT][4];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int j = 0; j < kNWT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][j][e] = 0.f;
  {
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
  }
  __syncthreads();  // every warp is done with its ring, which elu(y) overwrites
  // y = acc + bu, zero before t = 0 (input column m < 0); elu(y) planes.
  const int o_lo = 16 * mt + g, o_hi = o_lo + 8;
  {
    const float bl = __bfloat162float(bu[o_lo]), bh = __bfloat162float(bu[o_hi]);
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < kNWT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cw = 8 * j + 2 * t + e;
          const bool live = m0 - kHaloC + cw >= 0;
          acc[p][j][e] = live ? acc[p][j][e] + bl : 0.f;
          acc[p][j][2 + e] = live ? acc[p][j][2 + e] + bh : 0.f;
          const int row = ((r0 + p) * kERows + 1 + cw) * kEs;
          store_hi_lo_pair(e2h, e2l, row + 16 * mt + 2 * g, elu(acc[p][j][e]), elu(acc[p][j][2 + e]));
        }
  }
  for (int i = threadIdx.x; i < 4 * kC; i += kThreads) {  // the planes' zero rows
    const int idx = (i / kC) * kERows * kEs + i % kC;
    e2h[idx] = __float2bfloat16(0.f);
    e2l[idx] = __float2bfloat16(0.f);
  }
  __syncthreads();

  // R1. n-tile q = kNWT*r + j; position t - 2 + d is phase r+d-2 of the
  // same column, or (below 0) phase r+d+2 of the one before.
  {
    const int mt1 = warp & 1, qq = warp >> 1;
    constexpr int kQ = 4 * kNWT / 4;
    float acc1[kQ][4];
#pragma unroll
    for (int q = 0; q < kQ; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[q][e] = 0.f;
    const uint4* wa = w1s + mt1 * kKs1 * 32 + lane;
    const bf16* e2 = hi_lo_lane(e2h, e2l);
#pragma unroll 1
    for (int d = 0; d < 3; ++d) {
      int off[kQ];  // this lane's row of each n-tile at shift d
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int tile = qq * kQ + q;
        const int r = tile / kNWT, j = tile % kNWT;
        int rp = r + d - 2, row = 1 + 8 * j + (lane & 7);
        if (rp < 0) {
          rp += 4;
          row -= 1;
        }
        off[q] = (rp * kERows + row) * kEs;
      }
#pragma unroll 1
      for (int kk = 0; kk < kC / 16; ++kk) {
        const uint4 af = wa[(d * (kC / 16) + kk) * 32];
        uint32_t bb[kQ][4];
#pragma unroll
        for (int q = 0; q < kQ; ++q) ldmatrix_x4(bb[q], e2 + off[q] + 16 * kk);
#pragma unroll
        for (int q = 0; q < kQ; ++q) mma_frag(acc1[q], af, bb[q][0], bb[q][1]);  // hi
#pragma unroll
        for (int q = 0; q < kQ; ++q) mma_frag(acc1[q], af, bb[q][2], bb[q][3]);  // lo
      }
    }
    const int c_lo = 16 * mt1 + g, c_hi = c_lo + 8;
    const float bl = __bfloat162float(b1[c_lo]), bh = __bfloat162float(b1[c_hi]);
#pragma unroll
    for (int q = 0; q < kQ; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = ((qq * kQ + q) * 8 + 2 * t + e) * kHs;
        store_hi_lo_pair(h1h, h1l, row + 16 * mt1 + 2 * g, elu(acc1[q][e] + bl), elu(acc1[q][2 + e] + bh));
      }
  }
  __syncthreads();

  // R2 onto the y registers; z = elu(.) as hi/lo planes, row t - (t0-8):
  // window sample 4*cw + r is t0 - 4*kHaloC + 4*cw + r.
  {
    const float bl = __bfloat162float(b2[o_lo]), bh = __bfloat162float(b2[o_hi]);
    const bf16* h1 = hi_lo_lane(h1h, h1l);
#pragma unroll
    for (int ks = 0; ks < kKs2; ++ks) {
      const uint4 af = w2s[(mt * kKs2 + ks) * 32 + lane];
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        uint32_t bb[kNWT][4];
#pragma unroll
        for (int j = 0; j < kNWT; ++j)
          ldmatrix_x4(bb[j], h1 + (((r0 + p) * kNWT + j) * 8 + (lane & 7)) * kHs + ks * 16);
#pragma unroll
        for (int j = 0; j < kNWT; ++j) mma_frag(acc[p][j], af, bb[j][0], bb[j][1]);
#pragma unroll
        for (int j = 0; j < kNWT; ++j) mma_frag(acc[p][j], af, bb[j][2], bb[j][3]);
      }
    }
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < kNWT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cw = 8 * j + 2 * t + e;
          const int i = 4 * cw + r0 + p + 8 - 4 * kHaloC;
          if (i >= 0) {
            const bool live = m0 - kHaloC + cw >= 0;
            store_hi_lo_pair(zh, zl, i * kZs + 16 * mt + 2 * g, live ? elu(acc[p][j][e] + bl) : 0.f,
                             live ? elu(acc[p][j][2 + e] + bh) : 0.f);
          }
        }
  }
  __syncthreads();

  // F: out[t0 + n] = bf + sum_{o,d} wf[o][d] * z[t0 + n - 6 + d], on tensor
  // cores with the samples as M: A[n][(d, o)] = z row n + 2 + d (shifted
  // ldmatrix reads of the z planes, hi and lo), B the prepared wf fragments
  // (column 0 holds wf, columns 1-7 zero). Warp w owns the m-tiles of 16
  // samples w, w + 8, ...; four accumulator chains (k-step parity x
  // hi/lo), added in a fixed order.
#pragma unroll 1
  for (int n0 = 16 * warp; n0 < kOutP; n0 += 16 * (kThreads / 32)) {
    float fa[2][2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) fa[i][h][e] = 0.f;
    const int a_off = (n0 + (lane & 15) + 2) * kZs + 8 * (lane >> 4);
#pragma unroll
    for (int ks = 0; ks < kKsF; ++ks) {
      const int d = ks / (kC / 16), k0 = (ks % (kC / 16)) * 16;
      const uint2 bw = wfs[ks * 32 + lane];
      uint32_t ah[4], al[4];
      ldmatrix_x4(ah, zh + a_off + d * kZs + k0);
      ldmatrix_x4(al, zl + a_off + d * kZs + k0);
      mma::mma_bf16(fa[ks & 1][0], ah, bw.x, bw.y);
      mma::mma_bf16(fa[ks & 1][1], al, bw.x, bw.y);
    }
    if (t == 0) {  // column 0: rows g (c0) and g + 8 (c2)
      const float bias = __bfloat162float(bf[0]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = n0 + g + 8 * h, t_abs = 4 * m0 + n;
        const float v = (fa[0][0][2 * h] + fa[1][0][2 * h]) + (fa[0][1][2 * h] + fa[1][1][2 * h]);
        if (n < 4 * kN && t_abs < 4 * t_in) out[(size_t)b * 4 * t_in + t_abs] = __float2bfloat16(v + bias);
      }
    }
  }
}

int launch(const void* x, const void* wu, const void* bu, const void* w1, const void* b1,
           const void* w2, const void* b2, const void* wf, const void* bf, void* out, int B,
           int t_in, cudaStream_t stream) {
  // Raised once per process, so launches stay legal inside a graph capture.
  static const cudaError_t attr = cudaFuncSetAttribute(
      up_tail_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (attr != cudaSuccess) return (int)attr;
  dim3 grid((t_in + kN - 1) / kN, B);
  up_tail_mma_kernel<<<grid, kThreads, kSmem, stream>>>(
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
// contiguous; t_in a multiple of 32. Weights:
//   float32: the reference layouts, wu [64,128,8] repacked, w1 [32,64,3],
//     w2 [64,32,1], wf [1,64,7];
//   bfloat16: wu, w1 and w2 as A fragments and wf as B fragments (see
//     tc::up_tail_mma_kernel; kernels/seanet_tail.py prepares them), wu
//     [4,4,16,32,8], w1 [2,12,32,8], w2 [4,2,32,8], wf [28,32,4]; the
//     biases as they are.
extern "C" int seanet_up_tail(int dtype, const void* x, const void* wu, const void* bu,
                              const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* wf, const void* bf, void* out,
                              int B, int t_in, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (t_in <= 0 || t_in % kTb != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return launch_up<float>(x, wu, bu, w1, b1, w2, b2, wf, bf, out, B, t_in, s);
  if (dtype == 1) return tc::launch(x, wu, bu, w1, b1, w2, b2, wf, bf, out, B, t_in, s);
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
