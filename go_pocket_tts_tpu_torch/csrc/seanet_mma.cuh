// Tensor-core pieces of the bfloat16 SEANet kernels (seanet_tail.cu's up3
// tail and res3 tail, seanet_up2.cu's up2 + res2 and the whole cascade):
// every convolution as an implicit GEMM on mma.sync m16n8k16, bf16
// operands, float32 accumulation.
//
// - A transposed conv of stride S (kernel 2S, repacked) is S phase GEMMs:
//   phase s of output u = S*m + s reads input columns m-1 (tap 0) and m
//   (tap 1), so its K runs over (tap, input channel) and its B operand is
//   the x tile read at two row offsets. A k3 causal conv is three shifted
//   reads of one tile, a k1 conv a plain GEMM. No im2col buffer.
// - Activations sit in shared memory position-major, channel-contiguous
//   ([position][channel], rows padded by 16 bytes so that 8 consecutive rows
//   fall in 8 bank groups): a shift by one position is a row offset, and
//   ldmatrix (not transposed) reads B fragments straight from it.
// - Weights are the A operand, prepared once on the host in the fragment
//   order of mma_sync.cuh (kernels/seanet_tail.py: mma_fragments): tile
//   (m, k) of 16 x 16 is 32 lanes x 16 bytes, so a warp fetches its A
//   fragment as one coalesced 512-byte read, several k-steps ahead of its
//   use (FragRing). Each warp owns its output rows of a transposed conv, so
//   a block reads those weights once.
// - A float32 intermediate v is the B operand as a pair of bf16 planes,
//   hi = bf16(v) and lo = bf16(v - hi): two MMAs with the same (exact) bf16
//   weight carry v to ~2^-17 relative, so the result is the float32-
//   intermediate function of the plain versions, not a bf16-staged one.
//   Its channels are interleaved within each 16 (store_hi_lo_pair).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace seanet_mma {

using bf16 = __nv_bfloat16;
using mma::ldmatrix_x2;
using mma::ldmatrix_x4;
using mma::mma_bf16;

constexpr int kThreads = 256;

// ELU as v > 0 ? v : __expf(v) - 1: within 2.5e-7 of float32 ELU in
// absolute terms (the fast exponential's error near 1), far below the
// hi/lo pair's 2^-17 of the values it feeds. The kernels take ~2 ELUs per
// MMA-tile element, and library expm1f, several times the instructions,
// was the largest single cost of their epilogues.
__device__ __forceinline__ float elu(float v) { return v > 0.f ? v : __expf(v) - 1.f; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(mma::smem_addr(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// A warp's A fragments in flight: a per-lane ring in shared memory, fed by
// 16-byte cp.async (L2 only). Each lane reads back only the 16 bytes it
// copied, so a wait on its own copy groups is all the synchronisation a
// stage needs. K-step ks reads kFrags fragments at src + ks*ks_stride +
// f*frag_stride (in uint4, this lane's already added); kDepth - 1 k-steps
// are in flight while one is consumed, which covers L2's latency where one
// k-step's MMAs do not. Copy groups committed before start() (resident
// weights) complete no later than k-step 0.
template <int kFrags, int kDepth>
struct FragRing {
  uint4* ring;  // this warp's kDepth * kFrags * 32 uint4, this lane's added
  const uint4* src;
  int ks_stride, frag_stride, n;

  __device__ __forceinline__ void issue(int ks) const {
    if (ks < n) {
#pragma unroll
      for (int f = 0; f < kFrags; ++f)
        cp_async16(ring + ((ks % kDepth) * kFrags + f) * 32, src + (size_t)ks * ks_stride + (size_t)f * frag_stride);
    }
    cp_async_commit();  // empty past the end: keeps the count
  }
  __device__ __forceinline__ void start() const {
#pragma unroll
    for (int ks = 0; ks < kDepth - 1; ++ks) issue(ks);
  }
  // K-step ks's fragments into af; puts k-step ks + kDepth - 1 in flight.
  __device__ __forceinline__ void get(int ks, uint4* af) const {
    issue(ks + kDepth - 1);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kDepth - 1) : "memory");
#pragma unroll
    for (int f = 0; f < kFrags; ++f) af[f] = ring[((ks % kDepth) * kFrags + f) * 32];
  }
};

// Every copy group of this thread (a ring's, and resident weights').
__device__ __forceinline__ void ring_drain() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ void mma_frag(float* d, const uint4& a, uint32_t b0, uint32_t b1) {
  mma_bf16(d, reinterpret_cast<const uint32_t*>(&a), b0, b1);
}

// A fragment's two channels c and c + 8 (rows g and g + 8 of an m16 tile)
// at one position, as hi/lo bf16 pairs: the kernels keep the channels of
// their own activations interleaved within each 16 (c at 2c, c + 8 at
// 2c + 1; kernels/seanet_tail.py: interleave_k permutes the consuming
// weights' K to match), so each plane takes one 32-bit store at `idx`, the
// pair's even element, and one packed conversion.
__device__ __forceinline__ void store_hi_lo_pair(bf16* hi, bf16* lo, int idx, float v0, float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  *reinterpret_cast<__nv_bfloat162*>(hi + idx) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo + idx) = __floats2bfloat162_rn(v0 - hf.x, v1 - hf.y);
}

constexpr int kStreamHalo = 5;  // x columns of causal state a streamed block carries

// x[kCh, t_in] (one batch row) at columns [c0, c0 + kCols) into xs
// transposed, [1 + kCols][kStride]: row 1 + c holds column c0 + c, row 0
// (and every column outside [0, t_in)) is zero. c0 and t_in are multiples
// of 8, so each 16-byte load is 8 columns wholly inside or outside.
// A streamed block passes its causal state: column a < 0 is
// halo_b[:, kStreamHalo + a] (halo_b [kCh][kStreamHalo]) where a >=
// -kStreamHalo and its absolute column start + a >= 0, else zero.
// Ends with a barrier.
template <int kCh, int kCols, int kStride>
__device__ void load_x_tile(const bf16* __restrict__ xb, int t_in, int c0, bf16* xs,
                            const bf16* __restrict__ halo_b = nullptr, int start = 0) {
  static_assert(kCols % 8 == 0, "whole 16-byte column groups");
  constexpr int kVecs = kCols / 8;
  for (int e = threadIdx.x; e < kCh * kVecs; e += kThreads) {
    const int i = e / kVecs, v = e % kVecs;
    const int c = c0 + 8 * v;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (c >= 0 && c < t_in) {
      u = *reinterpret_cast<const uint4*>(xb + (size_t)i * t_in + c);
    } else if (c < 0 && halo_b != nullptr) {
      bf16* hv = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int a = c + k;
        if (a >= -kStreamHalo && a < 0 && start + a >= 0) hv[k] = halo_b[i * kStreamHalo + kStreamHalo + a];
      }
    }
    const bf16* h = reinterpret_cast<const bf16*>(&u);
#pragma unroll
    for (int k = 0; k < 8; ++k) xs[(1 + 8 * v + k) * kStride + i] = h[k];
  }
  for (int i = threadIdx.x; i < kCh; i += kThreads) xs[i] = __float2bfloat16(0.f);
  __syncthreads();
}

// B fragments of two neighbouring n-tiles (8 rows each, from `row0` and
// row0 + 8, channels k0 .. k0+15) of a [row][kStride] bf16 tile:
// b[0], b[1] for the first, b[2], b[3] for the second.
template <int kStride>
__device__ __forceinline__ void ld_b_pair(uint32_t* b, const bf16* tile, int row0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x4(b, tile + (row0 + 8 * (lane >> 4) + (lane & 7)) * kStride + k0 + 8 * ((lane >> 3) & 1));
}

// B fragments of one n-tile: b[0], b[1].
template <int kStride>
__device__ __forceinline__ void ld_b(uint32_t* b, const bf16* tile, int row0, int k0) {
  const int lane = threadIdx.x & 31;
  ldmatrix_x2(b, tile + (row0 + (lane & 7)) * kStride + k0 + 8 * ((lane >> 3) & 1));
}

// This lane's base in a hi/lo pair of [row][kStride] planes for an
// ldmatrix.x4 of one n-tile: lanes 0-15 read hi, 16-31 lo, each group its
// two k halves; at base + row * kStride + k0 (row: this lane's, n = lane % 8)
// it gives b[0], b[1] from hi and b[2], b[3] from lo.
__device__ __forceinline__ const bf16* hi_lo_lane(const bf16* hi, const bf16* lo) {
  const int lane = threadIdx.x & 31;
  return ((lane & 16) ? lo : hi) + 8 * ((lane >> 3) & 1);
}

// ---- the up3 tail after its U stage (kernels 2, 3 and 8) ------------------
// A block of kN = 8*kNWT - 2 up3-input columns [m0, m0+kN) -> 4*kN PCM
// samples, over a window of kNW = 8*kNWT columns from m0-2 (the two before
// m0 are the causal halo: the final conv reads z at t0-6 .. t0-1, which
// reads y from t0-8). The caller's U stage leaves y - bias in registers:
// warp w owns channels [16*(w%4), +16) of phases r0 = 2*(w/4) and r0+1 over
// the whole window, acc[p][j] the m16n8 tile of phase r0+p and window
// columns [8j, 8j+8). Then, on tensor cores:
//   E   y += bias, zero before absolute t = 0; elu(y) as hi/lo planes
//       [phase][1 + window column][channel] (row 0 zero).
//   R1  h1 = elu(res3.conv1(elu(y))) (M 32, K 3 shifts x 64, N 4*kNW):
//       warp w owns m-tile w%2 and a quarter of the (phase, 8 columns)
//       n-tiles, read at the shifted rows of the phase planes.
//   R2  z = elu(y + res3.conv2(h1)) (M 64, K 32) onto the y registers,
//       zero before t = 0, into shared memory as hi/lo planes in time order.
//   F   out = final(z) (k7 64 -> 1): on tensor cores with the z rows as M,
//       the per-tap partials P[i][d] = sum_o z[i][o] wf[o][d] (N = 7 taps
//       in 8), then each output sample sums its 7 diagonal partials.
template <int kNWT>
struct UpTail {
  static constexpr int kC = 64;                // tail channels
  static constexpr int kCr = 32;               // res3 hidden channels
  static constexpr int kHaloC = 2;             // window columns before m0
  static constexpr int kNW = 8 * kNWT;         // window columns, from m0-2
  static constexpr int kN = kNW - kHaloC;      // the block's columns
  static constexpr int kEs = kC + 8;           // elu(y) row stride
  static constexpr int kERows = 1 + kNW;       // per phase plane: zero row, then the window
  static constexpr int kEPlane = 4 * kERows * kEs;
  static constexpr int kHs = kCr + 8;          // h1 row stride
  static constexpr int kHRows = 4 * kNW;       // h1 rows, phase-major: kNW*r + window column
  static constexpr int kZ = (4 * kNW + 15) / 16 * 16;  // z samples from t0-8, in m-tiles of 16 (past 4*kNW unwritten)
  static constexpr int kZs = kC + 8;           // z row stride (hi/lo planes [sample][channel])
  static constexpr int kPs = 9;                // F's partials, float row stride (odd: conflict-free sums)
  static constexpr int kKsF = kC / 16;         // final conv k-steps
  static constexpr int kKs1 = 3 * kC / 16;     // R1 k-steps
  static constexpr int kKs2 = kCr / 16;        // R2 k-steps
  // bf16 elements: elu(y), then z (hi/lo planes); h1 (hi/lo planes).
  static constexpr int kRegionE = 2 * kEPlane > 2 * kZ * kZs ? 2 * kEPlane : 2 * kZ * kZs;
  static constexpr int kRegionH = 2 * kHRows * kHs;
  // Resident weights, uint4: res3's A fragments (w1, w2) and the final
  // conv's B fragments (wf), 17 KB.
  static constexpr int kW1 = (kCr / 16) * kKs1 * 32, kW2 = (kC / 16) * kKs2 * 32, kWf = kKsF * 32 / 2;
  static constexpr int kW = kW1 + kW2 + kWf;
  static_assert(4 * kHaloC >= 8, "the 8-sample halo of res3 and the final conv");
  static_assert(kZ * kPs * 4 <= kRegionH * 2, "F's partials lie under h1");
};

// The resident weights of UpTail (w1 [2][12][32], w2 [4][2][32] A fragments,
// wf [4][32] B fragments of 8 bytes) into ws, as one more copy group of
// this thread (not committed).
template <int kNWT>
__device__ __forceinline__ void up_tail_weights(uint4* ws, const uint4* __restrict__ w1f, const uint4* __restrict__ w2f,
                                                const bf16* __restrict__ wf) {
  using G = UpTail<kNWT>;
  for (int i = threadIdx.x; i < G::kW; i += kThreads)
    cp_async16(ws + i, i < G::kW1 ? w1f + i
                       : i < G::kW1 + G::kW2 ? w2f + (i - G::kW1)
                                             : reinterpret_cast<const uint4*>(wf) + (i - G::kW1 - G::kW2));
}

// Stages E, R1, R2 and F (see UpTail). `region_e` holds G::kRegionE and
// `region_h` G::kRegionH bf16 elements, `ws` the resident weights (arrived:
// the caller waited on them); the caller's barrier after its U stage
// precedes the call. `bu` may be null (y taken as it is). Window column cw
// is absolute up3-input column m_abs_w + cw: positions of a negative column
// are zero. Writes out[t0 + n] for n < 4*kN and t0 + n < t_end.
template <int kNWT>
__device__ __forceinline__ void up_tail_stages(float (&acc)[2][kNWT][4], bf16* region_e, bf16* region_h,
                                               const uint4* ws, const bf16* __restrict__ bu,
                                               const bf16* __restrict__ b1, const bf16* __restrict__ b2,
                                               const bf16* __restrict__ bf, int m_abs_w, int t0, int t_end,
                                               bf16* __restrict__ out) {
  using G = UpTail<kNWT>;
  constexpr int kC = G::kC, kERows = G::kERows, kEs = G::kEs, kHs = G::kHs, kZs = G::kZs;
  bf16* e2h = region_e;
  bf16* e2l = e2h + G::kEPlane;
  bf16* zh = region_e;  // after R1: z, hi/lo planes
  bf16* zl = region_e + G::kZ * kZs;
  bf16* h1h = region_h;
  bf16* h1l = h1h + G::kHRows * kHs;
  const uint4* w1s = ws;
  const uint4* w2s = w1s + G::kW1;
  const uint2* wfs = reinterpret_cast<const uint2*>(w2s + G::kW2);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp & 3, r0 = 2 * (warp >> 2);

  // E: y = acc + bu, zero before t = 0 (a negative column); elu(y) planes.
  const int o_lo = 16 * mt + g, o_hi = o_lo + 8;
  {
    const float bl = bu != nullptr ? __bfloat162float(bu[o_lo]) : 0.f;
    const float bh = bu != nullptr ? __bfloat162float(bu[o_hi]) : 0.f;
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int j = 0; j < kNWT; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cw = 8 * j + 2 * t + e;
          const bool live = m_abs_w + cw >= 0;
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
    const uint4* wa = w1s + mt1 * G::kKs1 * 32 + lane;
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
    for (int ks = 0; ks < G::kKs2; ++ks) {
      const uint4 af = w2s[(mt * G::kKs2 + ks) * 32 + lane];
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
          const int i = 4 * cw + r0 + p + 8 - 4 * G::kHaloC;
          if (i >= 0) {
            const bool live = m_abs_w + cw >= 0;
            store_hi_lo_pair(zh, zl, i * kZs + 16 * mt + 2 * g, live ? elu(acc[p][j][e] + bl) : 0.f,
                             live ? elu(acc[p][j][2 + e] + bh) : 0.f);
          }
        }
  }
  __syncthreads();

  // F: out[t0 + n] = bf + sum_{d,o} wf[o][d] * z[t0 + n - 6 + d], z row
  // t0 + n - 6 + d being n + 2 + d. On tensor cores the partials P[i][d] =
  // sum_o z[i][o] * wf[o][d] for every z row (A: the z planes, hi and lo;
  // B: the prepared wf fragments, tap d in column d, column 7 zero), warp w
  // owning the m-tiles of 16 rows w, w + 8, ...; then P lies over h1 (read
  // for the last time in R2) and thread n sums its diagonal, in a fixed
  // order, and writes out[t0 + n].
  float* ps = reinterpret_cast<float*>(h1h);
#pragma unroll 1
  for (int i0 = 16 * warp; i0 < G::kZ; i0 += 16 * (kThreads / 32)) {
    float fa[2][4];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 4; ++e) fa[h][e] = 0.f;
    const int a_off = (i0 + (lane & 15)) * kZs + 8 * (lane >> 4);
#pragma unroll
    for (int ks = 0; ks < G::kKsF; ++ks) {
      const uint2 bw = wfs[ks * 32 + lane];
      uint32_t ah[4], al[4];
      ldmatrix_x4(ah, zh + a_off + 16 * ks);
      ldmatrix_x4(al, zl + a_off + 16 * ks);
      mma::mma_bf16(fa[0], ah, bw.x, bw.y);
      mma::mma_bf16(fa[1], al, bw.x, bw.y);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h)  // rows g (c0, c1) and g + 8 (c2, c3), taps 2t, 2t + 1
#pragma unroll
      for (int e = 0; e < 2; ++e) ps[(i0 + g + 8 * h) * G::kPs + 2 * t + e] = fa[0][2 * h + e] + fa[1][2 * h + e];
  }
  __syncthreads();
  const float bias = __bfloat162float(bf[0]);
  for (int n = threadIdx.x; n < 4 * G::kN; n += kThreads) {
    float v = 0.f;
#pragma unroll
    for (int d = 0; d < 7; ++d) v += ps[(n + 2 + d) * G::kPs + d];
    if (t0 + n < t_end) out[t0 + n] = __float2bfloat16(v + bias);
  }
}

}  // namespace seanet_mma
