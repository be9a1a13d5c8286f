// Tensor-core pieces of the bfloat16 SEANet kernels (seanet_tail.cu's up3
// tail, seanet_up2.cu's up2 + res2): every convolution as an implicit GEMM
// on mma.sync m16n8k16, bf16 operands, float32 accumulation.
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

// x[kCh, t_in] (one batch row) at columns [c0, c0 + kCols) into xs
// transposed, [1 + kCols][kStride]: row 1 + c holds column c0 + c, row 0
// (and every column outside [0, t_in)) is zero. c0 and t_in are multiples
// of 8, so each 16-byte load is 8 columns wholly inside or outside.
// Ends with a barrier.
template <int kCh, int kCols, int kStride>
__device__ void load_x_tile(const bf16* __restrict__ xb, int t_in, int c0, bf16* xs) {
  static_assert(kCols % 8 == 0, "whole 16-byte column groups");
  constexpr int kVecs = kCols / 8;
  for (int e = threadIdx.x; e < kCh * kVecs; e += kThreads) {
    const int i = e / kVecs, v = e % kVecs;
    const int c = c0 + 8 * v;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (c >= 0 && c < t_in) u = *reinterpret_cast<const uint4*>(xb + (size_t)i * t_in + c);
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

}  // namespace seanet_mma
