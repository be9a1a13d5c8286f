// Split-KV decode attention over a thread-block cluster, for sm_90a: the
// device code of decode_attention.cu (kernel 1) and
// batched_decode_attention.cu (kernel 4, both variants and the fused step).
//
// One query row per (lane b, head h) against that pair's cache rows
// 0..n-1, n = min(offset, C-1) + 1:
//
//   out[b,h] = softmax(q.K^T * sm_scale).V   (int8: K and V rows times their
//                                             float32 row scales)
//
// What bounds it: the read of the visible K/V rows (about 1 FLOP a byte,
// two orders under the ~295 ops/byte at which the H100's tensor cores start
// to matter; an mma tile would pad the one query row to 16 or 64, so the
// tensor cores are not used). So few bytes take well under a microsecond
// to stream; what costs is latency. One block per (b, h) would put 16
// blocks on 132 SMs at B = 1, each warp walking its rows one dependent
// 128-byte load at a time (~80 row visits a warp at C = 320). This design
// keeps whole tiles in flight on many SMs instead:
//   - grid (splits, B*H); each (b, h) is one cluster of `splits` blocks
//     (<= 8, the portable cluster size). Block `s` owns rows
//     [s*R, (s+1)*R) (R a multiple of 16, chosen on the host from C and B*H
//     so the grid fills the SMs) and reads only its visible ones;
//   - thread 0 brings them into shared memory with 1D bulk async copies
//     (cp.async.bulk ... mbarrier::complete_tx) into a 2-stage ring of tiles
//     of 16 KB of K+V, so a whole tile is in flight per copy;
//   - one pass with an online softmax: a row is read as 16-byte vectors
//     (16 lanes a float32 row, 8 a bf16 row, 4 an int8 row), each lane keeps
//     a running max m, sum l and its slice of acc[64] in float32;
//   - the warp's row groups, then the block's warps, merge their (m, l,
//     acc); each block stores its (m, l, acc) into rank 0's shared memory
//     through distributed shared memory (the cluster barrier's arrive at the
//     start and its wait before that store make sure rank 0 is running),
//     the cluster syncs, and rank 0 rescales the partials by exp(m_i - m)
//     and writes acc / l rounded once. Storing to rank 0 rather than having
//     it load from its peers needs no second cluster barrier: a peer may exit
//     once its store is visible.
// No device scratch, no atomics, one launch.
//
// With kAppend the kernel also does the step's prologue: it rotates q (every
// block, 64 values) and k_new by RoPE at clamp(offset, 0, max_seq-1), the
// same float32 products and sums apply_rope_rows takes (no FMA
// contraction), rounds them to the activation type and, for an int8
// cache, quantizes the k and v rows as quantize_kv_rows does; the block
// whose split holds row clamp(offset, 0, C-1) writes the row (and scales)
// to the cache and also puts it into its own tile after the bulk copy
// lands, over the stale row it copied, so no block reads the fresh row back
// through the async proxy.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace splitkv {

namespace cg = cooperative_groups;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kD = 64;  // head dim

// Rows of a ring stage: 8 KB of K and 8 KB of V whatever the cache type.
template <typename CT>
struct TileRows {
  static constexpr int value = 8192 / (kD * (int)sizeof(CT));
};

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

// A 16-byte vector of cache elements as floats. int8: flip the sign bits
// (x + 128 as an unsigned byte), put the byte into the mantissa of 2^23 and
// subtract 2^23 + 128; exact, and two full-rate instructions where a
// conversion instruction runs at a quarter of the rate.
template <typename CT>
__device__ __forceinline__ void unpack(const uint4& v, float* f);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& v, float* f) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <>
__device__ __forceinline__ void unpack<int8_t>(const uint4& v, float* f) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t u = w[i] ^ 0x80808080u;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u + j)) - 8388736.0f;
  }
}

// -- mbarrier and bulk copy (PTX) -------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// `bytes` and both addresses are multiples of 16.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- RoPE and row quantization, bit for bit as the plain versions ------------

// (a, b) one interleaved pair: (a c - b s, a s + b c), each product and sum
// rounded on its own as PyTorch's elementwise ops round them.
__device__ __forceinline__ void rope_pair(float& a, float& b, float c, float s) {
  const float x = __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, s));
  const float y = __fadd_rn(__fmul_rn(a, s), __fmul_rn(b, c));
  a = x;
  b = y;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// quantize_kv_rows of one 64-wide row held as a pair per lane of a warp:
// scale = amax / 127, the IEEE quotient (quantize_kv_rows divides by a
// tensor, so no device takes a product by the reciprocal), 1 where 0;
// q = rint(x / scale) clamped to +-127 (torch.round rounds half to even, as
// rintf).
__device__ __forceinline__ float quantize_pair(float a, float b, int8_t& qa, int8_t& qb) {
  const float amax = warp_max(fmaxf(fabsf(a), fabsf(b)));
  float scale = __fdiv_rn(amax, 127.0f);
  scale = scale > 0.f ? scale : 1.0f;
  qa = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(a, scale)), -127.f), 127.f);
  qb = (int8_t)fminf(fmaxf(rintf(__fdiv_rn(b, scale)), -127.f), 127.f);
  return scale;
}

// -- the kernel ---------------------------------------------------------------

template <typename QT, typename CT>
struct Args {
  const QT* q;      // [B, H, D] rows, lane stride q_sb, head stride D
  const QT* k_new;  // same layout, stride k_sb (kAppend only)
  const QT* v_new;  // same layout, stride v_sb (kAppend only)
  CT* k_cache;      // [L, B*H, C, D]
  CT* v_cache;
  float* k_scale;  // [L, B*H, C] (int8 only)
  float* v_scale;
  const int32_t* offsets;  // [B], or one offset for every lane
  const float* rope_cos;   // [max_seq, D/2] (kAppend only)
  const float* rope_sin;
  QT* out;  // [B*H, D]
  long long q_sb, k_sb, v_sb;
  int H, BH, C, layer, max_seq;
  int rows_per_split;  // R, a multiple of 16
  int tile_rows;       // rows of a ring stage, min(TileRows, R)
  int lane_offsets;    // 1: offsets[b]; 0: offsets[0] for every lane
  int write_past_end;  // 1: an offset >= C writes row C-1; 0: it writes nothing
  float sm_scale;
};

template <typename CT, bool kInt8>
__host__ __device__ constexpr size_t stage_bytes(int tile) {
  return (size_t)tile * (2 * kD * sizeof(CT) + (kInt8 ? 2 * sizeof(float) : 0));
}

template <typename QT, typename CT, bool kInt8, bool kAppend>
__global__ void __launch_bounds__(kThreads) split_kv_attention(const Args<QT, CT> a) {
  constexpr int kVec = 16 / (int)sizeof(CT);       // cache elements of a 16-byte vector
  constexpr int kLanesPerRow = kD / kVec;          // 16 (float32), 8 (bf16), 4 (int8)
  constexpr int kRowsPerWarp = 32 / kLanesPerRow;  // rows a warp reads at once
  static_assert(kLanesPerRow <= 32 && kD % kVec == 0, "row geometry");

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar[2];
  __shared__ float q_s[kD];
  __shared__ float w_m[kWarps], w_l[kWarps];
  __shared__ float w_acc[kWarps][kD];
  __shared__ float parts[8][kD + 2];  // rank 0: each split's acc[64], m, l

  cg::cluster_group cluster = cg::this_cluster();
  // Arrive now; the wait before the first remote store finds every block of
  // the cluster running.
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x;  // the cluster spans x: split == block rank
  const int bh = blockIdx.y;
  const int b = bh / a.H, h = bh - b * a.H;
  const int off = a.offsets[a.lane_offsets ? b : 0];
  const int n = min(off, a.C - 1) + 1;  // visible rows 0..n-1
  const int s0 = split * a.rows_per_split;
  const int s1 = min(s0 + a.rows_per_split, n);
  const int n_tiles = s1 > s0 ? (s1 - s0 + a.tile_rows - 1) / a.tile_rows : 0;
  const size_t pair = (size_t)a.layer * a.BH + bh;
  CT* kc = a.k_cache + pair * a.C * kD;
  CT* vc = a.v_cache + pair * a.C * kD;
  float* ksg = kInt8 ? a.k_scale + pair * a.C : nullptr;
  float* vsg = kInt8 ? a.v_scale + pair * a.C : nullptr;
  // Scales go by bulk copy when every chunk is 16-byte aligned (C % 4 == 0;
  // rows start at multiples of 16); else the block copies them itself.
  const bool bulk_scales = kInt8 && (a.C % 4 == 0);

  const size_t sb = stage_bytes<CT, kInt8>(a.tile_rows);
  auto k_tile = [&](int st) { return reinterpret_cast<CT*>(smem + st * sb); };
  auto v_tile = [&](int st) { return k_tile(st) + a.tile_rows * kD; };
  auto ks_tile = [&](int st) { return reinterpret_cast<float*>(v_tile(st) + a.tile_rows * kD); };
  auto vs_tile = [&](int st) { return ks_tile(st) + a.tile_rows; };

  auto load_tile = [&](int t) {  // thread 0: tile t into stage t & 1
    const int st = t & 1;
    const int r0 = s0 + t * a.tile_rows;
    const int cnt = min(a.tile_rows, s1 - r0);
    const uint32_t bytes = (uint32_t)cnt * kD * sizeof(CT);
    const uint32_t sbytes = bulk_scales ? (uint32_t)((cnt + 3) & ~3) * 4u : 0u;
    mbar_expect_tx(&bar[st], 2 * bytes + 2 * sbytes);
    bulk_load(k_tile(st), kc + (size_t)r0 * kD, bytes, &bar[st]);
    bulk_load(v_tile(st), vc + (size_t)r0 * kD, bytes, &bar[st]);
    if (sbytes) {
      bulk_load(ks_tile(st), ksg + r0, sbytes, &bar[st]);
      bulk_load(vs_tile(st), vsg + r0, sbytes, &bar[st]);
    }
  };

  if (tid == 0) {
    mbar_init(&bar[0], 1);
    mbar_init(&bar[1], 1);
    mbar_init_fence();
    for (int t = 0; t < min(n_tiles, 2); ++t) load_tile(t);
  }

  // While the copies fly: q (rotated with kAppend) into q_s, and the step's
  // own K/V row (warp 1: k, warp 2: v), one interleaved pair a lane.
  const int row = min(max(off, 0), a.C - 1);
  const bool own = kAppend && (a.write_past_end || off < a.C) &&
                   split == row / a.rows_per_split;
  const int rope_row = min(max(off, 0), a.max_seq - 1);
  CT own0{}, own1{};  // this lane's pair of the own row (warps 1, 2)
  float own_scale = 1.f;
  if (warp == 0 || (own && (warp == 1 || warp == 2))) {
    const QT* src = warp == 0 ? a.q + b * a.q_sb : warp == 1 ? a.k_new + b * a.k_sb
                                                              : a.v_new + b * a.v_sb;
    src += (size_t)h * kD + 2 * lane;
    float x0 = to_f32(src[0]), x1 = to_f32(src[1]);
    if (kAppend && warp < 2) {
      rope_pair(x0, x1, a.rope_cos[(size_t)rope_row * (kD / 2) + lane],
                a.rope_sin[(size_t)rope_row * (kD / 2) + lane]);
      x0 = to_f32(from_f32<QT>(x0));  // rounded to the activation type
      x1 = to_f32(from_f32<QT>(x1));
    }
    if (warp == 0) {
      q_s[2 * lane] = x0;
      q_s[2 * lane + 1] = x1;
    } else {
      CT* dst = (warp == 1 ? kc : vc) + (size_t)row * kD + 2 * lane;
      if constexpr (kInt8) {
        int8_t q0, q1;
        own_scale = quantize_pair(x0, x1, q0, q1);
        own0 = q0;
        own1 = q1;
        if (lane == 0) (warp == 1 ? ksg : vsg)[row] = own_scale;
      } else {
        own0 = from_f32<CT>(x0);
        own1 = from_f32<CT>(x1);
      }
      dst[0] = own0;
      dst[1] = own1;
    }
  }
  __syncthreads();  // q_s and the barriers' init are visible to every thread

  const int sub = lane % kLanesPerRow;  // the 16-byte slice of a row this lane reads
  float qr[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) qr[e] = q_s[sub * kVec + e];
  float m = -INFINITY, l = 0.f, acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t & 1;
    const int r0 = s0 + t * a.tile_rows;
    const int cnt = min(a.tile_rows, s1 - r0);
    mbar_wait(&bar[st], (t >> 1) & 1);
    const bool own_here = own && row >= r0 && row < r0 + cnt;
    if (kInt8 && !bulk_scales) {
      // Plain loads, after the __syncthreads above: the own row's scale,
      // written by this block, reads back fresh.
      for (int i = tid; i < cnt; i += kThreads) {
        ks_tile(st)[i] = ksg[r0 + i];
        vs_tile(st)[i] = vsg[r0 + i];
      }
    }
    if (own_here && (warp == 1 || warp == 2)) {
      CT* dst = (warp == 1 ? k_tile(st) : v_tile(st)) + (row - r0) * kD + 2 * lane;
      dst[0] = own0;
      dst[1] = own1;
      if (kInt8 && bulk_scales && lane == 0) (warp == 1 ? ks_tile(st) : vs_tile(st))[row - r0] = own_scale;
    }
    if (own_here || (kInt8 && !bulk_scales)) __syncthreads();

    const CT* kt = k_tile(st);
    const CT* vt = v_tile(st);
    for (int base = warp * kRowsPerWarp; base < cnt; base += kWarps * kRowsPerWarp) {
      const int r = base + lane / kLanesPerRow;
      const bool valid = r < cnt;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      if (valid) kv = *reinterpret_cast<const uint4*>(kt + r * kD + sub * kVec);
      float ke[kVec];
      unpack<CT>(kv, ke);
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < kVec; ++e) dot += qr[e] * ke[e];
#pragma unroll
      for (int o = kLanesPerRow / 2; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (valid) {
        float s = dot;
        if constexpr (kInt8) s *= ks_tile(st)[r];
        s *= a.sm_scale;
        const uint4 vv = *reinterpret_cast<const uint4*>(vt + r * kD + sub * kVec);
        float ve[kVec];
        unpack<CT>(vv, ve);
        const float m_new = fmaxf(m, s);
        const float corr = expf(m - m_new);  // 0 while m is -inf
        float p = expf(s - m_new);
        l = l * corr + p;
        if constexpr (kInt8) p *= vs_tile(st)[r];
#pragma unroll
        for (int e = 0; e < kVec; ++e) acc[e] = acc[e] * corr + p * ve[e];
        m = m_new;
      }
    }
    if (t + 2 < n_tiles) {
      __syncthreads();  // every warp is done with this stage
      if (tid == 0) load_tile(t + 2);
    }
  }

  // Merge the warp's row groups (lanes kLanesPerRow apart), then the warps.
#pragma unroll
  for (int o = kLanesPerRow; o < 32; o <<= 1) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    const float l2 = __shfl_xor_sync(0xffffffffu, l, o);
    const float mm = fmaxf(m, m2);
    const float c1 = m == -INFINITY ? 0.f : expf(m - mm);
    const float c2 = m2 == -INFINITY ? 0.f : expf(m2 - mm);
    l = l * c1 + l2 * c2;
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float a2 = __shfl_xor_sync(0xffffffffu, acc[e], o);
      acc[e] = acc[e] * c1 + a2 * c2;
    }
    m = mm;
  }
  if (lane < kLanesPerRow) {
#pragma unroll
    for (int e = 0; e < kVec; ++e) w_acc[warp][lane * kVec + e] = acc[e];
  }
  if (lane == 0) {
    w_m[warp] = m;
    w_l[warp] = l;
  }
  __syncthreads();
  float bm = -INFINITY, bl = 0.f, ba = 0.f;
  if (tid < kD) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) bm = fmaxf(bm, w_m[w]);
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = w_m[w] == -INFINITY ? 0.f : expf(w_m[w] - bm);
      bl += w_l[w] * c;
      ba += w_acc[w][tid] * c;
    }
  }

  // The combine over distributed shared memory: store into rank 0's parts.
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  if (tid < kD) {
    float* dst = cluster.map_shared_rank(&parts[0][0], 0) + split * (kD + 2);
    dst[tid] = ba;
    if (tid == 0) {
      dst[kD] = bm;
      dst[kD + 1] = bl;
    }
  }
  cluster.sync();
  if (split == 0 && tid < kD) {
    const int splits = (int)gridDim.x;
    float gm = -INFINITY;
    for (int r = 0; r < splits; ++r) gm = fmaxf(gm, parts[r][kD]);
    float gl = 0.f, ga = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float c = parts[r][kD] == -INFINITY ? 0.f : expf(parts[r][kD] - gm);
      gl += parts[r][kD + 1] * c;
      ga += parts[r][tid] * c;
    }
    a.out[(size_t)bh * kD + tid] = from_f32<QT>(gl > 0.f ? ga / gl : 0.f);
  }
}

// Launch as clusters of `splits` blocks along x; returns the CUDA error code
// (0 on success).
template <typename QT, typename CT, bool kInt8, bool kAppend>
int launch(Args<QT, CT> a, int splits, cudaStream_t stream) {
  if (splits < 1 || splits > 8 || a.rows_per_split < 16 || a.rows_per_split % 16 ||
      (long long)(splits - 1) * a.rows_per_split >= a.C || a.BH < 1 || a.BH > 65535)
    return (int)cudaErrorInvalidValue;
  a.tile_rows = a.rows_per_split < TileRows<CT>::value ? a.rows_per_split : TileRows<CT>::value;
  const int stages = a.rows_per_split > a.tile_rows ? 2 : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)splits, (unsigned)a.BH, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = stages * stage_bytes<CT, kInt8>(a.tile_rows);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, split_kv_attention<QT, CT, kInt8, kAppend>, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace splitkv
