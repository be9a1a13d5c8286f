// Packed-INT4 group-wise skinny matmul with its epilogue fused, for sm_90a:
//
//   y[M, N] = sum_g (x[M, rows of group g] @ depack(w)[rows of group g, N]) * scale[g, N]
//                                                                     (float32), or
//   y[M, N] = T(that) + T(bias[N]), rounded once more to T            (T = x's type)
//
// Replaces the Pallas TPU kernel `int4_matmul`
// (go_pocket_tts_tpu/ops/pallas/int4_matmul.py) and, with the second form,
// the cast and bias add that apply_linear runs after it. Shapes are the
// reference's gate: M <= 64, K % 128 == 0, N % 256 == 0, scale [K/128, N]
// float32 (a group is 128 input rows); x is float32 or bfloat16 [M, K]; w is
// uint8 [K/2, N], byte [i, j] holding input row 2i in its low nibble and
// row 2i+1 in its high nibble, two's complement (models/quantize.py
// pack_int4_rows); bias float32 or bfloat16. The reference splits x into
// even and odd planes because Mosaic cannot interleave sublanes; here x is
// read as it is.
//
// What bounds it on an H100: the weight read, and before that latency. At
// the AR step's M = 8 a 1024x4096 linear (linear1) moves 2.1 MB of packed
// weight and 0.13 MB of scales and does 67 MFLOP: 0.71 us of bytes at
// 3.35 TB/s, far above its operations' time. A call lasts a few
// microseconds, so what counts is the wait for the first weight bytes and
// whatever else waits in line. The design is kernel 5's
// (quantized_matmul.cu, whose note gives the reasons), on the same
// skeleton (split_k_matmul.cuh) and plan (kernels/split_k.py, w_bits=4):
//   - one launch, grid (S, N / BN), the S blocks of a column tile one
//     thread-block cluster splitting its K rows in whole 128-row groups; no
//     memset, no atomics, no device scratch;
//   - at kernel start one thread requests the block's whole packed slab as
//     2-D TMA tiles of 64 packed rows (one scale group) x BN bytes, each on
//     its own mbarrier, swizzled as kernel 5's; x's columns and the block's
//     [groups, BN] float32 scales follow by cp.async from every thread;
//   - bfloat16 x runs on the tensor cores (mma.sync m16n8k16, float32
//     accumulation). The int4 pairing is the B fragment's: a 32-bit B
//     register of one column holds the k-pair (2t, 2t+1) of a k16 step,
//     which is one packed byte. So a lane's 32-bit load of 4 neighbouring
//     columns at packed row t of the step gives b0 for 4 n-tiles (kernel
//     5's lane-to-column mapping), and the load at packed row t+4 gives b1.
//     Each byte becomes one bf16x2 register exactly, by the magic-number
//     route: (nibble ^ 8) | 0x4300 is the bf16 of 128 + (code + 8), and one
//     bf16x2 subtraction of 136 leaves the code, -8..7, with the low nibble
//     (the even row) in the low half as mma.sync wants: a byte permute, a
//     lop3 and an HSUB2 per register. Products are the plain version's
//     exact products. Lanes 2-3 (BN = 64) or odd lanes (BN = 128) load row
//     t+4 first, so each of the two loads hits 32 distinct banks of the
//     swizzled tile. float32 x (the parity dtype) takes exact float32 FMAs
//     on CUDA cores in the same skeleton;
//   - group scale: a chunk is one group. Each warp sums the group's k16
//     steps it owns in a float32 fragment, then folds it in, acc += part *
//     scale[g, n] for its own columns: the scale multiplies the partial,
//     never the weight, as in the Pallas kernel and the plain version;
//   - the warps' accumulators, then the cluster's partials, are added in a
//     fixed order (the st.async combine into rank 0): two calls are
//     bit-equal. Rank 0 writes float32, or rounds to T, adds the bias
//     rounded to T and rounds again, as y.astype(T) + b.astype(T) does in
//     the JAX package's apply_linear.

#include "split_k_matmul.cuh"

namespace {

using namespace splitk;

// Four bf16 pairs from 4 packed bytes (one a column): out[j] holds byte j's
// low nibble in its low half and its high nibble in its high half, each
// the signed code -8..7 exactly: (nibble ^ 8) | 0x4300 is the bf16 of
// 128 + code + 8, less 136.
__device__ __forceinline__ void nibble_pairs(uint32_t u, uint32_t* out) {
  const uint32_t a = u ^ 0x88888888u;  // every nibble: code + 8
  const uint32_t h = a >> 4;           // byte j's high nibble in the low bits of byte j
  const __nv_bfloat162 k136 = __halves2bfloat162(__ushort_as_bfloat16(0x4308), __ushort_as_bfloat16(0x4308));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    // Byte 0 = a's byte j, byte 2 = h's byte j; then 0x43 over bytes 1 and 3.
    const uint32_t v = (__byte_perm(a, h, (uint32_t)(j | (j << 4) | ((4 + j) << 8) | ((4 + j) << 12))) & 0x000F000Fu) |
                       0x43004300u;
    const __nv_bfloat162 d = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), k136);
    out[j] = *reinterpret_cast<const uint32_t*>(&d);
  }
}

// The code of nibble h (0: low, 1: high) of byte b as a float.
__device__ __forceinline__ float nibble_f32(uint32_t b, int h) {
  return (float)((int)(b << (28 - 4 * h)) >> 28);
}

// kMTiles: 16-row tiles of x (M rounded up); BN: columns of the tile.
template <typename T, int kMTiles, int BN>
__global__ void __launch_bounds__(kThreads)
    int4_matmul_kernel(const __grid_constant__ CUtensorMap wmap, const Args a) {
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int kES = (int)sizeof(T);
  constexpr int kMT = 16 * kMTiles;
  constexpr int kGroups = BN / 32;          // 32-column groups of the tile
  constexpr int kParts = kWarps / kGroups;  // warps sharing a group, by k16 step
  constexpr int kSteps = kChunkRows / 16 / kParts;  // k16 steps of a warp in a chunk
  constexpr int kTileRows = kChunkRows / 2;         // packed rows of a chunk (one scale group)

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  __shared__ __align__(8) uint64_t peers_bar;  // rank 0: its peers' partials have landed
  __shared__ __align__(16) unsigned char s_bias[BN * 4];  // float32 or bfloat16, as stored
  unsigned char* smem = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, splits = gridDim.x;
  const int n0 = blockIdx.y * BN;
  const int k0 = split * a.rows_per_split;
  const int rows = min(a.rows_per_split, a.K - k0);  // > 0, a multiple of 128

  // The pass's staged operands: packed tiles [chunks][64][BN] bytes, group
  // scales [chunks][BN] float32, x's columns [M][tile_rows] (+ kPad).
  unsigned char* slab = smem;
  float* scales = reinterpret_cast<float*>(smem + (size_t)a.tile_rows / 2 * BN);
  unsigned char* xs = reinterpret_cast<unsigned char*>(scales + (size_t)(a.tile_rows / kChunkRows) * BN);
  const int x_row = a.tile_rows * kES + kPad;  // bytes per staged x row
  const T* xg = static_cast<const T*>(a.x);
  const int group = warp % kGroups, part = warp / kGroups;
  const int base = group * 32;  // the warp's first column in the tile
  const int g = lane >> 2, t = lane & 3;
  // Load row t+4 of a step before row t (bank spread; see the note).
  const bool flip = BN == 64 ? t >= 2 : (t & 1) != 0;

  start<4, BN>(&wmap, a, slab, bars, &peers_bar, s_bias, n0, k0, rows, split, splits);

  float acc[kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i) acc[i] = 0.f;

  for (int p0 = 0, pass = 0; p0 < rows; p0 += a.tile_rows, ++pass) {
    const int pass_rows = min(a.tile_rows, rows - p0);
    const int chunks = pass_rows / kChunkRows;
    if (pass > 0) {
      __syncthreads();  // every warp is done with the last pass's rows
      if (tid == 0) request_tiles<4, BN>(slab, &wmap, bars, n0, k0 + p0, chunks);
    }
    // x's columns of the pass, real rows only (the padded rows' products land
    // in accumulator rows that are never read), and the pass's group scales.
    const int vx = pass_rows * kES / 16;
    for (int i = tid; i < a.M * vx; i += kThreads) {
      const int m = i / vx, v = i - m * vx;
      cp_async16(xs + m * x_row + v * 16, xg + (size_t)m * a.K + k0 + p0 + v * (16 / kES));
    }
    const int g0 = (k0 + p0) / kChunkRows;
    for (int i = tid; i < chunks * (BN / 4); i += kThreads) {
      const int c = i / (BN / 4), v = i - c * (BN / 4);
      cp_async16(scales + c * BN + 4 * v, a.scale + (size_t)(g0 + c) * a.N + n0 + 4 * v);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // x, the scales and the barriers' init are visible to every thread

    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&bars[c], pass & 1);
      const unsigned char* tile = slab + c * kTileRows * BN;
      const float* sc = scales + c * BN;
      float part_acc[kMT];
#pragma unroll
      for (int i = 0; i < kMT; ++i) part_acc[i] = 0.f;
      if constexpr (kMma) {
        uint32_t u[kSteps][2];
#pragma unroll
        for (int q = 0; q < kSteps; ++q) {
          // B: packed rows t (k-pair 2t, 2t+1) and t+4 (2t+8, 2t+9) of the
          // step, columns base+4g .. +3.
          const int r = (part + q * kParts) * 8 + t;
          const int b = base + 4 * g;
          const uint32_t first = *reinterpret_cast<const uint32_t*>(tile + swz<BN>(flip ? r + 4 : r, b));
          const uint32_t second = *reinterpret_cast<const uint32_t*>(tile + swz<BN>(flip ? r : r + 4, b));
          u[q][0] = flip ? second : first;
          u[q][1] = flip ? first : second;
        }
#pragma unroll
        for (int q = 0; q < kSteps; ++q) {
          const int k = c * kChunkRows + (part + q * kParts) * 16;  // row of the pass
          uint32_t b0[4], b1[4];
          nibble_pairs(u[q][0], b0);
          nibble_pairs(u[q][1], b1);
#pragma unroll
          for (int mi = 0; mi < kMTiles; ++mi) {
            uint32_t af[4];
            ldmatrix_x4(af, xs + (16 * mi + (lane & 15)) * x_row + (k + (lane >> 4) * 8) * 2);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(&part_acc[(mi * 4 + j) * 4], af, b0[j], b1[j]);
          }
        }
        // The group's scale: fragment (mi, j) element 2h + e is column
        // base + 8t + 4e + j.
        const float4 s0 = *reinterpret_cast<const float4*>(sc + base + 8 * t);
        const float4 s1 = *reinterpret_cast<const float4*>(sc + base + 8 * t + 4);
        const float s[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
#pragma unroll
        for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = (mi * 4 + j) * 4 + r;
              acc[i] = fmaf(part_acc[i], s[4 * (r & 1) + j], acc[i]);
            }
      } else {
        // One column a lane, every x row, 4 k (two packed rows) at a time.
#pragma unroll
        for (int q = 0; q < kSteps; ++q) {
          const int r0 = (part + q * kParts) * 8;
#pragma unroll
          for (int kk = 0; kk < 8; kk += 2) {
            const int k = c * kChunkRows + 2 * (r0 + kk);
            const uint32_t w0 = tile[swz<BN>(r0 + kk, base + lane)];
            const uint32_t w1 = tile[swz<BN>(r0 + kk + 1, base + lane)];
            const float wv[4] = {nibble_f32(w0, 0), nibble_f32(w0, 1), nibble_f32(w1, 0), nibble_f32(w1, 1)};
#pragma unroll
            for (int m = 0; m < kMT; ++m) {
              const float4 xv = *reinterpret_cast<const float4*>(xs + m * x_row + k * 4);
              part_acc[m] = fmaf(xv.x, wv[0], part_acc[m]);
              part_acc[m] = fmaf(xv.y, wv[1], part_acc[m]);
              part_acc[m] = fmaf(xv.z, wv[2], part_acc[m]);
              part_acc[m] = fmaf(xv.w, wv[3], part_acc[m]);
            }
          }
        }
        const float s = sc[base + lane];
#pragma unroll
        for (int m = 0; m < kMT; ++m) acc[m] = fmaf(part_acc[m], s, acc[m]);
      }
    }
  }
  float* red = reinterpret_cast<float*>(smem + (a.parts_apart ? stage_bytes<4>(a, kMT, BN, kES) : 0));
  float4 sum[result_vecs<kMTiles, BN>()];
  if (!combine<kMma, kMTiles, BN>(acc, sum, red, &peers_bar, a, split, splits)) return;
  epilogue<T, kMTiles, BN, false>(sum, nullptr, s_bias, a, n0);
}

struct Int4Kernel {
  template <typename T, int kMTiles, int BN>
  static int launch(const CUtensorMap& map, const Args& a, int splits, cudaStream_t stream) {
    static bool configured = false;  // one attribute call per instantiation
    return splitk::launch(int4_matmul_kernel<T, kMTiles, BN>, configured, map, a, splits, BN,
                          smem_bytes<4>(a, splits, 16 * kMTiles, BN, (int)sizeof(T)), stream);
  }
};

}  // namespace

// x [M, K] (dtype 0 = float32, 1 = bfloat16), w [K/2, N] packed int4
// (uint8), scale [K/128, N] float32, bias [N] or null (bias_dtype 0 =
// float32, 1 = bfloat16), out [M, N] (out_t 0 = float32, 1 = x's type); the
// plan (block_n, splits, rows_per_split, tile_rows, parts_apart) from
// kernels/split_k.py with w_bits=4. Every pointer 16-byte aligned. Returns
// the CUDA error of the launch (0 on success; cudaErrorInvalidValue for
// what the kernel does not take, or where the weight's tensor map cannot
// be made).
extern "C" int int4_matmul(int dtype, const void* x, const void* w, const void* scale, const void* bias,
                           int bias_dtype, void* out, int out_t, int M, int K, int N, int block_n, int splits,
                           int rows_per_split, int tile_rows, int parts_apart, void* stream) {
  return splitk::run<Int4Kernel, 4>(dtype, x, w, scale, bias, bias_dtype, out, out_t, M, K, N, block_n, splits,
                                    rows_per_split, tile_rows, parts_apart, stream);
}
