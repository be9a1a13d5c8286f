// INT8 weight-only skinny matmul with its epilogue fused, for sm_90a:
//
//   y[M, N] = (x[M, K] @ w[K, N]) * scale[N]                     (float32), or
//   y[M, N] = T((x @ w) * scale) + T(bias[N]), rounded once to T  (T = x's type)
//
// Replaces the Pallas TPU kernel `quantized_matmul`
// (go_pocket_tts_tpu/ops/pallas/quantized_matmul.py) and, with the second
// form, the cast and bias add that apply_linear runs after it. Shapes are the
// reference's gate: M <= 64, K % 128 == 0, N % 256 == 0; x is float32 or
// bfloat16, w int8 [K, N] row-major, scale float32, bias float32 or bfloat16.
//
// What bounds it on an H100: the weight read, and before that latency. At the
// AR step's M = 8 a 1024x4096 linear moves 4.2 MB of int8 and does 67 MFLOP,
// so the bytes (1.25 us at 3.35 TB/s) dwarf the operations; a call lasts a
// few microseconds, so whatever waits in line (a memset, a second pass, a
// thread busy issuing copies, dependent loads) shows in full. The design:
//   - one launch, grid (S, N / BN): the S blocks of a column tile form one
//     thread-block cluster (S <= 8, chosen on the host by kernels/split_k.py
//     for the largest grid of one block an SM) and split its K rows; no
//     memset, no atomics, no device scratch;
//   - at kernel start one thread asks the tensor memory accelerator for the
//     block's whole weight slab (R rows x BN columns, 8-64 KB) as 2-D tile
//     copies of 128 rows, each completing on its own mbarrier, so the whole
//     slab is in flight at once, no thread spends time issuing it, and the
//     warps start on the first 128 rows when they land. The tiles arrive
//     swizzled (16-byte chunks XORed by row), so the fragment loads below
//     spread over the banks. x's matching columns (<= 64 rows) come by
//     16-byte cp.async copies from every thread, into rows padded by 16
//     bytes;
//   - bfloat16 x runs on the tensor cores (mma.sync m16n8k16, float32
//     accumulation). A lane loads 4 weight bytes of 4 neighbouring columns
//     in each of rows k, k+1, k+8, k+9 and turns them exactly into bf16
//     pairs: the byte goes into the mantissa of 2^23 as a float (the int8
//     unpack of split_kv_attention.cuh), whose top 16 bits are then the bf16
//     (an int8 has at most 8 significant bits). The 4 columns of a lane are
//     the same n-slot of 4 mma tiles, so the [K, N] layout needs no
//     repacking. Products are
//     exact, as in the plain version; only the summation order differs.
//     float32 x (the parity dtype) takes exact float32 FMAs on CUDA cores in
//     the same skeleton;
//   - the 8 warps split the columns into 32-wide groups and the rows of each
//     group by k16 step; their partials go through shared memory in a fixed
//     order, then each non-zero rank of the cluster stores its [M, BN]
//     partial into rank 0's shared memory with asynchronous stores that
//     count their bytes on an mbarrier of rank 0 (distributed shared memory;
//     no second cluster barrier, a peer exits once its stores are issued),
//     and rank 0 adds the partials in rank order: the result is
//     deterministic, two calls are bit-equal. The one cluster barrier only
//     keeps a peer from storing before rank 0 is ready: every block arrives
//     at its start where rank 0 has room for the partials beside its tiles,
//     after its last read of them where the partials reuse those bytes (M
//     near 64), and waits before its stores;
//   - rank 0 applies the scale (copied into shared memory at the start)
//     and, for the second form, rounds to T, adds the bias rounded to T and
//     rounds again, as y.to(T) + b.to(T) does.
// A block stages at most `tile_rows` (<= 2048) rows at a time; a split longer
// than that (only where shared memory is short: M near 64 with a long K) runs
// in passes over the same buffers. The start, the combine, the epilogue and
// the host side are split_k_matmul.cuh's, shared with kernel 6
// (int4_matmul.cu); this file holds the body: the int8 tile into products.

#include "split_k_matmul.cuh"

namespace {

using namespace splitk;

// Byte j of u (an int8) as an exact float: flip the sign bit, put the byte
// into the mantissa of 2^23 and subtract 2^23 + 128.
__device__ __forceinline__ float byte_to_f32(uint32_t u, int j) {
  return __uint_as_float(__byte_perm(u ^ 0x80808080u, 0x4B000000u, 0x7540u + j)) - 8388736.0f;
}

// Four bf16 pairs from the same 4 columns of two rows: out[j] holds
// (lo byte j, hi byte j), the lower k in the low half as mma.sync wants.
__device__ __forceinline__ void bf16_pairs(uint32_t lo, uint32_t hi, uint32_t* out) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out[j] = __byte_perm(__float_as_uint(byte_to_f32(lo, j)), __float_as_uint(byte_to_f32(hi, j)),
                         0x7632u);
}

// kMTiles: 16-row tiles of x (M rounded up); BN: columns of the tile.
template <typename T, int kMTiles, int BN>
__global__ void __launch_bounds__(kThreads)
    quantized_matmul_kernel(const __grid_constant__ CUtensorMap wmap, const Args a) {
  constexpr bool kMma = sizeof(T) == 2;
  constexpr int kES = (int)sizeof(T);
  constexpr int kMT = 16 * kMTiles;
  constexpr int kGroups = BN / 32;          // 32-column groups of the tile
  constexpr int kParts = kWarps / kGroups;  // warps sharing a group, by k16 step
  constexpr int kSteps = kChunkRows / 16 / kParts;  // k16 steps of a warp in a chunk

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t bars[kMaxChunks];
  __shared__ __align__(8) uint64_t peers_bar;  // rank 0: its peers' partials have landed
  __shared__ __align__(16) float s_scale[BN];
  __shared__ __align__(16) unsigned char s_bias[BN * 4];  // float32 or bfloat16, as stored
  unsigned char* smem = smem_raw + ((kAlign - (smem_u32(smem_raw) & (kAlign - 1))) & (kAlign - 1));

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x, splits = gridDim.x;
  const int n0 = blockIdx.y * BN;
  const int k0 = split * a.rows_per_split;
  const int rows = min(a.rows_per_split, a.K - k0);  // > 0, a multiple of 128

  unsigned char* slab = smem;
  unsigned char* xs = smem + (size_t)a.tile_rows * BN;
  const int x_row = a.tile_rows * kES + kPad;  // bytes per staged x row
  const T* xg = static_cast<const T*>(a.x);
  const int group = warp % kGroups, part = warp / kGroups;
  const int base = group * 32;  // the warp's first column in the tile
  const int g = lane >> 2, t = lane & 3;

  start<8, BN>(&wmap, a, slab, bars, &peers_bar, s_bias, n0, k0, rows, split, splits);
  // The epilogue's scale (rank 0), copied while the tiles fly.
  if (split == 0 && tid < BN / 4) cp_async16(s_scale + 4 * tid, a.scale + n0 + 4 * tid);

  float acc[kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i) acc[i] = 0.f;

  for (int p0 = 0, pass = 0; p0 < rows; p0 += a.tile_rows, ++pass) {
    const int pass_rows = min(a.tile_rows, rows - p0);
    const int chunks = pass_rows / kChunkRows;
    if (pass > 0) {
      __syncthreads();  // every warp is done with the last pass's rows
      if (tid == 0) request_tiles<8, BN>(slab, &wmap, bars, n0, k0 + p0, chunks);
    }
    // x's columns of the pass, real rows only (the padded rows' products land
    // in accumulator rows that are never read).
    const int vx = pass_rows * kES / 16;
    for (int i = tid; i < a.M * vx; i += kThreads) {
      const int m = i / vx, v = i - m * vx;
      cp_async16(xs + m * x_row + v * 16, xg + (size_t)m * a.K + k0 + p0 + v * (16 / kES));
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // x and the barriers' init are visible to every thread

    for (int c = 0; c < chunks; ++c) {
      mbar_wait(&bars[c], pass & 1);
      const unsigned char* tile = slab + c * kChunkRows * BN;
      if constexpr (kMma) {
        uint32_t u[kSteps][4];
#pragma unroll
        for (int q = 0; q < kSteps; ++q) {
          // B: rows k+2t, k+2t+1, k+2t+8, k+2t+9 of the step, columns base+4g .. +3.
          const int r = (part + q * kParts) * 16 + 2 * t;
          const int b = base + 4 * g;
          u[q][0] = *reinterpret_cast<const uint32_t*>(tile + swz<BN>(r, b));
          u[q][1] = *reinterpret_cast<const uint32_t*>(tile + swz<BN>(r + 1, b));
          u[q][2] = *reinterpret_cast<const uint32_t*>(tile + swz<BN>(r + 8, b));
          u[q][3] = *reinterpret_cast<const uint32_t*>(tile + swz<BN>(r + 9, b));
        }
#pragma unroll
        for (int q = 0; q < kSteps; ++q) {
          const int k = c * kChunkRows + (part + q * kParts) * 16;  // row of the pass
          uint32_t b0[4], b1[4];
          bf16_pairs(u[q][0], u[q][1], b0);
          bf16_pairs(u[q][2], u[q][3], b1);
#pragma unroll
          for (int mi = 0; mi < kMTiles; ++mi) {
            uint32_t af[4];
            ldmatrix_x4(af, xs + (16 * mi + (lane & 15)) * x_row + (k + (lane >> 4) * 8) * 2);
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_bf16(&acc[(mi * 4 + j) * 4], af, b0[j], b1[j]);
          }
        }
      } else {
        // One column a lane, every x row, 4 k at a time.
#pragma unroll
        for (int q = 0; q < kSteps; ++q) {
          const int r0 = (part + q * kParts) * 16;
#pragma unroll
          for (int kk = 0; kk < 16; kk += 4) {
            const int k = c * kChunkRows + r0 + kk;
            float wv[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) wv[e] = (float)(int8_t)tile[swz<BN>(r0 + kk + e, base + lane)];
#pragma unroll
            for (int m = 0; m < kMT; ++m) {
              const float4 xv = *reinterpret_cast<const float4*>(xs + m * x_row + k * 4);
              acc[m] = fmaf(xv.x, wv[0], acc[m]);
              acc[m] = fmaf(xv.y, wv[1], acc[m]);
              acc[m] = fmaf(xv.z, wv[2], acc[m]);
              acc[m] = fmaf(xv.w, wv[3], acc[m]);
            }
          }
        }
      }
    }
  }
  float* red = reinterpret_cast<float*>(smem + (a.parts_apart ? stage_bytes<8>(a, kMT, BN, kES) : 0));
  float4 sum[result_vecs<kMTiles, BN>()];
  if (!combine<kMma, kMTiles, BN>(acc, sum, red, &peers_bar, a, split, splits)) return;
  epilogue<T, kMTiles, BN, true>(sum, s_scale, s_bias, a, n0);
}

struct Int8Kernel {
  template <typename T, int kMTiles, int BN>
  static int launch(const CUtensorMap& map, const Args& a, int splits, cudaStream_t stream) {
    static bool configured = false;  // one attribute call per instantiation
    return splitk::launch(quantized_matmul_kernel<T, kMTiles, BN>, configured, map, a, splits, BN,
                          smem_bytes<8>(a, splits, 16 * kMTiles, BN, (int)sizeof(T)), stream);
  }
};

}  // namespace

// x [M, K] (dtype 0 = float32, 1 = bfloat16), w [K, N] int8, scale [N]
// float32, bias [N] or null (bias_dtype 0 = float32, 1 = bfloat16), out
// [M, N] (out_t 0 = float32, 1 = x's type); the plan (block_n, splits,
// rows_per_split, tile_rows, parts_apart) from kernels/split_k.py. Every
// pointer 16-byte aligned. Returns the CUDA error of the launch (0 on
// success; cudaErrorInvalidValue for what the kernel does not take, or where
// the weight's tensor map cannot be made).
extern "C" int quantized_matmul(int dtype, const void* x, const void* w, const void* scale,
                                const void* bias, int bias_dtype, void* out, int out_t, int M,
                                int K, int N, int block_n, int splits, int rows_per_split,
                                int tile_rows, int parts_apart, void* stream) {
  return splitk::run<Int8Kernel, 8>(dtype, x, w, scale, bias, bias_dtype, out, out_t, M, K, N, block_n, splits,
                                    rows_per_split, tile_rows, parts_apart, stream);
}
