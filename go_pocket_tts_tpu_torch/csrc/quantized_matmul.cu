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
// in passes over the same buffers.

#include <cuda.h>
#include <cudaTypedefs.h>

#include <mutex>

#include "split_kv_attention.cuh"  // the mbarrier helpers of kernels 1 and 4

namespace {

using splitkv::from_f32;
using splitkv::mbar_expect_tx;
using splitkv::mbar_init;
using splitkv::mbar_init_fence;
using splitkv::mbar_wait;
using splitkv::smem_u32;
using splitkv::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkRows = 128;  // weight rows of one tile copy (and mbarrier)
constexpr int kMaxChunks = 16;   // tile copies of one pass
constexpr int kPad = 16;         // bytes after each staged x row
constexpr int kAlign = 1024;     // swizzled tiles' alignment
constexpr int kMaxSmem = 230400;  // dynamic: the 227 KB of a block, less 2 KB of static

struct Args {
  const void* x;
  const float* scale;
  const void* bias;  // nullptr: none
  void* out;
  int M, K, N;
  int rows_per_split;  // R, a multiple of 128
  int tile_rows;       // rows staged at once, a multiple of 128, <= min(R, 2048)
  int parts_apart;     // the partials have bytes of their own (else they reuse the staged rows')
  int bias_bf16;       // bias is bfloat16 (else float32)
  int out_t;           // out is of x's type (else float32)
};

// 16 bytes global -> shared.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src) : "memory");
}

// A 2-D tile of the weight's tensor map, columns c0.., rows r0.., into dst.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int r0,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(r0), "r"(smem_u32(bar))
      : "memory");
}

// Byte offset of (row r, byte b) of a tile of BN-byte rows as the tensor
// memory accelerator swizzles it (64-byte rows: SWIZZLE_64B, 128: 128B):
// the 16-byte chunk index XORed with bits 7.. of the offset.
template <int BN>
__device__ __forceinline__ int swz(int r, int b) {
  constexpr int kMask = BN == 64 ? 3 : 7;
  const int o = r * BN + b;
  return o ^ (((o >> 7) & kMask) << 4);
}

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

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// At the start, after fence.mbarrier_init (a release at cluster scope): a
// peer whose wait returns sees rank 0's barrier initialised and armed.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
// After the last read of the staged rows that the peers' partials reuse.
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__host__ __device__ size_t stage_bytes(const Args& a, int mt, int bn, int es) {
  return (size_t)a.tile_rows * bn + (size_t)mt * (a.tile_rows * es + kPad);
}

// Bytes from the aligned base: the staged rows, then the warps' partials and
// rank 0's room for its peers' partials, apart or over the staged rows.
size_t smem_bytes(const Args& a, int splits, int mt, int bn, int es) {
  const size_t stage = stage_bytes(a, mt, bn, es);
  const size_t parts = (size_t)(kThreads / bn) * a.M * (bn + 4) * 4 + (size_t)(splits - 1) * a.M * bn * 4;
  return kAlign + (a.parts_apart ? stage + parts : (stage > parts ? stage : parts));
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
  constexpr int kRS = BN + 4;  // floats per row of the warps' partials (fewer bank conflicts)
  constexpr int kVecs = (kMT * BN / 4 + kThreads - 1) / kThreads;  // float4s of the result a thread owns

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
  const int mn = a.M * BN;
  const int m_vecs = mn / 4;

  unsigned char* slab = smem;
  unsigned char* xs = smem + (size_t)a.tile_rows * BN;
  const int x_row = a.tile_rows * kES + kPad;  // bytes per staged x row
  const T* xg = static_cast<const T*>(a.x);
  const int group = warp % kGroups, part = warp / kGroups;
  const int base = group * 32;  // the warp's first column in the tile
  const int g = lane >> 2, t = lane & 3;
  // The warps' partials, [part][M][kRS], then rank 0's room for its peers'
  // partials, [splits-1][M][BN]: after the staged rows (apart) or over them.
  float* red = reinterpret_cast<float*>(smem + (a.parts_apart ? stage_bytes(a, kMT, BN, kES) : 0));
  float* peers = red + (size_t)kParts * a.M * kRS;

  // Thread 0 asks for the pass's weight tiles, each 128 rows on its barrier.
  auto request_tiles = [&](int p0, int chunks) {
    for (int c = 0; c < chunks; ++c) {
      mbar_expect_tx(&bars[c], kChunkRows * BN);
      tma_load_2d(slab + c * kChunkRows * BN, &wmap, n0, k0 + p0 + c * kChunkRows, &bars[c]);
    }
  };
  if (tid == 0) {  // first of all: the weight is the critical path
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(&wmap)) : "memory");
    for (int c = 0; c < kMaxChunks; ++c) mbar_init(&bars[c], 1);
    mbar_init(&peers_bar, 1);
    if (split == 0 && splits > 1) mbar_expect_tx(&peers_bar, (uint32_t)((splits - 1) * mn * 4));
    mbar_init_fence();
    request_tiles(0, min(a.tile_rows, rows) / kChunkRows);
  }
  // The cluster barrier: arrive now where the peers' partials have bytes of
  // their own; the wait before a peer's store then finds rank 0 running.
  if (splits > 1 && a.parts_apart) cluster_arrive_relaxed();
  // The epilogue's operands (rank 0), copied while the tiles fly; they land
  // with x's first columns.
  if (split == 0 && tid < BN / 4) cp_async16(s_scale + 4 * tid, a.scale + n0 + 4 * tid);
  if (split == 0 && a.bias != nullptr && tid < BN / (a.bias_bf16 ? 8 : 4))
    cp_async16(s_bias + 16 * tid, static_cast<const unsigned char*>(a.bias) + (size_t)n0 * (a.bias_bf16 ? 2 : 4) + 16 * tid);

  float acc[kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i) acc[i] = 0.f;

  for (int p0 = 0, pass = 0; p0 < rows; p0 += a.tile_rows, ++pass) {
    const int pass_rows = min(a.tile_rows, rows - p0);
    const int chunks = pass_rows / kChunkRows;
    if (pass > 0) {
      __syncthreads();  // every warp is done with the last pass's rows
      if (tid == 0) request_tiles(p0, chunks);
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
  if (!a.parts_apart) {
    __syncthreads();  // every warp is done reading the staged rows
    if (splits > 1) cluster_arrive_release();
  }
  if constexpr (kMma) {
#pragma unroll
    for (int mi = 0; mi < kMTiles; ++mi)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // c[2h], c[2h+1]: row g + 8h, n-slots 2t and 2t+1 -> columns
          // base + 8t + j and base + 8t + 4 + j.
          const int m = 16 * mi + g + 8 * h;
          if (m < a.M) {
            float* dst = red + ((size_t)part * a.M + m) * kRS + base + 8 * t + j;
            dst[0] = acc[(mi * 4 + j) * 4 + 2 * h];
            dst[4] = acc[(mi * 4 + j) * 4 + 2 * h + 1];
          }
        }
  } else {
#pragma unroll
    for (int m = 0; m < kMT; ++m)
      if (m < a.M) red[((size_t)part * a.M + m) * kRS + base + lane] = acc[m];
  }
  __syncthreads();
  // This block's partial, 4 neighbouring columns of one row per float4,
  // the warps' parts added in order.
  float4 sum[kVecs];
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = tid + i * kThreads;
    sum[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (v < m_vecs) {
      const int m = v / (BN / 4), c = (v % (BN / 4)) * 4;
#pragma unroll
      for (int p = 0; p < kParts; ++p) {
        const float4 r = *reinterpret_cast<const float4*>(red + ((size_t)p * a.M + m) * kRS + c);
        sum[i].x += r.x;
        sum[i].y += r.y;
        sum[i].z += r.z;
        sum[i].w += r.w;
      }
    }
  }

  if (splits > 1) {
    cluster_wait();  // rank 0 is running (apart) or done with its rows
    if (split > 0) {
      // Into rank 0's shared memory; each store counts its bytes on rank 0's
      // barrier, so this block may exit at once.
      uint32_t dst, bar;
      asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(dst) : "r"(smem_u32(peers)));
      asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(bar) : "r"(smem_u32(&peers_bar)));
      dst += (uint32_t)((split - 1) * mn * 4);
#pragma unroll
      for (int i = 0; i < kVecs; ++i) {
        const int v = tid + i * kThreads;
        if (v < m_vecs)
          asm volatile(
              "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                  dst + 16u * v),
              "f"(sum[i].x), "f"(sum[i].y), "f"(sum[i].z), "f"(sum[i].w), "r"(bar)
              : "memory");
      }
      return;
    }
    mbar_wait(&peers_bar, 0);
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int v = tid + i * kThreads;
      if (v < m_vecs)
        for (int r = 0; r < splits - 1; ++r) {
          const float4 p = *reinterpret_cast<const float4*>(peers + (size_t)r * mn + 4 * v);
          sum[i].x += p.x;
          sum[i].y += p.y;
          sum[i].z += p.z;
          sum[i].w += p.w;
        }
    }
  }

  // Epilogue (rank 0): scale, then the cast and the bias add.
  const bool round_t = a.out_t || a.bias != nullptr;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = tid + i * kThreads;
    if (v >= m_vecs) continue;
    const int m = v / (BN / 4), c = (v % (BN / 4)) * 4;
    float y[4] = {sum[i].x, sum[i].y, sum[i].z, sum[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      y[e] = __fmul_rn(y[e], s_scale[c + e]);
      if (round_t) {
        y[e] = to_f32(from_f32<T>(y[e]));
        if (a.bias != nullptr) {
          const float b = a.bias_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(s_bias)[c + e])
                                      : reinterpret_cast<const float*>(s_bias)[c + e];
          y[e] = to_f32(from_f32<T>(__fadd_rn(y[e], to_f32(from_f32<T>(b)))));
        }
      }
    }
    const size_t o = (size_t)m * a.N + n0 + c;
    if (a.out_t) {
      T* dst = static_cast<T*>(a.out) + o;
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[e] = from_f32<T>(y[e]);
    } else {
      *reinterpret_cast<float4*>(static_cast<float*>(a.out) + o) = make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

// -- host: the weight's tensor map, cached by address and shape --------------

PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

struct MapEntry {
  const void* w;
  int K, N, bn;
  CUtensorMap map;
};

// The map of w [K, N] int8 with tiles of BN columns x 128 rows. Weights live
// as long as the model, so a few dozen entries serve every linear; a slot is
// overwritten when its address comes back with another shape.
bool weight_map(const void* w, int K, int N, int bn, CUtensorMap* out) {
  static std::mutex lock;
  static MapEntry cache[256];
  std::lock_guard<std::mutex> guard(lock);
  const size_t slot = (reinterpret_cast<uintptr_t>(w) >> 8) % 256;
  MapEntry& e = cache[slot];
  if (e.w == w && e.K == K && e.N == N && e.bn == bn) {
    *out = e.map;
    return true;
  }
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)K};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {(cuuint32_t)bn, (cuuint32_t)kChunkRows};
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap map;
  const CUresult r = fn(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box,
                        elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        bn == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return false;
  e = MapEntry{w, K, N, bn, map};
  *out = map;
  return true;
}

template <typename T, int kMTiles, int BN>
int launch(const CUtensorMap& map, const Args& a, int splits, cudaStream_t stream) {
  auto kernel = quantized_matmul_kernel<T, kMTiles, BN>;
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)splits, (unsigned)(a.N / BN), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes(a, splits, 16 * kMTiles, BN, (int)sizeof(T));
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;  // one split needs no cluster
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, map, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, int BN>
int launch_m(const CUtensorMap& map, const Args& a, int splits, cudaStream_t stream) {
  switch ((a.M + 15) / 16) {
    case 1: return launch<T, 1, BN>(map, a, splits, stream);
    case 2: return launch<T, 2, BN>(map, a, splits, stream);
    case 3: return launch<T, 3, BN>(map, a, splits, stream);
    default: return launch<T, 4, BN>(map, a, splits, stream);
  }
}

template <typename T>
int launch_t(const CUtensorMap& map, const Args& a, int bn, int splits, cudaStream_t stream) {
  return bn == 64 ? launch_m<T, 64>(map, a, splits, stream) : launch_m<T, 128>(map, a, splits, stream);
}

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
  Args a;
  a.x = x;
  a.scale = static_cast<const float*>(scale);
  a.bias = bias;
  a.out = out;
  a.M = M;
  a.K = K;
  a.N = N;
  a.rows_per_split = rows_per_split;
  a.tile_rows = tile_rows;
  a.parts_apart = parts_apart != 0;
  a.bias_bf16 = bias_dtype == 1;
  a.out_t = out_t != 0;
  const int es = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || M < 1 || M > 64 || K % 128 || N % 256 ||
      (block_n != 64 && block_n != 128) || splits < 1 || splits > 8 || rows_per_split < 128 ||
      rows_per_split % 128 || (long long)(splits - 1) * rows_per_split >= K ||
      (long long)splits * rows_per_split < K || tile_rows < 128 || tile_rows % 128 ||
      tile_rows > rows_per_split || tile_rows > kMaxChunks * kChunkRows || N / block_n > 65535 ||
      smem_bytes(a, splits, 16 * ((M + 15) / 16), block_n, es) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!weight_map(w, K, N, block_n, &map)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_t<float>(map, a, block_n, splits, s)
                    : launch_t<__nv_bfloat16>(map, a, block_n, splits, s);
}
