// Split-K skinny matmul over a thread-block cluster, for sm_90a: what the
// int8 kernel (quantized_matmul.cu, kernel 5) and the packed-int4 kernel
// (int4_matmul.cu, kernel 6) share. Each kernel keeps its own body: how its
// staged weight tiles turn into float32 products. This header holds the
// skeleton around it, one design for both (quantized_matmul.cu's note
// says why it is built this way):
//   - the PTX helpers: 16-byte cp.async, 2-D TMA tile loads, the cluster
//     barrier (ldmatrix and mma.sync come from mma_sync.cuh);
//   - the swizzle of a staged tile, 64- or 128-byte rows;
//   - the start: thread 0 initialises the block's barriers and requests the
//     pass's weight tiles, kChunkRows K rows each on its own mbarrier, before
//     anything else; rank 0 copies the bias;
//   - the combine: the warps' accumulators through shared memory in a fixed
//     order, then each peer's [M, BN] partial stored into rank 0's shared
//     memory by st.async (distributed shared memory, bytes counted on an
//     mbarrier of rank 0), added there in rank order: deterministic;
//   - rank 0's epilogue: the per-column scale (kernel 5; kernel 6 scales
//     each group's partial before the combine), the rounding to x's type
//     and the bias add, as y.to(T) + b.to(T);
//   - on the host: the weight's tensor map, cached by address, shape and
//     BN; the checks of the C entry points; the cluster launch.
// The plan (BN, splits, rows per split, rows staged at once, where the
// partials live) comes from kernels/split_k.py, which mirrors
// stage_bytes/smem_bytes below.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>

#include <mutex>

#include "mma_sync.cuh"  // ldmatrix, mma.sync
#include "split_kv_attention.cuh"  // the mbarrier helpers of kernels 1 and 4

namespace splitk {

using mma::ldmatrix_x4;
using mma::mma_bf16;
using splitkv::from_f32;
using splitkv::mbar_expect_tx;
using splitkv::mbar_init;
using splitkv::mbar_init_fence;
using splitkv::mbar_wait;
using splitkv::smem_u32;
using splitkv::to_f32;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkRows = 128;  // K rows of one tile copy (and mbarrier); kernel 6: one scale group
constexpr int kMaxChunks = 16;   // tile copies of one pass
constexpr int kPad = 16;         // bytes after each staged x row
constexpr int kAlign = 1024;     // swizzled tiles' alignment
constexpr int kMaxSmem = 230400;  // dynamic: the 227 KB of a block, less 2 KB of static

struct Args {
  const void* x;
  const float* scale;  // [N] (kernel 5) or [K/128, N] (kernel 6)
  const void* bias;    // nullptr: none
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

// Bytes of one pass's staged operands: the weight's tile_rows K rows at
// kWBits a weight, for int4 their group scales (one float32 row of BN per
// 128 K rows), and x's columns, each row padded by kPad.
template <int kWBits>
__host__ __device__ size_t stage_bytes(const Args& a, int mt, int bn, int es) {
  const size_t scales = kWBits == 4 ? (size_t)(a.tile_rows / kChunkRows) * bn * 4 : 0;
  return (size_t)a.tile_rows * bn * kWBits / 8 + scales + (size_t)mt * (a.tile_rows * es + kPad);
}

// Bytes from the aligned base: the staged rows, then the warps' partials and
// rank 0's room for its peers' partials, apart or over the staged rows.
template <int kWBits>
size_t smem_bytes(const Args& a, int splits, int mt, int bn, int es) {
  const size_t stage = stage_bytes<kWBits>(a, mt, bn, es);
  const size_t parts = (size_t)(kThreads / bn) * a.M * (bn + 4) * 4 + (size_t)(splits - 1) * a.M * bn * 4;
  return kAlign + (a.parts_apart ? stage + parts : (stage > parts ? stage : parts));
}

// Thread 0: the tile copies of `chunks` x kChunkRows K rows from K row
// `row0`, each on its own barrier. A tile is kChunkRows * kWBits / 8 rows of
// the weight as stored (int8 [K, N]: 128 rows; packed int4 [K/2, N]: 64)
// by BN bytes.
template <int kWBits, int BN>
__device__ __forceinline__ void request_tiles(unsigned char* slab, const CUtensorMap* map, uint64_t* bars,
                                              int n0, int row0, int chunks) {
  constexpr int kRows = kChunkRows * kWBits / 8;
  for (int c = 0; c < chunks; ++c) {
    mbar_expect_tx(&bars[c], kRows * BN);
    tma_load_2d(slab + c * kRows * BN, map, n0, row0 * kWBits / 8 + c * kRows, &bars[c]);
  }
}

// The start of a block: thread 0 first of all (the weight is the critical
// path) initialises the barriers and requests the first pass's tiles; the
// cluster barrier is arrived at now where the peers' partials have bytes of
// their own (the wait before a peer's store then finds rank 0 running);
// rank 0 copies the bias (cp.async, landing with x's first columns).
template <int kWBits, int BN>
__device__ __forceinline__ void start(const CUtensorMap* map, const Args& a, unsigned char* slab, uint64_t* bars,
                                      uint64_t* peers_bar, unsigned char* s_bias, int n0, int k0, int rows,
                                      int split, int splits) {
  if (threadIdx.x == 0) {
    asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
    for (int c = 0; c < kMaxChunks; ++c) mbar_init(&bars[c], 1);
    mbar_init(peers_bar, 1);
    if (split == 0 && splits > 1) mbar_expect_tx(peers_bar, (uint32_t)((splits - 1) * a.M * BN * 4));
    mbar_init_fence();
    request_tiles<kWBits, BN>(slab, map, bars, n0, k0, min(a.tile_rows, rows) / kChunkRows);
  }
  if (splits > 1 && a.parts_apart) cluster_arrive_relaxed();
  if (split == 0 && a.bias != nullptr && (int)threadIdx.x < BN / (a.bias_bf16 ? 8 : 4))
    cp_async16(s_bias + 16 * threadIdx.x,
               static_cast<const unsigned char*>(a.bias) + (size_t)n0 * (a.bias_bf16 ? 2 : 4) + 16 * threadIdx.x);
}

// float4s of the [M, BN] result a thread owns.
template <int kMTiles, int BN>
__host__ __device__ constexpr int result_vecs() {
  return (16 * kMTiles * BN / 4 + kThreads - 1) / kThreads;
}

// The cluster's [M, BN] sum, into rank 0's `sum` (4 neighbouring columns
// of one row per float4, thread-strided), in a fixed order: each warp's
// accumulators (kMma: mma.sync fragments, the 4 columns of a lane the same
// n-slot of 4 tiles; else one column a lane) go into shared memory at
// `red`, the warps' parts are added in order, then each peer stores its
// partial into rank 0 and returns false (it may exit at once: its stores
// count their bytes on rank 0's barrier), and rank 0 adds them in rank
// order and returns true. `red` lies after the staged rows (apart) or over
// them, where every warp must first be done reading them.
template <bool kMma, int kMTiles, int BN>
__device__ __forceinline__ bool combine(const float* acc, float4* sum, float* red, uint64_t* peers_bar,
                                        const Args& a, int split, int splits) {
  constexpr int kMT = 16 * kMTiles;
  constexpr int kGroups = BN / 32;          // 32-column groups of the tile
  constexpr int kParts = kWarps / kGroups;  // warps sharing a group, by k16 step
  constexpr int kRS = BN + 4;  // floats per row of the warps' partials (fewer bank conflicts)
  constexpr int kVecs = result_vecs<kMTiles, BN>();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int group = warp % kGroups, part = warp / kGroups;
  const int base = group * 32;
  const int g = lane >> 2, t = lane & 3;
  const int mn = a.M * BN;
  const int m_vecs = mn / 4;
  // The warps' partials, [part][M][kRS], then rank 0's room for its peers'
  // partials, [splits-1][M][BN].
  float* peers = red + (size_t)kParts * a.M * kRS;

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
  // This block's partial, the warps' parts added in order.
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
      asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\n" : "=r"(bar) : "r"(smem_u32(peers_bar)));
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
      return false;
    }
    mbar_wait(peers_bar, 0);
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
  return true;
}

// Rank 0's epilogue: with kScale the per-column scale, then for the second
// form the cast and the bias add (T(y) + T(b), rounded again), stored as
// float32 or T.
template <typename T, int kMTiles, int BN, bool kScale>
__device__ __forceinline__ void epilogue(const float4* sum, const float* s_scale, const unsigned char* s_bias,
                                         const Args& a, int n0) {
  constexpr int kVecs = result_vecs<kMTiles, BN>();
  const int m_vecs = a.M * BN / 4;
  const bool round_t = a.out_t || a.bias != nullptr;
#pragma unroll
  for (int i = 0; i < kVecs; ++i) {
    const int v = threadIdx.x + i * kThreads;
    if (v >= m_vecs) continue;
    const int m = v / (BN / 4), c = (v % (BN / 4)) * 4;
    float y[4] = {sum[i].x, sum[i].y, sum[i].z, sum[i].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if constexpr (kScale) y[e] = __fmul_rn(y[e], s_scale[c + e]);
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

// -- host: the weight's tensor map, cached by address, shape and BN ---------

inline PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
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
  int rows, N, bn;
  CUtensorMap map;
};

// The map of the weight as stored, [rows, N] bytes, with tiles of BN
// columns x box_rows rows (box_rows is fixed per kernel). Weights live as
// long as the model, so a few dozen entries serve every linear; a slot is
// overwritten when its address comes back with another shape.
inline bool weight_map(const void* w, int rows, int N, int bn, int box_rows, CUtensorMap* out) {
  static std::mutex lock;
  static MapEntry cache[256];
  std::lock_guard<std::mutex> guard(lock);
  const size_t slot = (reinterpret_cast<uintptr_t>(w) >> 8) % 256;
  MapEntry& e = cache[slot];
  if (e.w == w && e.rows == rows && e.N == N && e.bn == bn) {
    *out = e.map;
    return true;
  }
  PFN_cuTensorMapEncodeTiled_v12000 fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)N, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)N};
  const cuuint32_t box[2] = {(cuuint32_t)bn, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUtensorMap map;
  const CUresult r = fn(&map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w), dims, strides, box,
                        elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        bn == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return false;
  e = MapEntry{w, rows, N, bn, map};
  *out = map;
  return true;
}

// kernel(map, a) on grid (splits, N / bn), the splits of a column tile one
// cluster; `configured` is the instantiation's one attribute call.
template <typename Kernel>
int launch(Kernel kernel, bool& configured, const CUtensorMap& map, const Args& a, int splits, int bn, size_t smem,
           cudaStream_t stream) {
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)splits, (unsigned)(a.N / bn), 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
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

// The C entry points' body: check what the kernel does not take, make the
// weight's map, and launch Kernel::launch<T, kMTiles, BN> (kMTiles: 16-row
// tiles of x, M rounded up). Returns the CUDA error of the launch (0 on
// success; cudaErrorInvalidValue for what the kernel does not take, or
// where the weight's tensor map cannot be made).
template <class Kernel, typename T, int BN>
int launch_m(const CUtensorMap& map, const Args& a, int splits, cudaStream_t stream) {
  switch ((a.M + 15) / 16) {
    case 1: return Kernel::template launch<T, 1, BN>(map, a, splits, stream);
    case 2: return Kernel::template launch<T, 2, BN>(map, a, splits, stream);
    case 3: return Kernel::template launch<T, 3, BN>(map, a, splits, stream);
    default: return Kernel::template launch<T, 4, BN>(map, a, splits, stream);
  }
}

template <class Kernel, typename T>
int launch_t(const CUtensorMap& map, const Args& a, int bn, int splits, cudaStream_t stream) {
  return bn == 64 ? launch_m<Kernel, T, 64>(map, a, splits, stream)
                  : launch_m<Kernel, T, 128>(map, a, splits, stream);
}

template <class Kernel, int kWBits>
int run(int dtype, const void* x, const void* w, const void* scale, const void* bias, int bias_dtype, void* out,
        int out_t, int M, int K, int N, int block_n, int splits, int rows_per_split, int tile_rows, int parts_apart,
        void* stream) {
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
      smem_bytes<kWBits>(a, splits, 16 * ((M + 15) / 16), block_n, es) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map;
  if (!weight_map(w, K * kWBits / 8, N, block_n, kChunkRows * kWBits / 8, &map)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 0 ? launch_t<Kernel, float>(map, a, block_n, splits, s)
                    : launch_t<Kernel, __nv_bfloat16>(map, a, block_n, splits, s);
}

}  // namespace splitk
