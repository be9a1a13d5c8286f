// Fused LayerNorm over the last dim, with an optional adaLN modulate, for
// sm_90a.
//
// Replaces no TPU kernel: the JAX package leaves its `layer_norm`
// (go_pocket_tts_tpu/ops/norms.py) and `modulate` to XLA, which fuses each
// into one loop. Run eagerly, the port's same chain (ops/norms.py) is 14
// kernels a call (four dtype copies, two means, the subtractions, the
// square, the rsqrt, the affine) plus 3 for the modulate, about 300 of the
// ~460 kernels of an AR step. This kernel is that chain in one launch:
//
//   y   = T((x - mean) * rsqrt(var + eps) * w + b)      mean, var in float32
//   out = T(T(y * T(1 + scale)) + shift)                with the modulate
//
// with the two-pass mean and variance of ops/norms.py (the mean, then the
// mean of (x - mean)^2), each product and sum rounded as the eager chain
// rounds it (float32, then T = x's type where the eager ops produce T), so
// in bf16 the result equals the chain's up to the order of the row sums.
// The weight and bias are read as stored (bf16 or float32).
//
// What bounds it on an H100: nothing but latency. A [1, 1024] bf16 row is
// 2 KB in and 2 KB out (~1.2 ns of bandwidth); the AR step's 1 or 8 rows
// take the launch and two dependent reductions. So a row lives in
// registers after one 16-byte load a thread, both passes reduce from
// there (warp shuffles, then the warps' partials in shared memory), and
// there is one store. One block a row, of as many threads as the row has
// 16-byte chunks (kernels/layer_norm.py `launch_plan`), for any row count:
// at 1024 rows of 1024 it took 3.6 us where one warp a row and 8 rows a
// block took 5.1 (H100, bf16). A row whose elements are not adjacent (the Mimi
// transformer's transposed [B, T, C] view, stride T between channels) is
// staged through shared memory in tiles of rows read along the unit
// stride, so the load stays coalesced and no copy is made. The kernel
// neither synchronises with the host nor allocates, so it captures into a
// CUDA graph.
//
// The RMS mode (`rms_norm`, its own instantiations beside the LayerNorm's)
// is the hybrid backbone's RMSNorm (models/hybrid_backbone.py, two a layer,
// and the Mamba-2 mixer's gated norm over each group's channels), whose
// eager chain (kernels/rms_norm.py `rms_norm_plain`) is 7-8 kernels a call:
//
//   out = OT((x * rsqrt(sum(x^2) / D + eps)) * w)      in float32 from x as stored
//
// with one rounding, at the store; no mean, no bias, no modulate. The input
// and output types are separate (the gated norm reads float32 and writes
// the activations' type). Same row plan and reduction as the row path;
// contiguous rows only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // every block: 8 warps
constexpr int kMaxWarps = kThreads / 32;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16_rn(v); }

// The value of v once rounded to T.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

// N adjacent elements of U at p, widened: 16-byte loads where N elements
// fill whole 16-byte words (p is then 16-byte aligned), else one by one.
template <typename U, int N>
__device__ __forceinline__ void load(const U* p, float* f) {
  if constexpr ((N * sizeof(U)) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(U);
#pragma unroll
    for (int i = 0; i < N / kPer; ++i) {
      const int4 raw = __ldg(reinterpret_cast<const int4*>(p) + i);
      const U* e = reinterpret_cast<const U*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) f[i * kPer + j] = to_f(e[j]);
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) f[j] = to_f(p[j]);
  }
}

template <typename T, int N>
__device__ __forceinline__ void store(T* p, const float* f) {
  if constexpr ((N * sizeof(T)) % 16 == 0) {
    constexpr int kPer = 16 / sizeof(T);
#pragma unroll
    for (int i = 0; i < N / kPer; ++i) {
      int4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < kPer; ++j) e[j] = from_f<T>(f[i * kPer + j]);
      reinterpret_cast<int4*>(p)[i] = raw;
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) p[j] = from_f<T>(f[j]);
  }
}

// Row r of a tensor [..., D] whose leading dims are (outer, inner) with
// strides (s_outer, s_inner) in elements: its first element's offset.
struct Rows {
  long long inner, s_outer, s_inner;
  __device__ __forceinline__ long long at(long long r) const {
    return (r / inner) * s_outer + (r % inner) * s_inner;
  }
};

struct Args {
  const void* x;
  Rows xr;
  long long x_sd;  // stride between a row's elements (1: adjacent)
  long long rows;
  int D;
  float inv_d, eps;
  const void* w;  // [D] or null
  const void* b;  // [D] or null
  const void* shift;  // rows of [D], unit element stride, x's type; null: no modulate
  const void* scale;
  Rows sr, cr;  // shift's and scale's rows
  void* out;  // contiguous [rows, D], x's type
};

// The eager chain's arithmetic from (x - mean) on: affine in float32, one
// rounding to T, then the modulate, rounding after each op as T's eager
// ops do. Values, not pointers, so that nothing leaves the registers.
template <typename T>
__device__ __forceinline__ float finish(float xc, float rstd, bool has_w, float w, bool has_b, float b, bool mod,
                                        float sh, float sc) {
  float y = __fmul_rn(xc, rstd);
  if (has_w) y = __fmul_rn(y, w);
  if (has_b) y = __fadd_rn(y, b);
  const float h = round_to<T>(y);
  if (!mod) return h;
  const float s1 = round_to<T>(__fadd_rn(1.0f, sc));
  return round_to<T>(__fadd_rn(round_to<T>(__fmul_rn(h, s1)), sh));
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  return s;  // the same bits in every lane
}

// The sum over a row's `tpr` threads (the block), in the same order in
// each; `red` holds one partial a warp.
__device__ __forceinline__ float row_sum(float s, float* red, int tpr) {
  s = warp_sum(s);
  if (tpr <= 32) return s;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  s = 0.0f;
  for (int w = 0; w < tpr / 32; ++w) s += red[w];
  return s;
}

// A row in registers, one block (tpr threads) a row. Thread t holds chunks
// t, t + tpr, ... (kChunks of them) of VEC adjacent elements.
template <typename T, typename WT, int VEC, int kChunks>
__global__ void __launch_bounds__(kThreads) ln_rows_kernel(Args a) {
  __shared__ float red[2][kMaxWarps];
  const int tpr = blockDim.x;
  const long long row = blockIdx.x;
  const int chunks = a.D / VEC;
  const T* x = static_cast<const T*>(a.x) + a.xr.at(row);

  float v[kChunks][VEC];
  float s = 0.0f;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = threadIdx.x + k * tpr;
    if (c < chunks) {
      load<T, VEC>(x + (long long)c * VEC, v[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) s += v[k][j];
    }
  }
  const float mean = __fmul_rn(row_sum(s, red[0], tpr), a.inv_d);
  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    if (threadIdx.x + k * tpr < chunks) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[k][j] = __fsub_rn(v[k][j], mean);
        q = __fadd_rn(q, __fmul_rn(v[k][j], v[k][j]));
      }
    }
  }
  const float var = __fmul_rn(row_sum(q, red[1], tpr), a.inv_d);
  const float rstd = rsqrtf(__fadd_rn(var, a.eps));

  const WT* w = static_cast<const WT*>(a.w);
  const WT* b = static_cast<const WT*>(a.b);
  const T* shift = a.shift ? static_cast<const T*>(a.shift) + a.sr.at(row) : nullptr;
  const T* scale = a.shift ? static_cast<const T*>(a.scale) + a.cr.at(row) : nullptr;
  T* out = static_cast<T*>(a.out) + row * a.D;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = threadIdx.x + k * tpr;
    if (c >= chunks) continue;
    const long long e = (long long)c * VEC;
    float wv[VEC] = {}, bv[VEC] = {}, sh[VEC] = {}, sc[VEC] = {}, o[VEC];
    if (w) load<WT, VEC>(w + e, wv);
    if (b) load<WT, VEC>(b + e, bv);
    if (shift) {
      load<T, VEC>(shift + e, sh);
      load<T, VEC>(scale + e, sc);
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      o[j] = finish<T>(v[k][j], rstd, w != nullptr, wv[j], b != nullptr, bv[j], shift != nullptr, sh[j], sc[j]);
    store<T, VEC>(out + e, o);
  }
}

// Rows whose elements are not adjacent: a block stages `tile` rows in
// shared memory as float32 ([tile][D + 1]), reading them along whichever
// stride is the unit one (the row index varies fastest), then each warp
// normalises whole rows from there and writes them out adjacent.
template <typename T, typename WT>
__global__ void __launch_bounds__(kThreads) ln_tile_kernel(Args a, int tile) {
  extern __shared__ float smem[];
  __shared__ long long base[32];
  const int D = a.D, ld = D + 1;
  const long long r0 = (long long)blockIdx.x * tile;
  const int n = (int)min((long long)tile, a.rows - r0);
  if (threadIdx.x < n) base[threadIdx.x] = a.xr.at(r0 + threadIdx.x);
  __syncthreads();
  const T* x = static_cast<const T*>(a.x);
  for (int i = threadIdx.x; i < tile * D; i += kThreads) {
    const int r = i % tile, d = i / tile;
    if (r < n) smem[r * ld + d] = to_f(x[base[r] + d * a.x_sd]);
  }
  __syncthreads();

  const WT* w = static_cast<const WT*>(a.w);
  const WT* b = static_cast<const WT*>(a.b);
  const int lane = threadIdx.x & 31;
  for (int r = threadIdx.x >> 5; r < n; r += kMaxWarps) {
    const long long row = r0 + r;
    float* v = smem + r * ld;
    float s = 0.0f;
    for (int d = lane; d < D; d += 32) s += v[d];
    const float mean = __fmul_rn(warp_sum(s), a.inv_d);
    float q = 0.0f;
    for (int d = lane; d < D; d += 32) {
      const float xc = __fsub_rn(v[d], mean);
      v[d] = xc;
      q = __fadd_rn(q, __fmul_rn(xc, xc));
    }
    const float rstd = rsqrtf(__fadd_rn(__fmul_rn(warp_sum(q), a.inv_d), a.eps));
    const T* shift = a.shift ? static_cast<const T*>(a.shift) + a.sr.at(row) : nullptr;
    const T* scale = a.shift ? static_cast<const T*>(a.scale) + a.cr.at(row) : nullptr;
    T* out = static_cast<T*>(a.out) + row * D;
    for (int d = lane; d < D; d += 32) {
      const float wv = w ? to_f(w[d]) : 0.0f, bv = b ? to_f(b[d]) : 0.0f;
      const float sh = shift ? to_f(shift[d]) : 0.0f, sc = shift ? to_f(scale[d]) : 0.0f;
      out[d] = from_f<T>(finish<T>(v[d], rstd, w != nullptr, wv, b != nullptr, bv, shift != nullptr, sh, sc));
    }
  }
}

template <typename T, typename WT, int VEC, int kChunks>
void rows_launch(const Args& a, int tpr, cudaStream_t stream) {
  ln_rows_kernel<T, WT, VEC, kChunks><<<(unsigned)a.rows, tpr, 0, stream>>>(a);
}

// kChunks x VEC floats a thread stay in registers: at most 32.
template <typename T, typename WT, int VEC>
int rows_dispatch(const Args& a, int tpr, int chunks, cudaStream_t stream) {
  switch (chunks) {
    case 1: rows_launch<T, WT, VEC, 1>(a, tpr, stream); return 0;
    case 2: rows_launch<T, WT, VEC, 2>(a, tpr, stream); return 0;
    case 4: rows_launch<T, WT, VEC, 4>(a, tpr, stream); return 0;
  }
  if constexpr (VEC <= 4) {
    if (chunks == 8) { rows_launch<T, WT, VEC, 8>(a, tpr, stream); return 0; }
  }
  if constexpr (VEC == 1) {
    if (chunks == 16) { rows_launch<T, WT, VEC, 16>(a, tpr, stream); return 0; }
    if (chunks == 32) { rows_launch<T, WT, VEC, 32>(a, tpr, stream); return 0; }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T, typename WT>
int launch(const Args& a, int vec, int tpr, int chunks, int tile, cudaStream_t stream) {
  int err;
  if (tile > 0) {
    const size_t smem = (size_t)tile * (a.D + 1) * sizeof(float);
    if (tile > 32 || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
    const long long blocks = (a.rows + tile - 1) / tile;
    ln_tile_kernel<T, WT><<<(unsigned)blocks, kThreads, smem, stream>>>(a, tile);
    err = 0;
  } else if (tpr <= 0 || tpr % 32 || tpr > kThreads) {
    err = (int)cudaErrorInvalidValue;
  } else if (vec == 1) {
    err = rows_dispatch<T, WT, 1>(a, tpr, chunks, stream);
  } else if (vec == 16 / (int)sizeof(T)) {
    err = rows_dispatch<T, WT, 16 / sizeof(T)>(a, tpr, chunks, stream);
  } else {
    err = (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}

template <typename T>
int launch_w(int w_dtype, const Args& a, int vec, int tpr, int chunks, int tile, cudaStream_t stream) {
  if (w_dtype == 0) return launch<T, float>(a, vec, tpr, chunks, tile, stream);
  if (w_dtype == 1) return launch<T, __nv_bfloat16>(a, vec, tpr, chunks, tile, stream);
  return (int)cudaErrorInvalidValue;
}

// -- RMS mode ---------------------------------------------------------------

struct RmsArgs {
  const void* x;  // contiguous [rows, D], IT
  long long rows;
  int D, groups;
  float inv_d, eps;
  const void* w;  // [groups * D]: row r reads (r % groups) * D on
  void* out;  // contiguous [rows, D], OT
};

// The row path's plan, without the mean: the row in registers, the weight
// loaded before the one reduction so that its latency hides behind it.
template <typename IT, typename OT, typename WT, int VEC, int kChunks>
__global__ void __launch_bounds__(kThreads) rms_rows_kernel(RmsArgs a) {
  __shared__ float red[kMaxWarps];
  const int tpr = blockDim.x;
  const long long row = blockIdx.x;
  const int chunks = a.D / VEC;
  const IT* x = static_cast<const IT*>(a.x) + row * a.D;
  const WT* w = static_cast<const WT*>(a.w) + (row % a.groups) * a.D;

  float v[kChunks][VEC], wv[kChunks][VEC];
  float q = 0.0f;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = threadIdx.x + k * tpr;
    if (c < chunks) {
      load<IT, VEC>(x + (long long)c * VEC, v[k]);
      load<WT, VEC>(w + (long long)c * VEC, wv[k]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) q = __fadd_rn(q, __fmul_rn(v[k][j], v[k][j]));
    }
  }
  const float rstd = rsqrtf(__fadd_rn(__fmul_rn(row_sum(q, red, tpr), a.inv_d), a.eps));

  OT* out = static_cast<OT*>(a.out) + row * a.D;
#pragma unroll
  for (int k = 0; k < kChunks; ++k) {
    const int c = threadIdx.x + k * tpr;
    if (c >= chunks) continue;
    float o[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) o[j] = __fmul_rn(__fmul_rn(v[k][j], rstd), wv[k][j]);
    store<OT, VEC>(out + (long long)c * VEC, o);
  }
}

template <typename IT, typename OT, typename WT, int VEC, int kChunks>
void rms_launch(const RmsArgs& a, int tpr, cudaStream_t stream) {
  rms_rows_kernel<IT, OT, WT, VEC, kChunks><<<(unsigned)a.rows, tpr, 0, stream>>>(a);
}

// rows_dispatch's chunk counts: kChunks x VEC floats a thread, at most 32.
template <typename IT, typename OT, typename WT, int VEC>
int rms_dispatch(const RmsArgs& a, int tpr, int chunks, cudaStream_t stream) {
  switch (chunks) {
    case 1: rms_launch<IT, OT, WT, VEC, 1>(a, tpr, stream); return 0;
    case 2: rms_launch<IT, OT, WT, VEC, 2>(a, tpr, stream); return 0;
    case 4: rms_launch<IT, OT, WT, VEC, 4>(a, tpr, stream); return 0;
  }
  if constexpr (VEC <= 4) {
    if (chunks == 8) { rms_launch<IT, OT, WT, VEC, 8>(a, tpr, stream); return 0; }
  }
  if constexpr (VEC == 1) {
    if (chunks == 16) { rms_launch<IT, OT, WT, VEC, 16>(a, tpr, stream); return 0; }
    if (chunks == 32) { rms_launch<IT, OT, WT, VEC, 32>(a, tpr, stream); return 0; }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename IT, typename OT, typename WT>
int rms_vec(const RmsArgs& a, int vec, int tpr, int chunks, cudaStream_t stream) {
  int err;
  if (tpr <= 0 || tpr % 32 || tpr > kThreads) {
    err = (int)cudaErrorInvalidValue;
  } else if (vec == 1) {
    err = rms_dispatch<IT, OT, WT, 1>(a, tpr, chunks, stream);
  } else if (vec == 16 / (int)sizeof(IT)) {
    err = rms_dispatch<IT, OT, WT, 16 / sizeof(IT)>(a, tpr, chunks, stream);
  } else {
    err = (int)cudaErrorInvalidValue;
  }
  return err ? err : (int)cudaGetLastError();
}

template <typename IT, typename OT>
int rms_w(int w_dtype, const RmsArgs& a, int vec, int tpr, int chunks, cudaStream_t stream) {
  if (w_dtype == 0) return rms_vec<IT, OT, float>(a, vec, tpr, chunks, stream);
  if (w_dtype == 1) return rms_vec<IT, OT, __nv_bfloat16>(a, vec, tpr, chunks, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename IT>
int rms_out(int out_dtype, int w_dtype, const RmsArgs& a, int vec, int tpr, int chunks, cudaStream_t stream) {
  if (out_dtype == 0) return rms_w<IT, float>(w_dtype, a, vec, tpr, chunks, stream);
  if (out_dtype == 1) return rms_w<IT, __nv_bfloat16>(w_dtype, a, vec, tpr, chunks, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype (x, shift, scale, out) and w_dtype (weight and bias): 0 = float32,
// 1 = bfloat16. Row r of x starts at (r / x_inner) * x_so + (r % x_inner) *
// x_si elements, its elements x_sd apart; shift and scale likewise with
// their own (inner, s_outer, s_inner) and adjacent elements; out is [rows,
// D] contiguous. w, b, shift and scale may be null (shift and scale
// together). The launch shape (kernels/layer_norm.py `launch_plan`): `tile`
// > 0 stages `tile` rows a block (x_sd != 1); otherwise one block of `tpr`
// threads a row, `chunks` chunks of `vec` elements a thread.
// Returns the CUDA error of the launch (0 on success).
extern "C" int layer_norm(int dtype, int w_dtype, const void* x, long long x_inner, long long x_so,
                          long long x_si, long long x_sd, long long rows, int D, const void* w, const void* b,
                          float eps, const void* shift, long long s_inner, long long s_so, long long s_si,
                          const void* scale, long long c_inner, long long c_so, long long c_si, void* out,
                          int vec, int tpr, int chunks, int tile, void* stream) {
  if (rows <= 0 || D <= 0 || (shift == nullptr) != (scale == nullptr)) return (int)cudaErrorInvalidValue;
  Args a;
  a.x = x;
  a.xr = {x_inner, x_so, x_si};
  a.x_sd = x_sd;
  a.rows = rows;
  a.D = D;
  a.inv_d = 1.0f / (float)D;
  a.eps = eps;
  a.w = w;
  a.b = b;
  a.shift = shift;
  a.scale = scale;
  a.sr = {s_inner, s_so, s_si};
  a.cr = {c_inner, c_so, c_si};
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_w<float>(w_dtype, a, vec, tpr, chunks, tile, s);
  if (dtype == 1) return launch_w<__nv_bfloat16>(w_dtype, a, vec, tpr, chunks, tile, s);
  return (int)cudaErrorInvalidValue;
}

// The RMS mode. in_dtype (x), out_dtype (out) and w_dtype (w): 0 = float32,
// 1 = bfloat16. x and out are contiguous [rows, D]; w is [groups * D], row r
// scaled by its D elements from (r % groups) * D. The launch shape as
// `layer_norm`'s row path (kernels/layer_norm.py `launch_plan`, never a tile):
// one block of `tpr` threads a row, `chunks` chunks of `vec` elements a
// thread. Returns the CUDA error of the launch (0 on success).
extern "C" int rms_norm(int in_dtype, int out_dtype, int w_dtype, const void* x, long long rows, int D, int groups,
                        const void* w, float eps, void* out, int vec, int tpr, int chunks, void* stream) {
  if (rows <= 0 || D <= 0 || groups <= 0 || x == nullptr || w == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  RmsArgs a;
  a.x = x;
  a.rows = rows;
  a.D = D;
  a.groups = groups;
  a.inv_d = 1.0f / (float)D;
  a.eps = eps;
  a.w = w;
  a.out = out;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == 0) return rms_out<float>(out_dtype, w_dtype, a, vec, tpr, chunks, s);
  if (in_dtype == 1) return rms_out<__nv_bfloat16>(out_dtype, w_dtype, a, vec, tpr, chunks, s);
  return (int)cudaErrorInvalidValue;
}
