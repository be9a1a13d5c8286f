// Packed-INT4 group-wise skinny matmul, for sm_90a:
//
//   out[M, N] = sum_g (x[M, rows of group g] @ depack(w)[rows of group g, N]) * scale[g, N]
//
// (float32 out). Replaces the Pallas TPU kernel `int4_matmul`
// (go_pocket_tts_tpu/ops/pallas/int4_matmul.py). Shapes are the reference's
// gate: M <= 64, K % 128 == 0, N % 256 == 0, scale [K/128, N] float32; x is
// float32 or bfloat16 [M, K]; w is uint8 [K/2, N], byte [i, j] holding input
// row 2i in its low nibble and row 2i+1 in its high nibble, two's
// complement (models/quantize.py pack_int4_rows). The reference splits x
// into even and odd planes because Mosaic cannot interleave sublanes; here
// x is read as it is, rows 2i and 2i+1 side by side in shared memory.
//
// What bounds it on an H100: the weight read. At the AR step's M = 8 a
// 1024x4096 linear moves 2.1 MB of packed weight (+ 0.13 MB of scales) and
// does 67 MFLOP, so the bytes (0.7 us at 3.35 TB/s) dwarf the operations;
// the design reads each weight byte once from device memory and spends
// nothing else on it:
//   - a block owns 128 columns x one group (128 K rows = 64 packed rows)
//     and up to 8 rows of x; its 8 warps split the group's 64 packed rows,
//     8 each. For each packed row a lane reads 4 contiguous bytes (one
//     32-bit load, 8 weights over 4 columns), sign-extends the 8 nibbles in
//     registers with two shifts each and multiplies them into 8 x 4 float
//     accumulators against x[m, 2i] and x[m, 2i+1];
//   - the block's x rows (8 x 128) are staged in shared memory as float and
//     read as broadcasts;
//   - the 8 warps' partial sums are added in shared memory, multiplied by
//     the group's scale (the scale multiplies the partial, never the
//     weight) and added into the zeroed output with one float atomicAdd
//     per element: one block per group and column tile keeps even the
//     512-column products at 32 blocks and the 4096-column ones at 256;
//   - M above 8 takes more blocks along grid z, which read the same weight
//     tile again (from L2).
// Products and sums are float32 (CUDA cores; at M <= 64 the tensor cores
// would buy nothing while the weight read is the bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;                         // columns per block: 32 lanes x 4
constexpr int kGroup = 128;                      // K rows per scale row (and per block)
constexpr int kPacked = kGroup / 2;              // packed rows per block
constexpr int kMT = 8;                           // x rows per block
constexpr int kRowsPerWarp = kPacked / kWarps;   // packed rows per warp

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The nibble of byte j (0..3) of `word` at bit offset 4*h (h = 0 low, 1
// high), sign-extended: shift it to the top of a 32-bit int, then shift it
// back arithmetically. All 16 codes, -8 included, decode as the reference's
// depack does.
__device__ __forceinline__ float nibble(uint32_t word, int j, int h) {
  return (float)(((int)(word << (28 - 8 * j - 4 * h))) >> 28);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ scale, float* __restrict__ out,
                   int M, int K, int N) {
  __shared__ float xs[kMT][kGroup];
  __shared__ __align__(16) float part[kWarps][kMT][kBN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int g = blockIdx.y;
  const int k0 = g * kGroup;
  const int m0 = blockIdx.z * kMT;

  for (int i = tid; i < kMT * kGroup; i += kThreads) {
    const int m = i / kGroup, kk = i % kGroup;
    xs[m][kk] = (m0 + m < M) ? to_f32(x[(size_t)(m0 + m) * K + k0 + kk]) : 0.f;
  }
  __syncthreads();

  float acc[kMT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  const int pw = warp * kRowsPerWarp;  // the warp's first packed row in the group
  const uint8_t* wp = w + (size_t)(g * kPacked + pw) * N + n0 + lane * 4;
  uint32_t wv[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
    wv[r] = *reinterpret_cast<const uint32_t*>(wp + (size_t)r * N);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    float lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[j] = nibble(wv[r], j, 0);  // input row 2i
      hi[j] = nibble(wv[r], j, 1);  // input row 2i+1
    }
    const int kk = 2 * (pw + r);
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const float xe = xs[m][kk], xo = xs[m][kk + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] += xe * lo[j] + xo * hi[j];
    }
  }
#pragma unroll
  for (int m = 0; m < kMT; ++m)
    *reinterpret_cast<float4*>(&part[warp][m][lane * 4]) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();

  for (int i = tid; i < kMT * kBN; i += kThreads) {
    const int m = i / kBN, c = i % kBN;
    if (m0 + m >= M) continue;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) s += part[v][m][c];
    atomicAdd(out + (size_t)(m0 + m) * N + n0 + c, s * scale[(size_t)g * N + n0 + c]);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, void* out, int M, int K, int N,
           cudaStream_t stream) {
  if (M <= 0 || M > 64 || K <= 0 || K % kGroup != 0 || N % 256 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kBN, K / kGroup, (M + kMT - 1) / kMT);
  int4_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
      static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16. x [M, K], w [K/2, N] uint8 (4-byte
// aligned), scale [K/128, N] float32, out [M, N] float32 and zeroed by the
// caller. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int int4_matmul(int dtype, const void* x, const void* w, const void* scale, void* out,
                           int M, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, scale, out, M, K, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, scale, out, M, K, N, s);
  return (int)cudaErrorInvalidValue;
}
