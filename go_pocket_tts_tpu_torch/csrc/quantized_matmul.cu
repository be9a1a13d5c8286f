// INT8 weight-only skinny matmul, for sm_90a:
//
//   out[M, N] = (x[M, K] @ w[K, N]) * scale[N]     (float32 out)
//
// Replaces the Pallas TPU kernel `quantized_matmul`
// (go_pocket_tts_tpu/ops/pallas/quantized_matmul.py). Shapes are the
// reference's gate: M <= 64, K % 128 == 0, N % 256 == 0; x is float32 or
// bfloat16, w int8, scale float32.
//
// What bounds it on an H100: the weight read. At the AR step's M = 8 a
// 1024x4096 linear moves 4.2 MB of int8 and does 67 MFLOP, so the bytes
// (1.25 us at 3.35 TB/s) dwarf the operations; the design reads each weight
// byte once from device memory and spends nothing else on it:
//   - a block owns a 128-column x 128-row (K) weight tile and up to 8 rows
//     of x; its 8 warps split the tile's 128 K rows, 16 each. For each K row
//     a warp reads 128 contiguous weight bytes (4 int8 a lane, one 32-bit
//     load), converts them to float in registers and multiplies them into
//     8 x 4 float accumulators;
//   - the block's x rows (8 x 128) are staged in shared memory as float and
//     read as broadcasts;
//   - the 8 warps' partial sums are added in shared memory, multiplied by
//     the column scale, and added into the zeroed output with one float
//     atomicAdd per element: K is split over blocks so that even the
//     1024-column products launch enough blocks to cover the 132 SMs;
//   - M above 8 takes more blocks along grid z, which read the same weight
//     tile again (from L2: a whole layer's weights fit in its 50 MB).
// Products and sums are float32 (CUDA cores; at M <= 64 the tensor cores
// would buy nothing while the weight read is the bound).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 128;  // columns per block: 32 lanes x 4
constexpr int kBK = 128;  // K rows per block
constexpr int kMT = 8;    // x rows per block
constexpr int kRowsPerWarp = kBK / kWarps;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
quantized_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ scale, float* __restrict__ out,
                        int M, int K, int N) {
  __shared__ float xs[kMT][kBK];
  __shared__ float part[kWarps][kMT][kBN];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n0 = blockIdx.x * kBN;
  const int k0 = blockIdx.y * kBK;
  const int m0 = blockIdx.z * kMT;

  for (int i = tid; i < kMT * kBK; i += kThreads) {
    const int m = i / kBK, kk = i % kBK;
    xs[m][kk] = (m0 + m < M) ? to_f32(x[(size_t)(m0 + m) * K + k0 + kk]) : 0.f;
  }
  __syncthreads();

  float acc[kMT][4];
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  const int kw = warp * kRowsPerWarp;
  const int8_t* wp = w + (size_t)(k0 + kw) * N + n0 + lane * 4;
  char4 wv[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
    wv[r] = *reinterpret_cast<const char4*>(wp + (size_t)r * N);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const float w0 = (float)wv[r].x, w1 = (float)wv[r].y, w2 = (float)wv[r].z,
                w3 = (float)wv[r].w;
#pragma unroll
    for (int m = 0; m < kMT; ++m) {
      const float xv = xs[m][kw + r];
      acc[m][0] += xv * w0;
      acc[m][1] += xv * w1;
      acc[m][2] += xv * w2;
      acc[m][3] += xv * w3;
    }
  }
#pragma unroll
  for (int m = 0; m < kMT; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) part[warp][m][lane * 4 + j] = acc[m][j];
  __syncthreads();

  for (int i = tid; i < kMT * kBN; i += kThreads) {
    const int m = i / kBN, c = i % kBN;
    if (m0 + m >= M) continue;
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kWarps; ++v) s += part[v][m][c];
    atomicAdd(out + (size_t)(m0 + m) * N + n0 + c, s * scale[n0 + c]);
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* scale, void* out, int M, int K,
           int N, cudaStream_t stream) {
  if (M <= 0 || M > 64 || K % kBK != 0 || N % 256 != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(N / kBN, K / kBK, (M + kMT - 1) / kMT);
  quantized_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(scale), static_cast<float*>(out), M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype of x: 0 = float32, 1 = bfloat16. x [M, K], w [K, N] int8, scale [N]
// float32, out [M, N] float32 and zeroed by the caller. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int quantized_matmul(int dtype, const void* x, const void* w, const void* scale,
                                void* out, int M, int K, int N, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w, scale, out, M, K, N, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w, scale, out, M, K, N, s);
  return (int)cudaErrorInvalidValue;
}
