// One decode step of a Mamba-2 mixer, for sm_90a: the causal depthwise
// conv (width 4) with its state shift, softplus(dt + dt_bias), the float32
// state update h <- exp(dt*A)*h + dt*x (x) B, the readout y = h.C + D*x and
// the gate y*silu(z), in one launch (kernels/mamba2_step.py).
//
// Replaces no TPU kernel: the JAX package has no state-space layer. Run
// eagerly, the step is ~15 launches a layer, 36 layers an AR step at
// granite-4.0-h-micro's widths (H = 64 heads of P = 64, N = 128, G = 1).
//
// What bounds it on an H100: bytes. A layer's state is H*P*N float32 =
// 2 MiB, read and written once a step (4.19 MB of the ~4.3 MB a launch
// must move: the projection row, the conv state, weights and output are
// the rest); the operations (~5 a state element) are far below the
// card's rate. So the state streams through registers once: one block per
// (row, head, 16 rows of the head's [P, N] state), 8 threads a state row,
// each thread 4 float4 chunks interleaved so that a warp's 8 lanes read a
// row's 128 contiguous bytes at a time (coalesced) and the shared B and C
// values without bank conflicts. The conv, softplus and the gate are a few
// hundred scalars a block, computed from L2.
//
// The B and C channels' conv window is read by every block of a row, so
// their conv state cannot shift in place while blocks still read it. Each
// block counts itself on the caller's counter (`sync`, one int32 that is 0
// between launches) once its reads are done; the grid's last block (the
// count says so) shifts those channels for every row and sets the counter
// back to 0. No block waits on another, so the launch cannot deadlock
// whatever the card schedules, and it neither synchronises with the host
// nor allocates, so it captures into a CUDA graph. A block's own x
// channels shift in place: no other block reads them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kN = 128;       // state width N (d_state)
constexpr int kRows = 16;     // state rows a block updates
constexpr int kLanes = 8;     // threads a state row
constexpr int kChunks = kN / (4 * kLanes);  // float4 chunks a thread: 4
constexpr int kThreads = kRows * kLanes;    // 128
constexpr int kPast = 3;      // inputs the conv state holds (width - 1)

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float silu(float v) { return v / (1.0f + expf(-v)); }

// torch.nn.functional.softplus (beta 1, threshold 20).
__device__ __forceinline__ float softplus(float v) { return v > 20.0f ? v : log1pf(expf(v)); }

struct Args {
  const void* zxbcdt;  // [B, row_stride]: z [H*P] | xBC [conv_dim] | dt [H]
  long long row_stride;
  void* conv_state;    // [B, conv_dim, 3], zxbcdt's type
  const void* conv_w;  // [conv_dim, 4]
  const void* conv_b;  // [conv_dim]
  const float* dt_bias;  // [H]
  const float* a;        // [H]: -exp(A_log)
  const float* d;        // [H]
  float* ssm;            // [B, H, P, N]
  float* y;              // [B, H*P]
  int* sync;             // the grid's counter
  int B, H, P, G;
};

// The conv of channel c over its state and this step's input, bias, SiLU.
template <typename T, typename W>
__device__ __forceinline__ float conv_silu(const T* state, const W* w, const W* bias, T in) {
  float acc = 0.0f;
#pragma unroll
  for (int k = 0; k < kPast; ++k) acc += to_f(w[k]) * to_f(state[k]);
  acc += to_f(w[kPast]) * to_f(in);
  return silu(acc + to_f(*bias));
}

template <typename T, typename W>
__global__ void __launch_bounds__(kThreads) mamba2_step_kernel(Args a) {
  const int per_head = a.P / kRows;
  const int pb = blockIdx.x % per_head;
  const int h = (blockIdx.x / per_head) % a.H;
  const int b = blockIdx.x / (per_head * a.H);
  const int g = h / (a.H / a.G);
  const int d_inner = a.H * a.P;
  const int gn = a.G * kN;
  const int conv_dim = d_inner + 2 * gn;
  const T* row = static_cast<const T*>(a.zxbcdt) + (long long)b * a.row_stride;
  const T* xbc = row + d_inner;
  T* cs = static_cast<T*>(a.conv_state) + (long long)b * conv_dim * kPast;
  const W* cw = static_cast<const W*>(a.conv_w);
  const W* cb = static_cast<const W*>(a.conv_b);

  __shared__ float s_b[kN], s_c[kN], s_x[kRows], s_z[kRows];
  __shared__ float s_dt, s_da;
  __shared__ int s_last;

  const int t = threadIdx.x;
  // B and C of the head's group: read by every block of the row.
  for (int i = t; i < 2 * kN; i += kThreads) {
    const int c = d_inner + (i < kN ? g * kN + i : gn + g * kN + (i - kN));
    const float v = conv_silu(cs + (long long)c * kPast, cw + (long long)c * (kPast + 1), cb + c, xbc[c]);
    if (i < kN) {
      s_b[i] = v;
    } else {
      s_c[i - kN] = v;
    }
  }
  const int p0 = pb * kRows;
  if (t < kRows) {
    // This block's x channels: convolved, then shifted in place.
    const int c = h * a.P + p0 + t;
    T* st = cs + (long long)c * kPast;
    const T in = xbc[c];
    s_x[t] = conv_silu(st, cw + (long long)c * (kPast + 1), cb + c, in);
    const T s1 = st[1], s2 = st[2];
    st[0] = s1;
    st[1] = s2;
    st[2] = in;
  } else if (t < 2 * kRows) {
    s_z[t - kRows] = to_f(row[h * a.P + p0 + (t - kRows)]);
  } else if (t == 2 * kRows) {
    const float dt = softplus(to_f(row[d_inner + conv_dim + h]) + a.dt_bias[h]);
    s_dt = dt;
    s_da = expf(dt * a.a[h]);
  }
  __syncthreads();
  if (t == 0) {
    // Every thread of the block has read the B and C conv state.
    __threadfence();
    s_last = atomicAdd(a.sync, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (s_last) {
    // Every block has: shift the B and C channels of every row.
    __threadfence();
    for (int i = t; i < a.B * 2 * gn; i += kThreads) {
      const int bb = i / (2 * gn);
      const int c = d_inner + i % (2 * gn);
      T* st = static_cast<T*>(a.conv_state) + ((long long)bb * conv_dim + c) * kPast;
      const T in = static_cast<const T*>(a.zxbcdt)[(long long)bb * a.row_stride + d_inner + c];
      const T s1 = st[1], s2 = st[2];
      st[0] = s1;
      st[1] = s2;
      st[2] = in;
    }
    if (t == 0) *a.sync = 0;
  }

  // The state: row r of the block, chunks q*32 + lane*4 .. +3 of N.
  const int r = t / kLanes;
  const int lane = t % kLanes;
  const int p = p0 + r;
  float4* st = reinterpret_cast<float4*>(a.ssm + (((long long)b * a.H + h) * a.P + p) * kN);
  const float da = s_da;
  const float dtx = s_dt * s_x[r];
  float acc = 0.0f;
  float4 v[kChunks];
#pragma unroll
  for (int q = 0; q < kChunks; ++q) v[q] = st[q * kLanes + lane];
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const int n = q * 4 * kLanes + lane * 4;
    v[q].x = da * v[q].x + dtx * s_b[n];
    v[q].y = da * v[q].y + dtx * s_b[n + 1];
    v[q].z = da * v[q].z + dtx * s_b[n + 2];
    v[q].w = da * v[q].w + dtx * s_b[n + 3];
    acc += v[q].x * s_c[n] + v[q].y * s_c[n + 1] + v[q].z * s_c[n + 2] + v[q].w * s_c[n + 3];
    st[q * kLanes + lane] = v[q];
  }
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (lane == 0) {
    const float y = acc + a.d[h] * s_x[r];
    a.y[(long long)b * d_inner + h * a.P + p] = y * silu(s_z[r]);
  }
}

template <typename T, typename W>
int launch(const Args& a, cudaStream_t stream) {
  const int blocks = a.B * a.H * (a.P / kRows);
  mamba2_step_kernel<T, W><<<blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype, w_dtype: 0 float32, 1 bfloat16 (the projection and conv state;
// the conv weights). Returns a cudaError_t.
extern "C" int mamba2_step(int dtype, int w_dtype, const void* zxbcdt, long long row_stride, void* conv_state,
                           const void* conv_w, const void* conv_b, const void* dt_bias, const void* a, const void* d,
                           void* ssm, void* y, void* sync, int B, int H, int P, int N, int G, cudaStream_t stream) {
  if (N != kN || P % kRows != 0 || G <= 0 || H % G != 0 || B <= 0) return (int)cudaErrorInvalidValue;
  Args args{zxbcdt, row_stride, conv_state, conv_w, conv_b, static_cast<const float*>(dt_bias),
            static_cast<const float*>(a), static_cast<const float*>(d), static_cast<float*>(ssm),
            static_cast<float*>(y), static_cast<int*>(sync), B, H, P, G};
  if (dtype == 0 && w_dtype == 0) return launch<float, float>(args, stream);
  if (dtype == 0 && w_dtype == 1) return launch<float, __nv_bfloat16>(args, stream);
  if (dtype == 1 && w_dtype == 0) return launch<__nv_bfloat16, float>(args, stream);
  if (dtype == 1 && w_dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(args, stream);
  return (int)cudaErrorInvalidValue;
}
