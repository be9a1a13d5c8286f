// Fused decode-step attention over a stacked KV cache, for sm_90a.
//
// Replaces the Pallas TPU kernel `decode_attention_step`
// (go_pocket_tts_tpu/ops/pallas/decode_attention.py). One launch per layer
// of an AR step (T = 1) does all of it:
//   1. RoPE of q and k_new at `offset`: rope(x)[2j] = x[2j]cos - x[2j+1]sin,
//      rope(x)[2j+1] = x[2j]sin + x[2j+1]cos in float32; the rotated q is
//      rounded to the activation type, as the reference rounds it before its
//      kernel, the rotated k to the cache type;
//   2. the append of rope(k_new) and v_new at row clamp(offset, 0, C-1) of
//      layer `layer`, in place on the [L,B,H,C,D] caches (Mosaic could not
//      prove that dynamic single-row store aligned, so the TPU kernel left it
//      to XLA; on Hopper it is an ordinary store);
//   3. per (b, h): softmax(q.K^T / sqrt(D) masked to slots <= offset).V.
// `offset` is read from device memory, so the AR loop never syncs with the
// host to launch it.
//
// What bounds it on an H100: the KV read, 1.3 MB per layer at C = 320, bf16,
// 16 heads (~0.4 us at 3.35 TB/s), far under the launch latency, at about 1
// FLOP a byte. The design is split_kv_attention.cuh's: each (b, h) is a
// cluster of up to 8 blocks that bulk-copy their share of the visible rows
// into shared memory, run one online-softmax pass, and merge over
// distributed shared memory; at B = 1, C = 320 that is 7 x 16 blocks for
// the 132 SMs. Every block rotates q itself; the
// block whose split holds the appended row writes it and puts it into its
// own tile.

#include "split_kv_attention.cuh"

namespace {

template <typename T>
int launch(const void* q, const void* k_new, const void* v_new, void* k_cache, void* v_cache,
           const void* offset, const void* rope_cos, const void* rope_sin, void* out, int BH,
           int C, int D, int layer, int max_seq, int splits, int rows_per_split,
           cudaStream_t stream) {
  if (D != splitkv::kD) return (int)cudaErrorInvalidValue;
  splitkv::Args<T, T> a = {};
  a.q = static_cast<const T*>(q);
  a.k_new = static_cast<const T*>(k_new);
  a.v_new = static_cast<const T*>(v_new);
  a.k_cache = static_cast<T*>(k_cache);
  a.v_cache = static_cast<T*>(v_cache);
  a.offsets = static_cast<const int32_t*>(offset);
  a.rope_cos = static_cast<const float*>(rope_cos);
  a.rope_sin = static_cast<const float*>(rope_sin);
  a.out = static_cast<T*>(out);
  // q, k_new, v_new are [B*H, D]: one "lane" per (b, h) pair, H = 1.
  a.q_sb = a.k_sb = a.v_sb = D;
  a.H = 1;
  a.BH = BH;
  a.C = C;
  a.layer = layer;
  a.max_seq = max_seq;
  a.rows_per_split = rows_per_split;
  a.lane_offsets = 0;
  a.write_past_end = 1;
  a.sm_scale = 1.0f / sqrtf((float)D);
  return splitkv::launch<T, T, false, true>(a, splits, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error of the launch (0
// on success). Caches are [L, B*H, C, D]; q/k_new/v_new/out [B*H, D]; rope
// tables [max_seq, D/2] float32; offset one int32; `splits` clusters of
// `rows_per_split` rows (split_kv.split_plan).
extern "C" int decode_attention_step(int dtype, const void* q, const void* k_new,
                                     const void* v_new, void* k_cache, void* v_cache,
                                     const void* offset, const void* rope_cos,
                                     const void* rope_sin, void* out, int BH, int C, int D,
                                     int layer, int max_seq, int splits, int rows_per_split,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k_new, v_new, k_cache, v_cache, offset, rope_cos, rope_sin, out,
                         BH, C, D, layer, max_seq, splits, rows_per_split, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k_new, v_new, k_cache, v_cache, offset, rope_cos, rope_sin,
                                 out, BH, C, D, layer, max_seq, splits, rows_per_split, s);
  return (int)cudaErrorInvalidValue;
}
