// Batched decode-step attention with per-lane offsets, for sm_90a.
//
// Replaces the Pallas TPU kernel `batched_decode_attention`
// (go_pocket_tts_tpu/ops/pallas/batched_decode_attention.py), both of its
// variants. For one layer `layer` of the stacked [L,B,H,C,D] caches and one
// AR step of the continuous batcher, per lane b and head h:
//
//   out[b,h] = softmax(q[b,h].K[b,h]^T / sqrt(D) masked to slots <= offsets[b]).V[b,h]
//
// Offsets come from device memory, so the batcher's AR block never syncs
// with the host to launch it.
//   - float variant: caches bfloat16 or float32, the type of q;
//   - int8 variant: int8 caches with one float32 scale per row
//     ([L,B,H,C]); as in the reference's int8 kernel the scales distribute
//     over the products, scores = (k_i8 . q) * k_scale / sqrt(D) and
//     out = sum_t p_t * v_scale_t * v_i8_t, so no row is dequantized to
//     memory.
// Math is float32 throughout; the output is rounded once to q's type.
//
// Two entry kinds. The attention-only ones (the Pallas kernel's
// counterparts) read caches the caller has written. The fused step
// (batched_decode_attention_step) also does, in the same launch, what
// would otherwise be ~50 separate ops a layer of the batched transformer
// step: RoPE of q and k_new at each lane's clamp(offsets[b], 0, max_seq-1), int8 quantization of the k
// and v rows (int8 cache), and the row write at clamp(offsets[b], 0, C-1)
// only where offsets[b] < C; the rows and scales it writes are bit-equal to
// apply_rope_rows + quantize_kv_rows + the row scatter on the card.
//
// What bounds it on an H100: the read of each lane's visible rows. At
// B = 8, H = 16, C = 384 a full read is 12.6 MB of bf16 K+V (3.8 us at
// 3.35 TB/s) or 6.7 MB of int8 rows plus scales (2.0 us), ~1 FLOP a byte.
// Lane offsets differ, so with one block per pair the longest lane would
// set the time. The design is split_kv_attention.cuh's: each (lane, head)
// is a cluster of 2-4 blocks
// (split_kv.split_plan) that bulk-copy their share of the visible rows
// into shared memory, run one online-softmax pass and merge over
// distributed shared memory, so the longest lane's rows are read by 2-4
// SMs at once.

#include "split_kv_attention.cuh"

namespace {

template <typename QT, typename CT, bool kInt8, bool kAppend>
int launch(const void* q, long long q_sb, const void* k_new, long long k_sb, const void* v_new,
           long long v_sb, void* k_cache, void* v_cache, void* k_scale, void* v_scale,
           const void* offsets, const void* rope_cos, const void* rope_sin, void* out, int B,
           int H, int C, int D, int layer, int max_seq, int splits, int rows_per_split,
           cudaStream_t stream) {
  if (D != splitkv::kD) return (int)cudaErrorInvalidValue;
  splitkv::Args<QT, CT> a = {};
  a.q = static_cast<const QT*>(q);
  a.k_new = static_cast<const QT*>(k_new);
  a.v_new = static_cast<const QT*>(v_new);
  a.k_cache = static_cast<CT*>(k_cache);
  a.v_cache = static_cast<CT*>(v_cache);
  a.k_scale = static_cast<float*>(k_scale);
  a.v_scale = static_cast<float*>(v_scale);
  a.offsets = static_cast<const int32_t*>(offsets);
  a.rope_cos = static_cast<const float*>(rope_cos);
  a.rope_sin = static_cast<const float*>(rope_sin);
  a.out = static_cast<QT*>(out);
  a.q_sb = q_sb;
  a.k_sb = k_sb;
  a.v_sb = v_sb;
  a.H = H;
  a.BH = B * H;
  a.C = C;
  a.layer = layer;
  a.max_seq = max_seq;
  a.rows_per_split = rows_per_split;
  a.lane_offsets = 1;
  a.write_past_end = 0;
  a.sm_scale = 1.0f / sqrtf((float)D);
  return splitkv::launch<QT, CT, kInt8, kAppend>(a, splits, stream);
}

}  // namespace

// dtype of q, out and (float variant) the caches: 0 = float32, 1 = bfloat16.
// q/out [B*H, D]; caches [L, B*H, C, D]; row scales [L, B*H, C] float32;
// offsets [B] int32; `splits` clusters of `rows_per_split` rows
// (split_kv.split_plan). Each returns the CUDA error of the launch (0 on
// success).
extern "C" int batched_decode_attention(int dtype, const void* q, const void* k_cache,
                                        const void* v_cache, const void* offsets, void* out,
                                        int B, int H, int C, int D, int layer, int splits,
                                        int rows_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* kc = const_cast<void*>(k_cache);
  void* vc = const_cast<void*>(v_cache);
  if (dtype == 0)
    return launch<float, float, false, false>(q, H * D, nullptr, 0, nullptr, 0, kc, vc, nullptr,
                                              nullptr, offsets, nullptr, nullptr, out, B, H, C, D,
                                              layer, 1, splits, rows_per_split, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false, false>(
        q, H * D, nullptr, 0, nullptr, 0, kc, vc, nullptr, nullptr, offsets, nullptr, nullptr,
        out, B, H, C, D, layer, 1, splits, rows_per_split, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int batched_decode_attention_int8(int dtype, const void* q, const void* k_cache,
                                             const void* k_scale, const void* v_cache,
                                             const void* v_scale, const void* offsets,
                                             void* out, int B, int H, int C, int D, int layer,
                                             int splits, int rows_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* kc = const_cast<void*>(k_cache);
  void* vc = const_cast<void*>(v_cache);
  void* ks = const_cast<void*>(k_scale);
  void* vs = const_cast<void*>(v_scale);
  if (dtype == 0)
    return launch<float, int8_t, true, false>(q, H * D, nullptr, 0, nullptr, 0, kc, vc, ks, vs,
                                              offsets, nullptr, nullptr, out, B, H, C, D, layer,
                                              1, splits, rows_per_split, s);
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t, true, false>(q, H * D, nullptr, 0, nullptr, 0, kc, vc,
                                                      ks, vs, offsets, nullptr, nullptr, out, B,
                                                      H, C, D, layer, 1, splits,
                                                      rows_per_split, s);
  return (int)cudaErrorInvalidValue;
}

// The fused step. q, k_new, v_new are [B, H, 1, D] rows of D contiguous
// elements, heads D apart, lanes *_sb elements apart (views into the fused
// QKV projection need no copy); int8 = 1 takes int8 caches and row scales,
// else the caches have q's dtype; rope tables [max_seq, D/2] float32.
extern "C" int batched_decode_attention_step(int dtype, int int8, const void* q, long long q_sb,
                                             const void* k_new, long long k_sb,
                                             const void* v_new, long long v_sb, void* k_cache,
                                             void* v_cache, void* k_scale, void* v_scale,
                                             const void* offsets, const void* rope_cos,
                                             const void* rope_sin, void* out, int B, int H,
                                             int C, int D, int layer, int max_seq, int splits,
                                             int rows_per_split, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && int8)
    return launch<float, int8_t, true, true>(q, q_sb, k_new, k_sb, v_new, v_sb, k_cache, v_cache,
                                             k_scale, v_scale, offsets, rope_cos, rope_sin, out,
                                             B, H, C, D, layer, max_seq, splits, rows_per_split,
                                             s);
  if (dtype == 1 && int8)
    return launch<__nv_bfloat16, int8_t, true, true>(
        q, q_sb, k_new, k_sb, v_new, v_sb, k_cache, v_cache, k_scale, v_scale, offsets, rope_cos,
        rope_sin, out, B, H, C, D, layer, max_seq, splits, rows_per_split, s);
  if (dtype == 0)
    return launch<float, float, false, true>(q, q_sb, k_new, k_sb, v_new, v_sb, k_cache, v_cache,
                                             nullptr, nullptr, offsets, rope_cos, rope_sin, out,
                                             B, H, C, D, layer, max_seq, splits, rows_per_split,
                                             s);
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16, false, true>(
        q, q_sb, k_new, k_sb, v_new, v_sb, k_cache, v_cache, nullptr, nullptr, offsets, rope_cos,
        rope_sin, out, B, H, C, D, layer, max_seq, splits, rows_per_split, s);
  return (int)cudaErrorInvalidValue;
}
