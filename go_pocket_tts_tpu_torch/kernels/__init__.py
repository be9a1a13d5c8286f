"""Hand-written CUDA kernels of the synthesis, streaming and batched serving
paths (sources in ``csrc/``).

=================================================  ===========================================
wrapper                                            replaces (go_pocket_tts_tpu/ops/pallas)
=================================================  ===========================================
decode_attention.decode_attention_step             decode_attention.py: decode_attention_step
seanet_tail.fused_seanet_up_tail                   seanet_tail.py: fused_seanet_up_tail
seanet_tail.fused_seanet_tail                      seanet_tail.py: fused_seanet_tail
batched_decode_attention.batched_decode_attention  batched_decode_attention.py (float caches)
batched_decode_attention.batched_decode_attention_int8  batched_decode_attention.py (int8 caches)
quantized_matmul.quantized_matmul                  quantized_matmul.py: quantized_matmul
int4_matmul.int4_matmul                            int4_matmul.py: int4_matmul
seanet_tail.fused_up2_res                          seanet_tail.py: fused_up2_res
seanet_tail.fused_up2_up3_tail (and its stream)    seanet_tail.py: fused_up2_up3_tail
layer_norm.layer_norm                              none (``ops/norms.py``: layer_norm, modulate)
mamba2_step.mamba2_step                            none (the hybrid backbone's Mamba-2 decode step)
rms_norm.rms_norm                                  none (the hybrid backbone's RMSNorms)
=================================================  ===========================================

Each wrapper runs its plain PyTorch version for CPU tensors and launches its
kernel for CUDA tensors (or raises), counting launches in ``.launches``;
the four SEANet wrappers and the Mamba-2 step also count them by input
shape in ``.shapes``.
The batcher calls ``batched_decode_attention.batched_decode_attention_step``,
the same kernel with the step's RoPE, int8 row quantization and row write
fused in; its launches count under the attention wrapper of its cache kind.
Kernels 1 and 4 share ``csrc/split_kv_attention.cuh`` and
``split_kv.split_plan``; kernels 5 and 6 share ``csrc/split_k_matmul.cuh``
and ``split_k.matmul_plan``; the four SEANet kernels (2, 3, 7, 8) in
bfloat16 share ``csrc/seanet_mma.cuh`` (implicit-GEMM convolutions on
``mma.sync``; kernels 2, 3 and 8 its up3-tail stages), and every
tensor-core kernel the helpers of ``csrc/mma_sync.cuh``. The fused
LayerNorm (with the adaLN modulate as an optional epilogue) replaces no TPU
kernel: XLA fused the JAX package's norm, and the port ran it as ~14 eager
kernels a call. Nor does the Mamba-2 decode step (conv, softplus, the
float32 state update, readout and gate in one launch a layer): the JAX
package has no state-space layer; the hybrid backbone
(``models/hybrid_backbone.py``) calls it. Nor does the RMS mode of the
fused norm's source (the hybrid backbone's RMSNorms, its gated norm's
groups included, ~7-8 eager kernels a call), its own instantiations and C
entry beside the LayerNorm's.

No wrapper falls back on its own. A runtime built with ``pallas=False``
(``--runtime-pallas off``) keeps every call off the wrappers instead: the
transformer and Mimi configs' ``use_kernels`` flags send kernels 1, 2, 3,
4, 7 and 8's call sites and the layer norms' (the transformer's flag also
covers the FlowLM's output norm and the flowNet) to the plain versions, and
the quantized linears' backends (``models/params.py``) kernels 5 and 6's;
so no launch count moves.
Under a tensor-parallel mesh kernels 4, 5 and 6 run on each rank's shard
(``H/tp`` heads, ``N/tp`` columns or ``K/tp`` rows).
"""

from go_pocket_tts_tpu_torch.kernels import (
    batched_decode_attention,
    decode_attention,
    int4_matmul,
    layer_norm,
    mamba2_step,
    quantized_matmul,
    rms_norm,
    seanet_tail,
)

WRAPPERS = (
    decode_attention.decode_attention_step,
    seanet_tail.fused_seanet_up_tail,
    seanet_tail.fused_seanet_tail,
    batched_decode_attention.batched_decode_attention,
    batched_decode_attention.batched_decode_attention_int8,
    quantized_matmul.quantized_matmul,
    int4_matmul.int4_matmul,
    seanet_tail.fused_up2_res,
    seanet_tail.fused_up2_up3_tail,
    layer_norm.layer_norm,
    mamba2_step.mamba2_step,
    rms_norm.rms_norm,
)

# Per wrapper (same order): its CUDA source, the TPU kernel it replaces and
# the units its arithmetic runs on.
META = (
    {
        "source": "go_pocket_tts_tpu_torch/csrc/decode_attention.cu",
        "replaces": "go_pocket_tts_tpu/ops/pallas/decode_attention.py:92",
        "units": "CUDA cores (float32 arithmetic)",
    },
    {
        "source": "go_pocket_tts_tpu_torch/csrc/seanet_tail.cu",
        "replaces": "go_pocket_tts_tpu/ops/pallas/seanet_tail.py:251",
        "units": "bf16 on tensor cores (mma.sync m16n8k16), float32 on CUDA cores",
    },
    {
        "source": "go_pocket_tts_tpu_torch/csrc/seanet_tail.cu",
        "replaces": "go_pocket_tts_tpu/ops/pallas/seanet_tail.py:108",
        "units": "bf16 on tensor cores (mma.sync m16n8k16), float32 on CUDA cores",
    },
    {
        "source": "go_pocket_tts_tpu_torch/csrc/batched_decode_attention.cu",
        "replaces": "go_pocket_tts_tpu/ops/pallas/batched_decode_attention.py:113",
        "units": "CUDA cores (float32 arithmetic)",
    },
    {
        "source": "go_pocket_tts_tpu_torch/csrc/batched_decode_attention.cu",
        "replaces": "go_pocket_tts_tpu/ops/pallas/batched_decode_attention.py:113",
        "units": "CUDA cores (float32 arithmetic)",
    },
    {
        "source": "go_pocket_tts_tpu_torch/csrc/quantized_matmul.cu",
        "replaces": "go_pocket_tts_tpu/ops/pallas/quantized_matmul.py:50",
        "units": "bf16 on tensor cores (mma.sync m16n8k16), float32 on CUDA cores",
    },
    {
        "source": "go_pocket_tts_tpu_torch/csrc/int4_matmul.cu",
        "replaces": "go_pocket_tts_tpu/ops/pallas/int4_matmul.py:99",
        "units": "bf16 on tensor cores (mma.sync m16n8k16), float32 on CUDA cores",
    },
    {
        "source": "go_pocket_tts_tpu_torch/csrc/seanet_up2.cu",
        "replaces": "go_pocket_tts_tpu/ops/pallas/seanet_tail.py:381",
        "units": "bf16 on tensor cores (mma.sync m16n8k16), float32 on CUDA cores",
    },
    {
        "source": "go_pocket_tts_tpu_torch/csrc/seanet_up2.cu",
        "replaces": "go_pocket_tts_tpu/ops/pallas/seanet_tail.py:569",
        "units": "bf16 on tensor cores (mma.sync m16n8k16), float32 on CUDA cores",
    },
    {
        # No Pallas kernel: the JAX package's norm, which XLA fuses.
        "source": "go_pocket_tts_tpu_torch/csrc/layer_norm.cu",
        "replaces": "go_pocket_tts_tpu/ops/norms.py:27",
        "units": "CUDA cores (float32 arithmetic)",
    },
    {
        # No TPU kernel (the JAX package has no state-space layer): the
        # eager chain of its plain version.
        "source": "go_pocket_tts_tpu_torch/csrc/mamba2_step.cu",
        "replaces": "go_pocket_tts_tpu_torch/kernels/mamba2_step.py:66",
        "units": "CUDA cores (float32 arithmetic)",
    },
    {
        # No TPU kernel (the JAX package has no hybrid backbone): the eager
        # chain of its plain version.
        "source": "go_pocket_tts_tpu_torch/csrc/layer_norm.cu",
        "replaces": "go_pocket_tts_tpu_torch/kernels/rms_norm.py:35",
        "units": "CUDA cores (float32 arithmetic)",
    },
)


def reset_launches() -> None:
    """Set every kernel's launch count to 0 (and empty the counts by input
    shape, ``.shapes``, of the wrappers that keep them)."""
    for fn in WRAPPERS:
        fn.launches = 0
        if hasattr(fn, "shapes"):
            fn.shapes = {}


__all__ = [
    "batched_decode_attention",
    "decode_attention",
    "int4_matmul",
    "layer_norm",
    "mamba2_step",
    "quantized_matmul",
    "rms_norm",
    "seanet_tail",
    "WRAPPERS",
    "META",
    "reset_launches",
]
