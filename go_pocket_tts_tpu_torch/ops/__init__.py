"""Compute ops of the port (counterpart of ``go_pocket_tts_tpu/ops``).

Plain PyTorch; the hand-written CUDA kernels live in
``go_pocket_tts_tpu_torch.kernels``.
"""

from go_pocket_tts_tpu_torch.ops.act import elu, gelu_erf, silu
from go_pocket_tts_tpu_torch.ops.attention import (
    attention_with_positions,
    attention_with_positions_int8kv,
)
from go_pocket_tts_tpu_torch.ops.conv import (
    causal_conv1d,
    conv1d,
    conv_transpose1d_phases,
    conv_transpose1d_trim,
    repack_conv_transpose_kernel,
)
from go_pocket_tts_tpu_torch.ops.norms import layer_norm, modulate, rms_norm_bessel
from go_pocket_tts_tpu_torch.ops.rope import apply_rope, apply_rope_rows, build_rope_tables, rope_rows

# Per-op parity budgets (atol, rtol) against the reference package; the same
# values as ``go_pocket_tts_tpu.ops.TOLERANCES``.
TOLERANCES = {
    "matmul": (1e-4, 1e-4),
    "linear": (1e-4, 1e-4),
    "layer_norm": (1e-4, 1e-4),
    "softmax": (1e-4, 1e-4),
    "attention": (2e-4, 2e-4),
    "rope": (2e-4, 2e-4),
    "conv1d": (2e-4, 2e-4),
    "conv_transpose1d": (2e-4, 2e-4),
}

__all__ = [
    "elu",
    "gelu_erf",
    "silu",
    "layer_norm",
    "modulate",
    "rms_norm_bessel",
    "apply_rope",
    "apply_rope_rows",
    "build_rope_tables",
    "rope_rows",
    "attention_with_positions",
    "attention_with_positions_int8kv",
    "causal_conv1d",
    "conv1d",
    "conv_transpose1d_phases",
    "conv_transpose1d_trim",
    "repack_conv_transpose_kernel",
    "TOLERANCES",
]
