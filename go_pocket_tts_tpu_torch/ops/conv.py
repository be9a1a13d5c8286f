"""1-D convolutions with streaming (causal) semantics (counterpart of
``go_pocket_tts_tpu/ops/conv.py``).

- causal Conv1D: ``left_pad = (k-1)*dilation + 1 - stride`` (clamped at 0),
  right pad 0
- ConvTranspose1D: full output, then ``right_trim = k - stride`` samples cut
  from the tail

Weight layouts follow the reference package: Conv1d ``[out, in/groups, k]``;
ConvTranspose1d weights are kept REPACKED (:func:`repack_conv_transpose_kernel`,
``[out, in/groups, k]`` with the kernel flipped), the layout the fused SEANet
kernels read. The transposed convolutions undo the repack (a view-sized copy
of a small weight) and run ``F.conv_transpose1d``.

Products accumulate in float32 whatever the activation dtype, and the
result is cast to it before the bias add, as the reference does with
``preferred_element_type=float32``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

__all__ = [
    "conv1d",
    "causal_conv1d",
    "repack_conv_transpose_kernel",
    "unpack_conv_transpose_kernel",
    "conv_transpose1d_trim",
    "conv_transpose1d_phases",
]


def _add_bias(y: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    if bias is None:
        return y
    return y + bias.to(y.dtype)[None, :, None]


def conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    left_pad: int = 0,
    right_pad: int = 0,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """Conv1D over ``[B, C, T]`` with asymmetric explicit padding."""
    xp = F.pad(x.float(), (left_pad, right_pad))
    out = F.conv1d(xp, weight.float(), None, stride=stride, dilation=dilation, groups=groups)
    return _add_bias(out.to(x.dtype), bias)


def causal_conv1d(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    dilation: int = 1,
    groups: int = 1,
) -> torch.Tensor:
    """Streaming-causal Conv1D: left pad = effective_kernel - stride."""
    k = weight.shape[-1]
    eff_k = (k - 1) * dilation + 1
    return conv1d(x, weight, bias, stride, max(eff_k - stride, 0), 0, dilation, groups)


def repack_conv_transpose_kernel(weight: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """ConvTranspose1d weight ``[I, O/g, K]`` → forward-conv weight
    ``[O, I/g, K]``, kernel flipped. Done once at model load."""
    i_total, o_g, k = weight.shape
    i_g = i_total // groups
    w = weight.reshape(groups, i_g, o_g, k).flip(-1).transpose(1, 2)  # [g, O/g, I/g, K]
    return w.reshape(groups * o_g, i_g, k).contiguous()


def unpack_conv_transpose_kernel(repacked: torch.Tensor, groups: int = 1) -> torch.Tensor:
    """Inverse of :func:`repack_conv_transpose_kernel`."""
    o_total, i_g, k = repacked.shape
    o_g = o_total // groups
    w = repacked.reshape(groups, o_g, i_g, k).transpose(1, 2).flip(-1)  # [g, I/g, O/g, K]
    return w.reshape(groups * i_g, o_g, k)


def conv_transpose1d_trim(
    x: torch.Tensor,
    repacked_weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
    groups: int = 1,
    right_trim: Optional[int] = None,
) -> torch.Tensor:
    """ConvTranspose1D over ``[B, C, T]`` with right trim; the default trim
    ``K - stride`` yields exactly ``T*stride`` samples."""
    k = repacked_weight.shape[-1]
    if right_trim is None:
        right_trim = k - stride
    w = unpack_conv_transpose_kernel(repacked_weight.float(), groups)
    out = F.conv_transpose1d(x.float(), w, None, stride=stride, groups=groups)
    if right_trim > 0:
        out = out[:, :, : out.shape[2] - right_trim]
    elif right_trim < 0:  # K < stride: the last samples have no taps
        out = F.pad(out, (0, -right_trim))
    return _add_bias(out.to(x.dtype), bias)


def conv_transpose1d_phases(
    x: torch.Tensor,
    repacked_weight: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    stride: int = 1,
) -> torch.Tensor:
    """ConvTranspose1D with the streaming trim. The reference computes it as
    per-phase matmuls (an XLA lowering choice for the TPU); the arithmetic is
    that of :func:`conv_transpose1d_trim`, which this calls."""
    return conv_transpose1d_trim(x, repacked_weight, bias, stride, 1)
