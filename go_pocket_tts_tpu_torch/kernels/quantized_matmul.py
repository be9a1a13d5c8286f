"""INT8 weight-only skinny matmul with its epilogue fused: the wrapper of
``csrc/quantized_matmul.cu`` and its plain PyTorch version.

Counterpart of ``go_pocket_tts_tpu/ops/pallas/quantized_matmul.py``
(``quantized_matmul``)::

    y[M, N] = (x[M, K] @ w_q[K, N]) * scale[N]      float32 out

and, with a ``bias`` or ``out_dtype=x.dtype``, of what ``apply_linear``
does next: ``y.to(x.dtype) + bias.to(x.dtype)``. ``x`` is bfloat16 or
float32, ``w_q`` int8, ``scale`` float32, ``bias`` float32 or bfloat16;
products and sums run in float32, and the per-column scale multiplies the
output, not the weight. :func:`supports` is the reference's gate
(``m <= 64``, ``k % 128 == 0``, ``n % 256 == 0``): the AR step's
activations, a few rows against a large weight, where the int8 weight read
is the whole cost.

:func:`quantized_matmul` runs the plain version for CPU tensors and the CUDA
kernel for CUDA tensors (or raises): one launch, cut by
:func:`~go_pocket_tts_tpu_torch.kernels.split_k.matmul_plan`, deterministic.
It counts kernel launches in ``quantized_matmul.launches``.
"""

from __future__ import annotations

from typing import Optional

import torch

from go_pocket_tts_tpu_torch.kernels import build, split_k

__all__ = ["quantized_matmul", "quantized_matmul_plain", "supports"]


def supports(m: int, k: int, n: int) -> bool:
    """Shapes the kernel takes (the reference's gate); other shapes take the
    plain product in ``params.apply_linear``."""
    return k % 128 == 0 and n % 256 == 0 and m <= 64


def quantized_matmul_plain(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version: widen the weight, multiply, scale; then, with
    a bias or an activation-dtype output, round to ``x.dtype`` and add the
    bias rounded to it."""
    y = torch.matmul(x.float(), w_q.float()) * scale.float()
    return split_k.plain_epilogue(y, x.dtype, bias, out_dtype)


def _check(x, w_q, scale, bias, out_dtype) -> None:
    split_k.check_types("quantized_matmul", x, out_dtype)
    if x.ndim != 2 or w_q.ndim != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"quantized_matmul: shapes {tuple(x.shape)} @ {tuple(w_q.shape)}")
    m, k = x.shape
    n = w_q.shape[1]
    if not (0 < m and supports(m, k, n)):
        raise ValueError(f"quantized_matmul: (m, k, n) = {(m, k, n)} outside the kernel's gate")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32 or tuple(scale.shape) != (n,):
        raise ValueError("quantized_matmul: w_q must be int8 [K, N] and scale float32 [N]")
    split_k.check_operands("quantized_matmul", x, bias, n, (("x", x), ("w_q", w_q), ("scale", scale)))


def quantized_matmul(
    x: torch.Tensor,
    w_q: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``(x @ w_q) * scale`` as float32 ``[M, N]``; with a ``bias`` or
    ``out_dtype=x.dtype``, ``T(that) + T(bias)`` (``T = x.dtype``), as
    ``out_dtype``."""
    if not x.is_cuda:
        return quantized_matmul_plain(x, w_q, scale, bias, out_dtype)
    x = x.contiguous()
    _check(x, w_q, scale, bias, out_dtype)
    fn = build.library("quantized_matmul").quantized_matmul
    out = split_k.launch(fn, x, w_q, scale, bias, out_dtype, w_bits=8)
    quantized_matmul.launches += 1
    return out


quantized_matmul.launches = 0
