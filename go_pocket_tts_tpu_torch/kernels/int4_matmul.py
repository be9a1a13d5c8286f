"""Packed-INT4 group-wise skinny matmul with its epilogue fused: the wrapper
of ``csrc/int4_matmul.cu`` and its plain PyTorch version.

Counterpart of ``go_pocket_tts_tpu/ops/pallas/int4_matmul.py``
(``int4_matmul``)::

    y[M, N] = Σ_g (x[:, rows of group g] @ depack(w_packed)[rows of group g, :]) * scale[g, :]

float32 out, and, with a ``bias`` or ``out_dtype=x.dtype``, of what
``apply_linear`` does next: ``y.to(x.dtype) + bias.to(x.dtype)``.
``w_packed`` is ``uint8 [K/2, N]`` with ``models/quantize.pack_int4_rows``'s
pairing (byte ``[i, j]``: input row ``2i`` in the low nibble, ``2i+1`` in the
high one, two's complement), ``scale`` float32 ``[K/128, N]``, ``x``
bfloat16 or float32, ``bias`` float32 or bfloat16. Products and sums run in
float32 and each group's scale multiplies its partial sum, never the weight.

The reference splits ``x`` into even and odd planes ``[2, M, K/2]`` before
its kernel (Mosaic cannot interleave sublanes); this kernel reads
``x [M, K]`` as it is, rows ``2i`` and ``2i+1`` side by side.

:func:`supports` is the reference's gate: ``M <= 64``, ``K % 128 == 0``,
``N % 256 == 0`` and a 2-D scale ``[K/128, N]`` (per-channel int4 never
reaches the kernel). :func:`int4_matmul` runs the plain version for CPU
tensors and the CUDA kernel for CUDA tensors (or raises): one launch, cut by
:func:`~go_pocket_tts_tpu_torch.kernels.split_k.matmul_plan` with
``w_bits=4``, deterministic. It counts kernel launches in
``int4_matmul.launches``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from go_pocket_tts_tpu_torch.kernels import build, split_k

__all__ = ["int4_matmul", "int4_matmul_plain", "supports", "GROUP_SIZE"]

GROUP_SIZE = 128  # input rows per scale row


def supports(m: int, k: int, n: int, scale_shape: Sequence[int]) -> bool:
    """Shapes the kernel takes (the reference's gate); other shapes take the
    plain split product in ``params.apply_linear``."""
    return (
        m <= 64
        and k % GROUP_SIZE == 0
        and n % 256 == 0
        and len(scale_shape) == 2
        and scale_shape[0] == k // GROUP_SIZE
    )


def _depack(w_packed: torch.Tensor) -> torch.Tensor:
    """``uint8 [K/2, N]`` → the int8 levels ``[K, N]`` (row ``2i + p``)."""
    ui = w_packed.view(torch.int8)
    return torch.stack([(ui << 4) >> 4, ui >> 4], dim=1).reshape(2 * w_packed.shape[0], w_packed.shape[1])


def int4_matmul_plain(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Plain PyTorch version, the kernel's arithmetic: per group of input
    rows a float32 partial product, times that group's scale, summed over
    the groups; then, with a bias or an activation-dtype output, round to
    ``x.dtype`` and add the bias rounded to it."""
    m, k = x.shape
    g, n = scale.shape
    xg = x.float().reshape(m, g, k // g).transpose(0, 1)  # [G, M, K/G]
    wg = _depack(w_packed).float().reshape(g, k // g, n)  # [G, K/G, N]
    y = (torch.bmm(xg, wg) * scale.float()[:, None, :]).sum(dim=0)
    return split_k.plain_epilogue(y, x.dtype, bias, out_dtype)


def _check(x, w_packed, scale, bias, out_dtype) -> None:
    split_k.check_types("int4_matmul", x, out_dtype)
    if x.ndim != 2 or w_packed.ndim != 2 or x.shape[1] != 2 * w_packed.shape[0]:
        raise ValueError(f"int4_matmul: shapes {tuple(x.shape)} @ packed {tuple(w_packed.shape)}")
    m, k = x.shape
    n = w_packed.shape[1]
    if not (0 < m and supports(m, k, n, tuple(scale.shape))):
        raise ValueError(
            f"int4_matmul: (m, k, n) = {(m, k, n)} with scale {tuple(scale.shape)} outside the kernel's gate"
        )
    if w_packed.dtype != torch.uint8 or scale.dtype != torch.float32:
        raise ValueError("int4_matmul: w_packed must be uint8 [K/2, N] and scale float32 [K/128, N]")
    split_k.check_operands("int4_matmul", x, bias, n, (("x", x), ("w_packed", w_packed), ("scale", scale)))


def int4_matmul(
    x: torch.Tensor,
    w_packed: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """``Σ_g (x_g @ depack(w_packed)_g) * scale[g]`` as float32 ``[M, N]``;
    with a ``bias`` or ``out_dtype=x.dtype``, ``T(that) + T(bias)``
    (``T = x.dtype``), as ``out_dtype``."""
    if not x.is_cuda:
        return int4_matmul_plain(x, w_packed, scale, bias, out_dtype)
    x = x.contiguous()
    _check(x, w_packed, scale, bias, out_dtype)
    fn = build.library("int4_matmul").int4_matmul
    out = split_k.launch(fn, x, w_packed, scale, bias, out_dtype, w_bits=4)
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0
