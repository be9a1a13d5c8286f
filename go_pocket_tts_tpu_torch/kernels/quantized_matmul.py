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

import ctypes
from typing import Optional

import torch

from go_pocket_tts_tpu_torch.kernels import build
from go_pocket_tts_tpu_torch.kernels.split_k import matmul_plan

__all__ = ["quantized_matmul", "quantized_matmul_plain", "supports"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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
    if bias is not None or out_dtype != torch.float32:
        y = y.to(x.dtype)
        if bias is not None:
            y = y + bias.to(x.dtype)
    return y.to(out_dtype)


def _check(x, w_q, scale, bias, out_dtype) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"quantized_matmul: activation dtype {x.dtype} not supported")
    if out_dtype not in (torch.float32, x.dtype):
        raise TypeError(f"quantized_matmul: out_dtype {out_dtype} is neither float32 nor {x.dtype}")
    if x.ndim != 2 or w_q.ndim != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"quantized_matmul: shapes {tuple(x.shape)} @ {tuple(w_q.shape)}")
    m, k = x.shape
    n = w_q.shape[1]
    if not (0 < m and supports(m, k, n)):
        raise ValueError(f"quantized_matmul: (m, k, n) = {(m, k, n)} outside the kernel's gate")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32 or tuple(scale.shape) != (n,):
        raise ValueError("quantized_matmul: w_q must be int8 [K, N] and scale float32 [N]")
    if bias is not None and (bias.dtype not in _DTYPE_CODES or tuple(bias.shape) != (n,)):
        raise ValueError("quantized_matmul: bias must be float32 or bfloat16 [N]")
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale), ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"quantized_matmul: {name} must be contiguous on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"quantized_matmul: {name} must be 16-byte aligned")


def _lib() -> ctypes.CDLL:
    lib = build.library("quantized_matmul")
    fn = lib.quantized_matmul
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_int]
            + [ctypes.c_void_p] * 4
            + [ctypes.c_int, ctypes.c_void_p]
            + [ctypes.c_int] * 9
            + [ctypes.c_void_p]
        )
    return lib


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
    m, k = x.shape
    n = w_q.shape[1]
    plan = matmul_plan(m, k, n, x.element_size())
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = _lib().quantized_matmul(
        _DTYPE_CODES[x.dtype],
        x.data_ptr(),
        w_q.data_ptr(),
        scale.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        _DTYPE_CODES[bias.dtype] if bias is not None else 0,
        out.data_ptr(),
        int(out_dtype != torch.float32),
        m,
        k,
        n,
        plan.block_n,
        plan.splits,
        plan.rows_per_split,
        plan.tile_rows,
        int(plan.parts_apart),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"quantized_matmul: CUDA launch failed (cudaError {err})")
    quantized_matmul.launches += 1
    return out


quantized_matmul.launches = 0
