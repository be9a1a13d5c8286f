"""INT8 weight-only skinny matmul: the wrapper of ``csrc/quantized_matmul.cu``
and its plain PyTorch version.

Counterpart of ``go_pocket_tts_tpu/ops/pallas/quantized_matmul.py``
(``quantized_matmul``)::

    y[M, N] = (x[M, K] @ w_q[K, N]) * scale[N]      float32 out

``x`` is bfloat16 or float32, ``w_q`` int8, ``scale`` float32; products
and sums run in float32, and the per-column scale multiplies the output, not
the weight. :func:`supports` is the reference's gate (``m <= 64``,
``k % 128 == 0``, ``n % 256 == 0``): the AR step's activations, a few rows
against a large weight, where the int8 weight read is the whole cost.

:func:`quantized_matmul` runs the plain version for CPU tensors and the CUDA
kernel for CUDA tensors (or raises); it counts kernel launches in
``quantized_matmul.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from go_pocket_tts_tpu_torch.kernels import build

__all__ = ["quantized_matmul", "quantized_matmul_plain", "supports"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def supports(m: int, k: int, n: int) -> bool:
    """Shapes the kernel takes (the reference's gate); other shapes take the
    plain product in ``params.apply_linear``."""
    return k % 128 == 0 and n % 256 == 0 and m <= 64


def quantized_matmul_plain(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: widen the weight, multiply, scale."""
    return torch.matmul(x.float(), w_q.float()) * scale.float()


def _check(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"quantized_matmul: activation dtype {x.dtype} not supported")
    if x.ndim != 2 or w_q.ndim != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"quantized_matmul: shapes {tuple(x.shape)} @ {tuple(w_q.shape)}")
    m, k = x.shape
    n = w_q.shape[1]
    if not (0 < m and supports(m, k, n)):
        raise ValueError(f"quantized_matmul: (m, k, n) = {(m, k, n)} outside the kernel's gate")
    if w_q.dtype != torch.int8 or scale.dtype != torch.float32 or tuple(scale.shape) != (n,):
        raise ValueError("quantized_matmul: w_q must be int8 [K, N] and scale float32 [N]")
    for name, t in (("x", x), ("w_q", w_q), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"quantized_matmul: {name} must be contiguous on {x.device}")
    if w_q.data_ptr() % 4:
        raise ValueError("quantized_matmul: w_q must be 4-byte aligned")


def _lib() -> ctypes.CDLL:
    lib = build.library("quantized_matmul")
    fn = lib.quantized_matmul
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def quantized_matmul(x: torch.Tensor, w_q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``(x @ w_q) * scale`` as float32 ``[M, N]``."""
    if not x.is_cuda:
        return quantized_matmul_plain(x, w_q, scale)
    x = x.contiguous()
    _check(x, w_q, scale)
    m, k = x.shape
    n = w_q.shape[1]
    # The kernel splits K over blocks and adds each block's partial sum into
    # the output, so the output starts at zero.
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    err = _lib().quantized_matmul(
        _DTYPE_CODES[x.dtype],
        x.data_ptr(),
        w_q.data_ptr(),
        scale.data_ptr(),
        out.data_ptr(),
        m,
        k,
        n,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"quantized_matmul: CUDA launch failed (cudaError {err})")
    quantized_matmul.launches += 1
    return out


quantized_matmul.launches = 0
