"""Packed-INT4 group-wise skinny matmul: the wrapper of ``csrc/int4_matmul.cu``
and its plain PyTorch version.

Counterpart of ``go_pocket_tts_tpu/ops/pallas/int4_matmul.py``
(``int4_matmul``)::

    y[M, N] = Σ_g (x[:, rows of group g] @ depack(w_packed)[rows of group g, :]) * scale[g, :]

``w_packed`` is ``uint8 [K/2, N]`` with ``models/quantize.pack_int4_rows``'s
pairing (byte ``[i, j]``: input row ``2i`` in the low nibble, ``2i+1`` in the
high one, two's complement), ``scale`` float32 ``[K/128, N]``, ``x``
bfloat16 or float32; the output is float32. Products and sums run in
float32 and each group's scale multiplies its partial sum, never the weight.

The reference splits ``x`` into even and odd planes ``[2, M, K/2]`` before
its kernel (Mosaic cannot interleave sublanes); this kernel reads
``x [M, K]`` as it is, rows ``2i`` and ``2i+1`` side by side.

:func:`supports` is the reference's gate: ``M <= 64``, ``K % 128 == 0``,
``N % 256 == 0`` and a 2-D scale ``[K/128, N]`` (per-channel int4 never
reaches the kernel). :func:`int4_matmul` runs the plain version for CPU
tensors and the CUDA kernel for CUDA tensors (or raises); it counts kernel
launches in ``int4_matmul.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from go_pocket_tts_tpu_torch.kernels import build

__all__ = ["int4_matmul", "int4_matmul_plain", "supports", "GROUP_SIZE"]

GROUP_SIZE = 128  # input rows per scale row
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def int4_matmul_plain(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, the kernel's arithmetic: per group of input
    rows a float32 partial product, times that group's scale, summed over
    the groups."""
    m, k = x.shape
    g, n = scale.shape
    xg = x.float().reshape(m, g, k // g).transpose(0, 1)  # [G, M, K/G]
    wg = _depack(w_packed).float().reshape(g, k // g, n)  # [G, K/G, N]
    return (torch.bmm(xg, wg) * scale.float()[:, None, :]).sum(dim=0)


def _check(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"int4_matmul: activation dtype {x.dtype} not supported")
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
    for name, t in (("x", x), ("w_packed", w_packed), ("scale", scale)):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"int4_matmul: {name} must be contiguous on {x.device}")
    if w_packed.data_ptr() % 4:
        raise ValueError("int4_matmul: w_packed must be 4-byte aligned")


def _lib() -> ctypes.CDLL:
    lib = build.library("int4_matmul")
    fn = lib.int4_matmul
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    return lib


def int4_matmul(x: torch.Tensor, w_packed: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``Σ_g (x_g @ depack(w_packed)_g) * scale[g]`` as float32 ``[M, N]``."""
    if not x.is_cuda:
        return int4_matmul_plain(x, w_packed, scale)
    x = x.contiguous()
    _check(x, w_packed, scale)
    m, k = x.shape
    n = w_packed.shape[1]
    # Each block adds one group's scaled partial sum into the output, so the
    # output starts at zero.
    out = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    err = _lib().int4_matmul(
        _DTYPE_CODES[x.dtype],
        x.data_ptr(),
        w_packed.data_ptr(),
        scale.data_ptr(),
        out.data_ptr(),
        m,
        k,
        n,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"int4_matmul: CUDA launch failed (cudaError {err})")
    int4_matmul.launches += 1
    return out


int4_matmul.launches = 0
