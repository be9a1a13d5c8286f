"""RMSNorm over the last dim, or over each of ``groups`` equal slices of it:
the wrapper of ``csrc/layer_norm.cu``'s RMS mode and its plain PyTorch
version.

The plain version is the hybrid backbone's arithmetic
(``models/hybrid_backbone.py``): ``(x · rsqrt(mean(x²) + eps)) · w`` in
float32 from ``x`` as stored, one rounding to ``out_dtype``. With
``groups`` G the mean runs over each group's ``D / G`` channels (the
Mamba-2 mixer's gated norm), and ``w`` spans all ``D``. Run eagerly it is
8 kernels a call from bf16 (the cast, the square, the mean, ``+ eps``, the
rsqrt, two products, the cast back) and 7 from float32, ~890 of the
~1,480 kernels of a granite-4.0-h-micro AR step. The kernel replaces no TPU
kernel: the JAX package has no hybrid backbone.

:func:`rms_norm` runs the plain version for CPU tensors and the CUDA kernel
for CUDA tensors (or raises): one launch, shaped by the fused LayerNorm's
:func:`~go_pocket_tts_tpu_torch.kernels.layer_norm.launch_plan`, one block a
row (a group's slice of a row). ``x`` (float32 or bfloat16) is contiguous;
``weight`` (float32 or bfloat16) is read as stored. It counts kernel
launches in ``rms_norm.launches``.
"""

from __future__ import annotations

import ctypes

import torch

from go_pocket_tts_tpu_torch.kernels import build
from go_pocket_tts_tpu_torch.kernels.layer_norm import _DTYPE_CODES, MAX_D, launch_plan

__all__ = ["rms_norm", "rms_norm_plain"]


def rms_norm_plain(
    x: torch.Tensor, weight: torch.Tensor, eps: float, out_dtype: torch.dtype, groups: int = 1
) -> torch.Tensor:
    """Plain PyTorch version: RMSNorm in float32 over each of ``groups``
    slices of the last dim, times ``weight``, one rounding to
    ``out_dtype``."""
    g = x.float().reshape(*x.shape[:-1], groups, -1)
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + eps)
    return (g.reshape(x.shape) * weight).to(out_dtype)


def _check(x: torch.Tensor, weight: torch.Tensor, out_dtype: torch.dtype, groups: int) -> int:
    """The width of a group's slice, after checking what the kernel takes."""
    for name, dtype in (("x", x.dtype), ("out_dtype", out_dtype), ("weight", weight.dtype)):
        if dtype not in _DTYPE_CODES:
            raise TypeError(f"rms_norm: {name} dtype {dtype} not supported (float32 or bfloat16)")
    d = x.shape[-1] if x.ndim else 0
    if groups <= 0 or d % groups or not 0 < d // groups <= MAX_D:
        raise ValueError(f"rms_norm: width {d} in {groups} groups: a group's width must lie in (0, {MAX_D}]")
    if not x.is_contiguous():
        raise ValueError("rms_norm: x must be contiguous")
    if tuple(weight.shape) != (d,) or not weight.is_contiguous() or weight.device != x.device:
        raise ValueError(f"rms_norm: weight must be contiguous [{d}] on {x.device}")
    return d // groups


def _lib() -> ctypes.CDLL:
    lib = build.library("layer_norm")
    fn = lib.rms_norm
    if fn.argtypes is None:
        i64, ptr = ctypes.c_longlong, ctypes.c_void_p
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_int] * 3 + [ptr, i64, ctypes.c_int, ctypes.c_int, ptr, ctypes.c_float, ptr]
                       + [ctypes.c_int] * 3 + [ptr])
    return lib


def rms_norm(
    x: torch.Tensor, weight: torch.Tensor, eps: float, out_dtype: torch.dtype, groups: int = 1
) -> torch.Tensor:
    """``rms_norm_plain``'s result in one launch on a CUDA tensor."""
    if not x.is_cuda:
        return rms_norm_plain(x, weight, eps, out_dtype, groups)
    d = _check(x, weight, out_dtype, groups)
    out = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    if out.numel() == 0:
        return out
    vec = 16 // x.element_size()
    if d % vec or x.data_ptr() % 16 or weight.data_ptr() % 16:
        vec = 1
    plan = launch_plan(d, vec)
    err = _lib().rms_norm(
        _DTYPE_CODES[x.dtype],
        _DTYPE_CODES[out_dtype],
        _DTYPE_CODES[weight.dtype],
        x.data_ptr(),
        x.numel() // d,
        d,
        groups,
        weight.data_ptr(),
        float(eps),
        out.data_ptr(),
        plan.vec,
        plan.tpr,
        plan.chunks,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"rms_norm: CUDA launch failed (cudaError {err})")
    rms_norm.launches += 1
    return out


rms_norm.launches = 0
