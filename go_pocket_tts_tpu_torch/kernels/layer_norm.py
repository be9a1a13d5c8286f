"""Fused LayerNorm with an optional adaLN modulate: the wrapper of
``csrc/layer_norm.cu`` and its plain PyTorch version.

The plain version is :func:`go_pocket_tts_tpu_torch.ops.layer_norm`
(LayerNorm over the last dim, two-pass mean and variance in float32, the
affine in float32, one rounding to ``x.dtype``) followed, with ``shift`` and
``scale``, by :func:`~go_pocket_tts_tpu_torch.ops.modulate`
(``h * (1 + scale) + shift`` in ``x.dtype``). The kernel replaces no TPU
kernel: the JAX package leaves both to XLA, which fuses each into one loop,
while the same chain run eagerly is 14 kernels a norm and 3 a modulate,
most of an AR step's kernels.

:func:`layer_norm` runs the plain version for CPU tensors and the CUDA
kernel for CUDA tensors (or raises): one launch, shaped by
:func:`launch_plan`, one block a row, for any row count. ``x`` may be any
strided ``[..., D]`` view (the Mimi transformer's is transposed): the
kernel takes its strides, and the output is contiguous. ``weight`` and ``bias`` are read
as stored, float32 or bfloat16; ``shift`` and ``scale`` are of ``x``'s type
and shape (broadcast to it), with rows of their own strides. It counts
kernel launches in ``layer_norm.launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from go_pocket_tts_tpu_torch.kernels import build
from go_pocket_tts_tpu_torch.ops.norms import layer_norm as _norm
from go_pocket_tts_tpu_torch.ops.norms import modulate

__all__ = ["layer_norm", "layer_norm_plain", "launch_plan", "LaunchPlan", "MAX_D"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 8192  # the widest row the kernel takes (a thread holds at most 32 floats of it)
THREADS = 256  # every block
TILE_SMEM = 44 * 1024  # shared memory of a staged tile, under the 48 KB a block gets without opting in


class LaunchPlan(NamedTuple):
    vec: int  # adjacent elements a chunk (16 bytes' worth, or 1)
    tpr: int  # threads a row (a block)
    chunks: int  # chunks a thread
    tile: int  # > 0: rows staged a block through shared memory (elements not adjacent)


def _pow2_at_least(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def launch_plan(d: int, vec: int, adjacent: bool = True) -> LaunchPlan:
    """The launch shape for rows of ``d`` elements read ``vec`` at a time,
    for any row count. Rows whose elements are not ``adjacent`` are staged
    a tile of rows a block. Otherwise a row lives in the registers of one
    block of up to 256 threads, one 16-byte chunk a thread where the row
    allows (one warp a row, 8 rows a block, was slower at 1024 rows of 1024
    on an H100: 5.1 against 3.6 µs)."""
    if not 0 < d <= MAX_D:
        raise ValueError(f"layer_norm: row width {d} outside (0, {MAX_D}]")
    if not adjacent:
        tile = min(32, TILE_SMEM // (4 * (d + 1)))
        return LaunchPlan(1, THREADS, 0, 1 << (tile.bit_length() - 1))
    if d % vec:
        raise ValueError(f"layer_norm: width {d} is not a multiple of {vec}")
    chunks = d // vec
    tpr = min(THREADS, -(-chunks // 32) * 32)
    return LaunchPlan(vec, tpr, _pow2_at_least(-(-chunks // tpr)), 0)


def layer_norm_plain(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    shift: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version: ``ops.layer_norm``, then ``ops.modulate``
    with ``shift`` and ``scale``."""
    out = _norm(x, weight, bias, eps)
    return out if shift is None else modulate(out, shift, scale)


def _rows(t: torch.Tensor) -> Optional[Tuple[int, int, int, int]]:
    """``(rows, inner, s_outer, s_inner)``: ``t``'s leading dims as
    ``outer x inner`` rows at those strides (adjacent dims merged), or None
    where they do not fold into two."""
    dims = []
    for n, s in zip(t.shape[:-1], t.stride()[:-1]):
        if n == 1:
            continue
        if dims and dims[-1][1] == s * n:
            dims[-1] = (dims[-1][0] * n, s)
        else:
            dims.append((n, s))
    if len(dims) > 2:
        return None
    (outer, s_outer), (inner, s_inner) = [(1, 0)] * (2 - len(dims)) + dims
    return outer * inner, inner, s_outer, s_inner


def _aligned(t: torch.Tensor, rows) -> bool:
    """Every row of ``t`` starts on 16 bytes."""
    es = t.element_size()
    _, _, s_outer, s_inner = rows
    return t.data_ptr() % 16 == 0 and (s_outer * es) % 16 == 0 and (s_inner * es) % 16 == 0


def _check(x, weight, bias, shift, scale) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"layer_norm: dtype {x.dtype} not supported")
    d = x.shape[-1] if x.ndim else 0
    if not 0 < d <= MAX_D:
        raise ValueError(f"layer_norm: row width {d} outside (0, {MAX_D}]")
    for name, t in (("weight", weight), ("bias", bias)):
        if t is None:
            continue
        if t.dtype not in _DTYPE_CODES or tuple(t.shape) != (d,) or not t.is_contiguous() or t.device != x.device:
            raise ValueError(f"layer_norm: {name} must be contiguous float32 or bfloat16 [{d}] on {x.device}")
    if weight is not None and bias is not None and weight.dtype != bias.dtype:
        raise ValueError("layer_norm: weight and bias of different dtypes")
    if (shift is None) != (scale is None):
        raise ValueError("layer_norm: shift and scale go together")
    for name, t in (("shift", shift), ("scale", scale)):
        if t is not None and (t.dtype != x.dtype or t.device != x.device):
            raise ValueError(f"layer_norm: {name} must be {x.dtype} on {x.device}")


def _lib() -> ctypes.CDLL:
    lib = build.library("layer_norm")
    fn = lib.layer_norm
    if fn.argtypes is None:
        i64, ptr = ctypes.c_longlong, ctypes.c_void_p
        fn.restype = ctypes.c_int
        fn.argtypes = (
            [ctypes.c_int, ctypes.c_int, ptr] + [i64] * 5 + [ctypes.c_int, ptr, ptr, ctypes.c_float]
            + [ptr, i64, i64, i64] * 2 + [ptr] + [ctypes.c_int] * 4 + [ptr]
        )
    return lib


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
    shift: Optional[torch.Tensor] = None,
    scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``layer_norm_plain``'s result, contiguous, in one launch on a CUDA
    tensor."""
    if not x.is_cuda:
        return layer_norm_plain(x, weight, bias, eps, shift, scale)
    _check(x, weight, bias, shift, scale)
    d = x.shape[-1]
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out
    x_rows = _rows(x)
    if x_rows is None:
        x = x.contiguous()
        x_rows = _rows(x)
    mod = []
    for t in (shift, scale):
        if t is None:
            continue
        t = torch.broadcast_to(t, x.shape)
        if t.stride(-1) != 1 or _rows(t) is None:
            t = t.contiguous()
        mod.append((t, _rows(t)))
    adjacent = x.stride(-1) == 1 or d == 1
    vec = 16 // x.element_size()
    if not (
        adjacent
        and d % vec == 0
        and _aligned(x, x_rows)
        and all(_aligned(t, r) for t, r in mod)
        and all(t is None or t.data_ptr() % 16 == 0 for t in (weight, bias))
    ):
        vec = 1
    plan = launch_plan(d, vec, adjacent)
    w_code = _DTYPE_CODES[(weight if weight is not None else bias if bias is not None else x).dtype]
    (sh, sh_rows), (sc, sc_rows) = mod if mod else ((None, (0, 1, 0, 0)),) * 2
    err = _lib().layer_norm(
        _DTYPE_CODES[x.dtype],
        w_code,
        x.data_ptr(),
        *x_rows[1:],
        x.stride(-1),
        x_rows[0],
        d,
        None if weight is None else weight.data_ptr(),
        None if bias is None else bias.data_ptr(),
        float(eps),
        None if sh is None else sh.data_ptr(),
        *sh_rows[1:],
        None if sc is None else sc.data_ptr(),
        *sc_rows[1:],
        out.data_ptr(),
        *plan,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"layer_norm: CUDA launch failed (cudaError {err})")
    layer_norm.launches += 1
    return out


layer_norm.launches = 0
