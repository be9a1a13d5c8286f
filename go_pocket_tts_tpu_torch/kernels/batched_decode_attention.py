"""Batched decode-step attention with per-lane offsets: the wrappers of
``csrc/batched_decode_attention.cu`` and their plain PyTorch versions.

Counterpart of ``go_pocket_tts_tpu/ops/pallas/batched_decode_attention.py``
(``batched_decode_attention``), both variants. For one AR step of the
continuous batcher and layer ``layer`` of the stacked ``[L,B,H,C,D]``
caches, each lane ``b`` attends to its own slots ``0..offsets[b]``::

    out[b,h] = softmax(q[b,h]·K[b,h]ᵀ/√D masked to slots <= offsets[b])·V[b,h]

- :func:`batched_decode_attention`: bfloat16/float32 caches of q's type;
- :func:`batched_decode_attention_int8`: int8 caches with float32 row
  scales ``[L,B,H,C]``; the scales distribute over the products as in the
  reference's int8 kernel (``scores = (k_i8·q)·k_scale/√D``,
  ``out = Σ p·v_scale·v_i8``).

The caller has already rotated ``q`` and written the step's rows; neither
version writes the caches. ``offsets`` is an int32 ``[B]`` tensor on the
caches' device (the kernel reads it there, so the AR block launches it
without a host sync); an offset at or past the capacity sees every slot.
Math is float32; the output has q's dtype.

Each wrapper runs its plain version for CPU tensors and its CUDA kernel for
CUDA tensors (or raises), counting kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from go_pocket_tts_tpu_torch.kernels import build
from go_pocket_tts_tpu_torch.ops.attention import masked_softmax

__all__ = [
    "batched_decode_attention",
    "batched_decode_attention_int8",
    "batched_decode_attention_plain",
    "batched_decode_attention_int8_plain",
]

HEAD_DIM = 64  # the only head width the CUDA kernel is built for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Scores live in dynamic shared memory (4 B a slot), under the 48 KB a
# launch gets unasked with the kernel's 2.1 KB of static shared memory.
_MAX_CAPACITY = 8192


def _plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    offsets: torch.Tensor,
    k_scale: Optional[torch.Tensor],
    v_scale: Optional[torch.Tensor],
) -> torch.Tensor:
    """One layer: q ``[B,H,1,D]``, k/v ``[B,H,C,D]``, scales ``[B,H,C]``."""
    c_cap = k.shape[2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))  # [B,H,1,C]
    if k_scale is not None:
        scores = scores * k_scale[:, :, None, :]
    scores = scores * (1.0 / (q.shape[-1] ** 0.5))
    mask = torch.arange(c_cap, device=q.device)[None, :] <= offsets.long()[:, None]  # [B,C]
    p = masked_softmax(scores, mask[:, None, None, :])
    if v_scale is not None:
        p = p * v_scale[:, :, None, :]
    return torch.matmul(p, v.float()).to(q.dtype)


def batched_decode_attention_plain(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, offsets: torch.Tensor, layer: int = 0
) -> torch.Tensor:
    """Plain PyTorch version of the float variant."""
    return _plain(q, k_cache[layer], v_cache[layer], offsets, None, None)


def batched_decode_attention_int8_plain(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    k_scale: torch.Tensor,
    v_cache: torch.Tensor,
    v_scale: torch.Tensor,
    offsets: torch.Tensor,
    layer: int = 0,
) -> torch.Tensor:
    """Plain PyTorch version of the int8 variant."""
    return _plain(q, k_cache[layer], v_cache[layer], offsets, k_scale[layer], v_scale[layer])


def _check(q, k_cache, v_cache, offsets, layer, cache_dtype, scales=()) -> None:
    name = "batched_decode_attention"
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported")
    n_layers, b, h, c_cap, d = k_cache.shape
    if tuple(q.shape) != (b, h, 1, d) or tuple(v_cache.shape) != tuple(k_cache.shape):
        raise ValueError(f"{name}: q {tuple(q.shape)} / caches {tuple(k_cache.shape)} disagree")
    for t_name, t, dtype in (("k_cache", k_cache, cache_dtype), ("v_cache", v_cache, cache_dtype)):
        if t.dtype != dtype:
            raise ValueError(f"{name}: {t_name} must be {dtype}, got {t.dtype}")
    for t_name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)) + tuple(
        (f"scale{i}", s) for i, s in enumerate(scales)
    ):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous on {q.device}")
    for t_name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must be 16-byte aligned")
    for s in scales:
        if s.dtype != torch.float32 or tuple(s.shape) != (n_layers, b, h, c_cap):
            raise ValueError(f"{name}: row scales must be float32 {(n_layers, b, h, c_cap)}")
    if d != HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} != {HEAD_DIM}")
    if not 0 < c_cap <= _MAX_CAPACITY:
        raise ValueError(f"{name}: capacity {c_cap} outside (0, {_MAX_CAPACITY}]")
    if not 0 <= layer < n_layers:
        raise ValueError(f"{name}: layer {layer} outside [0, {n_layers})")
    if offsets.dtype != torch.int32 or tuple(offsets.shape) != (b,) or offsets.device != q.device:
        raise ValueError(f"{name}: offsets must be int32 [{b}] on the caches' device")


def _lib() -> ctypes.CDLL:
    lib = build.library("batched_decode_attention")
    fn, fn8 = lib.batched_decode_attention, lib.batched_decode_attention_int8
    if fn.argtypes is None:
        fn.restype = fn8.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn8.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    return lib


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed (cudaError {err})")


def batched_decode_attention(
    q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, offsets: torch.Tensor, layer: int = 0
) -> torch.Tensor:
    """Float variant: returns ``[B,H,1,D]`` in q's dtype."""
    if not q.is_cuda:
        return batched_decode_attention_plain(q, k_cache, v_cache, offsets, layer)
    q = q.contiguous()
    _check(q, k_cache, v_cache, offsets, layer, q.dtype)
    _, b, h, c_cap, d = k_cache.shape
    out = torch.empty_like(q)
    err = _lib().batched_decode_attention(
        _DTYPE_CODES[q.dtype],
        q.data_ptr(),
        k_cache.data_ptr(),
        v_cache.data_ptr(),
        offsets.data_ptr(),
        out.data_ptr(),
        b,
        h,
        c_cap,
        d,
        layer,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "batched_decode_attention")
    batched_decode_attention.launches += 1
    return out


def batched_decode_attention_int8(
    q: torch.Tensor,
    k_cache: torch.Tensor,
    k_scale: torch.Tensor,
    v_cache: torch.Tensor,
    v_scale: torch.Tensor,
    offsets: torch.Tensor,
    layer: int = 0,
) -> torch.Tensor:
    """Int8 variant: returns ``[B,H,1,D]`` in q's dtype."""
    if not q.is_cuda:
        return batched_decode_attention_int8_plain(q, k_cache, k_scale, v_cache, v_scale, offsets, layer)
    q = q.contiguous()
    _check(q, k_cache, v_cache, offsets, layer, torch.int8, (k_scale, v_scale))
    _, b, h, c_cap, d = k_cache.shape
    out = torch.empty_like(q)
    err = _lib().batched_decode_attention_int8(
        _DTYPE_CODES[q.dtype],
        q.data_ptr(),
        k_cache.data_ptr(),
        k_scale.data_ptr(),
        v_cache.data_ptr(),
        v_scale.data_ptr(),
        offsets.data_ptr(),
        out.data_ptr(),
        b,
        h,
        c_cap,
        d,
        layer,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "batched_decode_attention_int8")
    batched_decode_attention_int8.launches += 1
    return out


batched_decode_attention.launches = 0
batched_decode_attention_int8.launches = 0
