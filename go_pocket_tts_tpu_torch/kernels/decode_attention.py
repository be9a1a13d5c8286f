"""Decode-step attention with in-place cache append: the wrapper of
``csrc/decode_attention.cu`` and its plain PyTorch version.

Counterpart of ``go_pocket_tts_tpu/ops/pallas/decode_attention.py``
(``decode_attention_step``). For one AR step (T = 1) of layer ``layer``:

- rotate q and k_new by RoPE at ``offset`` (interleaved pairs, float32;
  the rotated q is rounded to q's dtype, the rotated k to the cache dtype);
- write rope(k_new) and v_new at row ``offset`` of layer ``layer`` of the
  stacked ``[L,B,H,C,D]`` caches, IN PLACE (the reference donates the
  buffers to the same effect);
- return ``softmax(q·K[:C]ᵀ/√D masked to slots <= offset)·V`` as
  ``[B,H,1,D]``.

``offset`` is a 0-d int32 tensor on the caches' device; the kernel reads it
there, so the AR loop launches it without a host sync. Out-of-range offsets
clamp as the reference's dynamic slices do.

The kernel splits each (b, h) pair's rows among a cluster of blocks
(:func:`~go_pocket_tts_tpu_torch.kernels.split_kv.split_plan`, chosen from
the capacity and ``B·H``) and merges their partial softmaxes on the card,
in the same launch.

:func:`decode_attention_step` runs the plain version for CPU tensors and the
CUDA kernel for CUDA tensors (or raises); it counts kernel launches in
``decode_attention_step.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from go_pocket_tts_tpu_torch.kernels import build
from go_pocket_tts_tpu_torch.kernels.split_kv import split_plan
from go_pocket_tts_tpu_torch.ops.attention import masked_softmax

__all__ = ["decode_attention_step", "decode_attention_step_plain", "HEAD_DIM"]

HEAD_DIM = 64  # the only head width the CUDA kernel is built for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The longest cache the split plan and the card tests cover (the model's
# max_seq).
_MAX_CAPACITY = 8192

Out = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _rope_dup(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """``x·cos_dup + swap_pairs(x)·sin_adj`` in float32 (the reference
    kernel's duplicated-trig / pair-swap form)."""
    d = x.shape[-1]
    cos_dup = c.repeat_interleave(2, dim=-1)
    # -1 on even lanes, +1 on odd ones (built without a host copy, so the
    # plain version can be captured in a CUDA graph).
    sign = (torch.arange(d, device=x.device) % 2).float() * 2.0 - 1.0
    sin_adj = s.repeat_interleave(2, dim=-1) * sign
    xf = x.float()
    swapped = xf.reshape(*x.shape[:-1], d // 2, 2).flip(-1).reshape(x.shape)
    return xf * cos_dup + swapped * sin_adj


def decode_attention_step_plain(
    q: torch.Tensor,
    k_new: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    v_new: torch.Tensor,
    offset: torch.Tensor,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    layer: int = 0,
) -> Out:
    """Plain PyTorch version of the kernel; same in-place cache append."""
    c_cap = k_cache.shape[3]
    off = offset.reshape(()).long()
    rope_row = off.clamp(0, rope_cos.shape[0] - 1).reshape(1)
    row = off.clamp(0, c_cap - 1).reshape(1)
    c = rope_cos.index_select(0, rope_row)  # [1, D/2]
    s = rope_sin.index_select(0, rope_row)
    q_r = _rope_dup(q, c, s).to(q.dtype)
    k_r = _rope_dup(k_new, c, s).to(k_cache.dtype)
    k_cache[layer].index_copy_(2, row, k_r)
    v_cache[layer].index_copy_(2, row, v_new.to(v_cache.dtype))

    scale = 1.0 / (q.shape[-1] ** 0.5)
    kc = k_cache[layer].float()  # [B,H,C,D]
    scores = torch.matmul(q_r.float(), kc.transpose(-1, -2)) * scale  # [B,H,1,C]
    mask = torch.arange(c_cap, device=q.device) <= off
    p = masked_softmax(scores, mask)
    out = torch.matmul(p, v_cache[layer].float())
    return out.to(q.dtype), k_cache, v_cache


def _check(q, k_new, k_cache, v_cache, v_new, offset, rope_cos, rope_sin, layer) -> None:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"decode_attention_step: dtype {q.dtype} not supported")
    n_layers, b, h, c_cap, d = k_cache.shape
    for name, t, shape in (
        ("q", q, (b, h, 1, d)),
        ("k_new", k_new, (b, h, 1, d)),
        ("v_new", v_new, (b, h, 1, d)),
        ("v_cache", v_cache, tuple(k_cache.shape)),
    ):
        if tuple(t.shape) != shape:
            raise ValueError(f"decode_attention_step: {name} shape {tuple(t.shape)} != {shape}")
    for name, t in (("q", q), ("k_new", k_new), ("v_new", v_new), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(
                f"decode_attention_step: {name} must be contiguous {q.dtype} on {q.device}"
            )
    if d != HEAD_DIM:
        raise ValueError(f"decode_attention_step: head dim {d} != {HEAD_DIM}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention_step: {name} must be 16-byte aligned (bulk copies)")
    if not 0 < c_cap <= _MAX_CAPACITY:
        raise ValueError(f"decode_attention_step: capacity {c_cap} outside (0, {_MAX_CAPACITY}]")
    if not 0 <= layer < n_layers:
        raise ValueError(f"decode_attention_step: layer {layer} outside [0, {n_layers})")
    if offset.dtype != torch.int32 or offset.numel() != 1 or offset.device != q.device:
        raise ValueError("decode_attention_step: offset must be one int32 on the caches' device")
    for name, t in (("rope_cos", rope_cos), ("rope_sin", rope_sin)):
        if (
            t.dtype != torch.float32
            or t.device != q.device
            or not t.is_contiguous()
            or t.ndim != 2
            or t.shape[1] != d // 2
        ):
            raise ValueError(f"decode_attention_step: {name} must be contiguous float32 [S, {d // 2}]")


def _lib() -> ctypes.CDLL:
    lib = build.library("decode_attention")
    fn = lib.decode_attention_step
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    return lib


def decode_attention_step(
    q: torch.Tensor,
    k_new: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    v_new: torch.Tensor,
    offset: torch.Tensor,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    layer: int = 0,
) -> Out:
    """Returns ``(attn [B,H,1,D], k_cache, v_cache)``; the caches are the
    arguments, updated in place."""
    if not q.is_cuda:
        return decode_attention_step_plain(
            q, k_new, k_cache, v_cache, v_new, offset, rope_cos, rope_sin, layer
        )
    _check(q, k_new, k_cache, v_cache, v_new, offset, rope_cos, rope_sin, layer)
    n_layers, b, h, c_cap, d = k_cache.shape
    splits, rows = split_plan(c_cap, b * h)
    out = torch.empty_like(q)
    err = _lib().decode_attention_step(
        _DTYPE_CODES[q.dtype],
        q.data_ptr(),
        k_new.data_ptr(),
        v_new.data_ptr(),
        k_cache.data_ptr(),
        v_cache.data_ptr(),
        offset.data_ptr(),
        rope_cos.data_ptr(),
        rope_sin.data_ptr(),
        out.data_ptr(),
        b * h,
        c_cap,
        d,
        layer,
        rope_cos.shape[0],
        splits,
        rows,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"decode_attention_step: CUDA launch failed (cudaError {err})")
    decode_attention_step.launches += 1
    return out, k_cache, v_cache


decode_attention_step.launches = 0
