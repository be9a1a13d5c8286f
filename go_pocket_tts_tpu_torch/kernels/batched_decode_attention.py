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

For these two the caller has already rotated ``q`` and written the step's
rows; neither version writes the caches. The batcher calls the fused step
instead:

- :func:`batched_decode_attention_step`: for each lane ``b``, what the
  batched transformer step ran as separate ops before its attention, in the
  same launch: RoPE of q and k_new at ``clamp(offsets[b], 0, max_seq-1)``,
  int8 quantization of the k and v rows (int8 cache, as
  :func:`~go_pocket_tts_tpu_torch.models.quantize.quantize_kv_rows`), and
  the row write at ``clamp(offsets[b], 0, C-1)`` only where
  ``offsets[b] < C`` (:func:`write_rows`); then the attention. Its launches
  count in the attention wrapper of its cache kind.

``offsets`` is an int32 ``[B]`` tensor on the caches' device (the kernel
reads it there, so the AR block launches it without a host sync); an offset
at or past the capacity sees every slot. Math is float32; the output has
q's dtype. The kernel splits each (lane, head) pair's rows among a cluster
of blocks (:func:`~go_pocket_tts_tpu_torch.kernels.split_kv.split_plan`).

Each wrapper runs its plain version for CPU tensors and its CUDA kernel for
CUDA tensors (or raises), counting kernel launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from go_pocket_tts_tpu_torch.kernels import build
from go_pocket_tts_tpu_torch.kernels.split_kv import split_plan
from go_pocket_tts_tpu_torch.models.quantize import quantize_kv_rows
from go_pocket_tts_tpu_torch.ops.attention import masked_softmax
from go_pocket_tts_tpu_torch.ops.rope import apply_rope_rows

__all__ = [
    "batched_decode_attention",
    "batched_decode_attention_int8",
    "batched_decode_attention_step",
    "batched_decode_attention_plain",
    "batched_decode_attention_int8_plain",
    "batched_decode_attention_step_plain",
    "write_rows",
    "write_step_rows",
]

HEAD_DIM = 64  # the only head width the CUDA kernel is built for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The longest cache the split plan and the card tests cover (the model's
# max_seq).
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


def write_rows(buf: torch.Tensor, lanes: torch.Tensor, rows: torch.Tensor, keep: torch.Tensor, vals: torch.Tensor) -> None:
    """``buf[b, :, rows[b]] = vals[b]`` for every lane ``b`` whose ``keep[b]``
    holds, in place (``buf`` ``[B,H,C,...]``, ``vals`` ``[B,H,...]``). The
    reference's scatter drops writes past the capacity; ``rows`` is clamped
    into range and a dropped lane writes back what the slot held."""
    old = buf[lanes, :, rows]
    mask = keep.reshape(-1, *([1] * (vals.ndim - 1)))
    buf[lanes, :, rows] = torch.where(mask, vals.to(buf.dtype), old)


def write_step_rows(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    offsets: torch.Tensor,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    layer: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fused step's prologue as separate ops: rotate q and k_new at each
    lane's offset, quantize the k and v rows (int8 cache), write them (and
    their scales) where the offset is inside the capacity. Returns the
    rotated q."""
    batch, capacity = q.shape[0], k_cache.shape[3]
    pos = offsets.long()
    rope_idx = pos.clamp(0, rope_cos.shape[0] - 1)
    cos_rows = rope_cos.index_select(0, rope_idx)[:, None, None, :]  # [B,1,1,D/2]
    sin_rows = rope_sin.index_select(0, rope_idx)[:, None, None, :]
    lanes = torch.arange(batch, device=q.device)
    rows = pos.clamp(0, capacity - 1)
    in_range = pos < capacity
    k = apply_rope_rows(k_new, cos_rows, sin_rows)
    if k_scale is not None:
        kq, ks = quantize_kv_rows(k[:, :, 0, :])  # [B,H,D] / [B,H]
        vq, vs = quantize_kv_rows(v_new[:, :, 0, :])
        for buf, val in ((k_cache[layer], kq), (v_cache[layer], vq), (k_scale[layer], ks), (v_scale[layer], vs)):
            write_rows(buf, lanes, rows, in_range, val)
    else:
        write_rows(k_cache[layer], lanes, rows, in_range, k[:, :, 0, :])
        write_rows(v_cache[layer], lanes, rows, in_range, v_new[:, :, 0, :])
    return apply_rope_rows(q, cos_rows, sin_rows)


def batched_decode_attention_step_plain(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    offsets: torch.Tensor,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    layer: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version of the fused step: :func:`write_step_rows`, then
    the attention's plain version."""
    q = write_step_rows(q, k_new, v_new, k_cache, v_cache, offsets, rope_cos, rope_sin, layer, k_scale, v_scale)
    if k_scale is not None:
        return batched_decode_attention_int8_plain(q, k_cache, k_scale, v_cache, v_scale, offsets, layer)
    return batched_decode_attention_plain(q, k_cache, v_cache, offsets, layer)


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
    caches = (("k_cache", k_cache), ("v_cache", v_cache)) + tuple((f"scale{i}", s) for i, s in enumerate(scales))
    for t_name, t in caches:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name}: {t_name} must be contiguous on {q.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {t_name} must be 16-byte aligned (bulk copies)")
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
    fn, fn8, step = lib.batched_decode_attention, lib.batched_decode_attention_int8, lib.batched_decode_attention_step
    if fn.argtypes is None:
        fn.restype = fn8.restype = step.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn8.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        ptr, lng = ctypes.c_void_p, ctypes.c_longlong
        step.argtypes = (
            [ctypes.c_int, ctypes.c_int, ptr, lng, ptr, lng, ptr, lng]
            + [ptr] * 8
            + [ctypes.c_int] * 8
            + [ptr]
        )
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
        *split_plan(c_cap, b * h),
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
        *split_plan(c_cap, b * h),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "batched_decode_attention_int8")
    batched_decode_attention_int8.launches += 1
    return out


def _lane_rows(t: torch.Tensor, d: int) -> torch.Tensor:
    """``t [B,H,1,D]`` as it is when each row is D contiguous elements and
    heads are D apart (a view into the fused QKV projection), else a
    contiguous copy; the kernel takes any lane stride."""
    return t if t.stride(3) == 1 and t.stride(1) == d else t.contiguous()


def batched_decode_attention_step(
    q: torch.Tensor,
    k_new: torch.Tensor,
    v_new: torch.Tensor,
    k_cache: torch.Tensor,
    v_cache: torch.Tensor,
    offsets: torch.Tensor,
    rope_cos: torch.Tensor,
    rope_sin: torch.Tensor,
    layer: int = 0,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The fused step: q, k_new, v_new ``[B,H,1,D]`` unrotated, in the
    activation dtype; caches of that dtype, or int8 with ``k_scale`` /
    ``v_scale`` ``[L,B,H,C]``; rope tables float32 ``[S, D/2]``. Writes the
    step's rows in place and returns ``[B,H,1,D]`` in q's dtype."""
    if not q.is_cuda:
        return batched_decode_attention_step_plain(
            q, k_new, v_new, k_cache, v_cache, offsets, rope_cos, rope_sin, layer, k_scale, v_scale
        )
    int8 = k_scale is not None
    if int8 != (v_scale is not None):
        raise ValueError("batched_decode_attention_step: give both row scales or neither")
    scales = (k_scale, v_scale) if int8 else ()
    _check(q, k_cache, v_cache, offsets, layer, torch.int8 if int8 else q.dtype, scales)
    _, b, h, c_cap, d = k_cache.shape
    q, k_new, v_new = (_lane_rows(t, d) for t in (q, k_new, v_new))
    for t_name, t in (("k_new", k_new), ("v_new", v_new)):
        if tuple(t.shape) != (b, h, 1, d) or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"batched_decode_attention_step: {t_name} must be {q.dtype} {(b, h, 1, d)} on {q.device}")
    for t_name, t in (("rope_cos", rope_cos), ("rope_sin", rope_sin)):
        if t.dtype != torch.float32 or t.device != q.device or not t.is_contiguous() or t.ndim != 2 or t.shape[1] != d // 2:
            raise ValueError(f"batched_decode_attention_step: {t_name} must be contiguous float32 [S, {d // 2}]")
    out = torch.empty((b, h, 1, d), dtype=q.dtype, device=q.device)
    err = _lib().batched_decode_attention_step(
        _DTYPE_CODES[q.dtype],
        int(int8),
        q.data_ptr(),
        q.stride(0),
        k_new.data_ptr(),
        k_new.stride(0),
        v_new.data_ptr(),
        v_new.stride(0),
        k_cache.data_ptr(),
        v_cache.data_ptr(),
        k_scale.data_ptr() if int8 else None,
        v_scale.data_ptr() if int8 else None,
        offsets.data_ptr(),
        rope_cos.data_ptr(),
        rope_sin.data_ptr(),
        out.data_ptr(),
        b,
        h,
        c_cap,
        d,
        layer,
        rope_cos.shape[0],
        *split_plan(c_cap, b * h),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(err, "batched_decode_attention_step")
    counter = batched_decode_attention_int8 if int8 else batched_decode_attention
    counter.launches += 1
    return out


batched_decode_attention.launches = 0
batched_decode_attention_int8.launches = 0
