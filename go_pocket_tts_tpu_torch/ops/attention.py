"""Scaled dot-product attention with absolute position masking (counterpart
of ``go_pocket_tts_tpu/ops/attention.py``).

A key at absolute position ``pos_k`` is visible to a query at ``pos_q`` iff::

    pos_k >= 0                      # -1 marks unused/padded cache slots
    delta = pos_q - pos_k >= 0      # causal
    context < 0 or delta < context  # optional sliding window (Mimi: 250)

Queries with no visible key produce zero rows. The softmax is written out
(masked max, exp, masked sum) so the masks match the reference exactly;
scores and the weighted sum accumulate in float32 whatever the input dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = [
    "attention_with_positions",
    "attention_with_positions_int8kv",
    "position_mask",
    "masked_softmax",
]


def position_mask(
    pos_q: torch.Tensor, pos_k: torch.Tensor, context: Optional[int] = None
) -> torch.Tensor:
    """Boolean visibility mask ``[Tq, Tk]`` (or batched with leading dims)."""
    pq = pos_q[..., :, None]
    pk = pos_k[..., None, :]
    delta = pq - pk
    mask = (pk >= 0) & (delta >= 0)
    if context is not None and context >= 0:
        mask = mask & (delta < context)
    return mask


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max-subtracted softmax over the last dim in float32; fully-masked rows
    yield zeros, not NaN."""
    neg = torch.finfo(torch.float32).min
    scores = torch.where(mask, scores, neg)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.where(mask, torch.exp(scores - m), 0.0)
    denom = e.sum(dim=-1, keepdim=True)
    return e / torch.where(denom > 0, denom, 1.0)


def _batch_mask(pos_q, pos_k, context) -> torch.Tensor:
    mask = position_mask(pos_q, pos_k, context)
    if mask.ndim == 2:
        return mask[None, None]
    if mask.ndim == 3:
        return mask[:, None]
    return mask


def attention_with_positions(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    pos_q: torch.Tensor,
    pos_k: torch.Tensor,
    context: Optional[int] = None,
) -> torch.Tensor:
    """Masked SDPA over ``[B, H, T, Dh]`` tensors.

    ``pos_q``/``pos_k`` are int absolute positions ``[Tq]``/``[Tk]`` or
    ``[B, Tq]``/``[B, Tk]``. Output matches the input dtype.
    """
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = masked_softmax(scores, _batch_mask(pos_q, pos_k, context))
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)


def attention_with_positions_int8kv(
    q: torch.Tensor,
    k_q: torch.Tensor,
    k_scale: torch.Tensor,
    v_q: torch.Tensor,
    v_scale: torch.Tensor,
    pos_q: torch.Tensor,
    pos_k: torch.Tensor,
    context: Optional[int] = None,
) -> torch.Tensor:
    """Masked SDPA over an int8 KV cache with per-row scales.

    ``k_q``/``v_q`` are int8 ``[B, H, Tk, Dh]``, ``k_scale``/``v_scale``
    float32 ``[B, H, Tk]``. The row scales distribute over the products:
    ``scores = (q·k_int8)·k_scale/√D`` and ``out = (p·v_scale)·v_int8``,
    with ``p·v_scale`` rounded to q's dtype as the reference rounds it.
    Masks as in :func:`attention_with_positions`.
    """
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.matmul(q.float(), k_q.float().transpose(-1, -2))
    scores = scores * k_scale[:, :, None, :] * scale
    p = masked_softmax(scores, _batch_mask(pos_q, pos_k, context))
    pv = (p * v_scale[:, :, None, :]).to(q.dtype).float()
    return torch.matmul(pv, v_q.float()).to(q.dtype)
