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

__all__ = ["attention_with_positions", "position_mask", "masked_softmax"]


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
    mask = position_mask(pos_q, pos_k, context)
    if mask.ndim == 2:
        mask = mask[None, None]
    elif mask.ndim == 3:
        mask = mask[:, None]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    p = masked_softmax(scores, mask)
    out = torch.matmul(p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
