"""Blocked local (sliding-window) attention (counterpart of
``go_pocket_tts_tpu/ops/local_attention.py``).

The Mimi transformer attends with a causal window of 250 positions. Scores
are computed only against the current and previous key blocks
(block >= window)::

    q blocks:  [B, H, nb, W, D]
    k/v pairs: [B, H, nb, 2W, D]   (previous block ‖ current block)
    scores:    [B, H, nb, W, 2W]

Exactly equivalent to ``attention_with_positions(.., context=window)`` for
positions ``0..T-1`` whenever ``window <= block``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from go_pocket_tts_tpu_torch.ops.attention import masked_softmax

__all__ = ["local_windowed_attention"]


def local_windowed_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    window: int,
    block: int = 256,
) -> torch.Tensor:
    """Causal sliding-window SDPA over ``[B, H, T, D]``; T % block == 0,
    window <= block."""
    b, h, t, d = q.shape
    if t % block != 0:
        raise ValueError(f"local attention requires T % block == 0, got {t} % {block}")
    if window > block:
        raise ValueError(f"window {window} must be <= block {block}")
    nb = t // block
    scale = 1.0 / (d**0.5)

    qb = q.reshape(b, h, nb, block, d)
    kb = k.reshape(b, h, nb, block, d)
    vb = v.reshape(b, h, nb, block, d)
    # Previous block (zeros for block 0).
    kp = F.pad(kb, (0, 0, 0, 0, 1, 0))[:, :, :-1]
    vp = F.pad(vb, (0, 0, 0, 0, 1, 0))[:, :, :-1]
    kk = torch.cat([kp, kb], dim=3)  # [B,H,nb,2W,D]
    vv = torch.cat([vp, vb], dim=3)

    scores = torch.matmul(qb.float(), kk.float().transpose(-1, -2)) * scale

    # delta = pos_q - pos_k = (block + r) - c for r in [0,W), c in [0,2W);
    # block 0's "previous" keys are the zero pad and must stay invisible.
    r = torch.arange(block, device=q.device)[:, None]
    c = torch.arange(2 * block, device=q.device)[None, :]
    delta = block + r - c
    base_mask = (delta >= 0) & (delta < window)  # [W, 2W]
    is_prev = c < block
    blk0 = (torch.arange(nb, device=q.device) == 0)[:, None, None]
    mask = base_mask[None] & ~(blk0 & is_prev[None])  # [nb, W, 2W]

    p = masked_softmax(scores, mask[None, None])
    out = torch.matmul(p.to(vv.dtype).float(), vv.float())
    return out.reshape(b, h, t, d).to(q.dtype)
