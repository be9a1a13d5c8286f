"""Rotary position embedding, interleaved-pair form (counterpart of
``go_pocket_tts_tpu/ops/rope.py``).

- tables: ``inv_freq[i] = max_period^(-i/half)``, rows are absolute positions
- application: pairs ``(x[2j], x[2j+1])`` rotated by ``pos * inv_freq[j]``
- the position may be a device int32 scalar tensor (the KV-cache offset), so
  the AR loop gathers its trig rows without a host sync

The rotation runs in float32 whatever the activation dtype.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

__all__ = ["build_rope_tables", "rope_rows", "apply_rope_rows", "apply_rope"]

DEFAULT_MAX_SEQ = 8192
DEFAULT_MAX_PERIOD = 10000.0

Pos = Union[int, torch.Tensor]


def build_rope_tables(
    max_seq: int = DEFAULT_MAX_SEQ,
    head_dim: int = 64,
    max_period: float = DEFAULT_MAX_PERIOD,
    device: str | torch.device = "cpu",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables of shape ``[max_seq, head_dim // 2]`` (float32)."""
    if head_dim % 2 != 0:
        raise ValueError(f"rope head dim must be even, got {head_dim}")
    half = head_dim // 2
    # The float32 exponent, raised in float64 and rounded once: the reference's
    # float32 ``max_period ** exponent`` bit for bit at every even head width
    # from 8 to 128 (torch's float32 pow is off by an ulp in a few entries).
    exponent = -torch.arange(half, dtype=torch.float32, device=device) / half
    inv_freq = torch.pow(
        torch.tensor(max_period, dtype=torch.float64, device=device), exponent.double()
    ).float()
    angles = torch.arange(max_seq, dtype=torch.float32, device=device)[:, None] * inv_freq[None, :]
    return torch.cos(angles), torch.sin(angles)


def rope_rows(
    cos: torch.Tensor, sin: torch.Tensor, pos: Pos, t: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cos/sin rows ``[T, half]`` for positions ``pos .. pos+t-1``.

    ``pos`` may be a Python int or a 0-d int tensor on the tables' device;
    the gather is an ``index_select`` so a device offset needs no sync, and
    an int offset needs no copy to the device (a CUDA graph may be
    capturing)."""
    if isinstance(pos, int):
        idx = torch.arange(pos, pos + t, device=cos.device)
    else:
        idx = torch.arange(t, device=cos.device) + torch.as_tensor(pos, device=cos.device).long()
    return cos.index_select(0, idx), sin.index_select(0, idx)


def apply_rope_rows(x: torch.Tensor, c: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Rotate ``x[..., T, D]`` by pre-gathered trig rows (see :func:`rope_rows`)."""
    d = x.shape[-1]
    xr = x.float().reshape(*x.shape[:-1], d // 2, 2)
    a, b = xr[..., 0], xr[..., 1]
    out = torch.stack([a * c - b * s, a * s + b * c], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, pos: Pos = 0) -> torch.Tensor:
    """Rotate ``x[B, H, T, D]`` (or ``[..., T, D]``) by absolute positions
    starting at ``pos``."""
    c, s = rope_rows(cos, sin, pos, x.shape[-2])
    return apply_rope_rows(x, c, s)
