"""Normalization layers and adaLN modulation (counterpart of
``go_pocket_tts_tpu/ops/norms.py``).

- :func:`layer_norm`: last-dim LayerNorm, population variance, mean/var in
  float32.
- :func:`rms_norm_bessel`: the flowNet timestep-embedder RMSNorm; the
  variance is Bessel-corrected (N-1) around the mean, but the mean is NOT
  subtracted from the output.
- :func:`modulate`: adaLN ``x * (1 + scale) + shift``.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["layer_norm", "rms_norm_bessel", "modulate"]


def layer_norm(
    x: torch.Tensor,
    weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """LayerNorm over the last dim; mean/var in float32."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)


def rms_norm_bessel(x: torch.Tensor, alpha: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x / sqrt(var(x, ddof=1) + eps) * alpha`` — the upstream `_rms_norm`."""
    xf = x.float()
    n = x.shape[-1]
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().sum(dim=-1, keepdim=True) / float(max(n - 1, 1))
    out = xf * torch.rsqrt(var + eps) * alpha.float()
    return out.to(x.dtype)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """adaLN modulation: ``x * (1 + scale) + shift`` (broadcasting)."""
    return x * (1.0 + scale) + shift
