"""Elementwise activations (counterpart of ``go_pocket_tts_tpu/ops/act.py``).

- GELU uses the erf form, not the tanh approximation
- ELU is the alpha=1 form ``x if x > 0 else expm1(x)``
- SiLU is ``x * sigmoid(x)``
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gelu_erf", "silu", "elu"]


def gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="none")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def elu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.expm1(x))
