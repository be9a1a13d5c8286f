"""Device selection for the port's entry points.

Entry points default to the GPU. On a host without CUDA they raise: the
port never drops to the CPU on its own. Callers that want the CPU (the
tests, which hold the port against the JAX package there) ask for it.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: str | torch.device = DEFAULT_DEVICE) -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and the
    host has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but CUDA is not available on this host; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
