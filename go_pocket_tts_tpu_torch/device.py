"""Device selection for the port's entry points.

Entry points default to the GPU. On a host without CUDA they raise: the
port never drops to the CPU on its own. Callers that want the CPU (the
tests, which hold the port against the JAX package there) ask for it.

:func:`exact_float32` scopes true float32 arithmetic around a block, for
code whose result must not depend on the TF32 flags of the caller's
process.
"""

from __future__ import annotations

import contextlib
import subprocess
import threading

import torch

__all__ = ["DEFAULT_DEVICE", "card_line", "exact_float32", "resolve_device"]

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


# The TF32 flags are process-wide: one holder at a time sets and restores them.
_FLAGS_LOCK = threading.Lock()


@contextlib.contextmanager
def exact_float32():
    """TF32 off for cuDNN convolutions and CUDA matmuls while the block
    runs, the caller's flags restored after it. A float32 convolution on
    the card takes TF32 (a 10-bit mantissa) under PyTorch's default
    ``torch.backends.cudnn.allow_tf32 = True``; inside this block it is
    float32 as on the CPU. Blocks of several threads run one at a time."""
    with _FLAGS_LOCK:
        conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def card_line() -> str:
    """The first card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them;
    raises where ``nvidia-smi`` is missing or fails."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        timeout=60,
        check=True,
    )
    return out.stdout.strip().splitlines()[0]
