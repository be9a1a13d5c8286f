"""Fused SEANet decode tails: the wrappers of ``csrc/seanet_tail.cu`` and
their plain PyTorch versions.

Counterparts of ``go_pocket_tts_tpu/ops/pallas/seanet_tail.py``:

- :func:`fused_seanet_up_tail` — ``final(elu(y + res3(y)))`` with
  ``y = up3(x)`` (ConvTranspose1d 128→64, k=8, stride 4, streaming trim);
  ``[B,128,T_in] → [B,1,4·T_in]``. Gate :func:`supports_up`.
- :func:`fused_seanet_tail` — ``final(elu(x + res3(x)))``;
  ``[B,64,T] → [B,1,T]``. Gate :func:`supports`.

All convolutions are causal (zeros before t = 0); intermediates and
accumulation are float32 whatever the input dtype, and the output takes the
input dtype, as in the reference kernels. Weights use the reference
layouts: ``wu`` is the repacked up3 kernel ``[64,128,8]``, ``w1 [32,64,3]``,
``w2 [64,32,1]``, ``wf [1,64,7]``.

Each wrapper runs the plain version for CPU tensors and the CUDA kernel for
CUDA tensors (or raises); it counts kernel launches in ``<wrapper>.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from go_pocket_tts_tpu_torch.kernels import build
from go_pocket_tts_tpu_torch.ops.act import elu
from go_pocket_tts_tpu_torch.ops.conv import causal_conv1d, conv_transpose1d_trim

__all__ = [
    "fused_seanet_up_tail",
    "fused_seanet_up_tail_plain",
    "fused_seanet_tail",
    "fused_seanet_tail_plain",
    "supports",
    "supports_up",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_T = 1920  # the reference gate's block: samples per latent frame
_QB = 512  # the reference up-tail gate's input block
_UP_K, _UP_S = 8, 4


def supports(t: int) -> bool:
    """Shapes the reference tail kernel takes (T a multiple of 1920)."""
    return t % _BLOCK_T == 0 and t >= _BLOCK_T


def supports_up(c_in: int, t_in: int, k: int) -> bool:
    """Shapes the reference up-tail kernel takes (T_in a multiple of 512)."""
    return c_in == 128 and k == _UP_K and t_in % _QB == 0 and t_in >= _QB


def _tail_plain(y, w1, b1, w2, b2, wf, bf) -> torch.Tensor:
    f = [t.float() for t in (w1, b1, w2, b2, wf, bf)]
    h = causal_conv1d(elu(y), f[0], f[1])
    h = causal_conv1d(elu(h), f[2], f[3])
    return causal_conv1d(elu(y + h), f[4], f[5])


def fused_seanet_up_tail_plain(x, wu, bu, w1, b1, w2, b2, wf, bf) -> torch.Tensor:
    y = conv_transpose1d_trim(x.float(), wu.float(), bu.float(), _UP_S)
    return _tail_plain(y, w1, b1, w2, b2, wf, bf).to(x.dtype)


def fused_seanet_tail_plain(x, w1, b1, w2, b2, wf, bf) -> torch.Tensor:
    return _tail_plain(x.float(), w1, b1, w2, b2, wf, bf).to(x.dtype)


_TAIL_SHAPES = ((32, 64, 3), (32,), (64, 32, 1), (64,), (1, 64, 7), (1,))


def _check(name: str, x: torch.Tensor, tensors: Sequence[torch.Tensor], shapes) -> None:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: dtype {x.dtype} not supported")
    for i, (t, shape) in enumerate(zip(tensors, shapes)):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: argument {i} shape {tuple(t.shape)} != {tuple(shape)}")
        if t.dtype != x.dtype or t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{name}: argument {i} must be contiguous {x.dtype} on {x.device}")


def _lib() -> ctypes.CDLL:
    lib = build.library("seanet_tail")
    for fn, n_ptr in ((lib.seanet_up_tail, 10), (lib.seanet_tail, 8)):
        if fn.argtypes is None:
            fn.restype = ctypes.c_int
            fn.argtypes = (
                [ctypes.c_int] + [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 2 + [ctypes.c_void_p]
            )
    return lib


def fused_seanet_up_tail(x, wu, bu, w1, b1, w2, b2, wf, bf) -> torch.Tensor:
    """``[B,128,T_in] → [B,1,4·T_in]`` PCM (see the module docstring)."""
    if not x.is_cuda:
        return fused_seanet_up_tail_plain(x, wu, bu, w1, b1, w2, b2, wf, bf)
    b, c_in, t_in = x.shape
    if c_in != 128 or t_in % 32 != 0 or t_in == 0:
        raise ValueError(f"fused_seanet_up_tail: x shape {tuple(x.shape)} not [B,128,32k]")
    args = (x, wu, bu, w1, b1, w2, b2, wf, bf)
    _check("fused_seanet_up_tail", x, args, ((b, 128, t_in), (64, 128, 8), (64,)) + _TAIL_SHAPES)
    out = torch.empty((b, 1, 4 * t_in), dtype=x.dtype, device=x.device)
    err = _lib().seanet_up_tail(
        _DTYPE_CODES[x.dtype],
        *(t.data_ptr() for t in args),
        out.data_ptr(),
        b,
        t_in,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_seanet_up_tail: CUDA launch failed (cudaError {err})")
    fused_seanet_up_tail.launches += 1
    return out


def fused_seanet_tail(x, w1, b1, w2, b2, wf, bf) -> torch.Tensor:
    """``[B,64,T] → [B,1,T]`` PCM (see the module docstring)."""
    if not x.is_cuda:
        return fused_seanet_tail_plain(x, w1, b1, w2, b2, wf, bf)
    b, c, t = x.shape
    if c != 64 or t % 128 != 0 or t == 0:
        raise ValueError(f"fused_seanet_tail: x shape {tuple(x.shape)} not [B,64,128k]")
    args = (x, w1, b1, w2, b2, wf, bf)
    _check("fused_seanet_tail", x, args, ((b, 64, t),) + _TAIL_SHAPES)
    out = torch.empty((b, 1, t), dtype=x.dtype, device=x.device)
    err = _lib().seanet_tail(
        _DTYPE_CODES[x.dtype],
        *(tt.data_ptr() for tt in args),
        out.data_ptr(),
        b,
        t,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_seanet_tail: CUDA launch failed (cudaError {err})")
    fused_seanet_tail.launches += 1
    return out


fused_seanet_up_tail.launches = 0
fused_seanet_tail.launches = 0
