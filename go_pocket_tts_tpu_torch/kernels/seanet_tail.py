"""Fused SEANet decode stages: the wrappers of ``csrc/seanet_tail.cu`` and
``csrc/seanet_up2.cu`` and their plain PyTorch versions.

Counterparts of ``go_pocket_tts_tpu/ops/pallas/seanet_tail.py``:

- :func:`fused_seanet_up_tail` — ``final(elu(y + res3(y)))`` with
  ``y = up3(x)`` (ConvTranspose1d 128→64, k=8, stride 4, streaming trim);
  ``[B,128,T_in] → [B,1,4·T_in]``. Gate :func:`supports_up`.
- :func:`fused_seanet_tail` — ``final(elu(x + res3(x)))``;
  ``[B,64,T] → [B,1,T]``. Gate :func:`supports`.
- :func:`fused_up2_res` — ``elu(y + res2(y))`` with ``y = up2(x)``
  (ConvTranspose1d 256→128, k=10, stride 5); ``[B,256,T_in] →
  [B,128,5·T_in]``. Gate :func:`supports_up2`.
- :func:`fused_up2_up3_tail` — the whole cascade ``final(elu(res3(up3(
  elu(res2(up2(x)))))))``; ``[B,256,T_in] → [B,1,20·T_in]``. Gate
  :func:`supports_cascade`. Its streaming form
  :func:`fused_up2_up3_tail_stream` takes the causal state of a block
  decoder: ``halo [B,256,5]``, the five input columns before ``x[..., 0]``,
  and ``start [B]`` int32, the absolute column of ``x[..., 0]``; every
  stage is zero before absolute position 0, so consecutive blocks
  concatenate to the whole-sequence output. Both forms count their launches
  on ``fused_up2_up3_tail.launches``. :func:`supports_stream` is the CUDA
  kernel's own gate (T_in a multiple of 32: every streamed block of whole
  latent frames).

All convolutions are causal (zeros before t = 0); intermediates and
accumulation are float32 whatever the input dtype, and the output takes the
input dtype, as in the reference kernels. Weights use the reference
layouts: ``wu`` is the repacked up3 kernel ``[64,128,8]``, ``w1 [32,64,3]``,
``w2 [64,32,1]``, ``wf [1,64,7]``.

Each wrapper runs the plain version for CPU tensors and the CUDA kernel for
CUDA tensors (or raises); it counts kernel launches in ``<wrapper>.launches``.
The up2 kernels read the up2 and res2 weights output channel last, so a
warp's loads coalesce; their wrappers take the reference layouts and
transpose those three weights on each call (three copies of 0.7 MB in all
at bfloat16, a few microseconds).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from go_pocket_tts_tpu_torch.kernels import build
from go_pocket_tts_tpu_torch.ops.act import elu
from go_pocket_tts_tpu_torch.ops.conv import causal_conv1d, conv_transpose1d_trim

__all__ = [
    "fused_seanet_up_tail",
    "fused_seanet_up_tail_plain",
    "fused_seanet_tail",
    "fused_seanet_tail_plain",
    "fused_up2_res",
    "fused_up2_res_plain",
    "fused_up2_up3_tail",
    "fused_up2_up3_tail_plain",
    "fused_up2_up3_tail_stream",
    "fused_up2_up3_tail_stream_plain",
    "supports",
    "supports_up",
    "supports_up2",
    "supports_cascade",
    "supports_stream",
    "HALO",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_BLOCK_T = 1920  # the reference gate's block: samples per latent frame
_QB = 512  # the reference up-tail gate's input block
_UP_K, _UP_S = 8, 4
_UP2_K, _UP2_S = 10, 5
_QB2 = 128  # the reference up2 gate's input block
_CB = 128  # the reference cascade gate's input block
HALO = 5  # input columns of causal state the streaming cascade reads


def supports(t: int) -> bool:
    """Shapes the reference tail kernel takes (T a multiple of 1920)."""
    return t % _BLOCK_T == 0 and t >= _BLOCK_T


def supports_up(c_in: int, t_in: int, k: int) -> bool:
    """Shapes the reference up-tail kernel takes (T_in a multiple of 512)."""
    return c_in == 128 and k == _UP_K and t_in % _QB == 0 and t_in >= _QB


def supports_up2(c_in: int, t_in: int, k: int) -> bool:
    """Shapes the reference up2 kernel takes (T_in a multiple of 128)."""
    return c_in == 256 and k == _UP2_K and t_in % _QB2 == 0 and t_in >= _QB2


def supports_cascade(c_in: int, t_in: int, k2: int, k3: int) -> bool:
    """Shapes the reference cascade kernel takes (T_in a multiple of 128)."""
    return c_in == 256 and k2 == _UP2_K and k3 == _UP_K and t_in % _CB == 0 and t_in >= _CB


def supports_stream(c_in: int, t_in: int, k2: int, k3: int) -> bool:
    """Shapes the CUDA cascade takes (T_in a multiple of 32, so its 128-sample
    blocks tile the output)."""
    return c_in == 256 and k2 == _UP2_K and k3 == _UP_K and t_in % 32 == 0 and t_in >= 32


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


def _up2_res_f32(x, wu, bu, w1, b1, w2, b2, stride: int = _UP2_S) -> torch.Tensor:
    y = conv_transpose1d_trim(x.float(), wu.float(), bu.float(), stride)
    h = causal_conv1d(elu(y), w1.float(), b1.float())
    h = causal_conv1d(elu(h), w2.float(), b2.float())
    return elu(y + h)


def fused_up2_res_plain(x, wu, bu, w1, b1, w2, b2) -> torch.Tensor:
    return _up2_res_f32(x, wu, bu, w1, b1, w2, b2).to(x.dtype)


def fused_up2_up3_tail_plain(
    x, wu2, bu2, w1r2, b1r2, w2r2, b2r2, wu3, bu3, w1r3, b1r3, w2r3, b2r3, wf, bf,
    strides: Tuple[int, int] = (_UP2_S, _UP_S),
) -> torch.Tensor:
    h = _up2_res_f32(x, wu2, bu2, w1r2, b1r2, w2r2, b2r2, strides[0])
    y = conv_transpose1d_trim(h, wu3.float(), bu3.float(), strides[1])
    return _tail_plain(y, w1r3, b1r3, w2r3, b2r3, wf, bf).to(x.dtype)


def fused_up2_up3_tail_stream_plain(
    x, halo, start, *weights, strides: Tuple[int, int] = (_UP2_S, _UP_S)
) -> torch.Tensor:
    """The streaming cascade as the whole-sequence chain over the halo and
    the block. A lane that starts at absolute column ``s`` gets the last
    ``min(s, HALO)`` halo columns in front of its block: with ``s >= HALO``
    they cover the chain's receptive field (2 input columns for the
    reference's kernel sizes), and with ``s < HALO`` the extended sequence
    begins at absolute 0, where the chain's own zero padding is the causal
    mask. Reads ``start`` on the host. ``strides`` are (up2, up3)."""
    b, _, t = x.shape
    per_sample = strides[0] * strides[1]
    lanes_of: Dict[int, list] = {}
    for lane, s in enumerate(start.tolist()):
        lanes_of.setdefault(min(int(s), HALO), []).append(lane)
    out = torch.empty((b, 1, per_sample * t), dtype=x.dtype, device=x.device)
    for n, lanes in lanes_of.items():
        idx = torch.tensor(lanes, device=x.device)
        xe = torch.cat([halo[idx, :, HALO - n :].to(x.dtype), x[idx]], dim=2)
        out[idx] = fused_up2_up3_tail_plain(xe, *weights, strides=strides)[:, :, per_sample * n :]
    return out


_TAIL_SHAPES = ((32, 64, 3), (32,), (64, 32, 1), (64,), (1, 64, 7), (1,))
_UP2_SHAPES = ((128, 256, 10), (128,), (64, 128, 3), (64,), (128, 64, 1), (128,))
_CASCADE_SHAPES = _UP2_SHAPES + ((64, 128, 8), (64,)) + _TAIL_SHAPES


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


def _lib_up2() -> ctypes.CDLL:
    lib = build.library("seanet_up2")
    if lib.up2_res.argtypes is None:
        lib.up2_res.restype = ctypes.c_int
        lib.up2_res.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        lib.up2_up3_tail.restype = ctypes.c_int
        lib.up2_up3_tail.argtypes = (
            [ctypes.c_int] + [ctypes.c_void_p] * 18 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        )
    return lib


def _up2_kernel_layout(wu, bu, w1, b1, w2, b2) -> Tuple[torch.Tensor, ...]:
    """The up2 + res2 weights as the CUDA kernels read them, output channel
    last: ``wu [256,10,128]``, ``w1 [128,3,64]``, ``w2 [64,128]``."""
    return (
        wu.permute(1, 2, 0).contiguous(),
        bu,
        w1.permute(1, 2, 0).contiguous(),
        b1,
        w2[:, :, 0].t().contiguous(),
        b2,
    )


def fused_up2_res(x, wu, bu, w1, b1, w2, b2) -> torch.Tensor:
    """``[B,256,T_in] → [B,128,5·T_in]`` (see the module docstring)."""
    if not x.is_cuda:
        return fused_up2_res_plain(x, wu, bu, w1, b1, w2, b2)
    b, c_in, t_in = x.shape
    if c_in != 256 or t_in % 8 != 0 or t_in == 0:
        raise ValueError(f"fused_up2_res: x shape {tuple(x.shape)} not [B,256,8k]")
    args = (x, wu, bu, w1, b1, w2, b2)
    _check("fused_up2_res", x, args, ((b, 256, t_in),) + _UP2_SHAPES)
    args = (x,) + _up2_kernel_layout(wu, bu, w1, b1, w2, b2)
    out = torch.empty((b, 128, 5 * t_in), dtype=x.dtype, device=x.device)
    err = _lib_up2().up2_res(
        _DTYPE_CODES[x.dtype],
        *(t.data_ptr() for t in args),
        out.data_ptr(),
        b,
        t_in,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_up2_res: CUDA launch failed (cudaError {err})")
    fused_up2_res.launches += 1
    return out


def _launch_cascade(x, halo, start, weights) -> torch.Tensor:
    b, c_in, t_in = x.shape
    if c_in != 256 or t_in % 32 != 0 or t_in == 0:
        raise ValueError(f"fused_up2_up3_tail: x shape {tuple(x.shape)} not [B,256,32k]")
    _check("fused_up2_up3_tail", x, (x, *weights), ((b, 256, t_in),) + _CASCADE_SHAPES)
    if halo is not None:
        _check("fused_up2_up3_tail halo", x, (halo,), ((b, 256, HALO),))
    if start is not None and (
        start.dtype != torch.int32 or tuple(start.shape) != (b,) or start.device != x.device
        or not start.is_contiguous()
    ):
        raise ValueError(f"fused_up2_up3_tail: start must be contiguous int32 [{b}] on {x.device}")
    weights = _up2_kernel_layout(*weights[:6]) + tuple(weights[6:])
    out = torch.empty((b, 1, 20 * t_in), dtype=x.dtype, device=x.device)
    err = _lib_up2().up2_up3_tail(
        _DTYPE_CODES[x.dtype],
        x.data_ptr(),
        None if halo is None else halo.data_ptr(),
        None if start is None else start.data_ptr(),
        *(t.data_ptr() for t in weights),
        out.data_ptr(),
        b,
        t_in,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_up2_up3_tail: CUDA launch failed (cudaError {err})")
    fused_up2_up3_tail.launches += 1
    return out


def fused_up2_up3_tail(x, wu2, bu2, w1r2, b1r2, w2r2, b2r2, wu3, bu3, w1r3, b1r3, w2r3, b2r3, wf, bf) -> torch.Tensor:
    """``[B,256,T_in] → [B,1,20·T_in]`` PCM, the reference's signature: no
    state before ``x`` (see the module docstring)."""
    weights = (wu2, bu2, w1r2, b1r2, w2r2, b2r2, wu3, bu3, w1r3, b1r3, w2r3, b2r3, wf, bf)
    if not x.is_cuda:
        return fused_up2_up3_tail_plain(x, *weights)
    return _launch_cascade(x, None, None, weights)


def fused_up2_up3_tail_stream(x, halo, start, *weights) -> torch.Tensor:
    """One block of a stream: ``x [B,256,T_in]`` with its causal state
    ``halo [B,256,5]`` and ``start [B]`` int32 → ``[B,1,20·T_in]`` PCM."""
    if not x.is_cuda:
        return fused_up2_up3_tail_stream_plain(x, halo, start, *weights)
    return _launch_cascade(x, halo, start, weights)


fused_seanet_up_tail.launches = 0
fused_seanet_tail.launches = 0
fused_up2_res.launches = 0
fused_up2_up3_tail.launches = 0
