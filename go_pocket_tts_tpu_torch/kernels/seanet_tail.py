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
CUDA tensors (or raises); it counts kernel launches in ``<wrapper>.launches``
and the input shapes it launched on in ``<wrapper>.shapes`` (``{x.shape:
count}``), so a caller can time each kernel at the shapes its path ran.

Weight layouts. The wrappers take the reference layouts and hand the
kernels their own, prepared once per weight by :func:`kernel_weight` and
cached while the weight lives and is not modified in place (keyed by
address, shape, dtype and version counter; an inference tensor, which keeps
no version, is taken as unmodified):

- the SIMT kernels (float32) read the up2 and res2 weights output channel
  last, so a warp's loads coalesce;
- the tensor-core kernels (all four in bfloat16) read every conv weight as
  the A operand of ``mma.sync`` m16n8k16 in fragment order
  (:func:`mma_fragments`): a transposed conv as its phase matrices
  (:func:`up_phase_matrices`), a k3 conv as ``[C_out, 3·C_in]``
  (:func:`conv_matrix`), a k1 conv as ``[C_out, C_in]``, and the final k7
  conv as a B operand, one tap a column (:func:`mma_b_fragments`); where a
  conv reads the kernel's own activations, its K is interleaved as they
  are (:func:`interleave_k`): res2 and res3 in every kernel, and up3 in the
  cascade, which reads res2's output from shared memory ("up3_mma_il"),
  where kernel 2 reads x from device memory ("up3_mma"). Their float32
  intermediates enter the MMAs as a hi/lo pair of bfloat16
  (:func:`split_hi_lo`), so every kernel computes the float32-intermediate
  function of the plain versions and rounds once, at the output.
"""

from __future__ import annotations

import ctypes
import threading
import weakref
from typing import Callable, Dict, Sequence, Tuple

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
    "mma_fragments",
    "mma_b_fragments",
    "interleave_k",
    "up_phase_matrices",
    "conv_matrix",
    "split_hi_lo",
    "kernel_weight",
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
    """Shapes the CUDA cascade takes (T_in a multiple of 32: the float32
    form's 128-sample blocks tile the output; the bfloat16 form masks its
    last block)."""
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
    mask. ``strides`` are (up2, up3). For CPU tensors it reads ``start`` on
    the host and runs the chain once per group of lanes; for CUDA ones
    (a CUDA graph may be capturing it) :func:`_stream_plain_every_halo`."""
    if start.is_cuda:
        return _stream_plain_every_halo(x, halo, start, *weights, strides=strides)
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


def _stream_plain_every_halo(
    x, halo, start, *weights, strides: Tuple[int, int] = (_UP2_S, _UP_S)
) -> torch.Tensor:
    """:func:`fused_up2_up3_tail_stream_plain` without reading ``start`` on
    the host: the chain runs over every lane once for each halo length
    ``0..HALO``, and each lane keeps the run of its own length."""
    b, _, t = x.shape
    per_sample = strides[0] * strides[1]
    n_of = start.clamp(0, HALO)[:, None, None]
    out = torch.zeros((b, 1, per_sample * t), dtype=x.dtype, device=x.device)
    for n in range(HALO + 1):
        xe = torch.cat([halo[:, :, HALO - n :].to(x.dtype), x], dim=2)
        pcm = fused_up2_up3_tail_plain(xe, *weights, strides=strides)[:, :, per_sample * n :]
        out = torch.where(n_of == n, pcm, out)
    return out


_TAIL_SHAPES = ((32, 64, 3), (32,), (64, 32, 1), (64,), (1, 64, 7), (1,))
_UP2_SHAPES = ((128, 256, 10), (128,), (64, 128, 3), (64,), (128, 64, 1), (128,))
_CASCADE_SHAPES = _UP2_SHAPES + ((64, 128, 8), (64,)) + _TAIL_SHAPES


def mma_fragments(a: torch.Tensor) -> torch.Tensor:
    """``[M, K]`` (multiples of 16) → ``[M/16, K/16, 32, 8]``: each 16×16
    tile as the A operand of ``mma.sync`` m16n8k16, lane ``4g + t`` holding
    rows g and g+8 at columns 2t, 2t+1 and 2t+8, 2t+9, in the order
    (a0, a1, a2, a3) of ``csrc/mma_sync.cuh``."""
    m, k = a.shape
    tiles = a.reshape(m // 16, 2, 8, k // 16, 2, 4, 2)  # mt, row+8, g, kt, col+8, t, pair
    return tiles.permute(0, 3, 2, 5, 4, 1, 6).reshape(m // 16, k // 16, 32, 8).contiguous()


def mma_b_fragments(b: torch.Tensor) -> torch.Tensor:
    """``[K, 8]`` (K a multiple of 16) → ``[K/16, 32, 4]``: each 16×8 tile as
    the B operand of ``mma.sync`` m16n8k16, lane ``4g + t`` holding column g
    at rows 2t, 2t+1, 2t+8, 2t+9 (b0, b1 of ``csrc/mma_sync.cuh``)."""
    k = b.shape[0]
    tiles = b.reshape(k // 16, 2, 4, 2, 8)  # kt, row+8, t, pair, g
    return tiles.permute(0, 4, 2, 1, 3).reshape(k // 16, 32, 4).contiguous()


def interleave_k(a: torch.Tensor) -> torch.Tensor:
    """The columns of ``[M, K]`` (K a multiple of 16) in the order the
    tensor-core kernels keep the channels of their own activations: within
    each 16, channel c at 2c and c + 8 at 2c + 1, so that the two channels
    one lane's MMA fragment holds (rows g and g + 8) are one 32-bit store.
    A GEMM's K may run in any order that A and B share."""
    m, k = a.shape
    return a.reshape(m, k // 16, 2, 8).transpose(2, 3).reshape(m, k)


def _conv_a(w: torch.Tensor) -> torch.Tensor:
    """A conv that reads the kernels' own activations, as A fragments."""
    return mma_fragments(interleave_k(conv_matrix(w)))


def _final_b(wf: torch.Tensor) -> torch.Tensor:
    """The final k7 conv ``[1, C, 7]`` as the tensor-core kernels' B
    fragments: a ``[C, 8]`` matrix whose column d holds tap d over the
    channels (K interleaved), column 7 zero; the kernels take the per-tap
    partials of every z row and sum each output's diagonal."""
    taps = torch.zeros((8, wf.shape[1]), dtype=wf.dtype, device=wf.device)
    taps[: wf.shape[2]] = wf[0].t()
    return mma_b_fragments(interleave_k(taps).t().contiguous())


def up_phase_matrices(wu: torch.Tensor, stride: int) -> torch.Tensor:
    """The repacked ConvTranspose kernel ``[C_out, C_in, 2·stride]`` as its
    ``stride`` phase matrices ``[stride, C_out, 2·C_in]``: output ``stride·m +
    s`` is ``A[s] @ concat(x[:, m-1], x[:, m])`` (K runs over tap, then input
    channel) plus the bias."""
    return torch.stack(
        [torch.cat([wu[:, :, stride - 1 - s], wu[:, :, 2 * stride - 1 - s]], dim=1) for s in range(stride)]
    )


def conv_matrix(w: torch.Tensor) -> torch.Tensor:
    """A causal conv kernel ``[C_out, C_in, k]`` as ``[C_out, k·C_in]`` (K runs
    over the shift, then input channel): output t is ``A @ concat(x[:, t-k+1],
    …, x[:, t])``."""
    return w.permute(0, 2, 1).reshape(w.shape[0], -1)


def split_hi_lo(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """A float32 tensor as the bfloat16 pair the tensor-core kernels feed
    their MMAs: ``hi = bf16(v)``, ``lo = bf16(v − hi)``; ``hi + lo`` carries v
    to about 2^-17 relative."""
    hi = v.to(torch.bfloat16)
    return hi, (v - hi.float()).to(torch.bfloat16)


def _up_phase_fragments(stride: int, interleaved: bool = False) -> Callable[[torch.Tensor], torch.Tensor]:
    order = interleave_k if interleaved else (lambda a: a)
    return lambda wu: torch.stack([mma_fragments(order(a)) for a in up_phase_matrices(wu, stride)])


_LAYOUTS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    # SIMT kernels, output channel last: [C_in, k, C_out], and [C_in, C_out] for k = 1.
    "simt": lambda w: w.permute(1, 2, 0).contiguous(),
    "simt_k1": lambda w: w[:, :, 0].t().contiguous(),
    # Tensor-core kernels: A fragments (final_mma: B fragments).
    "up2_mma": _up_phase_fragments(_UP2_S),
    "up3_mma": _up_phase_fragments(_UP_S),
    "up3_mma_il": _up_phase_fragments(_UP_S, interleaved=True),
    "conv_mma": _conv_a,
    "final_mma": _final_b,
}
_PREPARED: Dict[tuple, tuple] = {}  # key -> (weakref to the weight, its version, prepared)
# Reentrant: a weight's weakref callback can run from a collection that
# starts while the lock is held.
_PREPARED_LOCK = threading.RLock()


def kernel_weight(w: torch.Tensor, layout: str) -> torch.Tensor:
    """``w`` in a kernel's layout (see the module docstring), prepared on
    first use and then cached while ``w`` is alive and unmodified."""
    key = (layout, w.data_ptr(), tuple(w.shape), w.dtype, w.device)
    version = -1 if w.is_inference() else w._version
    with _PREPARED_LOCK:
        hit = _PREPARED.get(key)
        if hit is not None and hit[0]() is w and hit[1] == version:
            return hit[2]

    def forget(ref, key=key):
        with _PREPARED_LOCK:
            if _PREPARED.get(key, (None,))[0] is ref:
                del _PREPARED[key]

    prepared = _LAYOUTS[layout](w)
    with _PREPARED_LOCK:
        _PREPARED[key] = (weakref.ref(w, forget), version, prepared)
    return prepared


def _count(fn, x: torch.Tensor) -> None:
    fn.launches += 1
    shape = tuple(x.shape)
    fn.shapes[shape] = fn.shapes.get(shape, 0) + 1


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
    if x.dtype == torch.bfloat16:
        args = (x, kernel_weight(wu, "up3_mma"), bu, kernel_weight(w1, "conv_mma"), b1,
                kernel_weight(w2, "conv_mma"), b2, kernel_weight(wf, "final_mma"), bf)
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
    _count(fused_seanet_up_tail, x)
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
    if x.dtype == torch.bfloat16:
        args = (x, kernel_weight(w1, "conv_mma"), b1, kernel_weight(w2, "conv_mma"), b2,
                kernel_weight(wf, "final_mma"), bf)
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
    _count(fused_seanet_tail, x)
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


def fused_up2_res(x, wu, bu, w1, b1, w2, b2) -> torch.Tensor:
    """``[B,256,T_in] → [B,128,5·T_in]`` (see the module docstring)."""
    if not x.is_cuda:
        return fused_up2_res_plain(x, wu, bu, w1, b1, w2, b2)
    b, c_in, t_in = x.shape
    if c_in != 256 or t_in % 8 != 0 or t_in == 0:
        raise ValueError(f"fused_up2_res: x shape {tuple(x.shape)} not [B,256,8k]")
    args = (x, wu, bu, w1, b1, w2, b2)
    _check("fused_up2_res", x, args, ((b, 256, t_in),) + _UP2_SHAPES)
    if x.dtype == torch.bfloat16:
        layouts = ("up2_mma", "conv_mma", "conv_mma")
    else:
        layouts = ("simt", "simt", "simt_k1")
    args = (x, kernel_weight(wu, layouts[0]), bu, kernel_weight(w1, layouts[1]), b1, kernel_weight(w2, layouts[2]), b2)
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
    _count(fused_up2_res, x)
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
    if x.dtype == torch.bfloat16:
        layouts = ("up2_mma", None, "conv_mma", None, "conv_mma", None,
                   "up3_mma_il", None, "conv_mma", None, "conv_mma", None, "final_mma", None)
    else:
        layouts = ("simt", None, "simt", None, "simt_k1") + (None,) * 9
    weights = tuple(w if layout is None else kernel_weight(w, layout) for w, layout in zip(weights, layouts))
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
    _count(fused_up2_up3_tail, x)
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


for _fn in (fused_seanet_up_tail, fused_seanet_tail, fused_up2_res, fused_up2_up3_tail):
    _fn.launches = 0
    _fn.shapes = {}
