"""One decode step of a Mamba-2 mixer: the wrapper of
``csrc/mamba2_step.cu`` and its plain PyTorch version.

For one token of ``B`` rows, from the mixer's input projection
``zxbcdt = [z | xBC | dt]`` (``z`` and ``x`` of ``H·P`` channels, ``B`` and
``C`` of ``G·N`` each, ``dt`` of ``H``):

- the causal depthwise convolution of width 4 over ``xBC``: the window is
  the conv state's three earlier inputs and this one, plus the bias, then
  SiLU; the conv state shifts by one, IN PLACE;
- ``dt = softplus(dt + dt_bias)`` and ``dA = exp(dt·A)`` per head;
- the float32 state update ``h ← dA·h + dt·x ⊗ B``, IN PLACE (head ``h``
  reads group ``h // (H/G)`` of B and C);
- the readout ``y = h·C + D·x`` and the gate ``y·silu(z)``.

Returns ``y`` as float32 ``[B, H·P]``; the gated RMSNorm and the output
projection follow as ordinary launches. Every sum and product runs in
float32 from the inputs as stored; the conv state keeps the raw inputs
(the projection's dtype), the SSM state float32.

Replaces no TPU kernel: the JAX package has no state-space layer. Run
eagerly, the step is ~15 launches a layer (the conv shift, the conv, SiLU,
softplus, exp, the outer product, the decay, the readout, the gate) and 36
layers an AR step at granite-4.0-h-micro's widths.

:func:`mamba2_step` runs the plain version for CPU tensors and the CUDA
kernel for CUDA tensors (or raises): one launch, one block per (row, head,
16 rows of the head's state). The conv state of the ``B`` and ``C``
channels is read by every block of a row and shifted by the grid's last
block once all have read it: ``sync`` is the grid's counter, one int32 on
the device that is 0 between launches (the caller owns it, one per
cache, so two caches' launches never share it). It counts launches in
``mamba2_step.launches`` and launches by ``(B, H, P, N)`` in
``mamba2_step.shapes``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch
import torch.nn.functional as F

from go_pocket_tts_tpu_torch.kernels import build

__all__ = ["mamba2_step", "mamba2_step_plain", "step_widths", "D_CONV", "STATE_ROWS", "D_STATE"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
D_CONV = 4  # the convolution's width: the state holds D_CONV - 1 inputs
D_STATE = 128  # the only state width N the CUDA kernel is built for
STATE_ROWS = 16  # rows of a head's [P, N] state a block updates


def step_widths(zxbcdt_width: int, heads: int, groups: int, d_inner: int) -> Tuple[int, int]:
    """``(N, conv channels)`` of a projection row of ``zxbcdt_width``
    (``2·d_inner + 2·G·N + H``)."""
    n2 = zxbcdt_width - 2 * d_inner - heads
    if n2 <= 0 or n2 % (2 * groups):
        raise ValueError(f"mamba2_step: projection width {zxbcdt_width} does not split as "
                         f"2·{d_inner} + 2·{groups}·N + {heads}")
    n = n2 // (2 * groups)
    return n, d_inner + 2 * groups * n


def mamba2_step_plain(
    zxbcdt: torch.Tensor,
    conv_state: torch.Tensor,
    conv_w: torch.Tensor,
    conv_b: torch.Tensor,
    dt_bias: torch.Tensor,
    a: torch.Tensor,
    d: torch.Tensor,
    ssm_state: torch.Tensor,
    groups: int,
    sync: torch.Tensor = None,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel; the same in-place state
    updates. ``zxbcdt [B, W]``, ``conv_state [B, C, 3]``, ``conv_w [C, 4]``,
    ``conv_b [C]``, ``dt_bias``, ``a`` (``A = -exp(A_log)``) and ``d``
    ``[H]`` float32, ``ssm_state [B, H, P, N]`` float32; ``sync`` is the
    kernel's and unused here."""
    b, heads, p, n = ssm_state.shape
    d_inner = heads * p
    conv_dim = d_inner + 2 * groups * n
    z, xbc, dt = zxbcdt.split([d_inner, conv_dim, heads], dim=-1)
    window = torch.cat([conv_state.float(), xbc.float()[..., None]], dim=-1)  # [B, C, 4]
    conv = F.silu((window * conv_w.float()).sum(-1) + conv_b.float())
    conv_state.copy_(torch.cat([conv_state[..., 1:], xbc[..., None].to(conv_state.dtype)], dim=-1))
    x, bm, cm = conv.split([d_inner, groups * n, groups * n], dim=-1)
    x = x.reshape(b, heads, p)
    rep = heads // groups
    bm = bm.reshape(b, groups, n).repeat_interleave(rep, dim=1)  # [B, H, N]
    cm = cm.reshape(b, groups, n).repeat_interleave(rep, dim=1)
    dt = F.softplus(dt.float() + dt_bias.float())  # [B, H]
    da = torch.exp(dt * a.float())
    ssm_state.mul_(da[:, :, None, None]).add_((dt[:, :, None] * x)[..., None] * bm[:, :, None, :])
    y = (ssm_state @ cm[..., None])[..., 0] + d.float()[:, None] * x
    return (y * F.silu(z.float().reshape(b, heads, p))).reshape(b, d_inner)


def _check(zxbcdt, conv_state, conv_w, conv_b, dt_bias, a, d, ssm_state, groups, sync) -> None:
    if zxbcdt.dtype not in _DTYPE_CODES:
        raise TypeError(f"mamba2_step: dtype {zxbcdt.dtype} not supported")
    if ssm_state.ndim != 4 or ssm_state.dtype != torch.float32 or not ssm_state.is_contiguous():
        raise ValueError("mamba2_step: ssm_state must be contiguous float32 [B, H, P, N]")
    b, heads, p, n = ssm_state.shape
    if n != D_STATE or p % STATE_ROWS or heads % groups:
        raise ValueError(f"mamba2_step: state [{b}, {heads}, {p}, {n}] with {groups} groups: the kernel takes "
                         f"N = {D_STATE}, P a multiple of {STATE_ROWS} and H a multiple of G")
    n_found, conv_dim = step_widths(zxbcdt.shape[-1], heads, groups, heads * p)
    if n_found != n:
        raise ValueError(f"mamba2_step: projection width {zxbcdt.shape[-1]} gives N = {n_found}, the state {n}")
    for name, t, shape, dtype in (
        ("zxbcdt", zxbcdt, (b, zxbcdt.shape[-1]), zxbcdt.dtype),
        ("conv_state", conv_state, (b, conv_dim, D_CONV - 1), zxbcdt.dtype),
        ("conv_w", conv_w, (conv_dim, D_CONV), None),
        ("conv_b", conv_b, (conv_dim,), None),
        ("dt_bias", dt_bias, (heads,), torch.float32),
        ("a", a, (heads,), torch.float32),
        ("d", d, (heads,), torch.float32),
        ("sync", sync, (1,), torch.int32),
    ):
        if tuple(t.shape) != shape or t.device != ssm_state.device:
            raise ValueError(f"mamba2_step: {name} must be {list(shape)} on {ssm_state.device}, got "
                             f"{list(t.shape)} on {t.device}")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"mamba2_step: {name} must be {dtype}, got {t.dtype}")
        if name != "zxbcdt" and not t.is_contiguous():
            raise ValueError(f"mamba2_step: {name} must be contiguous")
    if zxbcdt.stride(-1) != 1:
        raise ValueError("mamba2_step: zxbcdt rows must have unit element stride")
    if conv_w.dtype != conv_b.dtype or conv_w.dtype not in _DTYPE_CODES:
        raise ValueError("mamba2_step: conv_w and conv_b must share one dtype, float32 or bfloat16")


def _lib() -> ctypes.CDLL:
    lib = build.library("mamba2_step")
    fn = lib.mamba2_step
    if fn.argtypes is None:
        ptr = ctypes.c_void_p
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.c_int, ptr, ctypes.c_longlong] + [ptr] * 9 + [ctypes.c_int] * 5 + [ptr]
    return lib


def mamba2_step(
    zxbcdt: torch.Tensor,
    conv_state: torch.Tensor,
    conv_w: torch.Tensor,
    conv_b: torch.Tensor,
    dt_bias: torch.Tensor,
    a: torch.Tensor,
    d: torch.Tensor,
    ssm_state: torch.Tensor,
    groups: int,
    sync: torch.Tensor = None,
) -> torch.Tensor:
    """``mamba2_step_plain``'s result in one launch on CUDA tensors:
    ``y [B, H·P]`` float32; both states updated in place."""
    if not zxbcdt.is_cuda:
        return mamba2_step_plain(zxbcdt, conv_state, conv_w, conv_b, dt_bias, a, d, ssm_state, groups, sync)
    if sync is None:
        raise ValueError("mamba2_step: a CUDA launch needs the grid's counter (sync, one int32, 0 at rest)")
    _check(zxbcdt, conv_state, conv_w, conv_b, dt_bias, a, d, ssm_state, groups, sync)
    b, heads, p, n = ssm_state.shape
    y = torch.empty((b, heads * p), dtype=torch.float32, device=zxbcdt.device)
    err = _lib().mamba2_step(
        _DTYPE_CODES[zxbcdt.dtype],
        _DTYPE_CODES[conv_w.dtype],
        zxbcdt.data_ptr(),
        zxbcdt.stride(0) if zxbcdt.shape[0] > 1 else zxbcdt.shape[-1],
        conv_state.data_ptr(),
        conv_w.data_ptr(),
        conv_b.data_ptr(),
        dt_bias.data_ptr(),
        a.data_ptr(),
        d.data_ptr(),
        ssm_state.data_ptr(),
        y.data_ptr(),
        sync.data_ptr(),
        b,
        heads,
        p,
        n,
        groups,
        torch.cuda.current_stream(zxbcdt.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"mamba2_step: CUDA launch failed (cudaError {err})")
    mamba2_step.launches += 1
    shape = (b, heads, p, n)
    mamba2_step.shapes[shape] = mamba2_step.shapes.get(shape, 0) + 1
    return y


mamba2_step.launches = 0
mamba2_step.shapes = {}
