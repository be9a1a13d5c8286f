"""INT8 / INT4 weight-only and INT8 KV-cache quantization (counterpart of
``go_pocket_tts_tpu/models/quantize.py``).

INT8 weights are symmetric per output channel::

    w_q[i, o] = round(w[i, o] / scale[o]),   scale[o] = max_i |w[i, o]| / 127

and a linear runs ``(x @ w_q) * scale`` (``params.apply_linear``): the int8
operand halves the weight bytes every AR step streams, the scale folds into
the output, activations stay bf16/f32.

INT4 (``bits=4``) is group-wise: one scale per ``GROUP_SIZE`` input rows and
output channel, ``scale [G, out]``, levels −7…7, when the input dim is a
multiple of ``GROUP_SIZE`` above it; otherwise one scale per output channel
(``[out]``), and an odd input dim falls back to int8. The levels are packed
two two's-complement nibbles per byte into ``uint8 [in/2, out]``: byte
``[i, j]`` holds input row ``2i`` in the low nibble and ``2i+1`` in the high
nibble, the pairing of the pre-quantized artifact's ``[out, in/2]`` buffer
transposed.

KV-cache rows are symmetric per row (one scale per lane, head and position).
Zero columns, groups and rows get scale 1 so they stay exactly zero.
``torch.round`` rounds half to even, as ``jnp.round`` does, and every
division is a true float32 division (never a product by a reciprocal, which
a CUDA tensor divided by a Python number would take), so load-time
quantization on either device, the exporter's NumPy and the reference all
give the same bytes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

__all__ = [
    "GROUP_SIZE",
    "quantize_kv_rows",
    "quantize_linear",
    "quantize_model_params",
    "is_quantized",
    "is_int4_packed",
    "model_quantized_bits",
    "pack_int4_rows",
    "depack_int4_pairs",
    "dequantize_weight",
]

Params = Dict

GROUP_SIZE = 128  # int4 scale granularity along the input dim

# A gather table and a once-per-utterance projector: left in floating point.
_SKIP_KEYS = ("conditioner_embed", "latent_to_mimi")


def _check_bits(bits: int) -> None:
    if bits not in (8, 4):
        raise ValueError(f"quantize bits must be 8 or 4, got {bits}")


def _symmetric_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """``amax / qmax``, with 1 where ``amax`` is 0."""
    scale = amax / torch.full_like(amax, qmax)
    return torch.where(scale > 0, scale, torch.ones_like(scale))


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x[..., Dh]`` → ``(int8 [..., Dh], float32 scale [...])`` with
    ``scale = max|row| / 127``."""
    xf = x.float()
    scale = _symmetric_scale(xf.abs().amax(dim=-1), 127.0)
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def pack_int4_rows(q: torch.Tensor) -> torch.Tensor:
    """``int8 [k, n]`` values in [-8, 7] → packed ``uint8 [k/2, n]``."""
    k, n = q.shape
    qp = q.reshape(k // 2, 2, n)
    return ((qp[:, 0, :] & 0x0F) | (qp[:, 1, :] << 4)).view(torch.uint8)


def depack_int4_pairs(packed: torch.Tensor) -> torch.Tensor:
    """Packed ``uint8 [k/2, n]`` → sign-extended ``int8 [k/2, 2, n]``;
    ``out[i, p, j]`` is input row ``2i + p``."""
    ui = packed.view(torch.int8)
    return torch.stack([(ui << 4) >> 4, ui >> 4], dim=1)


def dequantize_weight(p: Params) -> torch.Tensor:
    """A quantized linear's float32 ``w [in, out]``, scales folded in (int8
    per-channel, and packed int4 per-channel or group-wise)."""
    w = p["w"]
    wq = depack_int4_pairs(w).reshape(w.shape[0] * 2, w.shape[1]) if w.dtype == torch.uint8 else w
    wf = wq.float()
    sc = p["scale"].float()
    if sc.ndim == 2:
        g = sc.shape[0]
        return (wf.reshape(g, -1, wf.shape[1]) * sc[:, None, :]).reshape(wf.shape)
    return wf * sc


def quantize_linear(p: Params, bits: int = 8) -> Params:
    """``{w [in, out], b?}`` → ``{w, scale, b?}``: int8 ``w`` with a
    float32 ``scale [out]``, or (``bits=4``) packed ``uint8 [in/2, out]``
    with ``scale [G, out]`` or ``[out]``."""
    _check_bits(bits)
    w = p["w"].float()
    k, n = w.shape
    if bits == 4 and k % 2 != 0:
        bits = 8  # an odd input dim cannot nibble-pack (the exporter does the same)
    qmax = 127.0 if bits == 8 else 7.0
    if bits == 4 and k % GROUP_SIZE == 0 and k > GROUP_SIZE:
        wg = w.reshape(k // GROUP_SIZE, GROUP_SIZE, n)
        scale = _symmetric_scale(wg.abs().amax(dim=1), qmax)  # [G, out]
        q = torch.round(wg / scale[:, None, :]).clamp(-qmax, qmax).to(torch.int8).reshape(k, n)
    else:
        scale = _symmetric_scale(w.abs().amax(dim=0), qmax)  # [out]
        q = torch.round(w / scale).clamp(-qmax, qmax).to(torch.int8)
    out = {"w": pack_int4_rows(q) if bits == 4 else q, "scale": scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


def is_quantized(p: Params) -> bool:
    return "scale" in p and p["w"].dtype in (torch.int8, torch.uint8)


def is_int4_packed(p: Params) -> bool:
    return "scale" in p and p["w"].dtype == torch.uint8


def model_quantized_bits(params: Params) -> Optional[int]:
    """4 or 8 if the tree holds quantized linears, else None; a tree with
    both (an int4 artifact's int8 fallbacks) reports 4."""
    found = set()

    def walk(node):
        if isinstance(node, dict):
            if is_quantized(node):
                found.add(4 if node["w"].dtype == torch.uint8 else 8)
                return
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(params)
    return min(found) if found else None


def _is_linear(node) -> bool:
    return (
        isinstance(node, dict)
        and isinstance(node.get("w"), torch.Tensor)
        and node["w"].ndim == 2
        and node["w"].is_floating_point()
        and "scale" not in node
    )


def quantize_model_params(params: Params, bits: int = 8) -> Params:
    """Every 2-D float linear of the tree quantized; norms, RoPE tables, conv
    kernels, latent stats, already-quantized linears and the
    :data:`_SKIP_KEYS` subtrees stay as they are."""
    _check_bits(bits)

    def walk(node):
        if _is_linear(node):
            return quantize_linear(node, bits)
        if isinstance(node, dict):
            return {k: (v if k in _SKIP_KEYS else walk(v)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(params)
