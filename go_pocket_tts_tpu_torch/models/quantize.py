"""INT8 weight-only and KV-cache quantization (counterpart of the int8 part of
``go_pocket_tts_tpu/models/quantize.py``).

Weights are symmetric per output channel::

    w_q[i, o] = round(w[i, o] / scale[o]),   scale[o] = max_i |w[i, o]| / 127

and a linear runs ``(x @ w_q) * scale`` (``params.apply_linear``): the int8
operand halves the weight bytes every AR step streams, the scale folds into
the output, activations stay bf16/f32. KV-cache rows are symmetric per row
(one scale per lane, head and position). Zero columns and rows get scale 1
so they stay exactly zero. ``torch.round`` rounds half to even, as
``jnp.round`` does, so both packages produce the same int8 values.

INT4 (``bits=4``, the reference's packed-nibble tier) is not ported yet: it
is the "INT4 serving" item of ROADMAP.md.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = [
    "quantize_kv_rows",
    "quantize_linear",
    "quantize_model_params",
    "is_quantized",
    "dequantize_weight",
]

Params = Dict

# A gather table and a once-per-utterance projector: left in floating point.
_SKIP_KEYS = ("conditioner_embed", "latent_to_mimi")


def _check_bits(bits: int) -> None:
    if bits == 4:
        raise NotImplementedError(
            "int4 weights are not ported yet (ROADMAP.md: INT4 serving with kernel 6)"
        )
    if bits != 8:
        raise ValueError(f"quantize bits must be 8 or 4, got {bits}")


def quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``x[..., Dh]`` → ``(int8 [..., Dh], float32 scale [...])`` with
    ``scale = max|row| / 127``."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_linear(p: Params, bits: int = 8) -> Params:
    """``{w [in, out], b?}`` → ``{w int8, scale float32 [out], b?}``."""
    _check_bits(bits)
    w = p["w"].float()
    scale = w.abs().amax(dim=0) / 127.0
    scale = torch.where(scale > 0, scale, torch.ones_like(scale))
    out = {"w": torch.round(w / scale).clamp(-127, 127).to(torch.int8), "scale": scale}
    if "b" in p:
        out["b"] = p["b"]
    return out


def is_quantized(p: Params) -> bool:
    return "scale" in p and p["w"].dtype == torch.int8


def dequantize_weight(p: Params) -> torch.Tensor:
    """An int8 linear's float32 ``w [in, out]``, scales folded in."""
    return p["w"].float() * p["scale"].float()


def _is_linear(node) -> bool:
    return (
        isinstance(node, dict)
        and isinstance(node.get("w"), torch.Tensor)
        and node["w"].ndim == 2
        and node["w"].is_floating_point()
        and "scale" not in node
    )


def quantize_model_params(params: Params, bits: int = 8) -> Params:
    """Every 2-D linear of the tree quantized; norms, RoPE tables, conv
    kernels, latent stats and the :data:`_SKIP_KEYS` subtrees stay as they
    are."""
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
