"""Pre-quantized serving checkpoint export (host side, NumPy; counterpart of
``go_pocket_tts_tpu/model_assets/quantize_export.py``).

A pre-quantized checkpoint stores its linear weights already quantized, so
serving loads them straight into the quantized form
(``models/params.py::linear_params``) with no load-time quantization, and
the weight-dominant tensors are ~4x (int8) or ~8x (int4) smaller than F32.
The numbers are those of load-time quantization
(``models/quantize.py::quantize_linear``): per-output-channel int8;
group-wise (128 input rows) int4, per-channel where the input dim is not a
multiple of 128 above it, int8 where it is odd. The set of quantized tensors
is recorded from a load by the port's own loader
(``record_linear_weight_names``), never guessed from names.

On-disk layout (names stay those of the float checkpoint):

- int8: ``X.weight`` I8 ``[out, in]``, ``X.weight_scale`` F32 ``[out]``;
- int4: ``X.weight`` U8 ``[out, in/2]`` (two's-complement nibbles, the low
  one holding the even input index) and ``X.weight_scale`` F32 ``[G, out]``
  or ``[out]``;
- ``__metadata__["pockettts.quantize"]`` names the format (``int8`` or
  ``int4-g128``).

For the same checkpoint the output equals the reference exporter's tensor
for tensor and, written, byte for byte.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Mapping, Optional, Set, Tuple, Union

import numpy as np
import torch

from go_pocket_tts_tpu_torch.models.quantize import GROUP_SIZE
from go_pocket_tts_tpu_torch.utils.safetensors import pack_nibbles, unpack_nibbles

__all__ = [
    "QUANT_METADATA_KEY",
    "linear_weight_names",
    "quantize_weight_np",
    "dequantize_weight_np",
    "to_bf16",
    "reencode_tensor",
    "build_quantized_checkpoint",
]

QUANT_METADATA_KEY = "pockettts.quantize"

Tensor = Union[np.ndarray, torch.Tensor]


def _is_float(a: Tensor) -> bool:
    if isinstance(a, torch.Tensor):
        return a.is_floating_point()
    return np.asarray(a).dtype.kind == "f"


def linear_weight_names(tensors: Mapping[str, np.ndarray], num_heads: int = 16) -> Set[str]:
    """Full checkpoint names of every weight the port's loader treats as a
    linear, recorded while it loads ``tensors``."""
    from go_pocket_tts_tpu_torch.models import flow_lm, mimi
    from go_pocket_tts_tpu_torch.models.params import VarBuilder, record_linear_weight_names

    vb = VarBuilder(tensors)
    with record_linear_weight_names() as names:
        flow_lm.load_flow_lm(vb, num_heads=num_heads)
        mimi.load_mimi(vb)
    return set(names)


def quantize_weight_np(w: np.ndarray, bits: int, group_size: int = GROUP_SIZE) -> Tuple[np.ndarray, np.ndarray]:
    """Quantize a torch-orientation weight ``[out, in]`` into the on-disk
    ``(weight, weight_scale)`` pair above; the same values, rounding (half
    to even) and group rule as ``quantize_linear``."""
    if bits not in (8, 4):
        raise ValueError(f"quantize bits must be 8 or 4, got {bits}")
    w = np.asarray(w, dtype=np.float32)
    if w.ndim != 2:
        raise ValueError(f"expected rank-2 weight, got shape {w.shape}")
    out_dim, k = w.shape
    if bits == 4 and k % 2 != 0:
        bits = 8  # cannot nibble-pack an odd input dim
    if bits == 8:
        scale = np.abs(w).max(axis=1) / 127.0  # [out]
        scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
        q = np.clip(np.rint(w / scale[:, None]), -127, 127).astype(np.int8)
        return q, scale
    if k % group_size == 0 and k > group_size:
        g = k // group_size
        wg = w.reshape(out_dim, g, group_size)
        scale = np.abs(wg).max(axis=2) / 7.0  # [out, G]
        scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
        q = np.clip(np.rint(wg / scale[:, :, None]), -7, 7).astype(np.int8)
        return pack_nibbles(q.reshape(out_dim, k)), np.ascontiguousarray(scale.T)
    scale = np.abs(w).max(axis=1) / 7.0  # [out]
    scale = np.where(scale > 0, scale, 1.0).astype(np.float32)
    q = np.clip(np.rint(w / scale[:, None]), -7, 7).astype(np.int8)
    return pack_nibbles(q), scale


def dequantize_weight_np(stored: np.ndarray, scale: np.ndarray) -> np.ndarray:
    """The float32 weight ``[out, in]`` of an on-disk pair."""
    scale = np.asarray(scale, dtype=np.float32)
    if stored.dtype == np.uint8:
        vals = unpack_nibbles(stored).astype(np.float32)  # [out, in]
        if scale.ndim == 2:  # grouped: scale [G, out]
            out_dim, k = vals.shape
            g = scale.shape[0]
            return (vals.reshape(out_dim, g, k // g) * scale.T[:, :, None]).reshape(out_dim, k)
        return vals * scale[:, None]
    return stored.astype(np.float32) * scale[:, None]


def to_bf16(a: Tensor) -> torch.Tensor:
    """Round to nearest even into bfloat16 (written as BF16)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().to(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(torch.bfloat16)


def reencode_tensor(tensors: Mapping[str, Tensor], name: str, float_dtype: str = "f32") -> Tensor:
    """One tensor of a re-encode: a float tensor becomes bfloat16 when
    ``float_dtype`` is ``"bf16"`` (never a ``.weight_scale``, which stays
    float32-exact); everything else passes through as it is."""
    a = tensors[name]
    if float_dtype == "bf16" and _is_float(a) and not name.endswith(".weight_scale"):
        return to_bf16(a)
    return a


def build_quantized_checkpoint(
    tensors: Mapping[str, Tensor],
    bits: int,
    num_heads: int = 16,
    keep_names: Optional[Iterable[str]] = None,
    float_dtype: str = "f32",
    metadata: Optional[Mapping[str, str]] = None,
) -> Tuple[Dict[str, Tensor], Dict[str, str], List[str]]:
    """``(tensors, metadata, quantized_names)`` of the pre-quantized
    checkpoint of ``tensors`` (a name → array mapping as
    ``utils.safetensors.load_file`` returns it; ``metadata`` is the source
    file's own ``__metadata__``).

    Tensors come out in name order. ``keep_names`` restricts the output;
    already-quantized and integer tensors pass through, so exporting an
    export changes nothing. ``float_dtype="bf16"`` stores the remaining
    float tensors as BF16; the scales stay F32.
    """
    if float_dtype not in ("f32", "bf16"):
        raise ValueError(f"float_dtype must be f32 or bf16, got {float_dtype!r}")
    linears = linear_weight_names(tensors, num_heads=num_heads)
    keep = set(keep_names) if keep_names is not None else None
    out: Dict[str, Tensor] = {}
    quantized: List[str] = []
    for name in sorted(tensors):
        if keep is not None and name not in keep:
            continue
        if name in linears and _is_float(tensors[name]):
            w = tensors[name]
            w = w.detach().cpu().float().numpy() if isinstance(w, torch.Tensor) else np.asarray(w, np.float32)
            q, scale = quantize_weight_np(w, bits)
            out[name] = q
            out[name + "_scale"] = scale
            quantized.append(name)
        else:
            out[name] = reencode_tensor(tensors, name, float_dtype)
    meta = dict(metadata or {})
    if quantized:
        meta[QUANT_METADATA_KEY] = "int8" if bits == 8 else f"int4-g{GROUP_SIZE}"
    # else nothing was (re-)quantized: the source's own stamp stays, so an
    # int8 artifact exported again as int4 is still labelled int8.
    return out, meta, quantized
