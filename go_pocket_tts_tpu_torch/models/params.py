"""Parameter-tree helpers: a dotted-prefix VarBuilder over a name → array
mapping, the checkpoint loader of linear layers (float, or pre-quantized
int8 / packed int4), and the linear layer itself (counterpart of
``go_pocket_tts_tpu/models/params.py``).

Parameters are nested dicts of tensors with the reference package's keys,
so a tree from either package can be compared leaf by leaf.

The quantized linears' formulations are module-level switches, as in the
reference: :func:`set_quantized_matmul_backend` (int8: ``"pallas"``, the
quantized-matmul kernel where its gate admits the shape, or ``"xla"``, the
plain product) and :func:`set_int4_matmul_variant` (packed int4:
``"pallas"``, the int4 kernel, ``"split"``, the per-group float32 product,
or ``"dequant"``, one product on the dequantized weight; env
``POCKETTTS_INT4_VARIANT``). A ``:interpret`` suffix is accepted and means
the kernel's plain version. The defaults are the kernels, where the
reference's are ``"xla"`` and ``"split"``: the port's kernels are what its
card paths were measured with. :func:`matmul_backends` sets both for one
thread while a block runs (a runtime built with ``pallas=False`` runs its
device work inside it), over the module-level values.
"""

from __future__ import annotations

import contextlib
import os
import threading
from typing import Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

from go_pocket_tts_tpu_torch.kernels import int4_matmul as i4mm
from go_pocket_tts_tpu_torch.kernels import quantized_matmul as qmm
from go_pocket_tts_tpu_torch.models.quantize import depack_int4_pairs, dequantize_weight

__all__ = [
    "VarBuilder",
    "linear_params",
    "layer_norm_params",
    "record_linear_weight_names",
    "apply_linear",
    "matmul_backends",
    "set_int4_matmul_variant",
    "set_quantized_matmul_backend",
    "tree_map",
]

Params = Dict


class VarBuilder:
    """Dotted-prefix view over ``{name: np.ndarray}`` yielding float32 CPU
    tensors."""

    def __init__(self, tensors: Mapping[str, np.ndarray], prefix: str = "") -> None:
        self._tensors = tensors
        self._prefix = prefix

    def path(self, *parts: str) -> "VarBuilder":
        joined = ".".join(parts)
        prefix = f"{self._prefix}.{joined}" if self._prefix else joined
        return VarBuilder(self._tensors, prefix)

    def full_name(self, name: str) -> str:
        return f"{self._prefix}.{name}" if self._prefix else name

    def has(self, name: str) -> bool:
        return self.full_name(name) in self._tensors

    def shape(self, name: str) -> Tuple[int, ...]:
        return tuple(np.shape(self._require(name)))

    def _require(self, name: str) -> np.ndarray:
        full = self.full_name(name)
        if full not in self._tensors:
            raise KeyError(f"tensor {full!r} not found")
        return self._tensors[full]

    def tensor(self, name: str, *shape: int) -> torch.Tensor:
        arr = np.asarray(self._require(name))
        if arr.dtype.kind not in "fiu":
            raise ValueError(f"tensor {self.full_name(name)!r} has dtype {arr.dtype}")
        if shape and tuple(arr.shape) != tuple(shape):
            raise ValueError(
                f"tensor {self.full_name(name)!r} has shape {arr.shape}, expected {tuple(shape)}"
            )
        return torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32))

    def tensor_maybe(self, name: str) -> Optional[torch.Tensor]:
        return self.tensor(name) if self.has(name) else None

    def raw(self, name: str) -> np.ndarray:
        """The stored array as it is (int8 and uint8 stay integers)."""
        return np.asarray(self._require(name))


# While set (by record_linear_weight_names), every linear_params call appends
# the full checkpoint name of its weight: the exporter quantizes exactly the
# tensors the loader treats as linears, the loader being the ground truth.
_LINEAR_NAMES_RECORDER: Optional[List[str]] = None


@contextlib.contextmanager
def record_linear_weight_names():
    global _LINEAR_NAMES_RECORDER
    prev = _LINEAR_NAMES_RECORDER
    names: List[str] = []
    _LINEAR_NAMES_RECORDER = names
    try:
        yield names
    finally:
        _LINEAR_NAMES_RECORDER = prev


def _bias(vb: VarBuilder, name: str, out_dim: int) -> Optional[torch.Tensor]:
    b = vb.tensor_maybe(name + ".bias")
    if b is not None and tuple(b.shape) != (out_dim,):
        raise ValueError(f"linear {name!r} bias shape {tuple(b.shape)} incompatible with out dim {out_dim}")
    return b


def _prequantized_linear_params(vb: VarBuilder, name: str, with_bias: bool) -> Params:
    """A linear of a pre-quantized checkpoint: ``weight`` int8 ``[out, in]``
    or packed uint8 ``[out, in/2]`` (nibbles paired along ``in``) and
    ``weight_scale`` float32 in the runtime orientation (``[out]``, or
    ``[G, out]`` for group-wise int4). The packed buffer transposes straight
    into ``pack_int4_rows``' ``[in/2, out]`` form: same bytes, no nibble
    surgery."""
    w = torch.from_numpy(np.ascontiguousarray(vb.raw(name + ".weight").T))
    scale = torch.from_numpy(np.ascontiguousarray(vb.raw(name + ".weight_scale"), dtype=np.float32))
    out_dim = w.shape[1]
    if scale.shape[-1] != out_dim:
        raise ValueError(f"linear {name!r}: scale shape {tuple(scale.shape)} incompatible with out dim {out_dim}")
    params = {"w": w, "scale": scale}
    b = _bias(vb, name, out_dim) if with_bias else None
    if b is not None:
        params["b"] = b
    return params


def linear_params(vb: VarBuilder, name: str, with_bias: bool) -> Params:
    """Torch-layout linear (weight ``[out, in]``, optional bias), stored
    transposed to ``[in, out]`` as the reference does, so the forward is
    ``x @ w``. A weight stored as int8 or uint8 (a pre-quantized
    checkpoint) loads straight into the quantized form."""
    if _LINEAR_NAMES_RECORDER is not None:
        _LINEAR_NAMES_RECORDER.append(vb.full_name(name + ".weight"))
    if vb.has(name + ".weight") and vb.raw(name + ".weight").dtype in (np.int8, np.uint8):
        return _prequantized_linear_params(vb, name, with_bias)
    w = vb.tensor(name + ".weight")
    if w.ndim != 2:
        raise ValueError(f"linear {name!r} weight must be rank-2, got {tuple(w.shape)}")
    params = {"w": w.T.contiguous()}
    b = _bias(vb, name, w.shape[0]) if with_bias else None
    if b is not None:
        params["b"] = b
    return params


def layer_norm_params(vb: VarBuilder, name: str) -> Params:
    return {"weight": vb.tensor(name + ".weight"), "bias": vb.tensor(name + ".bias")}


_QUANT_BACKENDS = ("xla", "pallas")
_INT4_VARIANTS = ("split", "dequant", "pallas")
_QUANT_BACKEND = "pallas"
_INT4_VARIANT = os.environ.get("POCKETTTS_INT4_VARIANT", "pallas")
# Per thread: the (int8 backend, int4 variant) pair matmul_backends set.
_SCOPED = threading.local()


def _checked(value: str, allowed: Tuple[str, ...], what: str) -> str:
    if value.split(":")[0] not in allowed:
        raise ValueError(f"unknown {what} {value!r}")
    return value


def set_quantized_matmul_backend(backend: str) -> None:
    """int8 linears: ``"pallas"`` (the kernel) or ``"xla"`` (the plain
    product); ``:interpret`` means the kernel's plain version."""
    global _QUANT_BACKEND
    _QUANT_BACKEND = _checked(backend, _QUANT_BACKENDS, "quantized matmul backend")


def set_int4_matmul_variant(variant: str) -> None:
    """Packed int4 linears: ``"pallas"`` (the kernel), ``"split"`` or
    ``"dequant"``; ``:interpret`` means the kernel's plain version."""
    global _INT4_VARIANT
    _INT4_VARIANT = _checked(variant, _INT4_VARIANTS, "int4 matmul variant")


@contextlib.contextmanager
def matmul_backends(quantized: str, int4: str) -> Iterator[None]:
    """Both switches, on this thread only, while the block runs."""
    pair = (_checked(quantized, _QUANT_BACKENDS, "quantized matmul backend"),
            _checked(int4, _INT4_VARIANTS, "int4 matmul variant"))
    prev = getattr(_SCOPED, "pair", None)
    _SCOPED.pair = pair
    try:
        yield
    finally:
        _SCOPED.pair = prev


def _backends() -> Tuple[str, str]:
    return getattr(_SCOPED, "pair", None) or (_QUANT_BACKEND, _INT4_VARIANT)


def _int4_product(x2: torch.Tensor, w: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """``x2 [M, K]`` times a packed int4 linear outside the int4 kernel's
    gate, float32: what the reference's default ``"split"`` variant
    computes — per-group float32 partials times ``scale [G, N]``, summed
    (the kernel's plain version), or for per-channel int4 the paired
    product times ``scale [N]``."""
    m, k = x2.shape
    n = w.shape[1]
    if scale.ndim == 2:
        return i4mm.int4_matmul_plain(x2, w, scale)
    return torch.matmul(x2.float(), depack_int4_pairs(w).reshape(k, n).float()) * scale.float()


def _product(x: torch.Tensor, w: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` (``w`` in x's dtype) as ``out_dtype``: float32 products of
    the rounded operands when a float32 result is asked of a bfloat16 ``x``."""
    w = w.to(x.dtype)
    if out_dtype == x.dtype:
        return torch.matmul(x, w)
    return torch.matmul(x.float(), w.float())


def apply_linear(params: Params, x: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``y = x @ w (+ b)`` in the activation dtype, float32 accumulation.

    Quantized linears (``models/quantize.py``) are told apart by the weight's
    dtype, and compute in float32 with the scale applied to the product:
    - int8 ``w``, ``scale [N]``: ``(x @ w) * scale``, through the
      quantized-matmul kernel where its gate admits the shape (the AR step's
      skinny products; the kernel also casts and adds the bias, so the
      linear is one launch), else as a plain product of the widened weight
      (prefill, and the narrow input/EOS/flowNet-output linears), where the
      reference takes XLA's mixed-dtype dot;
    - packed int4 ``w`` (uint8), ``scale [G, N]`` or ``[N]``: through the
      int4 kernel where its gate admits the shape (the AR step's group-wise
      linears; cast and bias fused as for int8), else
      :func:`_int4_product`.
    The backend switches above can send either to its plain form. The
    result is cast to the activation dtype, then the bias is added in it.

    ``out_dtype=torch.float32`` returns the product before that cast: a
    tensor-parallel rank's partial, which the ranks sum and round once. A
    linear with a bias refuses it, so that no bias is added once per rank.
    """
    w = params["w"]
    out = x.dtype if out_dtype is None else out_dtype
    if out_dtype is not None and "b" in params:
        raise ValueError("apply_linear: a partial product (out_dtype) of a linear with a bias")
    if w.dtype in (torch.int8, torch.uint8):
        if "scale" not in params:
            raise ValueError(f"linear weight of dtype {w.dtype} without a scale")
        lead, k, n = x.shape[:-1], x.shape[-1], w.shape[1]
        m = x.numel() // k
        x2 = x.reshape(m, k)
        scale = params["scale"]
        quant, int4 = _backends()
        if w.dtype == torch.uint8:
            if int4 == "pallas" and i4mm.supports(m, k, n, tuple(scale.shape)):
                y = i4mm.int4_matmul(x2, w, scale, bias=params.get("b"), out_dtype=out)
                return y.reshape(*lead, n)
            if int4 == "dequant":
                y = _product(x2, dequantize_weight(params), out)
            else:
                y = _int4_product(x2, w, scale)
        elif quant == "pallas" and qmm.supports(m, k, n):
            y = qmm.quantized_matmul(x2, w, scale, bias=params.get("b"), out_dtype=out)
            return y.reshape(*lead, n)
        else:
            y = torch.matmul(x2.float(), w.float()) * scale.float()
        y = y.reshape(*lead, n).to(out)
    else:
        y = _product(x, w, out)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


def tree_map(fn, tree, path: Tuple[str, ...] = ()):
    """Apply ``fn(path, leaf)`` to every tensor leaf of a nested dict/list."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, path + (str(i),)) for i, v in enumerate(tree))
    return fn(path, tree)
