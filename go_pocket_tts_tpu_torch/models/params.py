"""Parameter-tree helpers: a dotted-prefix VarBuilder over a name → array
mapping, and the linear layer (counterpart of
``go_pocket_tts_tpu/models/params.py``: float32/bfloat16 and int8
weight-only linears; the packed int4 form is not ported yet).

Parameters are nested dicts of tensors with the reference package's keys,
so a tree from either package can be compared leaf by leaf.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from go_pocket_tts_tpu_torch.kernels import quantized_matmul as qmm

__all__ = [
    "VarBuilder",
    "linear_params",
    "layer_norm_params",
    "apply_linear",
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


def linear_params(vb: VarBuilder, name: str, with_bias: bool) -> Params:
    """Torch-layout linear (weight ``[out, in]``, optional bias), stored
    transposed to ``[in, out]`` as the reference does, so the forward is
    ``x @ w``."""
    w = vb.tensor(name + ".weight")
    if w.ndim != 2:
        raise ValueError(f"linear {name!r} weight must be rank-2, got {tuple(w.shape)}")
    params = {"w": w.T.contiguous()}
    if with_bias:
        b = vb.tensor_maybe(name + ".bias")
        if b is not None:
            if tuple(b.shape) != (w.shape[0],):
                raise ValueError(
                    f"linear {name!r} bias shape {tuple(b.shape)} incompatible with "
                    f"weight {tuple(w.shape)}"
                )
            params["b"] = b
    return params


def layer_norm_params(vb: VarBuilder, name: str) -> Params:
    return {"weight": vb.tensor(name + ".weight"), "bias": vb.tensor(name + ".bias")}


def apply_linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    """``y = x @ w (+ b)`` in the activation dtype, float32 accumulation.

    An int8 weight-only linear (``models/quantize.py``: int8 ``w``, float32
    per-column ``scale``) computes ``(x @ w) * scale`` in float32: through
    the quantized-matmul kernel where its gate admits the shape (the AR
    step's skinny products), else as a plain product of the widened weight
    (prefill, and the narrow input/EOS/flowNet-output linears), where the
    reference takes XLA's mixed-dtype dot. The bias adds after the scale.
    """
    w = params["w"]
    if w.dtype == torch.int8 and "scale" in params:
        lead, k, n = x.shape[:-1], x.shape[-1], w.shape[1]
        m = x.numel() // k
        if qmm.supports(m, k, n):
            y = qmm.quantized_matmul(x.reshape(m, k), w, params["scale"]).reshape(*lead, n)
        else:
            y = torch.matmul(x.float(), w.float()) * params["scale"].float()
        y = y.to(x.dtype)
    else:
        y = torch.matmul(x, w.to(x.dtype))
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
