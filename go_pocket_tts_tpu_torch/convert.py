"""Convert the JAX package's parameter tree into the port's.

``params_from_jax`` takes the reference model's parameters as nested dicts
and lists of NumPy arrays (``jax.tree_util.tree_map(np.asarray,
model.params)`` on the caller's side: this module imports no JAX) and
returns the same tree as torch tensors on ``device`` in ``dtype``. The two
packages share keys and layouts (linear weights ``[in, out]``, repacked
ConvTranspose kernels, ``[S, D/2]`` RoPE tables), so no leaf is reshaped.
RoPE tables, the scales of int8 linears and the fused latent→mimi projector
stay float32; a quantized tree's int8 weights stay int8. The fused SEANet
kernels and the stream decoder read the same up2, res2, up3, res3 and
final-conv leaves as ``mimi_decode``, so they need nothing converted.

The same call carries the reference's Mimi encoder tree
(``mimi_encoder.load_mimi_encoder``) into the port's
(:mod:`models.mimi_encoder`): the two share its keys and layouts too.
"""

from __future__ import annotations

from typing import Union

import numpy as np
import torch

from go_pocket_tts_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from go_pocket_tts_tpu_torch.models.model import cast_params
from go_pocket_tts_tpu_torch.models.params import tree_map

__all__ = ["params_from_jax"]


def _to_numpy(path, leaf) -> np.ndarray:
    arr = np.asarray(leaf)
    # bfloat16 arrays (an extension dtype NumPy only knows by name) widen
    # exactly to float32; torch cannot wrap them directly.
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    if arr.dtype.kind not in "fiub":
        raise TypeError(f"params_from_jax: leaf {'.'.join(path)} has dtype {arr.dtype}")
    return np.array(arr, order="C")  # a writable copy torch can wrap


def params_from_jax(
    tree,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
):
    """The reference parameter tree (nested dicts/lists of arrays: the
    model's, or the Mimi encoder's) as the port's parameter tree on
    ``device`` in ``dtype``."""
    dev = resolve_device(device)
    return cast_params(tree_map(_to_numpy, tree), dev, dtype)
