"""PocketTTS model facade: FlowLM + Mimi from one safetensors store, or any
name → array mapping (counterpart of ``go_pocket_tts_tpu/models/model.py``).

The per-frame latent denormalization ``latent·emb_std + emb_mean`` is folded
into the 1×1 quantizer projection at load (``w' = w·std``,
``b' = b + w·mean``), so the decode starts with a single matmul.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Union

import numpy as np
import torch

from go_pocket_tts_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from go_pocket_tts_tpu_torch.models import flow_lm as flm
from go_pocket_tts_tpu_torch.models import mimi as mimi_mod
from go_pocket_tts_tpu_torch.models.params import VarBuilder, tree_map
from go_pocket_tts_tpu_torch.utils.safetensors import Store, open_store

__all__ = [
    "ModelConfig",
    "PocketTTSModel",
    "load_model",
    "load_model_from_store",
    "load_model_from_tensors",
    "cast_params",
    "KEEP_F32",
]

Params = Dict

# Leaves (by key) and subtrees kept float32 when the model is cast: the RoPE
# tables, the scales of quantized linears (``[N]`` int8, ``[G, N]`` or
# ``[N]`` int4; the reference's ``astype`` keeps them float32 too), and the
# fused latent→mimi projector, which the decode casts to the activation type
# where it reads it (the same values the reference gets by casting it at
# load). Integer leaves (int8 and packed int4 weights) are never cast.
KEEP_F32 = ("rope_cos", "rope_sin", "scale", "latent_to_mimi")


@dataclass(frozen=True)
class ModelConfig:
    flow_lm: flm.FlowLMConfig
    mimi: mimi_mod.MimiConfig


def _fuse_latent_to_mimi(flow_params: Params, mimi_params: Params) -> Optional[Params]:
    """Fold latent denorm stats into the quantizer projection."""
    proj = mimi_params.get("quantizer_out_proj")
    if proj is None:
        return None
    w = proj["w"]  # [O, I, K]
    if w.ndim != 3 or w.shape[2] != 1:
        return None
    std, mean = flow_params["emb_std"], flow_params["emb_mean"]
    if w.shape[1] != std.shape[0]:
        return None
    w2d = w[:, :, 0]  # [O, I]
    fused_b = w2d @ mean
    if "b" in proj:
        fused_b = fused_b + proj["b"]
    # Stored transposed [I, O] so the projection is latent[B,T,I] @ w.
    return {"w": (w2d * std[None, :]).T.contiguous(), "b": fused_b}


def cast_params(
    params: Params, device: Union[str, torch.device], dtype: torch.dtype
) -> Params:
    """Move every leaf to ``device`` and cast floating leaves to ``dtype``,
    except those under :data:`KEEP_F32`, which stay float32."""

    def cast(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            leaf = torch.from_numpy(np.ascontiguousarray(leaf))
        if leaf.is_floating_point():
            keep = any(p in KEEP_F32 for p in path)
            leaf = leaf.to(dtype=torch.float32 if keep else dtype)
        return leaf.to(device=device)

    return tree_map(cast, params)


class PocketTTSModel:
    """Loaded parameters + static configs for the synthesis pipeline."""

    def __init__(self, params: Params, config: ModelConfig) -> None:
        self.params = params
        self.config = config

    @property
    def device(self) -> torch.device:
        return self.params["flow_lm"]["conditioner_embed"].device

    @property
    def dtype(self) -> torch.dtype:
        return self.params["flow_lm"]["conditioner_embed"].dtype

    def to(self, device: Union[str, torch.device], dtype: torch.dtype) -> "PocketTTSModel":
        """A copy on ``device`` with floating parameters in ``dtype`` (RoPE
        tables and the fused projector stay float32)."""
        return PocketTTSModel(cast_params(self.params, device, dtype), self.config)

    def latent_to_mimi(self, latent_btl: torch.Tensor) -> torch.Tensor:
        """``[B, T, latent] → [B, 512, T]``: fused denorm + projection."""
        fused = self.params.get("latent_to_mimi")
        if fused is not None:
            out = torch.matmul(latent_btl, fused["w"].to(latent_btl.dtype))
            out = out + fused["b"].to(latent_btl.dtype)
            return out.transpose(1, 2)
        flow = self.params["flow_lm"]
        denorm = latent_btl * flow["emb_std"] + flow["emb_mean"]
        return mimi_mod.quantizer_project(self.params["mimi"], denorm.transpose(1, 2))

    def mimi_decode(self, mimi_latent: torch.Tensor) -> torch.Tensor:
        return mimi_mod.mimi_decode(self.params["mimi"], self.config.mimi, mimi_latent)


def load_model_from_tensors(
    tensors: Mapping[str, np.ndarray],
    num_heads: int = 16,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
) -> PocketTTSModel:
    """Build the model from checkpoint arrays keyed as the safetensors file
    names them (``flow_lm.*``, ``mimi.*``), on ``device`` in ``dtype``."""
    dev = resolve_device(device)
    vb = VarBuilder(tensors)
    flow_params, flow_cfg = flm.load_flow_lm(vb, num_heads=num_heads)
    mimi_params, mimi_cfg = mimi_mod.load_mimi(vb)
    params: Params = {"flow_lm": flow_params, "mimi": mimi_params}
    fused = _fuse_latent_to_mimi(flow_params, mimi_params)
    if fused is not None:
        params["latent_to_mimi"] = fused
    return PocketTTSModel(cast_params(params, dev, dtype), ModelConfig(flow_lm=flow_cfg, mimi=mimi_cfg))


def load_model_from_store(
    store: Store,
    num_heads: int = 16,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
) -> PocketTTSModel:
    """Build the model from a parsed safetensors :class:`Store`, float or
    pre-quantized (int8 / packed int4 linears, written by
    ``model_assets.quantize_export``), on ``device`` in ``dtype``; only the
    tensors the loader reads are decoded."""
    return load_model_from_tensors(store, num_heads=num_heads, device=device, dtype=dtype)


def load_model(
    path: str,
    num_heads: int = 16,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
    dtype: torch.dtype = torch.float32,
) -> PocketTTSModel:
    """Load a safetensors checkpoint file through :func:`load_model_from_store`."""
    dev = resolve_device(device)
    return load_model_from_store(open_store(path), num_heads=num_heads, device=dev, dtype=dtype)
