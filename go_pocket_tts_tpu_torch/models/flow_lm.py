"""FlowLM: text conditioner + transformer + flow-matching head (counterpart
of ``go_pocket_tts_tpu/models/flow_lm.py``).

Weight prefix ``flow_lm.*``:

- ``conditioner.embed.weight`` ``[n_bins+1, D]`` LUT text conditioner
- ``emb_std``/``emb_mean``/``bos_emb`` ``[latent]`` latent stats + BOS vector
- ``input_linear`` (latent→D), ``out_norm`` LN, ``out_eos`` (D→1)
- ``transformer.*`` (:mod:`flow_transformer`), or in its place a hybrid
  Mamba-2 / attention stack ``backbone.*`` (:mod:`hybrid_backbone`);
  ``flow_net.*`` (:mod:`flow_net`)

The backbone's parameters and config live under ``params["transformer"]``
and ``FlowLMConfig.transformer`` whichever kind it is; :func:`init_cache`
and :func:`cache_keys` give its cache.

The AR contract (:func:`ar_core`; :func:`flow_main` is its stateless
full-sequence counterpart): a NaN-sentinel frame is replaced by
``bos_emb``, projected to d_model, pushed through the cached transformer
and normalized; the last
hidden state gives the EOS logit (thresholded by the caller on the raw
logit) and conditions the LSD Euler decode from noise already scaled by
``sqrt(temperature)``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple, Union

import torch

from go_pocket_tts_tpu_torch.kernels import layer_norm as lnk
from go_pocket_tts_tpu_torch.models import flow_net as fnet
from go_pocket_tts_tpu_torch.models import hybrid_backbone as hyb
from go_pocket_tts_tpu_torch.models.flow_transformer import (
    TransformerConfig,
    init_kv_cache,
    load_flow_transformer,
    transformer_forward_cached,
    transformer_forward_stateless,
)
from go_pocket_tts_tpu_torch.models.params import (
    VarBuilder,
    apply_linear,
    layer_norm_params,
    linear_params,
)

__all__ = [
    "FlowLMConfig",
    "cache_keys",
    "init_cache",
    "is_hybrid",
    "load_flow_lm",
    "text_embeddings",
    "prompt",
    "ar_core",
    "flow_main",
    "sample_noise",
]

Params = Dict


@dataclass(frozen=True)
class FlowLMConfig:
    d_model: int = 1024
    latent_dim: int = 32
    # The backbone's: a TransformerConfig, or a hybrid_backbone.HybridConfig
    # (set by the loader).
    transformer: Union[TransformerConfig, hyb.HybridConfig] = None


def is_hybrid(cfg: FlowLMConfig) -> bool:
    """Whether the backbone is the hybrid Mamba-2 / attention stack."""
    return isinstance(cfg.transformer, hyb.HybridConfig)


def init_cache(
    cfg: FlowLMConfig, batch: int, capacity: int, dtype: torch.dtype = torch.float32, device="cpu"
) -> Params:
    """A zero cache of the backbone: the transformer's KV cache, or the
    hybrid's KV cache and recurrent states."""
    init = hyb.init_cache if is_hybrid(cfg) else init_kv_cache
    return init(cfg.transformer, batch, capacity, dtype, device)


def cache_keys(cfg: FlowLMConfig) -> Tuple[str, ...]:
    """The leaves of the backbone's cache."""
    return hyb.CACHE_KEYS if is_hybrid(cfg) else ("k", "v", "offset")


def _forward_cached(params: Params, cfg: FlowLMConfig, cache: Params, x: torch.Tensor, valid_len=None):
    forward = hyb.forward_cached if is_hybrid(cfg) else transformer_forward_cached
    return forward(params["transformer"], cfg.transformer, cache, x, valid_len)


def load_flow_lm(vb: VarBuilder, num_heads: int = 16) -> Tuple[Params, FlowLMConfig]:
    flow = vb.path("flow_lm")
    embed = flow.tensor("conditioner.embed.weight")
    if embed.ndim != 2:
        raise ValueError(f"conditioner embed must be rank-2, got {tuple(embed.shape)}")
    if flow.has("backbone.layers.0.input_layernorm.weight"):
        transformer, tcfg = hyb.load_hybrid_backbone(flow, num_heads)
    else:
        transformer, tcfg = load_flow_transformer(flow, num_heads=num_heads)
    latent_dim = int(flow.shape("bos_emb")[0])
    params = {
        "conditioner_embed": embed,
        "transformer": transformer,
        "flow_net": fnet.load_flow_net(flow.path("flow_net")),
        "emb_std": flow.tensor("emb_std", latent_dim),
        "emb_mean": flow.tensor("emb_mean", latent_dim),
        "bos_emb": flow.tensor("bos_emb", latent_dim),
        "input_linear": linear_params(flow, "input_linear", with_bias=True),
        "out_norm": layer_norm_params(flow, "out_norm"),
        "out_eos": linear_params(flow, "out_eos", with_bias=True),
    }
    return params, FlowLMConfig(d_model=tcfg.d_model, latent_dim=latent_dim, transformer=tcfg)


def text_embeddings(params: Params, token_ids: torch.Tensor) -> torch.Tensor:
    """Token IDs ``[B, T]`` → embeddings ``[B, T, D]`` (LUT gather). The
    caller checks the ids' range on the host."""
    return params["conditioner_embed"][token_ids]


def _replace_nan_with_bos(frame: torch.Tensor, bos: torch.Tensor) -> torch.Tensor:
    """NaN sentinel → BOS vector."""
    return torch.where(torch.isnan(frame), bos.to(frame.dtype), frame)


def _hidden_and_eos(
    params: Params, y: torch.Tensor, use_kernels: bool = False
) -> Tuple[torch.Tensor, torch.Tensor]:
    """out_norm → last token → eos logit. ``y``: [B,T,D] → ([B,D], [B]);
    the norm through the fused LayerNorm kernel with ``use_kernels``."""
    norm = lnk.layer_norm if use_kernels else lnk.layer_norm_plain
    n = norm(y, params["out_norm"]["weight"], params["out_norm"]["bias"])
    last = n[:, -1, :]
    return last, apply_linear(params["out_eos"], last)[:, 0]


def ar_core(
    params: Params,
    cfg: FlowLMConfig,
    cache: Params,
    frame: torch.Tensor,
    noise: torch.Tensor,
    decode_steps: int = 1,
    time_cond: Optional[torch.Tensor] = None,
    fused_ada: Optional[Params] = None,
) -> Tuple[Params, torch.Tensor, torch.Tensor]:
    """One stateful AR step. ``frame``: [B,1,L] previous latent (NaN = BOS);
    ``noise``: [B,L] already scaled by sqrt(temperature). Returns
    ``(cache, next_frame [B,1,L], eos_logit [B])``; EOS thresholding and the
    countdown are the caller's."""
    seq = _replace_nan_with_bos(frame, params["bos_emb"])
    x = apply_linear(params["input_linear"], seq)
    y, cache = _forward_cached(params, cfg, cache, x)
    kernels = cfg.transformer.use_kernels
    last, eos = _hidden_and_eos(params, y, kernels)
    decoded = fnet.lsd_decode(params["flow_net"], last, noise, decode_steps, time_cond, fused_ada, kernels)
    return cache, decoded[:, None, :], eos


def prompt(
    params: Params,
    cfg: FlowLMConfig,
    cache: Params,
    text_emb: torch.Tensor,
    valid_len: Union[int, torch.Tensor, None] = None,
) -> Params:
    """Prefill the transformer cache with conditioning embeddings
    ``text_emb`` [B, T, D], zero-padded to T with ``valid_len`` real
    tokens."""
    _, cache = _forward_cached(params, cfg, cache, text_emb, valid_len)
    return cache


def flow_main(
    params: Params, cfg: FlowLMConfig, sequence: torch.Tensor, text_emb: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stateless full-resequence forward: the latent frames ``sequence``
    [B, T, L] (NaN = BOS) projected to d_model after the text conditioning
    ``text_emb`` [B, Tt, D], through the causal transformer from position
    0; returns ``(last_hidden [B, D], eos_logit [B])``."""
    seq = _replace_nan_with_bos(sequence, params["bos_emb"])
    x = torch.cat([text_emb, apply_linear(params["input_linear"], seq)], dim=1)
    stateless = hyb.forward_stateless if is_hybrid(cfg) else transformer_forward_stateless
    y = stateless(params["transformer"], cfg.transformer, x)
    return _hidden_and_eos(params, y, cfg.transformer.use_kernels)


def sample_noise(generator: torch.Generator, batch: int, latent_dim: int, temperature: float) -> torch.Tensor:
    """``N(0, sqrt(temperature))`` float32 ``[batch, latent_dim]`` on the
    generator's device (zeros when ``temperature <= 0``)."""
    sigma = math.sqrt(max(float(temperature), 0.0))
    noise = torch.randn((batch, latent_dim), generator=generator, device=generator.device, dtype=torch.float32)
    return noise * sigma
