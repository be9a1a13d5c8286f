"""FlowLM: text conditioner + transformer + flow-matching head (counterpart
of ``go_pocket_tts_tpu/models/flow_lm.py``).

Weight prefix ``flow_lm.*``:

- ``conditioner.embed.weight`` ``[n_bins+1, D]`` LUT text conditioner
- ``emb_std``/``emb_mean``/``bos_emb`` ``[latent]`` latent stats + BOS vector
- ``input_linear`` (latent→D), ``out_norm`` LN, ``out_eos`` (D→1)
- ``transformer.*`` (:mod:`flow_transformer`), ``flow_net.*`` (:mod:`flow_net`)

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

from go_pocket_tts_tpu_torch.models import flow_net as fnet
from go_pocket_tts_tpu_torch.models.flow_transformer import (
    TransformerConfig,
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
from go_pocket_tts_tpu_torch.ops import layer_norm

__all__ = [
    "FlowLMConfig",
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
    transformer: TransformerConfig = None  # set by the loader


def load_flow_lm(vb: VarBuilder, num_heads: int = 16) -> Tuple[Params, FlowLMConfig]:
    flow = vb.path("flow_lm")
    embed = flow.tensor("conditioner.embed.weight")
    if embed.ndim != 2:
        raise ValueError(f"conditioner embed must be rank-2, got {tuple(embed.shape)}")
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


def _hidden_and_eos(params: Params, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """out_norm → last token → eos logit. ``y``: [B,T,D] → ([B,D], [B])."""
    n = layer_norm(y, params["out_norm"]["weight"], params["out_norm"]["bias"])
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
    y, cache = transformer_forward_cached(params["transformer"], cfg.transformer, cache, x)
    last, eos = _hidden_and_eos(params, y)
    decoded = fnet.lsd_decode(params["flow_net"], last, noise, decode_steps, time_cond, fused_ada)
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
    _, cache = transformer_forward_cached(
        params["transformer"], cfg.transformer, cache, text_emb, valid_len
    )
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
    y = transformer_forward_stateless(params["transformer"], cfg.transformer, x)
    return _hidden_and_eos(params, y)


def sample_noise(generator: torch.Generator, batch: int, latent_dim: int, temperature: float) -> torch.Tensor:
    """``N(0, sqrt(temperature))`` float32 ``[batch, latent_dim]`` on the
    generator's device (zeros when ``temperature <= 0``)."""
    sigma = math.sqrt(max(float(temperature), 0.0))
    noise = torch.randn((batch, latent_dim), generator=generator, device=generator.device, dtype=torch.float32)
    return noise * sigma
