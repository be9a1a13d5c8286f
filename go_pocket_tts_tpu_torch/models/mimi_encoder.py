"""Mimi encoder: PCM → latent, for voice cloning (counterpart of
``go_pocket_tts_tpu/models/mimi_encoder.py``).

The decoder of :mod:`models.mimi` in reverse::

    PCM [B,1,N] ──SEANet encoder (conv ↓4 ↓5 ↓6, ELU, res blocks)──> [B,C,N/120]
      ──encoder transformer (windowed 250)──> [B,C,200 Hz]
      ──downsample conv (stride 16, depthwise)──> [B,C,12.5 Hz]
      ──quantizer input_proj (1×1, C→latent)──> [B,L,T]

Weights sit under ``mimi.encoder.*``, ``mimi.encoder_transformer.*``,
``mimi.downsample.*`` and ``mimi.quantizer.input_proj``; the speaker
projection under
``condition_provider.conditioners.speaker_wavs.output_proj.weight``.

The encoder runs the decoder's own pieces: its convolutions and res blocks,
and its windowed transformer (:func:`models.mimi._transformer`), which
takes blocked local attention where the sequence is a multiple of 256
positions and dense attention elsewhere; the reference always runs the
dense form, which computes the same function. Its RoPE table has the
reference's 8192 rows, so an encode covers at most 8192 steps at 200 Hz
(40.96 s of audio); a longer input raises ``ValueError``. Every conv is
causal (left-padded), so right-padding the audio leaves the kept frames
as they are. None of this is a TPU kernel in the reference (XLA
convolutions and plain ``jnp``), so the port computes it with PyTorch's
own ops.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from go_pocket_tts_tpu_torch.models.mimi import (
    MimiConfig,
    _conv,
    _load_conv,
    _load_resblock,
    _load_transformer_layer,
    _resblock,
    _transformer,
)
from go_pocket_tts_tpu_torch.models.params import VarBuilder
from go_pocket_tts_tpu_torch.ops import build_rope_tables, causal_conv1d, elu

__all__ = ["ROPE_ROWS", "load_mimi_encoder", "mimi_encode", "load_speaker_projection"]

Params = Dict

# Rows of the encoder transformer's RoPE table: its positions at 200 Hz.
ROPE_ROWS = 8192

# Encoder layer indices mirror the decoder's Sequential numbering (conv at
# 0; per downsample stage: res block then strided conv; final conv).
_ENC_RES_IDX = (1, 4, 7)
_ENC_DOWN_IDX = (3, 6, 9)
_ENC_FINAL_IDX = 11


def load_mimi_encoder(vb: VarBuilder, cfg: MimiConfig) -> Optional[Params]:
    """The encoder's parameters as float32 CPU tensors; None when the
    checkpoint has no encoder (the no-voice-cloning checkpoint)."""
    mimi = vb.path("mimi")
    if not mimi.path("encoder", "model", "0", "conv").has("weight"):
        return None

    layers = []
    while mimi.path("encoder_transformer", "transformer", "layers", str(len(layers))).has("norm1.weight"):
        layers.append(_load_transformer_layer(mimi.path("encoder_transformer", "transformer", "layers", str(len(layers)))))
    transformer: Params = {"layers": layers}
    if layers:
        head_dim = layers[0]["out_proj"]["w"].shape[1] // cfg.num_heads
        transformer["rope_cos"], transformer["rope_sin"] = build_rope_tables(ROPE_ROWS, head_dim, cfg.max_period)

    params: Params = {
        "init_conv": _load_conv(mimi.path("encoder", "model", "0", "conv"), with_bias=True),
        "final_conv": _load_conv(mimi.path("encoder", "model", str(_ENC_FINAL_IDX), "conv"), with_bias=True),
        "transformer": transformer,
        "downsample": _load_conv(mimi.path("downsample", "conv", "conv"), with_bias=False),
    }
    if mimi.path("quantizer", "input_proj").has("weight"):
        params["quantizer_in_proj"] = _load_conv(mimi.path("quantizer", "input_proj"), with_bias=False)
    for slot, (res_idx, down_idx) in enumerate(zip(_ENC_RES_IDX, _ENC_DOWN_IDX)):
        params[f"res{slot + 1}"] = _load_resblock(mimi.path("encoder", "model", str(res_idx)))
        params[f"down{slot + 1}"] = _load_conv(mimi.path("encoder", "model", str(down_idx), "conv"), with_bias=True)
    return params


def mimi_encode(params: Params, cfg: MimiConfig, pcm: torch.Tensor, to_latent: bool = False) -> torch.Tensor:
    """``[B, 1, N] PCM → [B, C, T]`` embedding at 12.5 Hz; with
    ``to_latent=True`` also the quantizer's ``input_proj`` to the flow
    latent ``[B, L, T]``."""
    strides = tuple(reversed(cfg.seanet_strides))  # the encoder downsamples 4, 5, 6
    rope = params["transformer"].get("rope_cos")
    limit = None if rope is None else rope.shape[0]
    hop = strides[0] * strides[1] * strides[2]
    if limit is not None and pcm.shape[-1] // hop > limit:
        raise ValueError(
            f"audio of {pcm.shape[-1]} samples takes {pcm.shape[-1] // hop} encoder steps; the encoder's "
            f"position table covers {limit} ({limit * hop / cfg.sample_rate:.2f} s at {cfg.sample_rate} Hz)"
        )
    x = _conv(params["init_conv"], pcm)
    for slot, stride in enumerate(strides):
        x = elu(_resblock(params[f"res{slot + 1}"], x))
        p = params[f"down{slot + 1}"]
        x = causal_conv1d(x, p["w"], p.get("b"), stride=stride)
    x = _conv(params["final_conv"], elu(x))
    if params["transformer"]["layers"]:
        x = _transformer(params, cfg, x)
    # Depthwise strided downsample 200 Hz → 12.5 Hz.
    p = params["downsample"]
    groups = p["w"].shape[0] if p["w"].shape[1] == 1 else 1
    x = causal_conv1d(x, p["w"], p.get("b"), stride=cfg.steps_per_latent, groups=groups)
    if not to_latent:
        return x
    q = params["quantizer_in_proj"]
    out = torch.einsum("oc,bct->bot", q["w"][:, :, 0].float(), x.float()).to(x.dtype)
    if "b" in q:
        out = out + q["b"].to(out.dtype)[None, :, None]
    return out


def load_speaker_projection(vb: VarBuilder) -> Optional[torch.Tensor]:
    """The speaker-conditioning projection ``[d_model, C]``, or None."""
    name = "condition_provider.conditioners.speaker_wavs.output_proj.weight"
    return vb.tensor(name) if vb.has(name) else None
