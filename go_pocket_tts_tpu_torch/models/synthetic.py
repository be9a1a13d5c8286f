"""Synthetic checkpoint builder (a copy of
``go_pocket_tts_tpu/models/synthetic.py``, NumPy only).

Builds ``{name: np.ndarray}`` with the exact key naming the loader expects:

- :func:`tiny_arch` — small dims for fast CPU tests
- :func:`real_arch` — the published PocketTTS dimensions (d=1024, 16 heads,
  6 layers, latent 32, flow 512×6, Mimi 512-ch SEANet)

Weights are scaled Gaussian (≈ 1/sqrt(fan_in)) so activations stay O(1);
emb_std is strictly positive. The same seed gives the same arrays as the
reference builder for every key, in the same order: the decoder's first,
then the Mimi encoder's and the speaker projection (voice cloning), drawn
after every tensor the synthesis path reads so that those keep their bits.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from go_pocket_tts_tpu_torch.utils.safetensors import encode_tensors

__all__ = ["SynthArch", "tiny_arch", "real_arch", "build_checkpoint", "build_checkpoint_bytes"]


@dataclass(frozen=True)
class SynthArch:
    # FlowLM
    n_bins: int = 4000
    d_model: int = 1024
    num_heads: int = 16
    num_layers: int = 6
    ffn_dim: int = 4096
    latent_dim: int = 32
    # flowNet
    flow_dim: int = 512
    flow_depth: int = 6
    flow_hidden: int = 1024
    freq_half: int = 128
    te_hidden: int = 512
    # Mimi
    mimi_dim: int = 512
    mimi_layers: int = 2
    mimi_heads: int = 8
    mimi_ffn: int = 2048
    upsample_stride: int = 16
    upsample_kernel: int = 32
    seanet_channels: Tuple[int, ...] = (512, 256, 128, 64)
    seanet_strides: Tuple[int, ...] = (6, 5, 4)
    seanet_kernel_init: int = 7
    seanet_kernel_final: int = 7


def tiny_arch() -> SynthArch:
    return SynthArch(
        n_bins=64,
        d_model=64,
        num_heads=4,
        num_layers=2,
        ffn_dim=128,
        latent_dim=8,
        flow_dim=32,
        flow_depth=2,
        flow_hidden=48,
        freq_half=8,
        te_hidden=24,
        mimi_dim=32,
        mimi_layers=2,
        mimi_heads=4,
        mimi_ffn=64,
        upsample_stride=16,
        upsample_kernel=32,
        seanet_channels=(32, 16, 8, 4),
        seanet_strides=(6, 5, 4),
    )


def real_arch() -> SynthArch:
    return SynthArch()


def _lin(rng, out_dim: int, in_dim: int, bias: bool, tensors: Dict, prefix: str) -> None:
    tensors[f"{prefix}.weight"] = rng.randn(out_dim, in_dim).astype(np.float32) / np.sqrt(in_dim)
    if bias:
        tensors[f"{prefix}.bias"] = (rng.randn(out_dim) * 0.02).astype(np.float32)


def _ln(rng, dim: int, tensors: Dict, prefix: str) -> None:
    tensors[f"{prefix}.weight"] = (1.0 + 0.05 * rng.randn(dim)).astype(np.float32)
    tensors[f"{prefix}.bias"] = (0.02 * rng.randn(dim)).astype(np.float32)


def _conv(rng, out_ch: int, in_ch_per_group: int, k: int, bias: bool, tensors, prefix) -> None:
    fan_in = in_ch_per_group * k
    tensors[f"{prefix}.weight"] = (
        rng.randn(out_ch, in_ch_per_group, k).astype(np.float32) / np.sqrt(fan_in)
    )
    if bias:
        tensors[f"{prefix}.bias"] = (rng.randn(out_ch) * 0.02).astype(np.float32)


def _convtr(rng, in_ch: int, out_ch_per_group: int, k: int, bias_ch: int, bias, tensors, prefix):
    fan_in = in_ch * k
    tensors[f"{prefix}.weight"] = (
        rng.randn(in_ch, out_ch_per_group, k).astype(np.float32) / np.sqrt(fan_in)
    )
    if bias:
        tensors[f"{prefix}.bias"] = (rng.randn(bias_ch) * 0.02).astype(np.float32)


def build_checkpoint(arch: SynthArch, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    t: Dict[str, np.ndarray] = {}
    d, L, fd = arch.d_model, arch.latent_dim, arch.flow_dim

    # -- flow_lm ------------------------------------------------------------
    t["flow_lm.conditioner.embed.weight"] = rng.randn(arch.n_bins + 1, d).astype(np.float32) * 0.02
    t["flow_lm.emb_std"] = (0.5 + rng.rand(L)).astype(np.float32)
    t["flow_lm.emb_mean"] = (0.1 * rng.randn(L)).astype(np.float32)
    t["flow_lm.bos_emb"] = (0.1 * rng.randn(L)).astype(np.float32)
    _lin(rng, d, L, True, t, "flow_lm.input_linear")
    _ln(rng, d, t, "flow_lm.out_norm")
    _lin(rng, 1, d, True, t, "flow_lm.out_eos")

    for i in range(arch.num_layers):
        p = f"flow_lm.transformer.layers.{i}"
        _ln(rng, d, t, f"{p}.norm1")
        _ln(rng, d, t, f"{p}.norm2")
        _lin(rng, 3 * d, d, False, t, f"{p}.self_attn.in_proj")
        _lin(rng, d, d, False, t, f"{p}.self_attn.out_proj")
        _lin(rng, arch.ffn_dim, d, False, t, f"{p}.linear1")
        _lin(rng, d, arch.ffn_dim, False, t, f"{p}.linear2")

    # -- flow_net -----------------------------------------------------------
    for te in (0, 1):
        p = f"flow_lm.flow_net.time_embed.{te}"
        t[f"{p}.freqs"] = (np.exp(rng.rand(arch.freq_half) * 4)).astype(np.float32)
        _lin(rng, arch.te_hidden, 2 * arch.freq_half, True, t, f"{p}.mlp.0")
        _lin(rng, fd, arch.te_hidden, True, t, f"{p}.mlp.2")
        t[f"{p}.mlp.3.alpha"] = (1.0 + 0.05 * rng.randn(fd)).astype(np.float32)
    _lin(rng, fd, d, True, t, "flow_lm.flow_net.cond_embed")
    _lin(rng, fd, L, True, t, "flow_lm.flow_net.input_proj")
    for i in range(arch.flow_depth):
        p = f"flow_lm.flow_net.res_blocks.{i}"
        _ln(rng, fd, t, f"{p}.in_ln")
        _lin(rng, arch.flow_hidden, fd, True, t, f"{p}.mlp.0")
        _lin(rng, fd, arch.flow_hidden, True, t, f"{p}.mlp.2")
        _lin(rng, 3 * fd, fd, True, t, f"{p}.adaLN_modulation.1")
    _lin(rng, L, fd, True, t, "flow_lm.flow_net.final_layer.linear")
    _lin(rng, 2 * fd, fd, True, t, "flow_lm.flow_net.final_layer.adaLN_modulation.1")

    # -- mimi ---------------------------------------------------------------
    C = arch.mimi_dim
    _conv(rng, C, L, 1, False, t, "mimi.quantizer.output_proj")
    # Depthwise upsample: groups=C, weight [C, 1, K].
    _convtr(rng, C, 1, arch.upsample_kernel, C, False, t, "mimi.upsample.convtr.convtr")

    for i in range(arch.mimi_layers):
        p = f"mimi.decoder_transformer.transformer.layers.{i}"
        _ln(rng, C, t, f"{p}.norm1")
        _ln(rng, C, t, f"{p}.norm2")
        _lin(rng, 3 * C, C, False, t, f"{p}.self_attn.in_proj")
        _lin(rng, C, C, False, t, f"{p}.self_attn.out_proj")
        _lin(rng, arch.mimi_ffn, C, False, t, f"{p}.linear1")
        _lin(rng, C, arch.mimi_ffn, False, t, f"{p}.linear2")
        t[f"{p}.layer_scale_1.scale"] = np.full(C, 0.01, np.float32)
        t[f"{p}.layer_scale_2.scale"] = np.full(C, 0.01, np.float32)

    ch = arch.seanet_channels
    _conv(rng, ch[0], C, arch.seanet_kernel_init, True, t, "mimi.decoder.model.0.conv")
    for bi, (up_idx, res_idx) in enumerate([(2, 3), (5, 6), (8, 9)]):
        cin, cout = ch[bi], ch[bi + 1]
        stride = arch.seanet_strides[bi]
        _convtr(rng, cin, cout, 2 * stride, cout, True, t, f"mimi.decoder.model.{up_idx}.convtr")
        _conv(rng, cout // 2, cout, 3, True, t, f"mimi.decoder.model.{res_idx}.block.1.conv")
        _conv(rng, cout, cout // 2, 1, True, t, f"mimi.decoder.model.{res_idx}.block.3.conv")
    _conv(rng, 1, ch[-1], arch.seanet_kernel_final, True, t, "mimi.decoder.model.11.conv")

    # -- mimi encoder (voice cloning; the decoder mirrored) -------------------
    rev = tuple(reversed(ch))  # e.g. (64, 128, 256, 512)
    _conv(rng, rev[0], 1, arch.seanet_kernel_init, True, t, "mimi.encoder.model.0.conv")
    enc_strides = tuple(reversed(arch.seanet_strides))  # 4, 5, 6
    for bi, (res_idx, down_idx) in enumerate([(1, 3), (4, 6), (7, 9)]):
        cin, cout = rev[bi], rev[bi + 1]
        _conv(rng, cin // 2, cin, 3, True, t, f"mimi.encoder.model.{res_idx}.block.1.conv")
        _conv(rng, cin, cin // 2, 1, True, t, f"mimi.encoder.model.{res_idx}.block.3.conv")
        _conv(rng, cout, cin, 2 * enc_strides[bi], True, t, f"mimi.encoder.model.{down_idx}.conv")
    _conv(rng, C, rev[-1], 3, True, t, "mimi.encoder.model.11.conv")

    for i in range(arch.mimi_layers):
        p = f"mimi.encoder_transformer.transformer.layers.{i}"
        _ln(rng, C, t, f"{p}.norm1")
        _ln(rng, C, t, f"{p}.norm2")
        _lin(rng, 3 * C, C, False, t, f"{p}.self_attn.in_proj")
        _lin(rng, C, C, False, t, f"{p}.self_attn.out_proj")
        _lin(rng, arch.mimi_ffn, C, False, t, f"{p}.linear1")
        _lin(rng, C, arch.mimi_ffn, False, t, f"{p}.linear2")
        t[f"{p}.layer_scale_1.scale"] = np.full(C, 0.01, np.float32)
        t[f"{p}.layer_scale_2.scale"] = np.full(C, 0.01, np.float32)

    # Depthwise strided downsample (200 Hz → 12.5 Hz), quantizer input proj.
    _conv(rng, C, 1, 2 * arch.upsample_stride, False, t, "mimi.downsample.conv.conv")
    _conv(rng, L, C, 1, False, t, "mimi.quantizer.input_proj")

    # Speaker projection of the voice conditioning.
    t["condition_provider.conditioners.speaker_wavs.output_proj.weight"] = (
        rng.randn(d, C).astype(np.float32) / np.sqrt(C)
    )
    return t


def build_checkpoint_bytes(arch: SynthArch, seed: int = 0) -> bytes:
    """:func:`build_checkpoint` as a safetensors payload."""
    return encode_tensors(build_checkpoint(arch, seed))
