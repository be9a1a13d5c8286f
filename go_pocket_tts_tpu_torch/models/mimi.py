"""Mimi decoder: latent upsampling, windowed transformer, SEANet vocoder
(counterpart of ``go_pocket_tts_tpu/models/mimi.py``; decode path only).

Weight prefix ``mimi.*``:

- ``quantizer.output_proj``: 1×1 conv latent→512 (usually pre-fused into
  the latent→mimi projector, see :mod:`models.model`)
- ``upsample.convtr.convtr``: depthwise ConvTranspose1d, stride 16
  (12.5 Hz → 200 Hz)
- ``decoder_transformer.transformer.layers.N``: 8 heads, causal window 250,
  ``layer_scale_{1,2}``, RoPE, GELU FFN
- ``decoder.model.{0,2,3,5,6,8,9,11}``: SEANet — conv → convT(s6) → res →
  convT(s5) → res → convT(s4) → res → conv, ELU activations, streaming
  causal conv semantics
- 16·6·5·4 = 1920 output samples per 12.5 Hz latent frame at 24 kHz

Every stage is causal, so decoding a right-padded latent bucket yields a
sample-exact prefix. The last two SEANet stages go through the fused
kernels of ``kernels/seanet_tail.py`` where their gates take the shape: up2
→ res2 → ELU through ``fused_up2_res`` (the reference wrote that kernel for
this decode and could not fit it in a TPU's scoped VMEM; its
``mimi_decode`` runs the ops), then up3 → res3 → final conv through the
fused tail kernels, as in the reference's kernel branch. The wrappers
launch the CUDA kernels for CUDA tensors and run their plain versions on
the CPU. The stream decoder (:mod:`models.mimi_stream`) runs the same
stages through the cascade kernel instead. The transformer's norms go
through the fused LayerNorm kernel, which reads its transposed input in
place. ``MimiConfig.use_kernels=False`` (the reference's ``use_pallas``)
calls the plain versions on any device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Tuple

import torch

from go_pocket_tts_tpu_torch.kernels import layer_norm as lnk
from go_pocket_tts_tpu_torch.kernels import seanet_tail
from go_pocket_tts_tpu_torch.models.params import VarBuilder, apply_linear, layer_norm_params, linear_params
from go_pocket_tts_tpu_torch.ops import (
    apply_rope,
    attention_with_positions,
    build_rope_tables,
    causal_conv1d,
    conv_transpose1d_trim,
    elu,
    gelu_erf,
    repack_conv_transpose_kernel,
)
from go_pocket_tts_tpu_torch.ops.local_attention import local_windowed_attention

__all__ = [
    "MimiConfig",
    "load_mimi",
    "mimi_decode",
    "quantizer_project",
    "tail_weights",
    "takes_up2_kernel",
    "up2_weights",
    "takes_cascade_kernel",
    "cascade_weights",
]

Params = Dict


@dataclass(frozen=True)
class MimiConfig:
    sample_rate: int = 24_000
    frame_rate: float = 12.5
    encoder_frame_rate: float = 200.0
    num_heads: int = 8
    max_period: float = 10000.0
    context: int = 250
    upsample_groups: int = 512  # read from the checkpoint at load
    seanet_strides: Tuple[int, int, int] = (6, 5, 4)
    use_kernels: bool = True  # False: the SEANet and norm kernels' plain versions, on any device

    @property
    def steps_per_latent(self) -> int:
        """Upsample factor 200/12.5 = 16."""
        if self.frame_rate <= 0 or self.encoder_frame_rate <= 0:
            return 1
        return max(int(self.encoder_frame_rate / self.frame_rate), 1)

    @property
    def samples_per_latent(self) -> int:
        """1920 samples per latent frame (16 × 6 × 5 × 4 upsampling)."""
        return int(round(self.sample_rate / self.frame_rate))


def _load_conv(vb: VarBuilder, with_bias: bool) -> Params:
    w = vb.tensor("weight")
    if w.ndim != 3:
        raise ValueError(f"conv1d weight must be rank-3, got {tuple(w.shape)}")
    p = {"w": w}
    if with_bias:
        b = vb.tensor_maybe("bias")
        if b is not None:
            p["b"] = b
    return p


def _load_convtr(vb: VarBuilder, groups: int, with_bias: bool) -> Params:
    w = vb.tensor("weight")  # [I, O/g, K]
    if w.ndim != 3:
        raise ValueError(f"convtranspose1d weight must be rank-3, got {tuple(w.shape)}")
    p = {"w": repack_conv_transpose_kernel(w, groups)}
    if with_bias:
        b = vb.tensor_maybe("bias")
        if b is not None:
            p["b"] = b
    return p


def _load_resblock(vb: VarBuilder) -> Params:
    return {
        "conv1": _load_conv(vb.path("block", "1", "conv"), with_bias=True),
        "conv2": _load_conv(vb.path("block", "3", "conv"), with_bias=True),
    }


def _load_transformer_layer(vb: VarBuilder) -> Params:
    p = {
        "norm1": layer_norm_params(vb, "norm1"),
        "norm2": layer_norm_params(vb, "norm2"),
        "in_proj": linear_params(vb, "self_attn.in_proj", with_bias=False),
        "out_proj": linear_params(vb, "self_attn.out_proj", with_bias=False),
        "linear1": linear_params(vb, "linear1", with_bias=False),
        "linear2": linear_params(vb, "linear2", with_bias=False),
    }
    for key in ("layer_scale_1", "layer_scale_2"):
        scale = vb.tensor_maybe(f"{key}.scale")
        if scale is not None:
            p[key] = scale
    return p


def load_mimi(vb: VarBuilder, cfg: MimiConfig = MimiConfig()) -> Tuple[Params, MimiConfig]:
    mimi = vb.path("mimi")
    layers = []
    i = 0
    while mimi.path("decoder_transformer", "transformer", "layers", str(i)).has("norm1.weight"):
        layers.append(
            _load_transformer_layer(mimi.path("decoder_transformer", "transformer", "layers", str(i)))
        )
        i += 1
    if not layers:
        raise ValueError("mimi: no decoder transformer layers found")

    d_model = layers[0]["out_proj"]["w"].shape[1]
    if d_model % cfg.num_heads != 0:
        raise ValueError(f"mimi d_model {d_model} not divisible by heads {cfg.num_heads}")
    cos, sin = build_rope_tables(8192, d_model // cfg.num_heads, cfg.max_period)

    upsample_groups = int(mimi.path("upsample", "convtr", "convtr").shape("weight")[0])
    cfg = replace(cfg, upsample_groups=upsample_groups)
    model = mimi.path("decoder", "model")
    params = {
        "quantizer_out_proj": _load_conv(mimi.path("quantizer", "output_proj"), with_bias=False),
        "upsample": _load_convtr(
            mimi.path("upsample", "convtr", "convtr"), groups=upsample_groups, with_bias=False
        ),
        "transformer": {"layers": layers, "rope_cos": cos, "rope_sin": sin},
        "init_conv": _load_conv(model.path("0", "conv"), with_bias=True),
        "up1": _load_convtr(model.path("2", "convtr"), 1, True),
        "res1": _load_resblock(model.path("3")),
        "up2": _load_convtr(model.path("5", "convtr"), 1, True),
        "res2": _load_resblock(model.path("6")),
        "up3": _load_convtr(model.path("8", "convtr"), 1, True),
        "res3": _load_resblock(model.path("9")),
        "final_conv": _load_conv(model.path("11", "conv"), with_bias=True),
    }
    return params, cfg


# -- forward ----------------------------------------------------------------


def quantizer_project(params: Params, latent_bct: torch.Tensor) -> torch.Tensor:
    """``[B, latent, T] → [B, 512, T]`` 1×1 conv; used only when the fused
    latent→mimi projector is bypassed."""
    p = params["quantizer_out_proj"]
    w = p["w"][:, :, 0]  # [O, I]
    out = torch.einsum("oc,bct->bot", w.float(), latent_bct.float()).to(latent_bct.dtype)
    if "b" in p:
        out = out + p["b"].to(out.dtype)[None, :, None]
    return out


def _convtr(p: Params, x: torch.Tensor, stride: int, groups: int = 1) -> torch.Tensor:
    return conv_transpose1d_trim(x, p["w"], p.get("b"), stride, groups)


def _conv(p: Params, x: torch.Tensor) -> torch.Tensor:
    return causal_conv1d(x, p["w"], p.get("b"))


def _resblock(p: Params, x: torch.Tensor) -> torch.Tensor:
    h = _conv(p["conv1"], elu(x))
    h = _conv(p["conv2"], elu(h))
    return x + h


def _transformer(params: Params, cfg: MimiConfig, x: torch.Tensor) -> torch.Tensor:
    """Windowed-causal transformer over ``[B, C, T]``."""
    tp = params["transformer"]
    x = x.transpose(1, 2)  # [B, T, C]
    b, t, d = x.shape
    head_dim = tp["rope_cos"].shape[1] * 2
    num_heads = d // head_dim
    pos = torch.arange(t, dtype=torch.int32, device=x.device)
    norm = lnk.layer_norm if cfg.use_kernels else lnk.layer_norm_plain

    def heads(z):
        return z.reshape(b, t, num_heads, head_dim).transpose(1, 2)

    for layer in tp["layers"]:
        n1 = norm(x, layer["norm1"]["weight"], layer["norm1"]["bias"])
        q, k, v = (heads(z) for z in apply_linear(layer["in_proj"], n1).chunk(3, dim=-1))
        q = apply_rope(q, tp["rope_cos"], tp["rope_sin"], 0)
        k = apply_rope(k, tp["rope_cos"], tp["rope_sin"], 0)
        # Blocked local attention avoids the dense [T,T] scores when the
        # sequence is long and block-divisible (window 250 <= block 256).
        if t % 256 == 0 and t > 256 and cfg.context <= 256:
            a = local_windowed_attention(q, k, v, cfg.context, block=256)
        else:
            a = attention_with_positions(q, k, v, pos, pos, cfg.context)
        a = apply_linear(layer["out_proj"], a.transpose(1, 2).reshape(b, t, d))
        if "layer_scale_1" in layer:
            a = a * layer["layer_scale_1"].to(a.dtype)
        x = x + a

        n2 = norm(x, layer["norm2"]["weight"], layer["norm2"]["bias"])
        ff = apply_linear(layer["linear2"], gelu_erf(apply_linear(layer["linear1"], n2)))
        if "layer_scale_2" in layer:
            ff = ff * layer["layer_scale_2"].to(ff.dtype)
        x = x + ff
    return x.transpose(1, 2)


def _with_biases(*convs: Params) -> list:
    """``[w, b, w, b, ...]`` of the given convolutions, in the kernels'
    argument order, with zero biases where the checkpoint has none."""
    out = []
    for p in convs:
        w = p["w"]
        out.append(w)
        out.append(p["b"] if "b" in p else torch.zeros(w.shape[0], dtype=w.dtype, device=w.device))
    return out


def tail_weights(params: Params) -> list:
    """res3 and final-conv weights in the tail kernels' argument order."""
    return _with_biases(params["res3"]["conv1"], params["res3"]["conv2"], params["final_conv"])


def up2_weights(params: Params) -> list:
    """up2 and res2 weights in the order of ``fused_up2_res``."""
    return _with_biases(params["up2"], params["res2"]["conv1"], params["res2"]["conv2"])


def takes_up2_kernel(params: Params, cfg: MimiConfig) -> bool:
    """Whether this SEANet has the up2/res2 widths of the up2 kernels
    (256 → 128 channels, k = 10, stride 5; res2 128 → 64 → 128)."""
    return (
        cfg.seanet_strides[1] == 5
        and tuple(params["up2"]["w"].shape) == (128, 256, 10)
        and tuple(params["res2"]["conv1"]["w"].shape) == (64, 128, 3)
        and tuple(params["res2"]["conv2"]["w"].shape) == (128, 64, 1)
    )


def takes_cascade_kernel(params: Params, cfg: MimiConfig) -> bool:
    """Whether this SEANet has the widths of the up2 → up3 → tail cascade
    kernel: those of :func:`takes_up2_kernel`, then up3 128 → 64 (k = 8,
    stride 4), res3 64 → 32 → 64 and a k7 final conv."""
    return (
        takes_up2_kernel(params, cfg)
        and cfg.seanet_strides[2] == 4
        and tuple(params["up3"]["w"].shape) == (64, 128, 8)
        and tuple(params["res3"]["conv1"]["w"].shape) == (32, 64, 3)
        and tuple(params["res3"]["conv2"]["w"].shape) == (64, 32, 1)
        and tuple(params["final_conv"]["w"].shape) == (1, 64, 7)
    )


def cascade_weights(params: Params) -> list:
    """up2, res2, up3, res3 and final-conv weights in the order of
    ``fused_up2_up3_tail``."""
    return up2_weights(params) + _with_biases(params["up3"]) + tail_weights(params)


def mimi_decode(params: Params, cfg: MimiConfig, mimi_latent: torch.Tensor) -> torch.Tensor:
    """``[B, 512, T] → [B, 1, 1920·T]`` PCM."""
    s1, s2, s3 = cfg.seanet_strides
    x = _convtr(params["upsample"], mimi_latent, cfg.steps_per_latent, cfg.upsample_groups)
    x = _transformer(params, cfg, x)
    x = elu(_conv(params["init_conv"], x))
    x = _convtr(params["up1"], x, s1)
    x = elu(_resblock(params["res1"], x))
    st = seanet_tail
    up2_res = st.fused_up2_res if cfg.use_kernels else st.fused_up2_res_plain
    up_tail = st.fused_seanet_up_tail if cfg.use_kernels else st.fused_seanet_up_tail_plain
    tail = st.fused_seanet_tail if cfg.use_kernels else st.fused_seanet_tail_plain
    if takes_up2_kernel(params, cfg) and seanet_tail.supports_up2(x.shape[1], x.shape[-1], 10):
        x = up2_res(x, *up2_weights(params))
    else:
        x = _convtr(params["up2"], x, s2)
        x = elu(_resblock(params["res2"], x))
    wu = params["up3"]["w"]
    if (
        s3 == 4
        and x.shape[1] == 128
        and tuple(wu.shape[:2]) == (64, 128)
        and seanet_tail.supports_up(x.shape[1], x.shape[-1], wu.shape[-1])
    ):
        bu = params["up3"].get("b", torch.zeros(64, dtype=x.dtype, device=x.device))
        return up_tail(x, wu, bu, *tail_weights(params))
    x = _convtr(params["up3"], x, s3)
    if x.shape[1] == 64 and seanet_tail.supports(x.shape[-1]):
        return tail(x, *tail_weights(params))
    x = elu(_resblock(params["res3"], x))
    return _conv(params["final_conv"], x)
