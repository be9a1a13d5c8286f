"""Plain PyTorch reference of PocketTTS synthesis: FlowLM prefill and AR
steps, the flowNet LSD decode, the latent → Mimi projection and the Mimi
decoder, in float32, with no kernel, graph, cache manager or batching.

Frozen copy of the layer equations of the port's independent oracle
(``go_pocket_tts_tpu_torch/tts/runtime_torch.py``, ``TorchRuntime``),
rewritten over a ``{checkpoint name: tensor}`` dict and with static KV
buffers. It imports nothing of the port.

What a configuration derives from the weights, this module works out again
from the checkpoint tensors, by the port's documented rules
(``models/quantize.py``): int8 weights symmetric per output channel
(``scale = max|w| / 127``), int4 weights per 128 input rows and output
channel (levels -7..7; per channel where the input width is not a multiple
of 128 above it, int8 where it is odd), int8 KV rows per lane, head and
position. Every 2-D checkpoint weight but the text table is a linear.
Quantized operands are dequantized and every product runs in float32 with
TF32 off, so a quantized reference differs from the float one by the
quantization alone.

``precision`` (a configuration file's ``reference`` or ``control`` entry)
names the linears' weights (``float32``, ``int8``, ``int4``, ``fp8``), the
KV cache (``float32``, ``int8``, ``int4``) and the activations
(``float32``, or ``fp8``: the operands of every linear, convolution and
attention, and the convolutions' weights, through float8 e4m3 with a scale
per tensor, a precision below bfloat16).

The module also gives the configuration's checkpoint layout and its model
operations, which the harness reads by the configuration's
``reference_impl`` (``pbench/weights.py`` draws the layout,
``pbench/derive.py`` sums the operations): ``leaf_specs``,
``CHECKPOINT_DTYPE``, ``frame_step_flops`` and ``prefill_flops``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "CHECKPOINT_DTYPE",
    "PocketTTSReference",
    "exact_float32",
    "fp8",
    "frame_step_flops",
    "leaf_specs",
    "prefill_flops",
    "quantize_rows",
    "quantize_weight",
    "step_linears",
]

SAMPLES_PER_FRAME = 1920

# -- the checkpoint layout ----------------------------------------------------
#
# Frozen copy of the key naming and the initial scales of the port's
# ``models/synthetic.py`` (``build_checkpoint``, the decoder's tensors only):
# linear and convolution weights ~ N(0, 1/fan_in), biases 0.02·N, layer norms
# 1 + 0.05·N and 0.02·N, the text table 0.02·N, the latent statistics 0.5 + U
# and 0.1·N, the time embedders' frequencies exp(4·U), and Mimi's layer
# scales 0.01. The architecture is the configuration file's widths under the
# names of the port's ``SynthArch``.

# The dtype the leaves are drawn and held in.
CHECKPOINT_DTYPE = "float32"

# (name, shape, kind, scale, offset): value = offset + scale · draw, where
# kind "n" draws N(0, 1), "u" U[0, 1), "c" is the constant ``offset``, and
# "e" is exp(scale · U).
Spec = Tuple[str, Tuple[int, ...], str, float, float]


def _lin(specs: List[Spec], prefix: str, out_dim: int, in_dim: int, bias: bool) -> None:
    specs.append((f"{prefix}.weight", (out_dim, in_dim), "n", 1.0 / math.sqrt(in_dim), 0.0))
    if bias:
        specs.append((f"{prefix}.bias", (out_dim,), "n", 0.02, 0.0))


def _ln(specs: List[Spec], prefix: str, dim: int) -> None:
    specs.append((f"{prefix}.weight", (dim,), "n", 0.05, 1.0))
    specs.append((f"{prefix}.bias", (dim,), "n", 0.02, 0.0))


def _conv(specs: List[Spec], prefix: str, out_ch: int, in_per_group: int, k: int, bias: bool) -> None:
    specs.append((f"{prefix}.weight", (out_ch, in_per_group, k), "n", 1.0 / math.sqrt(in_per_group * k), 0.0))
    if bias:
        specs.append((f"{prefix}.bias", (out_ch,), "n", 0.02, 0.0))


def _convtr(specs: List[Spec], prefix: str, in_ch: int, out_per_group: int, k: int, bias_ch: int, bias: bool) -> None:
    specs.append((f"{prefix}.weight", (in_ch, out_per_group, k), "n", 1.0 / math.sqrt(in_ch * k), 0.0))
    if bias:
        specs.append((f"{prefix}.bias", (bias_ch,), "n", 0.02, 0.0))


def leaf_specs(arch: Dict) -> List[Spec]:
    """Every decoder-side checkpoint tensor of ``arch`` with its draw."""
    a = arch
    d, lat, fd = a["d_model"], a["latent_dim"], a["flow_dim"]
    s: List[Spec] = []
    s.append(("flow_lm.conditioner.embed.weight", (a["n_bins"] + 1, d), "n", 0.02, 0.0))
    s.append(("flow_lm.emb_std", (lat,), "u", 1.0, 0.5))
    s.append(("flow_lm.emb_mean", (lat,), "n", 0.1, 0.0))
    s.append(("flow_lm.bos_emb", (lat,), "n", 0.1, 0.0))
    _lin(s, "flow_lm.input_linear", d, lat, True)
    _ln(s, "flow_lm.out_norm", d)
    _lin(s, "flow_lm.out_eos", 1, d, True)
    for i in range(a["num_layers"]):
        p = f"flow_lm.transformer.layers.{i}"
        _ln(s, f"{p}.norm1", d)
        _ln(s, f"{p}.norm2", d)
        _lin(s, f"{p}.self_attn.in_proj", 3 * d, d, False)
        _lin(s, f"{p}.self_attn.out_proj", d, d, False)
        _lin(s, f"{p}.linear1", a["ffn_dim"], d, False)
        _lin(s, f"{p}.linear2", d, a["ffn_dim"], False)
    for te in (0, 1):
        p = f"flow_lm.flow_net.time_embed.{te}"
        s.append((f"{p}.freqs", (a["freq_half"],), "e", 4.0, 0.0))
        _lin(s, f"{p}.mlp.0", a["te_hidden"], 2 * a["freq_half"], True)
        _lin(s, f"{p}.mlp.2", fd, a["te_hidden"], True)
        s.append((f"{p}.mlp.3.alpha", (fd,), "n", 0.05, 1.0))
    _lin(s, "flow_lm.flow_net.cond_embed", fd, d, True)
    _lin(s, "flow_lm.flow_net.input_proj", fd, lat, True)
    for i in range(a["flow_depth"]):
        p = f"flow_lm.flow_net.res_blocks.{i}"
        _ln(s, f"{p}.in_ln", fd)
        _lin(s, f"{p}.mlp.0", a["flow_hidden"], fd, True)
        _lin(s, f"{p}.mlp.2", fd, a["flow_hidden"], True)
        _lin(s, f"{p}.adaLN_modulation.1", 3 * fd, fd, True)
    _lin(s, "flow_lm.flow_net.final_layer.linear", lat, fd, True)
    _lin(s, "flow_lm.flow_net.final_layer.adaLN_modulation.1", 2 * fd, fd, True)

    c = a["mimi_dim"]
    _conv(s, "mimi.quantizer.output_proj", c, lat, 1, False)
    _convtr(s, "mimi.upsample.convtr.convtr", c, 1, a["upsample_kernel"], c, False)
    for i in range(a["mimi_layers"]):
        p = f"mimi.decoder_transformer.transformer.layers.{i}"
        _ln(s, f"{p}.norm1", c)
        _ln(s, f"{p}.norm2", c)
        _lin(s, f"{p}.self_attn.in_proj", 3 * c, c, False)
        _lin(s, f"{p}.self_attn.out_proj", c, c, False)
        _lin(s, f"{p}.linear1", a["mimi_ffn"], c, False)
        _lin(s, f"{p}.linear2", c, a["mimi_ffn"], False)
        s.append((f"{p}.layer_scale_1.scale", (c,), "c", 0.0, 0.01))
        s.append((f"{p}.layer_scale_2.scale", (c,), "c", 0.0, 0.01))
    ch, strides = a["seanet_channels"], a["seanet_strides"]
    _conv(s, "mimi.decoder.model.0.conv", ch[0], c, a["seanet_kernel_init"], True)
    for bi, (up_idx, res_idx) in enumerate([(2, 3), (5, 6), (8, 9)]):
        cin, cout = ch[bi], ch[bi + 1]
        _convtr(s, f"mimi.decoder.model.{up_idx}.convtr", cin, cout, 2 * strides[bi], cout, True)
        _conv(s, f"mimi.decoder.model.{res_idx}.block.1.conv", cout // 2, cout, 3, True)
        _conv(s, f"mimi.decoder.model.{res_idx}.block.3.conv", cout, cout // 2, 1, True)
    _conv(s, "mimi.decoder.model.11.conv", 1, ch[-1], a["seanet_kernel_final"], True)
    return s


# -- the model's operations ------------------------------------------------------
#
# The work that a request's inputs need, whatever implements it, from the
# widths: two operations a multiply-add. Mimi's decode is counted in
# ``pbench/roofline.py`` (``decode_flops``), since every configuration of the
# system keeps it.


def step_linears(arch: Dict) -> Dict[str, Tuple[int, int]]:
    """``{name: (in, out)}`` of the linears one AR step runs for one lane."""
    d, ffn, lat, fd, fh = arch["d_model"], arch["ffn_dim"], arch["latent_dim"], arch["flow_dim"], arch["flow_hidden"]
    out = {"input_linear": (lat, d), "out_eos": (d, 1)}
    for i in range(arch["num_layers"]):
        out[f"l{i}.in_proj"] = (d, 3 * d)
        out[f"l{i}.out_proj"] = (d, d)
        out[f"l{i}.linear1"] = (d, ffn)
        out[f"l{i}.linear2"] = (ffn, d)
    out["cond_embed"] = (d, fd)
    out["input_proj"] = (lat, fd)
    for i in range(arch["flow_depth"]):
        out[f"r{i}.mlp0"] = (fd, fh)
        out[f"r{i}.mlp2"] = (fh, fd)
    out["adaln"] = (fd, (3 * arch["flow_depth"] + 2) * fd)
    out["final_linear"] = (fd, lat)
    return out


def frame_step_flops(arch: Dict, rows: int) -> float:
    """Operations of one lane's AR step attending to ``rows`` cached rows:
    the FlowLM linears and attention, and one flowNet evaluation."""
    linear = sum(2.0 * k * n for k, n in step_linears(arch).values())
    attention = arch["num_layers"] * 4.0 * rows * arch["d_model"]
    return linear + attention


def prefill_flops(arch: Dict, n_tokens: int) -> float:
    """Operations of a prompt of ``n_tokens``: the transformer's linears per
    token and its causal attention."""
    d, ffn = arch["d_model"], arch["ffn_dim"]
    per_token = 2.0 * (d * 3 * d + d * d + d * ffn + ffn * d) * arch["num_layers"]
    attention = arch["num_layers"] * 4.0 * d * n_tokens * (n_tokens + 1) / 2
    return per_token * n_tokens + attention



@contextlib.contextmanager
def exact_float32() -> Iterator[None]:
    """Float32 products and convolutions without TF32, gradients off."""
    mm, conv = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mm, conv


def _scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    s = amax / torch.full_like(amax, qmax)
    return torch.where(s > 0, s, torch.ones_like(s))


def quantize_weight(w: torch.Tensor, bits: int) -> torch.Tensor:
    """The dequantized float32 ``w [out, in]`` at ``bits`` (8 or 4)."""
    w = w.float()
    n_out, k = w.shape
    if bits == 4 and k % 2:
        bits = 8
    qmax = 127.0 if bits == 8 else 7.0
    if bits == 4 and k % 128 == 0 and k > 128:
        g = w.reshape(n_out, k // 128, 128)
        s = _scale(g.abs().amax(dim=2), qmax)
        return (torch.round(g / s[..., None]).clamp(-qmax, qmax) * s[..., None]).reshape(n_out, k)
    s = _scale(w.abs().amax(dim=1), qmax)
    return torch.round(w / s[:, None]).clamp(-qmax, qmax) * s[:, None]


def quantize_rows(x: torch.Tensor, bits: int) -> torch.Tensor:
    """``x[..., D]`` through symmetric per-row levels, dequantized."""
    qmax = 127.0 if bits == 8 else 7.0
    s = _scale(x.abs().amax(dim=-1), qmax)
    return torch.round(x / s[..., None]).clamp(-qmax, qmax) * s[..., None]


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` through float8 e4m3 with one scale for the tensor, as fp8
    inference scales its operands: ``amax`` maps to 448."""
    s = _scale(x.abs().amax(), 448.0)
    return (x / s).to(torch.float8_e4m3fn).float() * s


def _rope(x: torch.Tensor, pos: torch.Tensor, max_period: float = 10000.0) -> torch.Tensor:
    """Interleaved-pair RoPE of ``x [..., T, D]`` at positions ``pos [T]``."""
    half = x.shape[-1] // 2
    inv = max_period ** (-torch.arange(half, dtype=torch.float64, device=x.device) / half)
    angles = (pos.to(torch.float64)[:, None] * inv).to(torch.float32)
    cos, sin = torch.cos(angles), torch.sin(angles)
    xr = x.reshape(*x.shape[:-1], half, 2)
    a, b = xr[..., 0], xr[..., 1]
    return torch.stack([a * cos - b * sin, a * sin + b * cos], dim=-1).reshape(x.shape)


class PocketTTSReference:
    """The reference over ``weights`` (float32 on one device) of ``arch``."""

    def __init__(self, weights: Dict[str, torch.Tensor], arch: Dict, precision: Optional[Dict] = None) -> None:
        precision = dict(precision or {})
        self.arch = arch
        self.weight_precision = precision.get("weights", "float32")
        self.kv_precision = precision.get("kv", "float32")
        fp8_act = precision.get("activations", "float32") == "fp8"
        self._q = fp8 if fp8_act else (lambda x: x)
        bits = {"int8": 8, "int4": 4}.get(self.weight_precision)
        self.w: Dict[str, torch.Tensor] = {}
        for name, t in weights.items():
            t = t.float()
            table = name == "flow_lm.conditioner.embed.weight"
            if t.ndim == 2 and not table and bits:
                t = quantize_weight(t, bits)
            elif t.ndim == 2 and not table and self.weight_precision == "fp8":
                t = fp8(t)
            elif t.ndim == 3 and fp8_act:
                t = fp8(t)
            self.w[name] = t
        self.device = next(iter(weights.values())).device
        self.heads = arch["num_heads"]
        self.layers = arch["num_layers"]

    # -- building blocks ----------------------------------------------------

    def _linear(self, prefix: str, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self._q(x), self.w[f"{prefix}.weight"], self.w.get(f"{prefix}.bias"))

    def _attend(self, q, k, v, mask=None) -> torch.Tensor:
        return F.scaled_dot_product_attention(self._q(q), self._q(k), self._q(v), attn_mask=mask)

    def _ln(self, prefix: str, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
        return F.layer_norm(x, (x.shape[-1],), self.w[f"{prefix}.weight"], self.w[f"{prefix}.bias"], eps)

    def _kv_store(self, x: torch.Tensor) -> torch.Tensor:
        if self.kv_precision == "int8":
            return quantize_rows(x, 8)
        if self.kv_precision == "int4":
            return quantize_rows(x, 4)
        return x

    def _flow_layer(self, i: int, x: torch.Tensor, k_buf, v_buf, pos0: int, prefill: bool) -> torch.Tensor:
        """One FlowLM layer over ``x [1, T, D]`` at positions ``pos0..``;
        the K/V rows go into ``k_buf``/``v_buf [H, C, Dh]`` as the cache
        keeps them. A prefill attends to its own rows unquantized, as the
        port's prefill does before it stores them; a step attends to its
        row as stored."""
        p = f"flow_lm.transformer.layers.{i}"
        _, t, d = x.shape
        hd = d // self.heads
        qkv = self._linear(f"{p}.self_attn.in_proj", self._ln(f"{p}.norm1", x))
        q, k, v = (z.reshape(t, self.heads, hd).transpose(0, 1) for z in qkv[0].chunk(3, dim=-1))
        pos = torch.arange(pos0, pos0 + t, device=x.device)
        q, k = _rope(q, pos), _rope(k, pos)
        k_buf[:, pos0 : pos0 + t] = self._kv_store(k)
        v_buf[:, pos0 : pos0 + t] = self._kv_store(v)
        if prefill:
            a = self._attend(q, k, v, pos[:, None] >= pos[None, :])
        else:
            n = pos0 + t
            a = self._attend(q, k_buf[:, :n], v_buf[:, :n])
        a = a.transpose(0, 1).reshape(1, t, d)
        x = x + self._linear(f"{p}.self_attn.out_proj", a)
        h = F.gelu(self._linear(f"{p}.linear1", self._ln(f"{p}.norm2", x)), approximate="none")
        return x + self._linear(f"{p}.linear2", h)

    def _timestep_embed(self, prefix: str, t: torch.Tensor) -> torch.Tensor:
        args = t * self.w[f"{prefix}.freqs"][None, :]
        emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        h = self._linear(f"{prefix}.mlp.2", F.silu(self._linear(f"{prefix}.mlp.0", emb)))
        var = h.var(dim=-1, keepdim=True)  # Bessel-corrected, as upstream's _rms_norm
        return h / torch.sqrt(var + 1e-5) * self.w[f"{prefix}.mlp.3.alpha"]

    def _flow_direction(self, c: torch.Tensor, s: float, t: float, x: torch.Tensor) -> torch.Tensor:
        fn = "flow_lm.flow_net"
        one = torch.ones((x.shape[0], 1), device=x.device)
        y = 0.5 * (
            self._timestep_embed(f"{fn}.time_embed.0", one * s) + self._timestep_embed(f"{fn}.time_embed.1", one * t)
        ) + self._linear(f"{fn}.cond_embed", c)
        cur = self._linear(f"{fn}.input_proj", x)
        for i in range(self.arch["flow_depth"]):
            p = f"{fn}.res_blocks.{i}"
            shift, scale, gate = self._linear(f"{p}.adaLN_modulation.1", F.silu(y)).chunk(3, dim=-1)
            h = self._ln(f"{p}.in_ln", cur, eps=1e-6) * (1 + scale) + shift
            h = self._linear(f"{p}.mlp.2", F.silu(self._linear(f"{p}.mlp.0", h)))
            cur = cur + h * gate
        shift, scale = self._linear(f"{fn}.final_layer.adaLN_modulation.1", F.silu(y)).chunk(2, dim=-1)
        out = F.layer_norm(cur, (cur.shape[-1],), eps=1e-6) * (1 + scale) + shift
        return self._linear(f"{fn}.final_layer.linear", out)

    # -- FlowLM: prefill and the AR loop -------------------------------------

    def frames(self, ids: Sequence[int], n_frames: int, noise: Optional[torch.Tensor] = None,
               decode_steps: int = 1) -> torch.Tensor:
        """The ``[n_frames, latent]`` frames of one request: prefill of the
        text ``ids``, then ``n_frames`` AR steps from the BOS frame, each
        decoded from ``noise[step]`` (already scaled by sqrt(temperature);
        None: zeros, the greedy frame)."""
        a = self.arch
        d, lat = a["d_model"], a["latent_dim"]
        hd = d // self.heads
        dev = self.device
        n_tok = len(ids)
        cap = n_tok + n_frames
        kb = [torch.zeros((self.heads, cap, hd), device=dev) for _ in range(self.layers)]
        vb = [torch.zeros((self.heads, cap, hd), device=dev) for _ in range(self.layers)]
        with exact_float32():
            x = self.w["flow_lm.conditioner.embed.weight"][torch.as_tensor(list(ids), device=dev)][None]
            for i in range(self.layers):
                x = self._flow_layer(i, x, kb[i], vb[i], 0, prefill=True)
            out = torch.empty((n_frames, lat), device=dev)
            frame = self.w["flow_lm.bos_emb"][None, None]
            for step in range(n_frames):
                x = self._linear("flow_lm.input_linear", frame)
                for i in range(self.layers):
                    x = self._flow_layer(i, x, kb[i], vb[i], n_tok + step, prefill=False)
                hidden = self._ln("flow_lm.out_norm", x)[:, -1]
                z = torch.zeros((1, lat), device=dev) if noise is None else noise[step : step + 1].to(dev).float()
                for j in range(decode_steps):
                    z = z + self._flow_direction(hidden, j / decode_steps, (j + 1) / decode_steps, z) / decode_steps
                out[step] = z[0]
                frame = z[:, None, :]
        return out

    def teacher_frames(self, ids: Sequence[int], given: torch.Tensor) -> torch.Tensor:
        """The greedy frame the reference makes at each step ``t`` when the
        frames before it are ``given[:t]`` (teacher forcing): one causal
        pass over the text and the given frames, ``[T, latent]``."""
        a = self.arch
        d, lat = a["d_model"], a["latent_dim"]
        hd = d // self.heads
        dev = self.device
        n_tok, n = len(ids), given.shape[0]
        with exact_float32():
            text = self.w["flow_lm.conditioner.embed.weight"][torch.as_tensor(list(ids), device=dev)]
            prev = torch.cat([self.w["flow_lm.bos_emb"][None], given[:-1].float().to(dev)])
            x = torch.cat([text, self._linear("flow_lm.input_linear", prev)])[None]
            t = n_tok + n
            pos = torch.arange(t, device=dev)
            causal = pos[:, None] >= pos[None, :]
            for i in range(self.layers):
                p = f"flow_lm.transformer.layers.{i}"
                qkv = self._linear(f"{p}.self_attn.in_proj", self._ln(f"{p}.norm1", x))
                q, k, v = (z.reshape(t, self.heads, hd).transpose(0, 1) for z in qkv[0].chunk(3, dim=-1))
                q, k = _rope(q, pos), _rope(k, pos)
                # The text attends to its own rows as computed; each step to
                # the rows as the cache keeps them.
                a_text = self._attend(q[:, :n_tok], k[:, :n_tok], v[:, :n_tok], causal[:n_tok, :n_tok])
                a_step = self._attend(q[:, n_tok:], self._kv_store(k), self._kv_store(v), causal[n_tok:])
                att = torch.cat([a_text, a_step], dim=1).transpose(0, 1).reshape(1, t, d)
                x = x + self._linear(f"{p}.self_attn.out_proj", att)
                h = F.gelu(self._linear(f"{p}.linear1", self._ln(f"{p}.norm2", x)), approximate="none")
                x = x + self._linear(f"{p}.linear2", h)
            hidden = self._ln("flow_lm.out_norm", x)[0, n_tok:]
            z = torch.zeros((n, lat), device=dev)
            return z + self._flow_direction(hidden, 0.0, 1.0, z)

    # -- Mimi decoder ---------------------------------------------------------

    def _conv(self, prefix: str, x: torch.Tensor, groups: int = 1) -> torch.Tensor:
        w = self.w[f"{prefix}.weight"]
        x = F.pad(self._q(x.transpose(1, 2)).transpose(1, 2), (w.shape[-1] - 1, 0))
        return F.conv1d(x, w, self.w.get(f"{prefix}.bias"), groups=groups)

    def _convtr(self, prefix: str, x: torch.Tensor, stride: int, groups: int = 1) -> torch.Tensor:
        w = self.w[f"{prefix}.weight"]
        x = self._q(x.transpose(1, 2)).transpose(1, 2)
        out = F.conv_transpose1d(x, w, self.w.get(f"{prefix}.bias"), stride=stride, groups=groups)
        trim = w.shape[-1] - stride
        return out[:, :, : out.shape[2] - trim] if trim > 0 else out

    def _mimi_transformer(self, x: torch.Tensor) -> torch.Tensor:
        a = self.arch
        heads, context = a["mimi_heads"], a["mimi_context"]
        x = x.transpose(1, 2)
        _, t, d = x.shape
        hd = d // heads
        pos = torch.arange(t, device=x.device)
        delta = pos[:, None] - pos[None, :]
        mask = (delta >= 0) & (delta < context)
        for i in range(a["mimi_layers"]):
            p = f"mimi.decoder_transformer.transformer.layers.{i}"
            qkv = self._linear(f"{p}.self_attn.in_proj", self._ln(f"{p}.norm1", x))
            q, k, v = (z.reshape(t, heads, hd).transpose(0, 1) for z in qkv[0].chunk(3, dim=-1))
            q, k = _rope(q, pos), _rope(k, pos)
            att = self._attend(q, k, v, mask).transpose(0, 1).reshape(1, t, d)
            x = x + self._linear(f"{p}.self_attn.out_proj", att) * self.w[f"{p}.layer_scale_1.scale"]
            h = F.gelu(self._linear(f"{p}.linear1", self._ln(f"{p}.norm2", x)), approximate="none")
            x = x + self._linear(f"{p}.linear2", h) * self.w[f"{p}.layer_scale_2.scale"]
        return x.transpose(1, 2)

    def decode(self, frames: torch.Tensor) -> np.ndarray:
        """Float32 PCM at 24 kHz of ``frames [T, latent]``: denormalise,
        project to Mimi's latent, decode."""
        a = self.arch
        with exact_float32():
            denorm = frames.float() * self.w["flow_lm.emb_std"] + self.w["flow_lm.emb_mean"]
            proj = self.w["mimi.quantizer.output_proj.weight"][:, :, 0]
            x = (denorm @ proj.T).T[None]  # [1, C, T]
            up = self.w["mimi.upsample.convtr.convtr.weight"]
            x = self._convtr("mimi.upsample.convtr.convtr", x, a["upsample_stride"], groups=up.shape[0])
            x = self._mimi_transformer(x)
            x = F.elu(self._conv("mimi.decoder.model.0.conv", x))
            for (up_idx, res_idx), stride in zip(((2, 3), (5, 6), (8, 9)), a["seanet_strides"]):
                x = self._convtr(f"mimi.decoder.model.{up_idx}.convtr", x, stride)
                h = self._conv(f"mimi.decoder.model.{res_idx}.block.1.conv", F.elu(x))
                h = self._conv(f"mimi.decoder.model.{res_idx}.block.3.conv", F.elu(h))
                x = F.elu(x + h)
            pcm = self._conv("mimi.decoder.model.11.conv", x)
        return pcm[0, 0].cpu().numpy().astype(np.float32)

    def synthesize(self, ids: Sequence[int], n_frames: int, noise: Optional[torch.Tensor] = None) -> np.ndarray:
        return self.decode(self.frames(ids, n_frames, noise))

