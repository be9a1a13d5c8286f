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
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["PocketTTSReference", "exact_float32", "fp8", "quantize_rows", "quantize_weight"]

SAMPLES_PER_FRAME = 1920


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

