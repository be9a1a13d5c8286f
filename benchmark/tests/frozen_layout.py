"""Frozen copies of the benchmark's checkpoint layout, draw, host copy and
operation counts as they were before a configuration's reference module
took over its layout: what ``test_benchbuild_layout.py`` holds the harness
to, bit for bit, for the PocketTTS configurations. Not a test file."""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch

from pbench import roofline
from pbench.derive import SAMPLES_PER_FRAME, in_window

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


def make_weights(arch: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``{checkpoint name: float32 tensor on device}`` for ``arch`` from
    ``seed``: two draws on the device, then one slice per leaf."""
    specs = leaf_specs(arch)
    n_norm = sum(math.prod(sh) for _n, sh, k, _s, _o in specs if k == "n")
    n_unif = sum(math.prod(sh) for _n, sh, k, _s, _o in specs if k in ("u", "e"))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    normal = torch.randn(n_norm, generator=gen, device=device, dtype=torch.float32)
    unif = torch.rand(n_unif, generator=gen, device=device, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    i_n = i_u = 0
    for name, shape, kind, scale, offset in specs:
        size = math.prod(shape)
        if kind == "n":
            out[name] = (normal[i_n : i_n + size] * scale + offset).reshape(shape)
            i_n += size
        elif kind == "u":
            out[name] = (unif[i_u : i_u + size] * scale + offset).reshape(shape)
            i_u += size
        elif kind == "e":
            out[name] = torch.exp(unif[i_u : i_u + size] * scale).reshape(shape)
            i_u += size
        else:
            out[name] = torch.full(shape, offset, dtype=torch.float32, device=device)
    return out


def host_copy(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The checkpoint tensors on the host, in one copy: the port's loader
    reads host arrays."""
    names = list(weights)
    flat = torch.cat([weights[n].reshape(-1) for n in names]).cpu()
    out, i = {}, 0
    for n in names:
        size = weights[n].numel()
        out[n] = flat[i : i + size].reshape(weights[n].shape)
        i += size
    return out


def _linears(arch: Dict) -> Dict[str, Tuple[int, int]]:
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
    linear = sum(2.0 * k * n for k, n in _linears(arch).values())
    attention = arch["num_layers"] * 4.0 * rows * arch["d_model"]
    return linear + attention


def prefill_flops(arch: Dict, n_tokens: int) -> float:
    """Operations of a prompt of ``n_tokens``: the transformer's linears per
    token and its causal attention."""
    d, ffn = arch["d_model"], arch["ffn_dim"]
    per_token = 2.0 * (d * 3 * d + d * d + d * ffn + ffn * d) * arch["num_layers"]
    attention = arch["num_layers"] * 4.0 * d * n_tokens * (n_tokens + 1) / 2
    return per_token * n_tokens + attention


def _request_flops(arch: Dict, n_tokens: int, first: int, count: int, prefill: bool) -> float:
    steps = sum(frame_step_flops(arch, n_tokens + j + 1) for j in range(first, first + count))
    ops = steps + roofline.decode_flops(arch, first, count)
    return ops + (prefill_flops(arch, n_tokens) if prefill else 0.0)


def window_flops(run) -> float:
    """The model operations that the audio delivered in the window needed:
    each delivered frame's AR step and decode, and the prefill of each
    request whose first audio arrived in the window."""
    arch = run.config
    total = 0.0
    for r in run.records:
        n_tok = len(r.request.tokens)
        done = 0
        for i, (t, n) in enumerate(r.blocks):
            frames = n // SAMPLES_PER_FRAME
            if in_window(run, t):
                total += _request_flops(arch, n_tok, done, frames, prefill=(i == 0))
            done += frames
    return total


def mfu_pct(run) -> Optional[float]:
    ops = window_flops(run)
    if ops <= 0:
        return None
    return 100.0 * ops / (run.seconds * roofline.PEAK_FLOPS["bfloat16"])
