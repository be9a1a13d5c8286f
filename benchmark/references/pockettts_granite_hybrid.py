"""Plain PyTorch reference of PocketTTS synthesis over a hybrid Mamba-2 /
attention backbone: granite-4.0-h's decoder layers
(https://huggingface.co/ibm-granite/granite-4.0-h-micro/blob/main/config.json,
``granitemoehybrid``) in place of FlowLM's transformer, over PocketTTS's text
table and latent ``input_linear``, into FlowLM's ``out_norm``, EOS head and
flowNet, and Mimi. Float32 with TF32 off; no kernel, cache, graph or
batching. It imports nothing of the port, of ``pbench`` or of JAX: the
flowNet, Mimi's decoder, the precisions' casts (``fp8``, the quantizers)
and ``exact_float32`` are ``references/pockettts.py``'s, loaded by path.

The backbone, from the configuration file's keys (granite's own names):
the input scaled by ``embedding_multiplier``; per layer of ``layer_types``
(pre-norm, RMSNorm with ``rms_norm_eps``) ``x += r·mixer(rms(x))`` and
``x += r·mlp(rms(x))``, ``r`` the ``residual_multiplier`` and
``mlp(h) = output_linear(silu(gate)·up)``, ``[gate | up] =
input_linear(h)`` (``shared_intermediate_size`` wide). The attention
mixer: GQA (``num_attention_heads`` over ``num_key_value_heads``), no
position embedding, causal, scores scaled by ``attention_multiplier``. The
Mamba-2 mixer over the whole sequence at once, in the SSD paper's
quadratic (masked) form (Dao and Gu, 2024, "Transformers are SSMs", the
1-semiseparable matrix): with ``z | xBC | dt = in_proj(h)``, ``xBC =
silu(conv1d(xBC))`` (causal, depthwise, ``mamba_d_conv`` wide, with bias)
split into ``x``, ``B``, ``C``, ``dt = softplus(dt + dt_bias)`` and ``A =
-exp(A_log)``,

    y[t] = sum_{s <= t} (C[t]·B[s]) · exp(sum_{s < k <= t} dt[k]·A) · dt[s] · x[s] + D·x[t],

then ``out_proj(RMSNorm(y·silu(z)))``, the norm over each of
``mamba_n_groups`` groups of channels. An AR step is the whole sequence
again, its last row: no recurrent state is kept here, so the form shares
nothing with a program's step or chunked scan.

Departures from granite-4.0-h-micro, stated in the configuration's
``assumed``: its 100352-row token embedding and tied LM head are left out
(PocketTTS's text table and ``input_linear`` feed the backbone, FlowLM's
``out_norm``, EOS head and flowNet read it), and so is its final RMSNorm.

The module also gives the configuration's checkpoint layout and model
operations, which the harness reads by the configuration's
``reference_impl``: ``CHECKPOINT_DTYPE``, ``leaf_specs``,
``frame_step_flops``, ``prefill_flops``, and the Mamba-2 decode-step
kernel's least bytes a launch, ``mamba2_step_bytes``.
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

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
    "mamba2_step_bytes",
    "prefill_flops",
]


def _load_pockettts():
    path = Path(__file__).resolve().with_name("pockettts.py")
    spec = importlib.util.spec_from_file_location("pockettts_granite_hybrid_base", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_base = _load_pockettts()
exact_float32 = _base.exact_float32
fp8 = _base.fp8

# Float32 leaves: the constants below stay exact.
CHECKPOINT_DTYPE = "float32"

# The constants no shape gives, as one-element leaves under
# flow_lm.backbone.config.
CONSTANTS = ("embedding_multiplier", "residual_multiplier", "attention_multiplier", "rms_norm_eps", "mamba_n_groups")

Spec = Tuple[str, Tuple[int, ...], str, float, float]


def _dims(a: Dict) -> Dict[str, int]:
    d, heads = a["hidden_size"], a["num_attention_heads"]
    h, p, n, g = a["mamba_n_heads"], a["mamba_d_head"], a["mamba_d_state"], a["mamba_n_groups"]
    return {
        "d": d, "f": a["shared_intermediate_size"], "heads": heads, "kv": a["num_key_value_heads"],
        "hd": d // heads, "h": h, "p": p, "n": n, "g": g, "di": h * p, "conv": h * p + 2 * g * n,
        "k": a["mamba_d_conv"],
    }


def _softplus_inv(y: float) -> float:
    return math.log(math.expm1(y))


def _pockettts_arch(a: Dict) -> Dict:
    """The PocketTTS layout's arch: everything but its transformer (whose
    FFN width it reads and never uses)."""
    return {**a, "num_layers": 0, "d_model": a["hidden_size"], "ffn_dim": a["shared_intermediate_size"]}


def leaf_specs(arch: Dict) -> List[Spec]:
    """Every checkpoint tensor with its draw: PocketTTS's (text table,
    latent statistics, ``input_linear``, ``out_norm``, EOS head, flowNet,
    Mimi decoder) from ``references/pockettts.py``, then the backbone's.

    The backbone's draws follow the published initialisation where the
    layout's draws can express it: linears N(0, 1/fan_in), the conv weight
    N(0, 1/fan_in) and its bias U[-1/√fan_in, 1/√fan_in) (PyTorch's
    default), RMSNorm weights and D 1, ``A_log`` uniform on [0, log 16]
    (A log-uniform on [1, 16]; granite's init draws A uniform there, which
    the layout's draws cannot make) and ``dt_bias`` uniform on
    [softplus⁻¹(1e-3), softplus⁻¹(0.1)], so that ``softplus(dt_bias)`` spans
    the published dt range [1e-3, 0.1], near log-uniform (the published
    init draws dt log-uniform there and stores softplus⁻¹(dt))."""
    a = arch
    m = _dims(a)
    s: List[Spec] = list(_base.leaf_specs(_pockettts_arch(a)))
    for name in CONSTANTS:
        s.append((f"flow_lm.backbone.config.{name}", (1,), "c", 0.0, float(a[name])))

    def lin(name: str, out_dim: int, in_dim: int) -> None:
        s.append((f"{name}.weight", (out_dim, in_dim), "n", 1.0 / math.sqrt(in_dim), 0.0))

    lo, hi = _softplus_inv(1e-3), _softplus_inv(0.1)
    for i, kind in enumerate(a["layer_types"]):
        p = f"flow_lm.backbone.layers.{i}"
        s.append((f"{p}.input_layernorm.weight", (m["d"],), "c", 0.0, 1.0))
        s.append((f"{p}.post_attention_layernorm.weight", (m["d"],), "c", 0.0, 1.0))
        if kind == "mamba":
            lin(f"{p}.mamba.in_proj", 2 * m["di"] + 2 * m["g"] * m["n"] + m["h"], m["d"])
            s.append((f"{p}.mamba.conv1d.weight", (m["conv"], 1, m["k"]), "n", 1.0 / math.sqrt(m["k"]), 0.0))
            bound = 1.0 / math.sqrt(m["k"])
            s.append((f"{p}.mamba.conv1d.bias", (m["conv"],), "u", 2 * bound, -bound))
            s.append((f"{p}.mamba.dt_bias", (m["h"],), "u", hi - lo, lo))
            s.append((f"{p}.mamba.A_log", (m["h"],), "u", math.log(16.0), 0.0))
            s.append((f"{p}.mamba.D", (m["h"],), "c", 0.0, 1.0))
            s.append((f"{p}.mamba.norm.weight", (m["di"],), "c", 0.0, 1.0))
            lin(f"{p}.mamba.out_proj", m["d"], m["di"])
        else:
            lin(f"{p}.self_attn.q_proj", m["heads"] * m["hd"], m["d"])
            lin(f"{p}.self_attn.k_proj", m["kv"] * m["hd"], m["d"])
            lin(f"{p}.self_attn.v_proj", m["kv"] * m["hd"], m["d"])
            lin(f"{p}.self_attn.o_proj", m["d"], m["heads"] * m["hd"])
        lin(f"{p}.shared_mlp.input_linear", 2 * m["f"], m["d"])
        lin(f"{p}.shared_mlp.output_linear", m["d"], m["f"])
    return s


# -- the model's operations ----------------------------------------------------
#
# The work that a request's inputs need, whatever implements it, from the
# widths: two operations a multiply-add; the Mamba-2 mixer in its recurrent
# (linear-time) form. Mimi's decode is counted in ``pbench/roofline.py``.


def _layer_linears(a: Dict) -> float:
    """Multiply-adds of the backbone's linears for one row."""
    m = _dims(a)
    mlp = m["d"] * 2 * m["f"] + m["f"] * m["d"]
    mamba = m["d"] * (2 * m["di"] + 2 * m["g"] * m["n"] + m["h"]) + m["di"] * m["d"]
    attn = m["d"] * (m["heads"] + 2 * m["kv"]) * m["hd"] + m["heads"] * m["hd"] * m["d"]
    kinds = a["layer_types"]
    return kinds.count("mamba") * (mamba + mlp) + kinds.count("attention") * (attn + mlp)


def _mixer_ops(a: Dict) -> float:
    """Operations of the Mamba-2 recurrence for one row of one layer: the
    conv, and ~5 a state element (decay, input, sum, readout)."""
    m = _dims(a)
    return 2.0 * m["conv"] * m["k"] + 5.0 * m["di"] * m["n"]


def frame_step_flops(arch: Dict, rows: int) -> float:
    """Operations of one lane's AR step attending to ``rows`` cached rows:
    ``input_linear``, the backbone, the EOS head and one flowNet
    evaluation."""
    m = _dims(arch)
    head = sum(2.0 * k * n for k, n in _base.step_linears(_pockettts_arch(arch)).values())
    attention = arch["layer_types"].count("attention") * 4.0 * rows * m["heads"] * m["hd"]
    return head + 2.0 * _layer_linears(arch) + attention + arch["layer_types"].count("mamba") * _mixer_ops(arch)


def prefill_flops(arch: Dict, n_tokens: int) -> float:
    """Operations of a prompt of ``n_tokens``: the backbone per row, its
    causal attention and its recurrences."""
    m = _dims(arch)
    kinds = arch["layer_types"]
    per_token = 2.0 * _layer_linears(arch) + kinds.count("mamba") * _mixer_ops(arch)
    attention = kinds.count("attention") * 4.0 * m["heads"] * m["hd"] * n_tokens * (n_tokens + 1) / 2
    return per_token * n_tokens + attention


def mamba2_step_bytes(arch: Dict, batch: int = 1) -> int:
    """The least bytes one launch of the Mamba-2 decode-step kernel moves
    (one layer, ``batch`` rows), each read once and each write once: the
    float32 SSM state read and written, the projection row (z, xBC, dt),
    the conv state read and written, the conv weights and bias and the
    float32 ``dt_bias``, ``A`` and ``D``, in the configuration's activation
    dtype, and the float32 output."""
    m = _dims(arch)
    es = torch.empty((), dtype=getattr(torch, arch["system"]["dtype"])).element_size()
    state = 2 * batch * m["di"] * m["n"] * 4
    row = batch * (m["di"] + m["conv"] + m["h"]) * es
    conv_state = 2 * batch * m["conv"] * (m["k"] - 1) * es
    weights = m["conv"] * (m["k"] + 1) * es + 3 * m["h"] * 4
    return state + row + conv_state + weights + batch * m["di"] * 4


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = x[..., j+1] + … + x[..., i]`` for ``i >= j``, -inf
    above the diagonal; summed directly, not as a difference of prefix
    sums."""
    t = x.shape[-1]
    below = torch.ones((t, t), dtype=torch.bool, device=x.device).tril(-1)
    s = x[..., None].expand(*x.shape, t).masked_fill(~below, 0.0).cumsum(dim=-2)
    return s.masked_fill(~torch.ones((t, t), dtype=torch.bool, device=x.device).tril(), float("-inf"))


class PocketTTSReference(_base.PocketTTSReference):
    """The reference over ``weights`` (float32 on one device) of ``arch``;
    ``precision`` as in ``references/pockettts.py`` (weights, KV, the
    activations; ``state``, which must be ``float32``: no state is kept)."""

    def __init__(self, weights: Dict[str, torch.Tensor], arch: Dict, precision: Optional[Dict] = None) -> None:
        if dict(precision or {}).get("state", "float32") != "float32":
            raise ValueError("the hybrid reference computes its recurrence in float32 only")
        super().__init__(weights, _pockettts_arch(arch), precision)
        self.arch = arch
        self.dims = _dims(arch)

    def _rms(self, x: torch.Tensor, w: torch.Tensor, groups: int = 1) -> torch.Tensor:
        g = x.reshape(*x.shape[:-1], groups, -1)
        g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + self.arch["rms_norm_eps"])
        return g.reshape(x.shape) * w

    def _attention(self, p: str, h: torch.Tensor) -> torch.Tensor:
        m = self.dims
        t = h.shape[1]
        q = self._linear(f"{p}.self_attn.q_proj", h)[0].reshape(t, m["heads"], m["hd"]).transpose(0, 1)
        k, v = (self._linear(f"{p}.self_attn.{n}_proj", h)[0].reshape(t, m["kv"], m["hd"]).transpose(0, 1)
                .repeat_interleave(m["heads"] // m["kv"], dim=0) for n in ("k", "v"))
        pos = torch.arange(t, device=h.device)
        a = F.scaled_dot_product_attention(self._q(q), self._kv_store(self._q(k)), self._kv_store(self._q(v)),
                                           attn_mask=pos[:, None] >= pos[None, :],
                                           scale=self.arch["attention_multiplier"])
        return self._linear(f"{p}.self_attn.o_proj", a.transpose(0, 1).reshape(1, t, m["heads"] * m["hd"]))

    def _mamba(self, p: str, h: torch.Tensor) -> torch.Tensor:
        m = self.dims
        t = h.shape[1]
        z, xbc, dt = self._linear(f"{p}.mamba.in_proj", h)[0].split([m["di"], m["conv"], m["h"]], dim=-1)
        xbc = F.silu(self._conv(f"{p}.mamba.conv1d", xbc.T[None], groups=m["conv"]))[0].T
        x, b, c = xbc.split([m["di"], m["g"] * m["n"], m["g"] * m["n"]], dim=-1)
        dt = F.softplus(dt + self.w[f"{p}.mamba.dt_bias"])  # [T, H]
        a = -torch.exp(self.w[f"{p}.mamba.A_log"])
        rep = m["h"] // m["g"]
        cb = torch.einsum("tgn,sgn->gts", c.reshape(t, m["g"], m["n"]), b.reshape(t, m["g"], m["n"]))
        mix = torch.exp(_segsum((dt * a).T)) * cb.repeat_interleave(rep, dim=0) * dt.T[:, None, :]  # [H, T, S]
        x = x.reshape(t, m["h"], m["p"])
        y = torch.einsum("hts,shp->thp", mix, x) + self.w[f"{p}.mamba.D"][:, None] * x
        y = self._rms(y.reshape(t, m["di"]) * F.silu(z), self.w[f"{p}.mamba.norm.weight"], m["g"])
        return self._linear(f"{p}.mamba.out_proj", y[None])

    def _backbone(self, x: torch.Tensor) -> torch.Tensor:
        """``x [1, T, D]`` through every layer, positions 0 .. T-1."""
        a = self.arch
        r = a["residual_multiplier"]
        x = x * a["embedding_multiplier"]
        for i, kind in enumerate(a["layer_types"]):
            p = f"flow_lm.backbone.layers.{i}"
            h = self._rms(x, self.w[f"{p}.input_layernorm.weight"])
            x = x + r * (self._mamba(p, h) if kind == "mamba" else self._attention(p, h))
            gate, up = self._linear(f"{p}.shared_mlp.input_linear",
                                    self._rms(x, self.w[f"{p}.post_attention_layernorm.weight"])).chunk(2, dim=-1)
            x = x + r * self._linear(f"{p}.shared_mlp.output_linear", F.silu(gate) * up)
        return x

    def _hidden(self, ids: Sequence[int], frames: torch.Tensor) -> torch.Tensor:
        """FlowLM's normed hidden rows over the text ``ids`` and the BOS
        frame then ``frames [n, latent]``: ``[n + 1, D]`` (row ``j`` is the
        step whose previous frame is ``frames[j - 1]``)."""
        text = self.w["flow_lm.conditioner.embed.weight"][torch.as_tensor(list(ids), device=self.device)]
        prev = torch.cat([self.w["flow_lm.bos_emb"][None], frames.float().to(self.device)])
        x = torch.cat([text, self._linear("flow_lm.input_linear", prev)])[None]
        return self._ln("flow_lm.out_norm", self._backbone(x))[0, len(ids):]

    def frames(self, ids: Sequence[int], n_frames: int, noise: Optional[torch.Tensor] = None,
               decode_steps: int = 1) -> torch.Tensor:
        """The ``[n_frames, latent]`` frames of one request from the text
        alone, each step the whole sequence again; ``noise[step]`` already
        scaled by sqrt(temperature) (None: zeros, the greedy frame)."""
        lat = self.arch["latent_dim"]
        out = torch.zeros((n_frames, lat), device=self.device)
        with exact_float32():
            for step in range(n_frames):
                hidden = self._hidden(ids, out[:step])[-1:]
                z = torch.zeros((1, lat), device=self.device) if noise is None else noise[step : step + 1].to(self.device).float()
                for j in range(decode_steps):
                    z = z + self._flow_direction(hidden, j / decode_steps, (j + 1) / decode_steps, z) / decode_steps
                out[step] = z[0]
        return out

    def teacher_frames(self, ids: Sequence[int], given: torch.Tensor) -> torch.Tensor:
        """The greedy frame at each step ``t`` when the frames before it are
        ``given[:t]``: one causal pass, ``[T, latent]``."""
        with exact_float32():
            hidden = self._hidden(ids, given[:-1])
            z = torch.zeros((given.shape[0], self.arch["latent_dim"]), device=self.device)
            return z + self._flow_direction(hidden, 0.0, 1.0, z)

    def synthesize(self, ids: Sequence[int], n_frames: int, noise: Optional[torch.Tensor] = None) -> np.ndarray:
        return self.decode(self.frames(ids, n_frames, noise))
