"""A hybrid Mamba-2 / attention decoder stack as FlowLM's backbone, in place
of :mod:`flow_transformer`: granite-4.0-h's layers (``granitemoehybrid``,
https://huggingface.co/ibm-granite/granite-4.0-h-micro) over PocketTTS's
text LUT and latent ``input_linear``, into FlowLM's own ``out_norm``, EOS
head and flowNet.

Checkpoint keys, under ``flow_lm.backbone``:

- ``layers.{i}.input_layernorm`` and ``.post_attention_layernorm``
  (RMSNorm weights), ``.shared_mlp.input_linear`` (``[2F, D]``: gate | up)
  and ``.shared_mlp.output_linear`` (``[D, F]``);
- a Mamba-2 layer: ``.mamba.in_proj`` (``[2·d_inner + 2·G·N + H, D]``: z |
  xBC | dt), ``.mamba.conv1d`` (depthwise ``[C, 1, 4]`` and its bias),
  ``.mamba.dt_bias``, ``.mamba.A_log``, ``.mamba.D`` (``[H]``),
  ``.mamba.norm`` (the gated RMSNorm, ``[d_inner]``), ``.mamba.out_proj``;
- an attention layer: ``.self_attn.{q,k,v,o}_proj`` (grouped KV heads, no
  bias);
- ``config.{embedding_multiplier, residual_multiplier,
  attention_multiplier, rms_norm_eps, mamba_n_groups}``: one-element
  constants that no shape gives.

A layer's kind is read from which keys it has. The attention heads are the
loader's ``num_heads`` (the head width is ``D / num_heads``); the KV heads,
the Mamba heads, their width and the state width follow from the shapes.

Per layer (pre-norm, RMSNorm in float32 with one rounding; every RMSNorm,
the gated one too, one launch of the fused norm's RMS mode,
``kernels/rms_norm.py``):
``x += m·mixer(rms(x))``, then ``x += m·mlp(rms(x))`` with
``mlp(h) = out(silu(gate(h))·up(h))`` and ``m`` the residual multiplier,
folded into each branch's output linear at load. The backbone's input is
scaled by the embedding multiplier.

- Attention: no position embedding; scores scaled by the attention
  multiplier, folded at load into the q projection as
  ``attention_multiplier·√head_dim`` (0.125 at granite's widths, a power of
  two, so exact), so that the ``1/√head_dim`` of the attention code gives
  it. q, k and v are one projection. The KV heads are repeated to the query
  heads at the cache write, and identity RoPE tables (cos 1, sin 0) stand
  for no rotation, so an AR step runs through the decode-attention kernel
  (``kernels/decode_attention.py``) unchanged; a prompt runs plain.
- Mamba-2: ``z, xBC, dt = in_proj(h)``; ``xBC = silu(conv1d_4(xBC) + b)``
  (causal, depthwise) split into ``x [H, P]``, ``B`` and ``C`` (``G`` groups
  of ``N``); ``dt = softplus(dt + dt_bias)``, ``A = -exp(A_log)``; the
  state ``h [H, P, N]`` follows ``h ← exp(dt·A)·h + dt·x ⊗ B``; ``y = h·C
  + D·x``; ``out_proj(RMSNorm_G(y·silu(z)))``, the norm over each group's
  ``d_inner / G`` channels. An AR step runs it through the Mamba-2
  decode-step kernel (``kernels/mamba2_step.py``), then the gated norm
  and ``out_proj``; a prompt runs the chunked (SSD) form
  in plain PyTorch (:func:`ssd_scan`).

The cache (:func:`init_cache`) holds, beside the attention layers' KV
cache and its offset, each Mamba layer's conv state (its last three
inputs, ``[L_mamba, B, C, 3]`` in the activation dtype) and SSM state
(``[L_mamba, B, H, P, N]`` float32: the recurrent sum runs over hundreds of
steps), and the step kernel's grid counter. A prompt continues from the
cache's states (zero for a new request: the runtime's prefill zeroes
them); padded prompt rows change neither state (``dt`` is 0 there and the
conv state is read at ``valid_len``), so a bucketed prompt leaves the
states of the unpadded one. Every buffer is written in place.

The PocketTTS routes that carry or build a transformer KV cache from
elsewhere, or change its layout, are refused by name (:func:`unsupported`):
sessions, voices, weight quantization, the continuous batcher and tensor
parallel meshes.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple, Union

import torch
import torch.nn.functional as F

from go_pocket_tts_tpu_torch.kernels import decode_attention
from go_pocket_tts_tpu_torch.kernels import mamba2_step as m2k
from go_pocket_tts_tpu_torch.kernels import rms_norm as rmsk
from go_pocket_tts_tpu_torch.models.params import VarBuilder, apply_linear
from go_pocket_tts_tpu_torch.ops import attention_with_positions

__all__ = [
    "CACHE_KEYS",
    "CHUNK",
    "HybridConfig",
    "forward_cached",
    "forward_stateless",
    "init_cache",
    "is_hybrid_tree",
    "load_hybrid_backbone",
    "ssd_scan",
    "state_bytes",
    "unsupported",
]

Params = Dict

CACHE_KEYS = ("k", "v", "offset", "conv", "ssm", "sync")
# granite-4.0-h's mamba_chunk_size: a prompt is scanned in chunks of this
# many rows (one chunk for every prompt bucket up to 256).
CHUNK = 256
MAX_SEQ = 8192  # rows of the identity RoPE tables (decode-attention clamps to them)


@dataclass(frozen=True)
class HybridConfig:
    kinds: Tuple[str, ...]  # "mamba" or "attention", per layer
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    mamba_heads: int
    mamba_head_dim: int
    d_state: int
    mamba_groups: int
    embedding_multiplier: float
    rms_norm_eps: float
    use_kernels: bool = True  # False: the kernels' plain versions, on any device

    @property
    def num_layers(self) -> int:
        return len(self.kinds)

    @property
    def attention_layers(self) -> int:
        return self.kinds.count("attention")

    @property
    def mamba_layers(self) -> int:
        return self.kinds.count("mamba")

    @property
    def d_inner(self) -> int:
        return self.mamba_heads * self.mamba_head_dim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.mamba_groups * self.d_state


def unsupported(route: str) -> NotImplementedError:
    """The error of a route the hybrid backbone does not run."""
    return NotImplementedError(
        f"{route} is not supported with the hybrid Mamba-2 / attention backbone (flow_lm.backbone): "
        "it runs on the single runtime (GPURuntime: generate_audio, generate_audio_async, stream_generate) "
        "with float weights, without voices or sessions"
    )


def is_hybrid_tree(transformer: Params) -> bool:
    """Whether a FlowLM backbone parameter tree is this module's."""
    return any("f32" in layer for layer in transformer.get("layers", ()))


def _const(vb: VarBuilder, name: str) -> float:
    return float(vb.tensor(f"config.{name}").reshape(-1)[0])


def _linear(vb: VarBuilder, name: str, scale: float = 1.0) -> Params:
    w = vb.tensor(name + ".weight")
    if w.ndim != 2:
        raise ValueError(f"linear {vb.full_name(name)!r} must be rank-2, got {tuple(w.shape)}")
    return {"w": (w.T * scale).contiguous()}


def load_hybrid_backbone(flow: VarBuilder, num_heads: int) -> Tuple[Params, HybridConfig]:
    """The backbone under ``<flow>.backbone`` and its config; ``num_heads``
    is the attention layers' query heads."""
    bb = flow.path("backbone")
    if bb.raw("layers.0.input_layernorm.weight").dtype.kind not in "f":
        raise unsupported("a pre-quantized checkpoint")
    emb_mult = _const(bb, "embedding_multiplier")
    res_mult = _const(bb, "residual_multiplier")
    att_mult = _const(bb, "attention_multiplier")
    eps = _const(bb, "rms_norm_eps")
    groups = int(round(_const(bb, "mamba_n_groups")))
    d_model = bb.shape("layers.0.input_layernorm.weight")[0]
    if num_heads <= 0 or d_model % num_heads:
        raise ValueError(f"hybrid backbone: d_model {d_model} does not split into {num_heads} heads")
    head_dim = d_model // num_heads
    q_scale = att_mult * head_dim**0.5
    layers: List[Params] = []
    kinds: List[str] = []
    mamba_dims, kv_heads = set(), set()
    while True:
        lv = bb.path("layers", str(len(layers)))
        if lv.has("mamba.in_proj.weight"):
            kind = "mamba"
        elif lv.has("self_attn.q_proj.weight"):
            kind = "attention"
        else:
            break
        f32 = {"input_norm": lv.tensor("input_layernorm.weight"), "post_norm": lv.tensor("post_attention_layernorm.weight")}
        layer: Params = {
            "f32": f32,
            "mlp_in": _linear(lv, "shared_mlp.input_linear"),
            "mlp_out": _linear(lv, "shared_mlp.output_linear", res_mult),
        }
        if kind == "mamba":
            a_log = lv.tensor("mamba.A_log")
            conv = lv.tensor("mamba.conv1d.weight")
            if conv.ndim != 3 or conv.shape[1:] != (1, m2k.D_CONV):
                raise ValueError(f"hybrid backbone: conv1d weight {tuple(conv.shape)}, want [C, 1, {m2k.D_CONV}]")
            f32.update(a=-torch.exp(a_log), dt_bias=lv.tensor("mamba.dt_bias"), d=lv.tensor("mamba.D"),
                       gated_norm=lv.tensor("mamba.norm.weight"))
            layer.update(
                in_proj=_linear(lv, "mamba.in_proj"),
                conv_w=conv[:, 0, :].contiguous(),
                conv_b=lv.tensor("mamba.conv1d.bias"),
                out_proj=_linear(lv, "mamba.out_proj", res_mult),
            )
            heads, d_inner = a_log.shape[0], f32["gated_norm"].shape[0]
            n, conv_dim = m2k.step_widths(layer["in_proj"]["w"].shape[1], heads, groups, d_inner)
            if conv_dim != conv.shape[0] or d_inner % heads:
                raise ValueError(f"hybrid backbone: layer {len(layers)}: conv channels {conv.shape[0]} != {conv_dim}")
            mamba_dims.add((heads, d_inner // heads, n))
        else:
            q = _linear(lv, "self_attn.q_proj", q_scale)
            k, v = _linear(lv, "self_attn.k_proj"), _linear(lv, "self_attn.v_proj")
            if k["w"].shape[1] % head_dim or q["w"].shape[1] != d_model:
                raise ValueError(f"hybrid backbone: layer {len(layers)}: q/k widths {q['w'].shape[1]}/"
                                 f"{k['w'].shape[1]} do not fit {num_heads} heads of {head_dim}")
            layer.update(qkv={"w": torch.cat([q["w"], k["w"], v["w"]], dim=1)},
                         o_proj=_linear(lv, "self_attn.o_proj", res_mult))
            kv_heads.add(k["w"].shape[1] // head_dim)
        layers.append(layer)
        kinds.append(kind)
    if len(mamba_dims) != 1 or len(kv_heads) > 1:
        raise ValueError(f"hybrid backbone: Mamba widths {sorted(mamba_dims)} and KV heads {sorted(kv_heads)} "
                         "must each be one")
    (heads, p, n), num_kv = mamba_dims.pop(), kv_heads.pop() if kv_heads else num_heads
    if num_heads % num_kv:
        raise ValueError(f"hybrid backbone: {num_heads} query heads over {num_kv} KV heads")
    cfg = HybridConfig(
        kinds=tuple(kinds), d_model=d_model, num_heads=num_heads, num_kv_heads=num_kv, head_dim=head_dim,
        mamba_heads=heads, mamba_head_dim=p, d_state=n, mamba_groups=groups, embedding_multiplier=emb_mult,
        rms_norm_eps=eps,
    )
    half = head_dim // 2
    rope = {"rope_cos": torch.ones((MAX_SEQ, half)), "rope_sin": torch.zeros((MAX_SEQ, half))}
    return {"layers": layers, **rope}, cfg


def init_cache(
    cfg: HybridConfig,
    batch: int,
    capacity: int,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cpu",
) -> Params:
    """A zero cache: ``k``, ``v [L_attn, B, H, C, Dh]`` and the int32
    ``offset``, ``conv [L_mamba, B, conv_dim, 3]`` in ``dtype``, ``ssm
    [L_mamba, B, H_m, P, N]`` float32 and the step kernel's counter
    ``sync``."""
    kv = (cfg.attention_layers, batch, cfg.num_heads, capacity, cfg.head_dim)
    return {
        "k": torch.zeros(kv, dtype=dtype, device=device),
        "v": torch.zeros(kv, dtype=dtype, device=device),
        "offset": torch.zeros((), dtype=torch.int32, device=device),
        "conv": torch.zeros((cfg.mamba_layers, batch, cfg.conv_dim, m2k.D_CONV - 1), dtype=dtype, device=device),
        "ssm": torch.zeros((cfg.mamba_layers, batch, cfg.mamba_heads, cfg.mamba_head_dim, cfg.d_state),
                           dtype=torch.float32, device=device),
        "sync": torch.zeros((1,), dtype=torch.int32, device=device),
    }


def state_bytes(cfg: HybridConfig, batch: int, dtype: torch.dtype) -> int:
    """Bytes of a cache's recurrent state (the conv and SSM states)."""
    conv = cfg.mamba_layers * batch * cfg.conv_dim * (m2k.D_CONV - 1) * torch.empty((), dtype=dtype).element_size()
    return conv + cfg.mamba_layers * batch * cfg.d_inner * cfg.d_state * 4


def _rms_norm(x: torch.Tensor, w: torch.Tensor, cfg: HybridConfig, dtype: torch.dtype, groups: int = 1) -> torch.Tensor:
    """RMSNorm over the last dim (over each of ``groups`` equal slices of it)
    in float32 from ``x`` as stored, one rounding to ``dtype``: one launch of
    the fused norm's RMS mode with ``cfg.use_kernels``."""
    norm = rmsk.rms_norm if cfg.use_kernels else rmsk.rms_norm_plain
    return norm(x, w, cfg.rms_norm_eps, dtype, groups)


def _segsum(x: torch.Tensor) -> torch.Tensor:
    """``out[..., i, j] = x[..., j+1] + … + x[..., i]`` for ``i >= j``,
    -inf above the diagonal (summed by cumsum, not as a difference of
    cumsums, for accuracy)."""
    t = x.shape[-1]
    lower = torch.ones((t, t), dtype=torch.bool, device=x.device).tril(-1)
    s = x[..., None].expand(*x.shape, t).masked_fill(~lower, 0.0).cumsum(dim=-2)
    return s.masked_fill(~torch.ones((t, t), dtype=torch.bool, device=x.device).tril(), float("-inf"))


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    a: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    h0: torch.Tensor,
    chunk: int = CHUNK,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-2 recurrence over a sequence in the chunked SSD form
    (Dao and Gu, 2024, "Transformers are SSMs"): within a chunk the masked
    quadratic form, across chunks the states passed on. ``x [B, T, H, P]``,
    ``dt [B, T, H]`` (0 where a row must not count), ``a [H]``, ``b``, ``c``
    ``[B, T, G, N]``, the initial state ``h0 [B, H, P, N]``; all float32.
    Returns ``(y [B, T, H, P]`` without the ``D·x`` term, the final state
    ``[B, H, P, N])``."""
    batch, t, heads, p = x.shape
    rep = heads // b.shape[2]
    b = b.repeat_interleave(rep, dim=2)
    c = c.repeat_interleave(rep, dim=2)
    n = b.shape[-1]
    size = min(chunk, t)
    pad = -t % size
    if pad:
        x, dt, b, c = (F.pad(v, (0, 0) * (v.ndim - 2) + (0, pad)) for v in (x, dt, b, c))
    chunks = (t + pad) // size
    xs = (x * dt[..., None]).reshape(batch, chunks, size, heads, p)
    da = (dt * a).reshape(batch, chunks, size, heads).permute(0, 3, 1, 2)  # [B, H, c, l]
    b = b.reshape(batch, chunks, size, heads, n)
    c = c.reshape(batch, chunks, size, heads, n)
    cum = da.cumsum(dim=-1)
    y_diag = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", c, b, torch.exp(_segsum(da)), xs)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", b, torch.exp(cum[..., -1:] - cum), xs)
    states = torch.cat([h0[:, None], states], dim=1)
    passed = torch.einsum("bhzc,bchpn->bzhpn", torch.exp(_segsum(F.pad(cum[..., -1], (1, 0)))), states)
    y_off = torch.einsum("bclhn,bchpn,bhcl->bclhp", c, passed[:, :-1], torch.exp(cum))
    return (y_diag + y_off).reshape(batch, chunks * size, heads, p)[:, :t], passed[:, -1]


def _mamba(layer: Params, cfg: HybridConfig, cache: Params, j: int, h: torch.Tensor, valid) -> torch.Tensor:
    """Mamba layer ``j``'s mixer over ``h [B, T, D]``, updating its conv and
    SSM states in place: the step kernel for T = 1, the chunked scan for a
    prompt."""
    f = layer["f32"]
    zx = apply_linear(layer["in_proj"], h)
    batch, t = h.shape[:2]
    conv_state, ssm = cache["conv"][j], cache["ssm"][j]
    if t == 1:
        step = m2k.mamba2_step if cfg.use_kernels else m2k.mamba2_step_plain
        y = step(zx[:, 0], conv_state, layer["conv_w"], layer["conv_b"], f["dt_bias"], f["a"], f["d"], ssm,
                 cfg.mamba_groups, cache["sync"])[:, None]
    else:
        d_inner, heads = cfg.d_inner, cfg.mamba_heads
        z, xbc, dt = zx.split([d_inner, cfg.conv_dim, heads], dim=-1)
        # The causal conv from the cache's last inputs, in float32 (as the
        # step kernel), then the inputs at valid-3 .. valid-1 as the state.
        past = torch.cat([conv_state.float(), xbc.transpose(1, 2).float()], dim=-1)  # [B, C, 3 + T]
        w = layer["conv_w"].float()
        conv = sum(past[..., k : k + t] * w[:, k, None] for k in range(m2k.D_CONV))
        xbc = F.silu(conv + layer["conv_b"].float()[:, None]).transpose(1, 2)
        rows = torch.arange(m2k.D_CONV - 1, device=h.device) + torch.as_tensor(valid, device=h.device).long()
        x, bm, cm = xbc.split([d_inner] + [cfg.mamba_groups * cfg.d_state] * 2, dim=-1)
        real = torch.arange(t, device=h.device) < torch.as_tensor(valid, device=h.device)
        dt = torch.where(real[:, None], F.softplus(dt.float() + f["dt_bias"]), 0.0)
        x = x.reshape(batch, t, heads, cfg.mamba_head_dim)
        groups = (batch, t, cfg.mamba_groups, cfg.d_state)
        y, final = ssd_scan(x, dt, f["a"], bm.reshape(groups), cm.reshape(groups), ssm)
        conv_state.copy_(past.index_select(-1, rows))
        ssm.copy_(final)
        # The scan's einsums leave y channel-major; the norm reads rows.
        y = ((y + f["d"][:, None] * x).reshape(batch, t, d_inner) * F.silu(z.float())).contiguous()
    # The gated RMSNorm of the float32 y over each group's channels.
    return apply_linear(layer["out_proj"], _rms_norm(y, f["gated_norm"], cfg, h.dtype, cfg.mamba_groups))


def forward_cached(
    params: Params,
    cfg: HybridConfig,
    cache: Params,
    x: torch.Tensor,
    valid_len: Union[int, torch.Tensor, None] = None,
) -> Tuple[torch.Tensor, Params]:
    """Prefill (T > 1) or AR step (T = 1) of ``x [B, T, D]`` through every
    layer, from the cache's offset and states; ``valid_len`` (≤ T, an int
    or a device int32 scalar) counts the real rows. Returns ``(y, cache)``:
    the cache's buffers, written in place, with the offset advanced by
    ``valid_len``. Reads nothing on the host, so a CUDA graph captures
    it."""
    batch, t, _ = x.shape
    offset = cache["offset"]
    valid = t if valid_len is None else valid_len
    dtype = x.dtype
    x = x * cfg.embedding_multiplier
    if t == 1:
        step = (decode_attention.decode_attention_step if cfg.use_kernels
                else decode_attention.decode_attention_step_plain)
    else:
        pos_q = offset + torch.arange(t, dtype=torch.int32, device=x.device)
        pos_k = torch.arange(cache["k"].shape[3], dtype=torch.int32, device=x.device)
        slots = offset.long() + torch.arange(t, device=x.device)
    k_all, v_all = cache["k"], cache["v"]
    n_attn = n_mamba = 0
    rep = cfg.num_heads // cfg.num_kv_heads
    for layer, kind in zip(params["layers"], cfg.kinds):
        f = layer["f32"]
        h = _rms_norm(x, f["input_norm"], cfg, dtype)
        if kind == "mamba":
            h = _mamba(layer, cfg, cache, n_mamba, h, valid)
            n_mamba += 1
        else:
            q, k, v = apply_linear(layer["qkv"], h).split(
                [cfg.num_heads * cfg.head_dim] + [cfg.num_kv_heads * cfg.head_dim] * 2, dim=-1)
            q = q.reshape(batch, t, cfg.num_heads, cfg.head_dim).transpose(1, 2).contiguous()
            k, v = (z.reshape(batch, t, cfg.num_kv_heads, cfg.head_dim).transpose(1, 2)
                    .repeat_interleave(rep, dim=1).contiguous() for z in (k, v))
            if t == 1:
                attn, k_all, v_all = step(q, k, k_all, v_all, v, offset, params["rope_cos"], params["rope_sin"],
                                          layer=n_attn)
            else:
                k_all[n_attn].index_copy_(2, slots, k.to(k_all.dtype))
                v_all[n_attn].index_copy_(2, slots, v.to(v_all.dtype))
                attn = attention_with_positions(q, k_all[n_attn], v_all[n_attn], pos_q, pos_k)
            h = apply_linear(layer["o_proj"], attn.transpose(1, 2).reshape(batch, t, cfg.num_heads * cfg.head_dim))
            n_attn += 1
        x = x + h
        gate, up = apply_linear(layer["mlp_in"], _rms_norm(x, f["post_norm"], cfg, dtype)).chunk(2, -1)
        x = x + apply_linear(layer["mlp_out"], F.silu(gate) * up)
    return x, {**cache, "k": k_all, "v": v_all, "offset": offset + valid}


def forward_stateless(params: Params, cfg: HybridConfig, x: torch.Tensor) -> torch.Tensor:
    """The full-sequence forward of ``x [B, T, D]`` from zero states."""
    cache = init_cache(cfg, x.shape[0], x.shape[1], x.dtype, x.device)
    return forward_cached(params, cfg, cache, x)[0]
