"""FlowLM transformer: pre-norm layers with fused-QKV attention and a
static-capacity KV cache (counterpart of
``go_pocket_tts_tpu/models/flow_transformer.py``).

Per layer: LN → fused in_proj (QKV) → split → ``[B,H,T,Dh]`` → RoPE(q, k at
the cache offset) → append K/V → position-masked attention → out_proj →
residual; LN → linear1 → GELU(erf) → linear2 → residual.

The cache is ``{k, v: [L,B,H,C,Dh], offset: int32 0-d tensor}`` on the
device. All layers share one offset; it stays a device tensor, so neither
prefill nor an AR step needs a host sync. Unlike the reference, whose
functions are pure, the cache buffers are updated IN PLACE and returned
(the reference donates them to the same effect).

:func:`transformer_forward_stateless` is the full-sequence causal forward
without a cache (positions from 0), in plain PyTorch.

An AR step (T = 1) of a causal config goes through the decode-attention
kernel wrapper (``kernels/decode_attention.py``: RoPE, append and masked
attention in one launch per layer); prefill (T > 1) and windowed configs
use plain PyTorch.

The continuous batcher's step, :func:`transformer_step_batched`, keeps one
offset per lane (``offset`` int32 ``[B]``) and, optionally, an int8 cache
with per-row float32 scales (``k_scale``/``v_scale`` ``[L,B,H,C]``); its
RoPE, row quantization, row writes and attention go through the fused
batched decode-attention step (``kernels/batched_decode_attention.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from go_pocket_tts_tpu_torch.kernels import batched_decode_attention as bda
from go_pocket_tts_tpu_torch.kernels import decode_attention
from go_pocket_tts_tpu_torch.models.params import (
    VarBuilder,
    apply_linear,
    layer_norm_params,
    linear_params,
)
from go_pocket_tts_tpu_torch.ops import (
    apply_rope,
    apply_rope_rows,
    attention_with_positions,
    attention_with_positions_int8kv,
    build_rope_tables,
    gelu_erf,
    layer_norm,
    rope_rows,
)

__all__ = [
    "TransformerConfig",
    "detect_num_heads",
    "load_flow_transformer",
    "init_kv_cache",
    "kv_cache_from_voice_state",
    "transformer_forward_cached",
    "transformer_forward_stateless",
    "transformer_step_batched",
]

Params = Dict


@dataclass(frozen=True)
class TransformerConfig:
    num_layers: int
    num_heads: int
    head_dim: int
    d_model: int
    max_period: float = 10000.0
    max_seq: int = 8192
    context: Optional[int] = None  # sliding attention window (Mimi: 250)


def detect_num_heads(d_model: int, fallback: int = 16) -> int:
    """Head-count heuristic from known PocketTTS configs."""
    for n in (16, 8, 4, 2, 1):
        if d_model % n == 0:
            return n
    return fallback


def _load_layer(vb: VarBuilder) -> Params:
    return {
        "norm1": layer_norm_params(vb, "norm1"),
        "norm2": layer_norm_params(vb, "norm2"),
        "in_proj": linear_params(vb, "self_attn.in_proj", with_bias=False),
        "out_proj": linear_params(vb, "self_attn.out_proj", with_bias=False),
        "linear1": linear_params(vb, "linear1", with_bias=False),
        "linear2": linear_params(vb, "linear2", with_bias=False),
    }


def load_flow_transformer(
    vb: VarBuilder, num_heads: int = 0, max_period: float = 10000.0
) -> Tuple[Params, TransformerConfig]:
    """Load layers under ``<vb>.transformer.layers.N`` (count probed by key
    presence)."""
    layers: List[Params] = []
    i = 0
    while vb.path("transformer", "layers", str(i)).has("norm1.weight"):
        layers.append(_load_layer(vb.path("transformer", "layers", str(i))))
        i += 1
    if not layers:
        raise ValueError("flow transformer: no layers found")

    d_model = layers[0]["out_proj"]["w"].shape[1]
    if num_heads <= 0:
        num_heads = detect_num_heads(d_model)
    if d_model % num_heads != 0:
        raise ValueError(f"d_model {d_model} not divisible by num_heads {num_heads}")
    cfg = TransformerConfig(
        num_layers=len(layers),
        num_heads=num_heads,
        head_dim=d_model // num_heads,
        d_model=d_model,
        max_period=max_period,
    )
    cos, sin = build_rope_tables(cfg.max_seq, cfg.head_dim, cfg.max_period)
    return {"layers": layers, "rope_cos": cos, "rope_sin": sin}, cfg


def init_kv_cache(
    cfg: TransformerConfig,
    batch: int,
    capacity: int,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cpu",
) -> Params:
    """Zero cache ``{k,v: [L,B,H,C,Dh], offset: int32}`` on ``device``."""
    shape = (cfg.num_layers, batch, cfg.num_heads, capacity, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dtype, device=device),
        "v": torch.zeros(shape, dtype=dtype, device=device),
        "offset": torch.zeros((), dtype=torch.int32, device=device),
    }


def kv_cache_from_voice_state(
    cfg: TransformerConfig,
    modules: Dict[str, Dict[str, np.ndarray]],
    capacity: int,
    dtype: torch.dtype = torch.float32,
    device: Union[str, torch.device] = "cpu",
) -> Params:
    """A cache hydrated from upstream voice model state.

    Upstream stores per module ``cache [2,B,T,H,Dh]`` (K and V, time-major)
    and ``offset`` under ``transformer.layers.N.self_attn``; the cache here
    is head-major ``[L,B,H,C,Dh]``, zero-padded to ``capacity``, with the
    shared offset. Every layer must name the same offset."""
    ks, vs, offsets = [], [], []
    for i in range(cfg.num_layers):
        name = f"transformer.layers.{i}.self_attn"
        module = modules.get(name)
        if module is None:
            raise ValueError(f"voice model state missing module {name!r}")
        cache = module.get("cache")
        off_t = module.get("offset")
        if cache is None or off_t is None:
            raise ValueError(f"voice model state module {name!r} missing cache/offset")
        cache = np.asarray(cache)
        if cache.ndim != 5 or cache.shape[0] != 2:
            raise ValueError(
                f"voice model state module {name!r} cache shape {cache.shape}, want [2,B,T,H,D]"
            )
        _, _, t, h, dh = cache.shape
        if h != cfg.num_heads or dh != cfg.head_dim:
            raise ValueError(
                f"voice model state module {name!r} heads/dim ({h},{dh}) != ({cfg.num_heads},{cfg.head_dim})"
            )
        off = float(np.asarray(off_t).reshape(-1)[0])
        if off != int(off) or off < 0:
            raise ValueError(f"voice model state module {name!r} offset {off} invalid")
        off = int(off)
        if off > t:
            raise ValueError(f"voice model state module {name!r} offset {off} exceeds cache length {t}")
        if t > capacity:
            raise ValueError(f"voice cache length {t} exceeds KV capacity {capacity}; raise the prompt bucket")
        offsets.append(off)
        # [B,T,H,Dh] → [B,H,T,Dh], time zero-padded to the capacity.
        pad = ((0, 0), (0, 0), (0, capacity - t), (0, 0))
        ks.append(np.pad(np.moveaxis(cache[0], 2, 1), pad))
        vs.append(np.pad(np.moveaxis(cache[1], 2, 1), pad))
    if len(set(offsets)) != 1:
        raise ValueError(f"voice model state has inconsistent per-layer offsets {offsets}")
    return {
        "k": torch.from_numpy(np.stack(ks).astype(np.float32)).to(device=device, dtype=dtype),
        "v": torch.from_numpy(np.stack(vs).astype(np.float32)).to(device=device, dtype=dtype),
        "offset": torch.tensor(offsets[0], dtype=torch.int32, device=device),
    }


def _split_heads(x: torch.Tensor, num_heads: int, head_dim: int) -> torch.Tensor:
    b, t, _ = x.shape
    return x.reshape(b, t, num_heads, head_dim).transpose(1, 2).contiguous()


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def transformer_forward_cached(
    params: Params,
    cfg: TransformerConfig,
    cache: Params,
    x: torch.Tensor,
    valid_len: Union[int, torch.Tensor, None] = None,
) -> Tuple[torch.Tensor, Params]:
    """Prefill (T>1) or AR step (T=1) through all layers with cache update.

    ``x``: [B, T, D]. ``valid_len`` (≤ T) marks how many of the T tokens are
    real; the offset advances by it, and padded tokens are never visible to
    later queries (their slots sit beyond the new offset and are overwritten
    by later writes). Returns ``(y, cache)``; the cache buffers are the
    input's, written in place, with a new offset tensor.
    """
    t = x.shape[1]
    offset = cache["offset"]
    valid = t if valid_len is None else valid_len
    capacity = cache["k"].shape[3]
    device = x.device

    use_kernel = t == 1 and cfg.context is None
    if not use_kernel:
        # A slot's position equals its index; causal masking over absolute
        # positions hides unwritten and padded slots.
        pos_q = offset + torch.arange(t, dtype=torch.int32, device=device)
        pos_k = torch.arange(capacity, dtype=torch.int32, device=device)
        slots = offset.long() + torch.arange(t, device=device)
        cos_rows, sin_rows = rope_rows(params["rope_cos"], params["rope_sin"], offset, t)

    k_all, v_all = cache["k"], cache["v"]
    for i, layer in enumerate(params["layers"]):
        n1 = layer_norm(x, layer["norm1"]["weight"], layer["norm1"]["bias"])
        qkv = apply_linear(layer["in_proj"], n1)
        q, k, v = (
            _split_heads(part, cfg.num_heads, cfg.head_dim) for part in qkv.chunk(3, dim=-1)
        )
        if use_kernel:
            attn, k_all, v_all = decode_attention.decode_attention_step(
                q, k, k_all, v_all, v, offset, params["rope_cos"], params["rope_sin"], layer=i
            )
        else:
            q = apply_rope_rows(q, cos_rows, sin_rows)
            k = apply_rope_rows(k, cos_rows, sin_rows)
            k_all[i].index_copy_(2, slots, k.to(k_all.dtype))
            v_all[i].index_copy_(2, slots, v.to(v_all.dtype))
            attn = attention_with_positions(q, k_all[i], v_all[i], pos_q, pos_k, cfg.context)

        x = x + apply_linear(layer["out_proj"], _merge_heads(attn))
        n2 = layer_norm(x, layer["norm2"]["weight"], layer["norm2"]["bias"])
        x = x + apply_linear(layer["linear2"], gelu_erf(apply_linear(layer["linear1"], n2)))

    return x, {"k": k_all, "v": v_all, "offset": offset + valid}


def transformer_step_batched(
    params: Params,
    cfg: TransformerConfig,
    cache: Params,
    x: torch.Tensor,
) -> Tuple[torch.Tensor, Params]:
    """One AR step (T = 1) with **per-lane** offsets: the continuous
    batcher's counterpart of :func:`transformer_forward_cached`.

    ``cache['offset']`` is int32 ``[B]``; each lane rotates q and k by its
    own position, writes its K/V row at its own offset (after quantizing
    the rows when the cache is int8) and attends to slots ``0..offset``. A
    lane whose offset has reached the capacity (a finished lane that filled
    it) writes nothing. A causal config does all of that in one fused
    kernel launch per layer
    (:func:`~go_pocket_tts_tpu_torch.kernels.batched_decode_attention.batched_decode_attention_step`);
    a windowed one runs it as separate ops. Returns ``(y, cache)``: the
    buffers are the input's, updated in place, with offsets ``+ 1``.
    """
    offsets = cache["offset"]
    batch, capacity = x.shape[0], cache["k"].shape[3]
    use_kernel = cfg.context is None
    if not use_kernel:
        pos_q = offsets[:, None]
        pos_k = torch.arange(capacity, dtype=torch.int32, device=x.device).expand(batch, capacity)

    k_all, v_all = cache["k"], cache["v"]
    ks_all, vs_all = cache.get("k_scale"), cache.get("v_scale")
    rope = (params["rope_cos"], params["rope_sin"])
    for i, layer in enumerate(params["layers"]):
        n1 = layer_norm(x, layer["norm1"]["weight"], layer["norm1"]["bias"])
        qkv = apply_linear(layer["in_proj"], n1)
        # [B,H,1,Dh] views into the projection: the kernel takes their strides.
        q, k, v = qkv.reshape(batch, 1, 3, cfg.num_heads, cfg.head_dim).permute(2, 0, 3, 1, 4)
        if use_kernel:
            attn = bda.batched_decode_attention_step(q, k, v, k_all, v_all, offsets, *rope, i, ks_all, vs_all)
        else:
            q = bda.write_step_rows(q, k, v, k_all, v_all, offsets, *rope, i, ks_all, vs_all)
            if ks_all is not None:
                attn = attention_with_positions_int8kv(
                    q, k_all[i], ks_all[i], v_all[i], vs_all[i], pos_q, pos_k, cfg.context
                )
            else:
                attn = attention_with_positions(q, k_all[i], v_all[i], pos_q, pos_k, cfg.context)
        x = x + apply_linear(layer["out_proj"], _merge_heads(attn))
        n2 = layer_norm(x, layer["norm2"]["weight"], layer["norm2"]["bias"])
        x = x + apply_linear(layer["linear2"], gelu_erf(apply_linear(layer["linear1"], n2)))

    new_cache = {"k": k_all, "v": v_all, "offset": offsets + 1}
    if ks_all is not None:
        new_cache["k_scale"], new_cache["v_scale"] = ks_all, vs_all
    return x, new_cache


def transformer_forward_stateless(params: Params, cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal forward without a cache (the reference's
    ``FlowMain`` resequencing path): ``x`` [B, T, D] at positions
    ``0..T-1``, RoPE from 0, masked to ``cfg.context`` when it is set."""
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    rope = (params["rope_cos"], params["rope_sin"])
    for layer in params["layers"]:
        n1 = layer_norm(x, layer["norm1"]["weight"], layer["norm1"]["bias"])
        q, k, v = (
            _split_heads(part, cfg.num_heads, cfg.head_dim)
            for part in apply_linear(layer["in_proj"], n1).chunk(3, dim=-1)
        )
        attn = attention_with_positions(apply_rope(q, *rope), apply_rope(k, *rope), v, pos, pos, cfg.context)
        x = x + apply_linear(layer["out_proj"], _merge_heads(attn))
        n2 = layer_norm(x, layer["norm2"]["weight"], layer["norm2"]["bias"])
        x = x + apply_linear(layer["linear2"], gelu_erf(apply_linear(layer["linear1"], n2)))
    return x
