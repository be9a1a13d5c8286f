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
Every layer norm goes through the fused LayerNorm kernel
(``kernels/layer_norm.py``: one launch a norm).
``TransformerConfig.use_kernels=False`` (the reference's ``use_pallas``)
sends the three kernels' calls to their plain versions, on any device.

**Tensor parallel.** A transformer tree whose ``ranks`` holds one tree per
tp rank (``parallel.mesh.shard_params_tp``) runs the Megatron split: rank
``r`` holds its own heads' columns of ``in_proj`` (from each of q, k and
v), its columns of ``linear1`` and the matching rows of ``out_proj`` and
``linear2``, on its own device; its KV cache holds its heads,
``{"ranks": [{k, v[, k_scale, v_scale]}: [L,B,H/tp,C,Dh]], "offset"}``.
Each rank's column products feed its heads' attention (the same kernels, at
``H/tp`` heads); its row product is a float32 partial, and the partials are
summed onto the rank-0 device and rounded once, one reduction per residual
add. Norms run once, on rank 0. :func:`transformer_step_batched` and
:func:`transformer_forward_cached` take either form.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from go_pocket_tts_tpu_torch.kernels import batched_decode_attention as bda
from go_pocket_tts_tpu_torch.kernels import decode_attention
from go_pocket_tts_tpu_torch.kernels import layer_norm as lnk
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
    rope_rows,
)

__all__ = [
    "TransformerConfig",
    "detect_num_heads",
    "load_flow_transformer",
    "init_kv_cache",
    "init_kv_cache_tp",
    "kv_cache_from_voice_state",
    "shard_cache_heads",
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
    use_kernels: bool = True  # False: the kernels' plain versions, on any device


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


def init_kv_cache_tp(
    cfg: TransformerConfig,
    batch: int,
    capacity: int,
    dtype: torch.dtype,
    devices: Sequence[torch.device],
) -> Params:
    """Zero tensor-parallel cache: rank ``r`` holds ``[L,B,H/tp,C,Dh]`` on
    ``devices[r]``; the offset (int32, 0-d) lives on ``devices[0]``."""
    heads = cfg.num_heads // len(devices)
    shape = (cfg.num_layers, batch, heads, capacity, cfg.head_dim)
    ranks = [
        {"k": torch.zeros(shape, dtype=dtype, device=d), "v": torch.zeros(shape, dtype=dtype, device=d)}
        for d in devices
    ]
    return {"ranks": ranks, "offset": torch.zeros((), dtype=torch.int32, device=devices[0])}


def shard_cache_heads(cache: Params, devices: Sequence[torch.device]) -> Params:
    """A whole float cache ``{k, v: [L,B,H,C,Dh], offset}`` split by heads
    into the tensor-parallel form on ``devices`` (copies)."""
    tp = len(devices)
    ranks = [
        {"k": k.to(d, copy=True).contiguous(), "v": v.to(d, copy=True).contiguous()}
        for d, k, v in zip(devices, cache["k"].chunk(tp, dim=2), cache["v"].chunk(tp, dim=2))
    ]
    return {"ranks": ranks, "offset": cache["offset"].to(devices[0], copy=True)}


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
    input's, written in place, with a new offset tensor. A tensor-parallel
    tree and cache run every T in plain PyTorch. ``valid_len`` may be a
    device int32 scalar: no value on the device is read on the host, so a
    CUDA graph captures the prefill (``GPURuntime._prefill``, the batcher's
    slot prefill), on either path.
    """
    t = x.shape[1]
    offset = cache["offset"]
    valid = t if valid_len is None else valid_len
    if "ranks" in params:
        return _forward_cached_tp(params["ranks"], cfg, cache, x), {
            "ranks": cache["ranks"],
            "offset": offset + valid,
        }
    capacity = cache["k"].shape[3]
    device = x.device
    norm = lnk.layer_norm if cfg.use_kernels else lnk.layer_norm_plain

    use_kernel = t == 1 and cfg.context is None
    if use_kernel:
        step = decode_attention.decode_attention_step if cfg.use_kernels else decode_attention.decode_attention_step_plain
    else:
        # A slot's position equals its index; causal masking over absolute
        # positions hides unwritten and padded slots.
        pos_q = offset + torch.arange(t, dtype=torch.int32, device=device)
        pos_k = torch.arange(capacity, dtype=torch.int32, device=device)
        slots = offset.long() + torch.arange(t, device=device)
        cos_rows, sin_rows = rope_rows(params["rope_cos"], params["rope_sin"], offset, t)

    k_all, v_all = cache["k"], cache["v"]
    for i, layer in enumerate(params["layers"]):
        n1 = norm(x, layer["norm1"]["weight"], layer["norm1"]["bias"])
        qkv = apply_linear(layer["in_proj"], n1)
        q, k, v = (
            _split_heads(part, cfg.num_heads, cfg.head_dim) for part in qkv.chunk(3, dim=-1)
        )
        if use_kernel:
            attn, k_all, v_all = step(
                q, k, k_all, v_all, v, offset, params["rope_cos"], params["rope_sin"], layer=i
            )
        else:
            q = apply_rope_rows(q, cos_rows, sin_rows)
            k = apply_rope_rows(k, cos_rows, sin_rows)
            k_all[i].index_copy_(2, slots, k.to(k_all.dtype))
            v_all[i].index_copy_(2, slots, v.to(v_all.dtype))
            attn = attention_with_positions(q, k_all[i], v_all[i], pos_q, pos_k, cfg.context)

        x = x + apply_linear(layer["out_proj"], _merge_heads(attn))
        n2 = norm(x, layer["norm2"]["weight"], layer["norm2"]["bias"])
        x = x + apply_linear(layer["linear2"], gelu_erf(apply_linear(layer["linear1"], n2)))

    return x, {"k": k_all, "v": v_all, "offset": offset + valid}


def _batched_attention(
    cfg: TransformerConfig,
    rope: Tuple[torch.Tensor, torch.Tensor],
    part: Params,
    offsets: torch.Tensor,
    layer: int,
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
) -> torch.Tensor:
    """One layer's batched decode attention over ``part`` (a cache, or one
    rank's), writing the step's rows: the fused kernel step for a causal
    config, separate ops for a windowed one."""
    k_all, v_all = part["k"], part["v"]
    ks_all, vs_all = part.get("k_scale"), part.get("v_scale")
    if cfg.context is None:
        step = bda.batched_decode_attention_step if cfg.use_kernels else bda.batched_decode_attention_step_plain
        return step(q, k, v, k_all, v_all, offsets, *rope, layer, ks_all, vs_all)
    batch, capacity = q.shape[0], k_all.shape[3]
    pos_q = offsets[:, None]
    pos_k = torch.arange(capacity, dtype=torch.int32, device=q.device).expand(batch, capacity)
    q = bda.write_step_rows(q, k, v, k_all, v_all, offsets, *rope, layer, ks_all, vs_all)
    if ks_all is not None:
        return attention_with_positions_int8kv(
            q, k_all[layer], ks_all[layer], v_all[layer], vs_all[layer], pos_q, pos_k, cfg.context
        )
    return attention_with_positions(q, k_all[layer], v_all[layer], pos_q, pos_k, cfg.context)


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
    (:func:`~go_pocket_tts_tpu_torch.kernels.batched_decode_attention.batched_decode_attention_step`),
    per rank under tensor parallelism; a windowed one runs it as separate
    ops. Returns ``(y, cache)``: the buffers are the input's, updated in
    place, with offsets ``+ 1``.
    """
    offsets = cache["offset"]
    if "ranks" in params:
        ranks = params["ranks"]
        rank_offsets = [offsets.to(r["rope_cos"].device) for r in ranks]

        def attend(r, i, q, k, v):
            rope = (ranks[r]["rope_cos"], ranks[r]["rope_sin"])
            return _batched_attention(cfg, rope, cache["ranks"][r], rank_offsets[r], i, q, k, v)

        return _tp_layers(ranks, cfg, x, attend), {"ranks": cache["ranks"], "offset": offsets + 1}

    batch = x.shape[0]
    rope = (params["rope_cos"], params["rope_sin"])
    norm = lnk.layer_norm if cfg.use_kernels else lnk.layer_norm_plain
    for i, layer in enumerate(params["layers"]):
        n1 = norm(x, layer["norm1"]["weight"], layer["norm1"]["bias"])
        qkv = apply_linear(layer["in_proj"], n1)
        # [B,H,1,Dh] views into the projection: the kernel takes their strides.
        q, k, v = qkv.reshape(batch, 1, 3, cfg.num_heads, cfg.head_dim).permute(2, 0, 3, 1, 4)
        attn = _batched_attention(cfg, rope, cache, offsets, i, q, k, v)
        x = x + apply_linear(layer["out_proj"], _merge_heads(attn))
        n2 = norm(x, layer["norm2"]["weight"], layer["norm2"]["bias"])
        x = x + apply_linear(layer["linear2"], gelu_erf(apply_linear(layer["linear1"], n2)))

    new_cache = {"k": cache["k"], "v": cache["v"], "offset": offsets + 1}
    if "k_scale" in cache:
        new_cache["k_scale"], new_cache["v_scale"] = cache["k_scale"], cache["v_scale"]
    return x, new_cache


# -- tensor parallel ----------------------------------------------------------


def _reduce(parts: List[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """The ranks' float32 partials summed on x's device, rounded once to
    x's dtype."""
    total = parts[0].to(x.device)
    for part in parts[1:]:
        total = total + part.to(x.device)
    return total.to(x.dtype)


def _tp_layers(
    ranks: Sequence[Params],
    cfg: TransformerConfig,
    x: torch.Tensor,
    attend: Callable[[int, int, torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """The layers of a tensor-parallel forward. Per layer: the norm on rank
    0; each rank's column product on its device, split into its heads'
    q, k, v ``[B,H/tp,T,Dh]`` views for ``attend(rank, layer, q, k, v)``,
    and its row product as a float32 partial; one reduction per residual
    add."""
    b, t = x.shape[:2]
    heads = cfg.num_heads // len(ranks)
    devices = [r["rope_cos"].device for r in ranks]
    norm = lnk.layer_norm if cfg.use_kernels else lnk.layer_norm_plain
    for i in range(cfg.num_layers):
        norms = ranks[0]["layers"][i]
        n1 = norm(x, norms["norm1"]["weight"], norms["norm1"]["bias"])
        parts = []
        for r, (rank, dev) in enumerate(zip(ranks, devices)):
            layer = rank["layers"][i]
            qkv = apply_linear(layer["in_proj"], n1.to(dev))
            q, k, v = qkv.reshape(b, t, 3, heads, cfg.head_dim).permute(2, 0, 3, 1, 4)
            attn = attend(r, i, q, k, v)
            parts.append(apply_linear(layer["out_proj"], _merge_heads(attn), out_dtype=torch.float32))
        x = x + _reduce(parts, x)
        n2 = norm(x, norms["norm2"]["weight"], norms["norm2"]["bias"])
        parts = []
        for rank, dev in zip(ranks, devices):
            layer = rank["layers"][i]
            h = gelu_erf(apply_linear(layer["linear1"], n2.to(dev)))
            parts.append(apply_linear(layer["linear2"], h, out_dtype=torch.float32))
        x = x + _reduce(parts, x)
    return x


def _forward_cached_tp(ranks: Sequence[Params], cfg: TransformerConfig, cache: Params, x: torch.Tensor) -> torch.Tensor:
    """:func:`transformer_forward_cached`'s plain path, per rank over its
    heads and its cache."""
    t = x.shape[1]
    per_rank = []
    for rank, part in zip(ranks, cache["ranks"]):
        dev = part["k"].device
        offset = cache["offset"].to(dev)
        cos_rows, sin_rows = rope_rows(rank["rope_cos"], rank["rope_sin"], offset, t)
        per_rank.append((
            offset + torch.arange(t, dtype=torch.int32, device=dev),
            torch.arange(part["k"].shape[3], dtype=torch.int32, device=dev),
            offset.long() + torch.arange(t, device=dev),
            cos_rows,
            sin_rows,
        ))

    def attend(r, i, q, k, v):
        pos_q, pos_k, slots, cos_rows, sin_rows = per_rank[r]
        k_all, v_all = cache["ranks"][r]["k"], cache["ranks"][r]["v"]
        q = apply_rope_rows(q, cos_rows, sin_rows)
        k = apply_rope_rows(k, cos_rows, sin_rows)
        k_all[i].index_copy_(2, slots, k.to(k_all.dtype))
        v_all[i].index_copy_(2, slots, v.to(v_all.dtype))
        return attention_with_positions(q, k_all[i], v_all[i], pos_q, pos_k, cfg.context)

    return _tp_layers(ranks, cfg, x, attend)


def transformer_forward_stateless(params: Params, cfg: TransformerConfig, x: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal forward without a cache (the reference's
    ``FlowMain`` resequencing path): ``x`` [B, T, D] at positions
    ``0..T-1``, RoPE from 0, masked to ``cfg.context`` when it is set."""
    pos = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    rope = (params["rope_cos"], params["rope_sin"])
    norm = lnk.layer_norm if cfg.use_kernels else lnk.layer_norm_plain
    for layer in params["layers"]:
        n1 = norm(x, layer["norm1"]["weight"], layer["norm1"]["bias"])
        q, k, v = (
            _split_heads(part, cfg.num_heads, cfg.head_dim)
            for part in apply_linear(layer["in_proj"], n1).chunk(3, dim=-1)
        )
        attn = attention_with_positions(apply_rope(q, *rope), apply_rope(k, *rope), v, pos, pos, cfg.context)
        x = x + apply_linear(layer["out_proj"], _merge_heads(attn))
        n2 = norm(x, layer["norm2"]["weight"], layer["norm2"]["bias"])
        x = x + apply_linear(layer["linear2"], gelu_erf(apply_linear(layer["linear1"], n2)))
    return x
