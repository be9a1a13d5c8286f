"""Stateful block-streaming Mimi decoder (counterpart of
``go_pocket_tts_tpu/models/mimi_stream.py``).

Every stage of the decode chain is causal, so a block decoder that carries
per-stage state is sample-exact with the whole-sequence decoder:

- causal Conv1d (stride 1): carry the last ``k − 1`` input frames; a zero
  state is the causal left pad;
- ConvTranspose1d (right trim ``k − s``): overlap-add, emit ``T·s``
  samples and carry the ``k − s`` tail into the next block;
- the windowed transformer: a K/V cache at absolute positions, whose
  250-step window hides old slots.

The last two SEANet stages (up2 → res2 → ELU → up3 → res3 → ELU → final
conv) run as one block of the cascade kernel
(``kernels/seanet_tail.fused_up2_up3_tail_stream``), which recomputes its
causal halo instead of carrying a tail per stage. So where the reference
keeps seven leaves (``up2_tail`` … ``final_conv``), this state keeps one,
``up2_in [B, C, 5]``: the last five columns of the up2 input. A block
passes it with ``start``, the absolute up2-input column of its first
column (``offset`` before the block × the up1 stride). For SEANet widths
the kernel does not take (``tiny_arch``), the kernel's plain streaming
version runs on the same state, so one layout serves every model.

Block size is in latent frames (each = 16 transformer steps = 1920
samples). Unlike the reference, whose functions are pure, the K/V buffers
are written IN PLACE (the reference donates them); every other leaf of
the returned state is a new tensor. A lane that :func:`freeze_lanes` keeps
back still had its K/V row written at its offset, which it does not
advance: the row lies past what the lane attends to and is written again
by its next block.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from go_pocket_tts_tpu_torch.kernels import layer_norm as lnk
from go_pocket_tts_tpu_torch.kernels import seanet_tail
from go_pocket_tts_tpu_torch.models.mimi import (
    MimiConfig,
    cascade_weights,
    takes_cascade_kernel,
)
from go_pocket_tts_tpu_torch.models.params import apply_linear
from go_pocket_tts_tpu_torch.ops import (
    apply_rope,
    apply_rope_rows,
    attention_with_positions,
    conv1d,
    conv_transpose1d_trim,
    elu,
    gelu_erf,
)

__all__ = [
    "init_stream_state",
    "decode_block",
    "freeze_lanes",
    "reset_lane",
    "reset_lanes",
]

Params = Dict
State = Dict

# Per-leaf lane axis in a batched stream state: the K/V buffers are
# [L, B, H, S, Dh] (axis 1), every other leaf is batch-leading.
_LANE_AXIS = {"kv_k": 1, "kv_v": 1}


def freeze_lanes(new_state: State, old_state: State, live: torch.Tensor) -> State:
    """Keep ``new_state`` for lanes where ``live`` is True, ``old_state``
    elsewhere: idle lanes must not advance their stream state. A leaf that
    :func:`decode_block` wrote in place (the K/V buffers, the same tensor in
    both states) is passed through: see the module docstring for why its
    rows at an idle lane's offset are harmless."""
    out = {}
    for key, new in new_state.items():
        if new is old_state[key]:
            out[key] = new
            continue
        axis = _LANE_AXIS.get(key, 0)
        shape = [1] * new.ndim
        shape[axis] = live.shape[0]
        out[key] = torch.where(live.reshape(shape).to(new.device), new, old_state[key])
    return out


def reset_lane(state: State, slot: int) -> State:
    """A copy of a batched stream state with one lane zeroed (a new
    streaming request was admitted into that slot)."""
    return reset_lanes({key: val.clone() for key, val in state.items()}, torch.tensor([slot]))


def reset_lanes(state: State, slots: Union[torch.Tensor, list]) -> State:
    """Zero several lanes IN PLACE and return the state (the reference's
    donated reset). Duplicate slot ids are fine: zeroing is idempotent."""
    for key, val in state.items():
        idx = torch.as_tensor(slots, dtype=torch.long, device=val.device)
        val.index_fill_(_LANE_AXIS.get(key, 0), idx, 0)
    return state


def init_stream_state(
    params: Params,
    cfg: MimiConfig,
    batch: int,
    max_steps: int,
    dtype: torch.dtype = torch.float32,
    per_lane_offsets: bool = False,
) -> State:
    """Zero state on the parameters' device. ``max_steps`` bounds the
    transformer K/V capacity in encoder steps (= latent frames × 16).

    ``per_lane_offsets=True`` makes ``offset`` an int32 ``[batch]`` vector
    so each lane advances on its own (a batched stream whose lanes join and
    leave at different times)."""
    tp = params["transformer"]
    device = params["init_conv"]["w"].device
    d_model = tp["layers"][0]["out_proj"]["w"].shape[1] if tp["layers"] else 0
    head_dim = tp["rope_cos"].shape[1] * 2
    num_heads = d_model // head_dim if d_model else 0

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def conv_tail(p):
        return zeros(batch, p["w"].shape[1], p["w"].shape[-1] - 1)

    def convtr_tail(p, stride):
        return zeros(batch, p["w"].shape[0], p["w"].shape[-1] - stride)

    s1 = cfg.seanet_strides[0]
    kv_shape = (len(tp["layers"]), batch, num_heads, max_steps, head_dim)
    offset_shape = (batch,) if per_lane_offsets else ()
    return {
        "offset": torch.zeros(offset_shape, dtype=torch.int32, device=device),
        "kv_k": zeros(*kv_shape),
        "kv_v": zeros(*kv_shape),
        "upsample_tail": convtr_tail(params["upsample"], cfg.steps_per_latent),
        "init_conv": conv_tail(params["init_conv"]),
        "up1_tail": convtr_tail(params["up1"], s1),
        "res1_c1": conv_tail(params["res1"]["conv1"]),
        "res1_c2": conv_tail(params["res1"]["conv2"]),
        "up2_in": zeros(batch, params["up2"]["w"].shape[1], seanet_tail.HALO),
    }


def _stream_conv(p: Params, state: State, key: str, x: torch.Tensor) -> Tuple[torch.Tensor, State]:
    """Causal conv, stride 1: the carried tail in place of the zero pad."""
    tail = state[key]
    inp = torch.cat([tail.to(x.dtype), x], dim=2)
    y = conv1d(inp, p["w"], p.get("b"))
    n = tail.shape[2]
    new_tail = inp[:, :, inp.shape[2] - n :] if n > 0 else tail
    return y, {**state, key: new_tail}


def _stream_convtr(
    p: Params, state: State, key: str, x: torch.Tensor, stride: int, groups: int = 1
) -> Tuple[torch.Tensor, State]:
    """ConvTranspose with an overlap-add tail: emit T·s samples, carry k−s."""
    full = conv_transpose1d_trim(x, p["w"], p.get("b"), stride, groups, right_trim=0)
    tail = state[key]
    n_tail = tail.shape[2]
    t_out = x.shape[2] * stride
    if n_tail > 0:
        full[:, :, :n_tail] += tail.to(full.dtype)
    emit = full[:, :, :t_out]
    new_tail = full[:, :, t_out:]
    if p.get("b") is not None and n_tail > 0:
        # The bias is added once per sample on both the emitted and the
        # carried region; the carried part must not count it twice.
        new_tail = new_tail - p["b"].to(new_tail.dtype)[None, :, None]
    return emit, {**state, key: new_tail}


def _stream_resblock(p: Params, state: State, k1: str, k2: str, x: torch.Tensor) -> Tuple[torch.Tensor, State]:
    h, state = _stream_conv(p["conv1"], state, k1, elu(x))
    h, state = _stream_conv(p["conv2"], state, k2, elu(h))
    return x + h, state


def _write_rows(buf: torch.Tensor, lanes: torch.Tensor, slots: torch.Tensor, rows: torch.Tensor) -> None:
    """``buf [B, H, S, Dh][lane, :, slot] = rows [B, T, H, Dh]`` per lane,
    dropping rows whose slot is past the capacity, as the reference's
    scatter does (a frozen lane that filled its capacity is still written).
    Without a host sync: such rows are aimed at the last slot and carry
    what that slot ends up holding, so every write there agrees."""
    last = buf.shape[2] - 1
    rows = rows.to(buf.dtype)
    hits = (slots == last)[:, :, None, None]
    final = torch.where(hits.any(1), torch.where(hits, rows, 0).sum(1), buf[:, :, last])  # [B, H, Dh]
    rows = torch.where((slots <= last)[:, :, None, None], rows, final[:, None])
    buf[lanes, :, slots.clamp(max=last)] = rows


def _stream_transformer(params: Params, cfg: MimiConfig, state: State, x: torch.Tensor) -> Tuple[torch.Tensor, State]:
    tp = params["transformer"]
    if not tp["layers"]:
        return x, state
    x = x.transpose(1, 2)  # [B, T, C]
    b, t, d = x.shape
    head_dim = tp["rope_cos"].shape[1] * 2
    num_heads = d // head_dim
    offset = state["offset"]
    capacity = state["kv_k"].shape[3]
    device = x.device
    steps = torch.arange(t, device=device)
    per_lane = offset.ndim == 1

    if per_lane:
        pos_q = offset[:, None] + steps[None, :].to(torch.int32)
        pos_k = torch.arange(capacity, dtype=torch.int32, device=device).expand(b, capacity)
        slots = offset.long()[:, None] + steps[None, :]  # [B, T]
        lanes = torch.arange(b, device=device)[:, None]
        rope_c = tp["rope_cos"][slots][:, None]  # [B, 1, T, half]
        rope_s = tp["rope_sin"][slots][:, None]
    else:
        pos_q = offset + steps.to(torch.int32)
        pos_k = torch.arange(capacity, dtype=torch.int32, device=device)
        slots = offset.long() + steps

    def heads(z):
        return z.reshape(b, t, num_heads, head_dim).transpose(1, 2)

    kv_k, kv_v = state["kv_k"], state["kv_v"]
    norm = lnk.layer_norm if cfg.use_kernels else lnk.layer_norm_plain
    for i, layer in enumerate(tp["layers"]):
        n1 = norm(x, layer["norm1"]["weight"], layer["norm1"]["bias"])
        q, k, v = (heads(z) for z in apply_linear(layer["in_proj"], n1).chunk(3, dim=-1))
        if per_lane:
            q, k = apply_rope_rows(q, rope_c, rope_s), apply_rope_rows(k, rope_c, rope_s)
            _write_rows(kv_k[i], lanes, slots, k.transpose(1, 2))
            _write_rows(kv_v[i], lanes, slots, v.transpose(1, 2))
        else:
            q = apply_rope(q, tp["rope_cos"], tp["rope_sin"], offset)
            k = apply_rope(k, tp["rope_cos"], tp["rope_sin"], offset)
            kv_k[i].index_copy_(2, slots, k.to(kv_k.dtype))
            kv_v[i].index_copy_(2, slots, v.to(kv_v.dtype))
        a = attention_with_positions(q, kv_k[i], kv_v[i], pos_q, pos_k, cfg.context)
        a = apply_linear(layer["out_proj"], a.transpose(1, 2).reshape(b, t, d))
        if "layer_scale_1" in layer:
            a = a * layer["layer_scale_1"].to(a.dtype)
        x = x + a
        n2 = norm(x, layer["norm2"]["weight"], layer["norm2"]["bias"])
        ff = apply_linear(layer["linear2"], gelu_erf(apply_linear(layer["linear1"], n2)))
        if "layer_scale_2" in layer:
            ff = ff * layer["layer_scale_2"].to(ff.dtype)
        x = x + ff

    state = {**state, "kv_k": kv_k, "kv_v": kv_v, "offset": offset + t}
    return x.transpose(1, 2), state


def decode_block(
    params: Params, cfg: MimiConfig, state: State, mimi_latent: torch.Tensor
) -> Tuple[torch.Tensor, State]:
    """Decode ``[B, 512, Tb]`` latent frames → ``[B, 1, Tb·1920]`` PCM,
    carrying the stream state. Concatenated blocks equal ``mimi_decode``
    of the whole latent (tested)."""
    s1, s2, s3 = cfg.seanet_strides
    b = mimi_latent.shape[0]
    start = (state["offset"].expand(b) * s1).to(torch.int32).contiguous()
    x, state = _stream_convtr(
        params["upsample"], state, "upsample_tail", mimi_latent, cfg.steps_per_latent, cfg.upsample_groups
    )
    x, state = _stream_transformer(params, cfg, state, x)
    x, state = _stream_conv(params["init_conv"], state, "init_conv", x)
    x = elu(x)
    x, state = _stream_convtr(params["up1"], state, "up1_tail", x, s1)
    x, state = _stream_resblock(params["res1"], state, "res1_c1", "res1_c2", x)
    x = elu(x).contiguous()
    halo = state["up2_in"].to(x.dtype).contiguous()
    weights = cascade_weights(params)
    if cfg.use_kernels and takes_cascade_kernel(params, cfg) and seanet_tail.supports_stream(x.shape[1], x.shape[2], 10, 8):
        pcm = seanet_tail.fused_up2_up3_tail_stream(x, halo, start, *weights)
    else:
        pcm = seanet_tail.fused_up2_up3_tail_stream_plain(x, halo, start, *weights, strides=(s2, s3))
    up2_in = torch.cat([halo, x], dim=2)[:, :, -seanet_tail.HALO :].to(state["up2_in"].dtype)
    return pcm, {**state, "up2_in": up2_in}

