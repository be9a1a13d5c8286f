"""Device meshes for batch serving: data parallel, and tensor parallel within
each replica (counterpart of ``go_pocket_tts_tpu/parallel/mesh.py``).

The reference annotates shardings on one program and lets GSPMD partition
it. PyTorch has no GSPMD, so here every placement is explicit and every
function returns the tensors each replica or rank holds:

- ``dp``: one engine replica per dp row. The weights are replicated on the
  row's rank-0 device, the slots and the batched state split over the rows.
  As in the reference, the forward has no collective.
- ``tp``: the Megatron split of the FlowLM transformer inside a replica.
  ``in_proj`` and ``linear1`` split their output columns, ``out_proj`` and
  ``linear2`` their input rows, and the KV cache its heads. The fused QKV
  is q|k|v, each part head-major, so rank ``r`` takes its own heads'
  columns from each of q, k and v (the reference lets GSPMD reshuffle the
  activation instead). Each rank's row product is a float32 partial; the
  partials are summed onto the rank-0 device, one reduction per residual
  add (``models/flow_transformer.py``). Everything else (norms, the
  flowNet, the EOS head, Mimi) stays whole on the rank-0 device.

A :class:`Mesh` is a ``[dp][tp]`` grid of ``torch.device``; a device may
repeat, so several ranks and replicas can share one card. The default
``device="cuda"`` takes the first ``dp·tp`` cards and raises when there are
fewer; ``device="cpu"`` gives ``dp·tp`` entries of the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

from go_pocket_tts_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from go_pocket_tts_tpu_torch.models import hybrid_backbone
from go_pocket_tts_tpu_torch.models.params import tree_map

__all__ = [
    "Mesh",
    "dp_mesh",
    "dp_tp_mesh",
    "replicate_params",
    "shard_batch",
    "shard_state",
    "shard_params_tp",
    "shard_state_tp",
]

Params = Dict
Devices = Optional[Sequence[Union[str, torch.device]]]


@dataclass(frozen=True)
class Mesh:
    """``devices[i][r]`` holds tp rank ``r`` of dp replica ``i``."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        sizes = {"dp": len(self.devices), "tp": len(self.devices[0])}
        return {name: sizes[name] for name in self.axis_names}

    @property
    def dp(self) -> int:
        return len(self.devices)

    @property
    def tp(self) -> int:
        return len(self.devices[0])


def _devices(what: str, need: int, devices: Devices, device: Union[str, torch.device]) -> List[torch.device]:
    if devices is not None:
        devs = [resolve_device(d) for d in devices]
        if len(devs) != need:
            raise ValueError(f"{what}: {len(devs)} devices given for {need} ranks")
        return devs
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * need
    if dev.type != "cuda":
        raise ValueError(f"{what}: unsupported device {str(dev)!r}")
    have = torch.cuda.device_count()
    if have < need:
        raise ValueError(f"{what}: requested {need} devices but only {have} available (cuda)")
    return [torch.device("cuda", i) for i in range(need)]


def dp_mesh(n_devices: Optional[int] = None, devices: Devices = None, device: Union[str, torch.device] = DEFAULT_DEVICE) -> Mesh:
    """A 1-D ``dp`` mesh of ``n_devices`` ranks (default: ``len(devices)``,
    every card, or one CPU rank). Raises when fewer cards exist than asked:
    a ``--runtime-dp N`` user must not silently run on fewer."""
    if n_devices is None:
        if devices is not None:
            n_devices = len(devices)
        elif torch.device(device).type == "cuda":
            n_devices = max(torch.cuda.device_count(), 1)
        else:
            n_devices = 1
    devs = _devices("dp_mesh", n_devices, devices, device)
    return Mesh(tuple((d,) for d in devs), ("dp",))


def dp_tp_mesh(dp: int, tp: int, devices: Devices = None, device: Union[str, torch.device] = DEFAULT_DEVICE) -> Mesh:
    """A 2-D ``(dp, tp)`` mesh over ``dp·tp`` ranks; ``tp`` is the inner
    axis, so a replica's ranks are adjacent devices."""
    devs = _devices(f"dp_tp_mesh (dp={dp} x tp={tp})", dp * tp, devices, device)
    return Mesh(tuple(tuple(devs[i * tp : (i + 1) * tp]) for i in range(dp)), ("dp", "tp"))


def replicate_params(params: Params, mesh: Mesh) -> List[Params]:
    """The weight tree on each replica's rank-0 device (shared, not copied,
    where that is the tree's own device)."""
    return [tree_map(lambda _p, t: t.to(row[0]), params) for row in mesh.devices]


def _split(t: torch.Tensor, parts: int, dim: int, what: str) -> List[torch.Tensor]:
    if t.shape[dim] % parts:
        raise ValueError(f"{what}: axis {dim} of {tuple(t.shape)} does not split {parts} ways")
    return list(t.chunk(parts, dim=dim))


def _own(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy on ``device``, so that replicas never share the
    buffers they write in place."""
    return t.to(device, copy=True).contiguous()


def shard_batch(tree, mesh: Mesh) -> list:
    """Every leaf's leading (batch) axis split over ``dp``: one tree per
    replica; 0-d leaves are replicated."""

    def rows(i):
        def put(_path, t):
            if t.ndim == 0:
                return _own(t, mesh.devices[i][0])
            return _own(_split(t, mesh.dp, 0, "shard_batch")[i], mesh.devices[i][0])

        return put

    return [tree_map(rows(i), tree) for i in range(mesh.dp)]


_KV_KEYS = ("k", "v", "k_scale", "v_scale")


def _check_slots(state: Params, mesh: Mesh) -> int:
    slots = state["cache"]["offset"].shape[0]
    if slots % mesh.dp:
        raise ValueError(f"{slots} slots do not split over dp={mesh.dp}")
    return slots // mesh.dp


def _lane_fields(state: Params, mesh: Mesh, i: int, per: int) -> Params:
    dev = mesh.devices[i][0]
    lanes = slice(i * per, (i + 1) * per)
    out = {k: _own(v[lanes], dev) for k, v in state.items() if k != "cache"}
    out["cache"] = {"offset": _own(state["cache"]["offset"][lanes], dev)}
    return out


def shard_state(state: Params, mesh: Mesh) -> List[Params]:
    """The batched AR state (``parallel.batching.make_batched_state``) split
    over ``dp``: KV buffers ``[L, B, ...]`` and their row scales on axis 1,
    every other field on its leading axis; one state per replica."""
    per = _check_slots(state, mesh)
    out = []
    for i in range(mesh.dp):
        part = _lane_fields(state, mesh, i, per)
        for key in _KV_KEYS:
            if key in state["cache"]:
                part["cache"][key] = _own(state["cache"][key][:, i * per : (i + 1) * per], mesh.devices[i][0])
        out.append(part)
    return out


def shard_state_tp(state: Params, mesh: Mesh) -> List[Params]:
    """The batched AR state over ``(dp, tp)``: slots over ``dp`` as in
    :func:`shard_state`, and each replica's KV buffers ``[L, B/dp, H, C,
    Dh]`` (and row scales ``[L, B/dp, H, C]``) split by heads over ``tp``,
    rank ``r``'s on ``devices[i][r]``: ``cache = {"ranks": [...], "offset"}``."""
    per = _check_slots(state, mesh)
    heads = state["cache"]["k"].shape[2]
    if heads % mesh.tp:
        raise ValueError(f"num_heads {heads} does not split over tp={mesh.tp}")
    out = []
    for i, row in enumerate(mesh.devices):
        part = _lane_fields(state, mesh, i, per)
        ranks = [{} for _ in row]
        for key in _KV_KEYS:
            if key in state["cache"]:
                lanes = state["cache"][key][:, i * per : (i + 1) * per]
                for r, (chunk, dev) in enumerate(zip(lanes.chunk(mesh.tp, dim=2), row)):
                    ranks[r][key] = _own(chunk, dev)
        part["cache"]["ranks"] = ranks
        out.append(part)
    return out


# The transformer layers' linears with a tensor-parallel layout.
_TP_COL = ("in_proj", "linear1")  # output columns split
_TP_ROW = ("out_proj", "linear2")  # input rows split


def _column_shard(p: Params, cols, dev: torch.device) -> Params:
    """The linear's output columns ``cols`` (a list of ranges) on ``dev``:
    ``w`` (float, int8 or packed int4) and ``scale`` (``[N]`` or ``[G, N]``)
    both have N last."""
    return {k: _own(torch.cat([v[..., a:b] for a, b in cols], dim=-1), dev) for k, v in p.items()}


def _row_shard(p: Params, r: int, tp: int, dev: torch.device, name: str) -> Params:
    """Rank ``r``'s input rows of the linear on ``dev``: ``w`` ``[K, N]`` (or
    packed ``[K/2, N]``) by rows; a per-channel ``scale [N]`` whole, a
    group-wise one ``[G, N]`` by its rank's groups (``K/tp`` a multiple of
    the group size)."""
    out = {"w": _own(_split(p["w"], tp, 0, name)[r], dev)}
    if "scale" in p:
        scale = p["scale"]
        out["scale"] = _own(_split(scale, tp, 0, f"{name} group scales")[r] if scale.ndim == 2 else scale, dev)
    return out


def _tp_rank_tree(transformer: Params, r: int, devices: Sequence[torch.device]) -> Params:
    tp, dev, dev0 = len(devices), devices[r], devices[0]
    layers = []
    for i, layer in enumerate(transformer["layers"]):
        for name in _TP_COL + _TP_ROW:
            if "b" in layer[name]:
                raise ValueError(f"layer {i} {name}: a tensor-parallel linear carries no bias")
        d = layer["out_proj"]["w"].shape[1]
        ffn = layer["linear1"]["w"].shape[1]
        if ffn % tp:
            raise ValueError(f"ffn_dim {ffn} does not split over tp={tp}")
        width = d // tp  # rank r's heads: width contiguous columns of each of q, k, v
        qkv_cols = [(part * d + r * width, part * d + (r + 1) * width) for part in range(3)]
        ffn_cols = [(r * ffn // tp, (r + 1) * ffn // tp)]
        layers.append({
            "norm1": tree_map(lambda _p, t: t.to(dev0), layer["norm1"]),
            "norm2": tree_map(lambda _p, t: t.to(dev0), layer["norm2"]),
            "in_proj": _column_shard(layer["in_proj"], qkv_cols, dev),
            "linear1": _column_shard(layer["linear1"], ffn_cols, dev),
            "out_proj": _row_shard(layer["out_proj"], r, tp, dev, f"layer {i} out_proj"),
            "linear2": _row_shard(layer["linear2"], r, tp, dev, f"layer {i} linear2"),
        })
    return {
        "layers": layers,
        "rope_cos": transformer["rope_cos"].to(dev),
        "rope_sin": transformer["rope_sin"].to(dev),
    }


def shard_params_tp(params: Params, mesh: Mesh, num_heads: int) -> List[Params]:
    """One tree per replica: a FlowLM tree, or a whole-model one (its
    ``flow_lm``), whose transformer is ``{"ranks": [rank trees]}``. Rank
    ``r``'s tree holds its shards of the transformer layers' four linears
    and the RoPE tables on ``devices[i][r]``, and the layer norms on the
    replica's rank-0 device, where everything outside the transformer
    stays whole. Raises when ``num_heads`` or the FFN width does not split
    over ``tp``, when a group-wise int4 ``K/tp`` is not a whole number of
    groups, and on a transformer linear with a bias."""
    tp = mesh.tp
    whole = "flow_lm" in params
    flow = params["flow_lm"] if whole else params
    if hybrid_backbone.is_hybrid_tree(flow["transformer"]):
        raise hybrid_backbone.unsupported("a tensor-parallel mesh")
    if num_heads % tp:
        raise ValueError(f"num_heads {num_heads} does not split over tp={tp}")
    out = []
    for row in mesh.devices:

        def on_row(tree):
            return tree_map(lambda _p, t: t.to(row[0]), tree)

        ranks = [_tp_rank_tree(flow["transformer"], r, row) for r in range(tp)]
        flow_row = {**on_row({k: v for k, v in flow.items() if k != "transformer"}), "transformer": {"ranks": ranks}}
        if whole:
            flow_row = {**on_row({k: v for k, v in params.items() if k != "flow_lm"}), "flow_lm": flow_row}
        out.append(flow_row)
    return out
