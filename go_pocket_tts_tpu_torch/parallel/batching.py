"""Continuous batching on the GPU: concurrent requests share one AR step
(counterpart of ``go_pocket_tts_tpu/parallel/batching.py``).

A fixed set of request *slots* steps together:

- each slot is a lane of the batched KV cache with its **own offset**
  (``models.flow_transformer.transformer_step_batched``), so requests join
  and leave at any step (different prompt lengths and EOS times);
- admission is burst-batched: every queued plain request (an embedding
  voice counts in its prompt) is prefilled in one batched forward and
  spliced into the batch state together, the count padded to 1 or the full
  slot count as the reference pads it; a request with a voice model state,
  or a session chunk carrying its predecessor's KV snapshot, is prefilled
  into its slot on its own;
- steps run in blocks of ``k``: ``steps_per_sync`` while any streaming lane
  is attached, ``steps_per_sync_burst`` otherwise. The whole block is
  enqueued on the device with no host sync; it also gives each lane's
  frames of this block (``windows``) and their count (``n_new``), so the
  streaming lanes' PCM is decoded in one batched stream decode enqueued
  straight behind it (``models/mimi_stream.py``, per-lane offsets; its last
  SEANet stages are the cascade kernel at each lane's own start);
- blocks pipeline one deep: block N's flags (done, active, n_frames),
  streamed int16 PCM and counts are copied to the host together and read
  while block N+1 runs;
- the per-lane EOS countdown runs on the device, as in the single runtime;
- finished plain lanes are decoded together (int16 PCM) and freed; a
  drainer thread waits for the PCM and resolves the futures. A finished
  streamed lane resolves with its concatenated blocks, and ends its stream;
- a session chunk's lane is snapshotted (a float copy of its KV cache) before
  its slot is freed (``generate_session``, ``stream_session``);
- a stream whose consumer goes away frees its lane at the next block.

Unlike the reference, whose state arrays are donated to each program and
replaced, the KV caches, the frame buffer, the per-lane fields and the
stream decoder's state are updated IN PLACE. On the card the engine's
programs are captured CUDA graphs (``runtime/graphs.py``), the reference's
jitted ones: one AR block graph per block size, its stream decode per
block size, the harvest decode per (padded lane count, decode bucket),
the burst admission (prefill and splice) per (padded lane count, prompt
bucket), the hydrated or session lane's prefill and splice per prompt
bucket, the lane snapshot (the slot a device index) and the stream
decoder's lane reset per padded lane count. Each writes every new state
leaf back into the engine's state tensors, which so keep their
addresses, and admissions write into them between blocks; an
admission's per-lane values reach the device as one packed copy. All
device work of the engine is issued from its thread on one stream, so
each in-place write is ordered after every read that was
enqueued before it; everything the engine reads one iteration later
(flags, PCM, counts) is copied to the host before the next graph runs, and
a session snapshot is a copy. The LSD noise comes from a device
``torch.Generator`` the batcher owns, drawn per block into the block
graph's static noise buffer (JAX's threefry bits cannot be reproduced, so
the two packages agree at temperature 0 only). On the CPU the graphs'
bodies run eagerly over the same buffers.

**Meshes** (``mesh=``, ``parallel/mesh.py``). Each dp row of the mesh is an
engine replica: ``slots/dp`` slots, its own state, stream decoder, device
``torch.Generator`` and thread, over one queue that every replica admits
from, taking only as many requests as it has free slots. A replica's model
is replicated on its row's rank-0 device or, with ``tp > 1``, its
transformer is Megatron-split over the row's ranks, each rank's KV cache
holding its heads (``models/flow_transformer.py``); the kernels run on each
rank's shard. Everything after the transformer (flowNet, EOS, the harvest
and stream decodes) runs on the replica's rank 0. Replicas that share a
device share its stream; their tensors are disjoint, so the in-place
ordering argument above holds per replica. A session's snapshot gathers
the heads back into one lane on the replica's rank 0, so it resumes on any
replica.

A mesh replica whose tp ranks all sit on its rank-0 device (every replica
of a mesh on one card, every dp-only replica) captures its programs as the
unsharded engine does, at its shards' shapes; one whose ranks span devices
runs them eagerly, decided from the mesh at construction
(``eager_reason``, :meth:`ContinuousBatcher.graph_stats`). Replicas enqueue
each program under the process's capture lock, so one replica's capture
never runs beside another's launches.
``pallas=False`` (or ``None`` with ``POCKETTTS_PALLAS=0``) runs every
kernel's plain version on the card, as ``GPURuntime`` does. An idle engine
waits for a request without taking it from the queue, so a burst is
admitted in the order it was submitted; the reference takes the waking
request and puts it back at the end.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import math
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from go_pocket_tts_tpu_torch import tracing
from go_pocket_tts_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from go_pocket_tts_tpu_torch.models import flow_lm as flm
from go_pocket_tts_tpu_torch.models import flow_transformer as ftr
from go_pocket_tts_tpu_torch.models import hybrid_backbone
from go_pocket_tts_tpu_torch.models import mimi_stream
from go_pocket_tts_tpu_torch.models.model import PocketTTSModel
from go_pocket_tts_tpu_torch.models.quantize import quantize_kv_rows
from go_pocket_tts_tpu_torch.parallel.mesh import (
    Mesh,
    replicate_params,
    shard_params_tp,
    shard_state,
    shard_state_tp,
)
from go_pocket_tts_tpu_torch.runtime.generate import (
    GenerateConfig,
    HostCopy,
    _full_f32,
    decode_pcm16,
    kernel_model,
    kernels_scope,
    quantized_model,
    resolve_pallas,
)
from go_pocket_tts_tpu_torch.runtime.graphs import GraphCache, exclusive, feed, write_back
from go_pocket_tts_tpu_torch.text.prepare import estimate_max_frames
from go_pocket_tts_tpu_torch.utils import buckets as bk

log = logging.getLogger("pockettts.torch.batching")

__all__ = ["BatchContinuation", "BatcherRuntime", "ContinuousBatcher", "make_batched_state"]

State = Dict


def _strip_voice_if_carried(cfg: GenerateConfig, cont) -> GenerateConfig:
    """A carried continuation supersedes voice conditioning (its cache holds
    the voice since the session's first chunk). The Service applies the
    voice to every chunk so that a session reset re-applies it; it is
    dropped here only when the carried state survived validation."""
    if cont is None or (cfg.voice_embedding is None and cfg.voice_model_state is None):
        return cfg
    return dataclasses.replace(cfg, voice_embedding=None, voice_model_state=None)


def _fail_request(req: "_Request", exc: Exception) -> None:
    """Deliver a failure on both channels: the future, and the stream queue
    (a streaming consumer reads only the queue)."""
    if req.stream is not None:
        req.stream.put(exc)
    _try_resolve(req.future, exc=exc)


def _try_resolve(fut: Future, result=None, exc: Optional[Exception] = None) -> None:
    """Resolve a future once, tolerating the drainer/_fail_all race."""
    try:
        if fut.done():
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except Exception:  # InvalidStateError: the other side resolved it first
        pass


# -- the device side: state, AR block, admission, decodes --------------------


def make_batched_state(
    flow_cfg,
    slots: int,
    capacity: int,
    max_frames: int,
    steps_per_sync: int,
    dtype: torch.dtype,
    kv_quantize: bool = False,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
) -> State:
    """The per-lane engine state :func:`_ar_step_body` reads and writes: all
    lanes inactive and zeroed. ``frames`` is ``steps_per_sync`` wider than
    ``max_frames``, as in the reference (its block-window slice never
    clamps). With ``kv_quantize`` the K/V buffers are int8 with float32 row
    scales (``quantize_kv_rows``)."""
    tcfg = flow_cfg.transformer
    latent = flow_cfg.latent_dim
    dev = resolve_device(device)
    cache_shape = (tcfg.num_layers, slots, tcfg.num_heads, capacity, tcfg.head_dim)
    kv_dtype = torch.int8 if kv_quantize else dtype
    cache = {
        "k": torch.zeros(cache_shape, dtype=kv_dtype, device=dev),
        "v": torch.zeros(cache_shape, dtype=kv_dtype, device=dev),
        "offset": torch.zeros((slots,), dtype=torch.int32, device=dev),
    }
    if kv_quantize:
        cache["k_scale"] = torch.zeros(cache_shape[:-1], dtype=torch.float32, device=dev)
        cache["v_scale"] = torch.zeros(cache_shape[:-1], dtype=torch.float32, device=dev)

    def lanes(fill, lane_dtype):
        return torch.full((slots,), fill, dtype=lane_dtype, device=dev)

    return {
        "cache": cache,
        "frame": torch.full((slots, 1, latent), float("nan"), dtype=dtype, device=dev),
        "frames": torch.zeros((slots, max_frames + steps_per_sync, latent), dtype=dtype, device=dev),
        "n_frames": lanes(0, torch.int32),
        "countdown": lanes(-1, torch.int32),
        "done": lanes(False, torch.bool),
        "active": lanes(False, torch.bool),
        "max_steps": lanes(0, torch.int32),
        "eos_threshold": lanes(0.0, torch.float32),
        "frames_after_eos": lanes(0, torch.int32),
        "sigma": lanes(0.0, torch.float32),
    }


def _ar_step_body(params, cfg, state: State, noise: torch.Tensor, decode_steps: int, time_cond, fused_ada) -> State:
    """One AR step for every lane; lanes that are not live (inactive, or
    done and waiting for harvest) keep their frame, counts and offset."""
    live = state["active"] & ~state["done"]
    frame = state["frame"]
    seq = torch.where(torch.isnan(frame), params["bos_emb"].to(frame.dtype), frame)
    x = flm.apply_linear(params["input_linear"], seq)
    y, cache = ftr.transformer_step_batched(params["transformer"], cfg.transformer, state["cache"], x)
    kernels = cfg.transformer.use_kernels
    last, eos_logit = flm._hidden_and_eos(params, y, kernels)
    decoded = flm.fnet.lsd_decode(params["flow_net"], last, noise, decode_steps, time_cond, fused_ada, kernels)

    frames = state["frames"]
    lanes = torch.arange(frames.shape[0], device=frames.device)
    idx = state["n_frames"].long().clamp(max=frames.shape[1] - 1)
    frames[lanes, idx] = torch.where(live[:, None], decoded.to(frames.dtype), frames[lanes, idx])

    countdown = state["countdown"]
    is_eos = eos_logit.float() > state["eos_threshold"]
    newly = is_eos & (countdown < 0) & live
    countdown = torch.where(newly, state["frames_after_eos"], countdown)
    n_frames = torch.where(live, state["n_frames"] + 1, state["n_frames"])
    done = state["done"] | (live & (countdown == 0)) | (n_frames >= state["max_steps"])
    countdown = torch.where((countdown > 0) & live & ~done, countdown - 1, countdown)
    # Frozen offsets for lanes that are not live, so a lane waiting for
    # harvest or admission does not drift.
    cache["offset"] = torch.where(live, cache["offset"], state["cache"]["offset"])
    return {
        **state,
        "cache": cache,
        "frame": torch.where(live[:, None, None], decoded[:, None, :], frame),
        "n_frames": n_frames,
        "countdown": countdown,
        "done": done,
    }


def _batched_ar_multi_step(params, cfg, state: State, k: int, decode_steps: int, gen: torch.Generator, time_cond, fused_ada):
    """``k`` AR steps for all lanes, enqueued with no host sync: the noise
    of the whole block is drawn on the device first (``[k, B, L]`` from
    ``gen``), then :func:`_ar_block_steps`. The eager form of the engine's
    block graph."""
    frame = state["frame"]
    noise = torch.randn((k, frame.shape[0], frame.shape[2]), generator=gen, device=frame.device, dtype=torch.float32)
    return _ar_block_steps(params, cfg, state, noise, decode_steps, time_cond, fused_ada)


def _ar_block_steps(params, cfg, state: State, noise: torch.Tensor, decode_steps: int, time_cond, fused_ada):
    """``len(noise)`` AR steps for all lanes, the noise ``[k, B, L]`` scaled
    per lane by ``sqrt(temperature)``.

    Returns ``(state, windows, n_new, flags)``: ``windows [B, k, L]`` is
    each lane's frames written by this block, left-aligned from its frame
    count before the block, ``n_new [B]`` their number (0 for a lane that
    is not live), and ``flags`` a ``[3, B]`` int32 copy of
    done/active/n_frames. All three are fresh tensors (a gather, a
    difference, a stack), never views of the state: the engine copies them
    to the host and reads them one iteration later, after the next block
    and admissions have written the state in place."""
    frame = state["frame"]
    k, slots = noise.shape[0], frame.shape[0]
    n_before = state["n_frames"].clone()
    noise = (noise * state["sigma"][None, :, None]).to(frame.dtype)
    for step in range(k):
        state = _ar_step_body(params, cfg, state, noise[step], decode_steps, time_cond, fused_ada)
    lanes = torch.arange(slots, device=frame.device)[:, None]
    cols = n_before.long()[:, None] + torch.arange(k, device=frame.device)[None, :]
    windows = state["frames"][lanes, cols]
    flags = torch.stack([state["done"].int(), state["active"].int(), state["n_frames"]])
    return state, windows, state["n_frames"] - n_before, flags


def _kv_parts(cache: State) -> List[State]:
    """The cache's K/V buffers: the cache itself, or its tensor-parallel
    ranks'."""
    return cache["ranks"] if "ranks" in cache else [cache]


def _set_cache_lanes(cache: State, idx: torch.Tensor, lanes: State, offsets: torch.Tensor) -> None:
    """Write prefilled float K/V lanes (a cache ``[L, N, H, C, Dh]``, or its
    ranks' heads) into the stacked cache at lanes ``idx`` ``[N]``, in
    place, quantizing each row first when the cache is int8."""
    cache["offset"].index_copy_(0, idx, offsets)
    for part, lane in zip(_kv_parts(cache), _kv_parts(lanes)):
        at = idx.to(part["k"].device)
        for name in ("k", "v"):
            if "k_scale" in part:
                q, scale = quantize_kv_rows(lane[name])
                part[name].index_copy_(1, at, q)
                part[f"{name}_scale"].index_copy_(1, at, scale)
            else:
                part[name].index_copy_(1, at, lane[name].to(part[name].dtype))


def _prefill_lanes(params, tcfg, embs: torch.Tensor, capacity: int) -> State:
    """Prefill ``N`` fresh lanes together: ``embs [N, bucket, D]``
    (zero-padded per lane) → a K/V cache ``[L, N, H, capacity, Dh]`` (per
    rank under tensor parallelism). Every lane starts at offset 0 with the
    same positions, so the uniform-offset forward applies; rows past a
    lane's prompt are never visible (its offset masks them, and its AR
    steps overwrite them)."""
    transformer = params["transformer"]
    if "ranks" in transformer:
        devices = [r["rope_cos"].device for r in transformer["ranks"]]
        cache = ftr.init_kv_cache_tp(tcfg, embs.shape[0], capacity, embs.dtype, devices)
    else:
        cache = ftr.init_kv_cache(tcfg, embs.shape[0], capacity, embs.dtype, embs.device)
    _, cache = ftr.transformer_forward_cached(transformer, tcfg, cache, embs)
    return cache


def _lane_values(slots, offsets, max_steps, eos_thresholds, frames_after_eos, sigmas) -> torch.Tensor:
    """The per-lane values of an admission, host lists of N each, packed
    into one host int32 ``[6, N]`` tensor so that they reach the device in
    one copy: rows slot, offset, max_steps, frames_after_eos, then the
    float32 eos_threshold and sigma as their bits."""
    packed = np.stack([
        np.asarray(slots, np.int32),
        np.asarray(offsets, np.int32),
        np.asarray(max_steps, np.int32),
        np.asarray(frames_after_eos, np.int32),
        np.asarray(eos_thresholds, np.float32).view(np.int32),
        np.asarray(sigmas, np.float32).view(np.int32),
    ])
    return torch.from_numpy(packed)


def _insert_lanes(state: State, values: torch.Tensor, lanes: State) -> None:
    """Splice N prefilled lanes into the batch state, in place (duplicate
    slots carry identical data); ``values`` is :func:`_lane_values`' packed
    tensor on the state's device."""
    slot, offset, max_steps, frames_after_eos, eos, sigma = values
    idx = slot.long()
    _set_cache_lanes(state["cache"], idx, lanes, offset)
    state["frame"].index_fill_(0, idx, float("nan"))
    state["n_frames"].index_fill_(0, idx, 0)
    state["countdown"].index_fill_(0, idx, -1)
    state["done"].index_fill_(0, idx, False)
    state["active"].index_fill_(0, idx, True)
    state["max_steps"].index_copy_(0, idx, max_steps)
    state["eos_threshold"].index_copy_(0, idx, eos.view(torch.float32))
    state["frames_after_eos"].index_copy_(0, idx, frames_after_eos)
    state["sigma"].index_copy_(0, idx, sigma.view(torch.float32))


def _harvest_decode_pcm16(model: PocketTTSModel, frames: torch.Tensor, slots: torch.Tensor, n_frames: torch.Tensor, decode_frames: int) -> torch.Tensor:
    """Decode the finished lanes ``slots`` in one batch → int16 PCM
    ``[N, 1, decode_frames·1920]``; the host trims each to its n_frames."""
    return decode_pcm16(model, frames[slots], n_frames[slots], decode_frames)


def _batched_stream_decode(
    model: PocketTTSModel,
    stream_state: State,
    windows: torch.Tensor,
    n_new: torch.Tensor,
    streaming_mask: torch.Tensor,
):
    """One stream decode for every streaming lane of a block → ``(int16 PCM
    [B, 1, k·1920], stream state)``.

    ``windows``/``n_new`` are the AR block's own outputs, so this is
    enqueued straight behind the block with no host read in between. Each
    lane's frames past its ``n_new`` are zeroed; a lane with ``n_new == 0``
    (a plain lane, an empty slot, a finished stream) keeps its stream state
    (``freeze_lanes``). The decoder's K/V rows are written in place for every
    lane, a frozen one included: those rows lie past its offset, which it
    does not advance, so it never attends to them, and its next block writes
    them again before reading them."""
    k = windows.shape[1]
    n_new = torch.where(streaming_mask, n_new, torch.zeros_like(n_new))
    mask = (torch.arange(k, device=windows.device) < n_new[:, None])[:, :, None]
    latent = torch.where(mask, windows, torch.zeros((), dtype=windows.dtype, device=windows.device))
    pcm, new_state = mimi_stream.decode_block(
        model.params["mimi"], model.config.mimi, stream_state, model.latent_to_mimi(latent)
    )
    new_state = mimi_stream.freeze_lanes(new_state, stream_state, n_new > 0)
    # Truncation toward zero, as the harvest decode and the host WAV encoder.
    return (pcm.float().clamp(-1.0, 1.0) * 32767.0).to(torch.int16), new_state


@dataclasses.dataclass
class BatchContinuation:
    """Cross-chunk prosody state for the batched engine: one lane's KV cache
    ``[L, 1, H, capacity, Dh]`` (float: an int8 cache is dequantized by the
    snapshot and quantized again when it is spliced back) and its offset
    ``[1]`` int32 on the device. The counterpart of
    ``runtime.generate.ContinuationState`` for slot-based serving; unlike
    that, it can be submitted more than once (hydration copies it).

    ``offset_host`` is read lazily by :meth:`ContinuousBatcher.generate_session`
    on the caller's thread, never the engine's."""

    k: torch.Tensor
    v: torch.Tensor
    offset: torch.Tensor
    capacity: int
    offset_host: Optional[int] = None


def _snapshot_lane(cache: State, slot: torch.Tensor):
    """One lane of the stacked KV cache (int8 rows dequantized with their
    scales; a tensor-parallel cache's heads gathered onto its rank 0) and
    its offset, for the lane ``slot`` (a ``[1]`` index on the device, so
    that every slot shares one graph, as the reference traces it). Fresh
    tensors (a gather), never views: later blocks write the stacked cache
    in place."""
    dev = cache["offset"].device
    ks, vs = [], []
    for part in _kv_parts(cache):
        at = slot.to(part["k"].device)
        k, v = part["k"].index_select(1, at), part["v"].index_select(1, at)
        if "k_scale" in part:
            k = k.float() * part["k_scale"].index_select(1, at)[..., None]
            v = v.float() * part["v_scale"].index_select(1, at)[..., None]
        ks.append(k.to(dev))
        vs.append(v.to(dev))
    return torch.cat(ks, dim=2), torch.cat(vs, dim=2), cache["offset"].index_select(0, slot)


# -- the host side: requests, slots, the engine loop -------------------------


@dataclasses.dataclass
class _Request:
    tokens: List[int]
    cfg: GenerateConfig
    future: Future
    # A streaming request's PCM blocks go here as they are decoded (None
    # ends the stream, an exception raises in the consumer); its future
    # resolves with the whole concatenated audio as well.
    stream: Optional["queue.Queue"] = None
    # Set when the consumer goes away (its generator closed): the engine
    # frees the lane at the next block.
    cancelled: threading.Event = dataclasses.field(default_factory=threading.Event)
    # A session chunk: ``cont`` hydrates the lane from the previous chunk's
    # snapshot; ``keep_state`` asks for this chunk's snapshot before the
    # slot is freed, in ``state_out`` (set before the future resolves).
    cont: Optional[BatchContinuation] = None
    keep_state: bool = False
    state_out: Optional[BatchContinuation] = None
    # The request's id (``tracing.py``), always set; while tracing is on, the
    # time ``_enqueue`` queued it, where its ``queue`` span starts.
    rid: int = dataclasses.field(default_factory=tracing.next_request_id)
    enqueued: Optional[int] = None


@dataclasses.dataclass
class _SlotInfo:
    request: Optional[_Request] = None
    emitted_frames: int = 0
    streaming: bool = False
    stream_parts: Optional[List[np.ndarray]] = None
    # Bumped on every attach and release. A block is read one iteration
    # after it was enqueued; if its slot was harvested and re-admitted in
    # between, its flags and PCM describe the previous occupant. The epoch
    # recorded with the block keeps a recycled slot from acting on them.
    epoch: int = 0


def _program(method):
    """An engine program: enqueued under the process's capture lock, so
    that another engine's capture on the same card never runs beside it."""

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with exclusive():
            return method(self, *args, **kwargs)

    return run


def _spans_devices(device: torch.device, rank_devices) -> Optional[str]:
    """Why an engine on ``device`` with tp ranks on ``rank_devices`` (None:
    unsharded) must run eagerly, or None when its graphs can be captured:
    a graph is captured on one device, so every rank must sit on the
    engine's own."""
    if rank_devices is None or all(torch.device(d) == torch.device(device) for d in rank_devices):
        return None
    return "its tp ranks span " + ", ".join(str(d) for d in rank_devices) + " (a graph is captured on one device)"


class _Engine:
    """One engine: a set of slots over one model replica (its tp ranks when
    the replica's transformer is sharded), stepped by its own thread, which
    admits from its owner's queue. The unsharded batcher is its own and
    only engine; a batcher over a mesh has one per dp row."""

    def _init_engine(
        self,
        owner: "ContinuousBatcher",
        model: PocketTTSModel,
        slots: int,
        device: torch.device,
        seed: Optional[int],
        state: State,
        index: int = 0,
    ) -> None:
        self._owner = owner
        self._index = index  # the engine's index among its batcher's, on its spans
        self.model, self.slots, self.device, self._state = model, slots, device, state
        self.dtype, self.kv_quantize, self.kernels = owner.dtype, owner.kv_quantize, owner.kernels
        self.steps_per_sync, self.steps_per_sync_burst = owner.steps_per_sync, owner.steps_per_sync_burst
        self.max_frames, self.capacity = owner.max_frames, owner.capacity
        self._queue, self._arrival = owner._queue, owner._arrival
        self._last_block_k = 0  # block size of the last block enqueued
        self._slot_info = [_SlotInfo() for _ in range(slots)]
        # The batched stream decoder's state, one lane per slot, made on the
        # first streaming admission; the lanes admitted in one burst are
        # reset together at its end.
        self._stream_state: Optional[State] = None
        self._pending_stream_resets: List[int] = []
        self._harvest_pool: Optional[ThreadPoolExecutor] = self._new_pool()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._crashed: Optional[Exception] = None
        self._gen = torch.Generator(device=device)
        self._gen.manual_seed(seed if seed is not None else time.time_ns() & 0x7FFFFFFF)
        flow = model.params["flow_lm"]
        ranks = flow["transformer"].get("ranks")
        self._rank_devices = None if ranks is None else [r["rope_cos"].device for r in ranks]
        with torch.no_grad(), kernels_scope(self.kernels):
            # Loop invariants of the AR step (the reference builds them inside
            # each block program).
            self._time_cond = flm.fnet.precompute_time_cond(flow["flow_net"], 1)
            self._fused_ada = flm.fnet.precompute_fused_adaln(flow["flow_net"])
        # The engine's programs as graphs (block, stream decode, harvest
        # decode, admission, slot prefill, snapshot, stream reset), captured
        # and replayed by the engine thread: the unsharded engine's, and a
        # mesh replica's whose ranks all sit on its rank-0 device. A replica
        # whose ranks span devices runs them eagerly (decided here, from the
        # mesh; ``eager_reason`` says why).
        self.eager_reason = _spans_devices(device, self._rank_devices)
        self._graphs: Optional[GraphCache] = GraphCache(device) if self.eager_reason is None else None
        if self.eager_reason is not None:
            log.info("batcher replica on %s runs eagerly: %s", device, self.eager_reason)
        # The slot prefill's static lane (made on its first use).
        self._lane: Optional[State] = None

    @staticmethod
    def _new_pool() -> ThreadPoolExecutor:
        return ThreadPoolExecutor(max_workers=1, thread_name_prefix="pockettts-harvest")

    def _start_engine(self) -> None:
        self._stop.clear()
        if self._harvest_pool is None:  # restart after stop()
            self._harvest_pool = self._new_pool()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _stop_engine(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        if self._graphs is not None:
            # Release the graphs and their pool; a restart captures anew.
            self._graphs.release()
        # Deliver every already-harvested wave before returning.
        if self._harvest_pool is not None:
            self._harvest_pool.shutdown(wait=True)
            self._harvest_pool = None
        # Never strand a caller or a stream consumer: fail whatever is still
        # attached.
        if any(info.request is not None for info in self._slot_info):
            self._fail_slots(RuntimeError("batcher stopped with requests in flight"))

    def _free_slots(self) -> List[int]:
        return [i for i, s in enumerate(self._slot_info) if s.request is None]

    def _pad_count(self, n: int) -> int:
        """An admission or harvest burst is padded to 1 or the full slot
        count, the reference's two program variants."""
        return 1 if n <= 1 else self.slots

    def _admit(self) -> None:
        free = self._free_slots()
        pending = []
        while free and not self._queue.empty():
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            tracing.record("queue", req.enqueued, request=req.rid, engine=self._index)
            pending.append((free.pop(0), req))
        if not pending:
            return
        with tracing.span("admit", engine=self._index):
            # A voice model state or a carried session hydrates an existing KV
            # cache, one lane at a time; the rest prefill together.
            batchable = []
            for slot, req in pending:
                if req.cfg.voice_model_state is not None or req.cont is not None:
                    try:
                        self._prefill_into_slot(slot, req)
                    except Exception as exc:  # noqa: BLE001
                        _fail_request(req, exc)
                else:
                    batchable.append((slot, req))
            if batchable:
                self._admit_batch(batchable)
            if self._pending_stream_resets:
                # One in-place reset of every stream lane admitted this burst,
                # after the stream decode enqueued before the admission.
                self._reset_streams(self._pending_stream_resets)
                self._pending_stream_resets = []

    def _tokens(self, req: _Request) -> np.ndarray:
        tokens = np.asarray(req.tokens, np.int64)
        n_bins = self.model.params["flow_lm"]["conditioner_embed"].shape[0]
        if np.any(tokens < 0) or np.any(tokens >= n_bins):
            raise ValueError(f"token id out of range [0,{n_bins})")
        return tokens

    def _max_steps(self, cfg: GenerateConfig, n_tokens: int) -> int:
        return min(cfg.max_steps or cfg.estimated_max_steps or estimate_max_frames(n_tokens), self.max_frames)

    def _embed(self, tokens: np.ndarray, width: int) -> torch.Tensor:
        """Text embeddings ``[1, width, D]`` of ``tokens`` padded to
        ``width`` on the host; the pad ids' K/V sit past the lane's offset
        and are never attended."""
        ids = np.zeros((1, width), np.int64)
        ids[0, : len(tokens)] = tokens
        flow = self.model.params["flow_lm"]
        with tracing.span("wait"):  # a copy from pageable memory: waits for the stream
            ids_dev = torch.from_numpy(ids).to(self.device)
        return flm.text_embeddings(flow, ids_dev).to(self.dtype)

    def _admit_batch(self, items) -> None:
        """Prefill N requests in one batched forward and splice them in. An
        embedding voice goes in front of the text and counts in the prompt
        bucket."""
        d_model = self.model.params["flow_lm"]["conditioner_embed"].shape[1]
        prepped = []
        with tracing.span("prepare"):
            for slot, req in items:
                try:
                    cfg = req.cfg
                    tokens = self._tokens(req)
                    max_steps = self._max_steps(cfg, len(tokens))
                    voice = None
                    if cfg.voice_embedding is not None:
                        with tracing.span("wait"):
                            voice = torch.as_tensor(np.asarray(cfg.voice_embedding, np.float32)).to(
                                self.device, self.dtype
                            )
                        if voice.ndim != 3 or voice.shape[0] != 1 or voice.shape[2] != d_model:
                            raise ValueError(f"voice embedding shape {tuple(voice.shape)}, want [1, T, {d_model}]")
                    voice_len = 0 if voice is None else voice.shape[1]
                    prompt_len = voice_len + len(tokens)
                    bucket = bk.pick_bucket(prompt_len, bk.PROMPT_BUCKETS)
                    if bucket + self.max_frames > self.capacity:
                        raise ValueError(
                            f"prompt ({prompt_len} tokens) exceeds batcher capacity "
                            f"{self.capacity - self.max_frames}; raise prompt_capacity"
                        )
                    emb = self._embed(tokens, bucket - voice_len)
                    if voice is not None:
                        emb = torch.cat([voice, emb], dim=1)
                    prepped.append((slot, req, emb, prompt_len, bucket, max_steps))
                except Exception as exc:  # noqa: BLE001
                    _fail_request(req, exc)
        if not prepped:
            return

        try:
            with tracing.span("enqueue"):
                # Every lane pads to the largest bucket present; the burst pads
                # to 1 or the full slot count by repeating its first entry.
                bucket = max(p[4] for p in prepped)
                padded = prepped + [prepped[0]] * (self._pad_count(len(prepped)) - len(prepped))
                embs = torch.cat(
                    [torch.nn.functional.pad(p[2], (0, 0, 0, bucket - p[2].shape[1])) for p in padded]
                )
                values = _lane_values(
                    [p[0] for p in padded],
                    [p[3] for p in padded],
                    [p[5] for p in padded],
                    [p[1].cfg.eos_threshold for p in padded],
                    [p[1].cfg.frames_after_eos for p in padded],
                    [math.sqrt(max(float(p[1].cfg.temperature), 0.0)) for p in padded],
                )
                self._admission(embs, values)
        except Exception as exc:  # noqa: BLE001
            for _slot, req, *_ in prepped:
                _fail_request(req, exc)
            return
        for slot, req, *_ in prepped:
            self._attach_request(slot, req)

    def _prefill_into_slot(self, slot: int, req: _Request) -> None:
        """Hydrate one lane from a voice model state or a session's
        snapshot, prefill the chunk's text after it and splice it in."""
        cfg = req.cfg
        if cfg.voice_embedding is not None:
            # A session's chunks arrive stripped (_strip_voice_if_carried).
            raise ValueError("voice embedding and model-state/session conditioning are mutually exclusive")
        tokens = self._tokens(req)
        max_steps = self._max_steps(cfg, len(tokens))
        prompt_len = len(tokens)
        bucket = bk.pick_bucket(prompt_len, bk.PROMPT_BUCKETS)
        if cfg.voice_model_state is not None:
            first = next(iter(cfg.voice_model_state.modules.values()))
            voice_frames = int(np.asarray(first["offset"]).reshape(-1)[0])
        else:
            voice_frames = int(req.cont.offset_host)  # read by _validate_cont
        # Bound by this chunk's own step budget, not the engine's max_frames:
        # the lane writes K/V at offset .. offset + bucket + max_steps.
        if voice_frames + bucket + max_steps > self.capacity:
            raise ValueError(
                f"prompt ({voice_frames} voice + {prompt_len} text tokens) + {max_steps} steps "
                f"exceeds batcher KV capacity {self.capacity}; raise prompt_capacity"
            )
        if cfg.voice_model_state is not None:
            with tracing.span("wait"):  # the state's host arrays, copied from pageable memory
                lane = ftr.kv_cache_from_voice_state(
                    self.model.config.flow_lm.transformer, cfg.voice_model_state.modules, self.capacity, self.dtype,
                    self.device,
                )
        else:
            # The continuation is copied (into the static lane, or by .to()
            # below): the prefill writes the lane in place, and a
            # continuation may be submitted again.
            lane = {"k": req.cont.k, "v": req.cont.v, "offset": req.cont.offset.reshape(())}
        values = _lane_values(
            [slot],
            [voice_frames + prompt_len],
            [max_steps],
            [cfg.eos_threshold],
            [cfg.frames_after_eos],
            [math.sqrt(max(float(cfg.temperature), 0.0))],
        )
        self._slot_prefill(lane, self._embed(tokens, bucket), prompt_len, values)
        self._attach_request(slot, req)

    def _attach_request(self, slot: int, req: _Request) -> None:
        info = self._slot_info[slot]
        info.epoch += 1
        info.request = req
        info.emitted_frames = 0
        info.streaming = req.stream is not None
        info.stream_parts = None
        if info.streaming:
            self._new_stream_state()
            self._pending_stream_resets.append(slot)
            info.stream_parts = []

    def _new_stream_state(self) -> None:
        """The batched stream decoder's state, one lane per slot, made on
        first use (by the engine, or by ``prewarm``'s captures)."""
        with exclusive():
            if self._stream_state is None:
                mimi_cfg = self.model.config.mimi
                self._stream_state = mimi_stream.init_stream_state(
                    self.model.params["mimi"],
                    mimi_cfg,
                    batch=self.slots,
                    max_steps=self.max_frames * mimi_cfg.steps_per_latent,
                    dtype=self.dtype,
                    per_lane_offsets=True,
                )

    def _any_streaming(self) -> bool:
        return any(s.request is not None and s.streaming for s in self._slot_info)

    def _emit_streams(self, pcm_np: np.ndarray, n_new: np.ndarray, epochs) -> None:
        """Hand one decoded block (on the host) to the streaming slots'
        consumers; ``epochs`` gates recycled slots."""
        samples_per = self.model.config.mimi.samples_per_latent
        for slot, info in enumerate(self._slot_info):
            n = int(n_new[slot])
            if info.request is None or not info.streaming or n <= 0 or info.epoch != epochs[slot]:
                continue
            block = pcm_np[slot, 0, : n * samples_per].astype(np.float32) / 32767.0
            info.emitted_frames += n
            info.stream_parts.append(block)
            info.request.stream.put(block)

    def _snapshot_graph(self):
        cache = self._state["cache"]

        def make():
            return (lambda inputs: _snapshot_lane(inputs["cache"], inputs["slot"])), {
                "cache": cache,
                "slot": torch.zeros((1,), dtype=torch.long, device=self.device),
            }

        return self._graphs.get(("snapshot", self.dtype, self.kv_quantize), make)

    @_program
    def _snapshot(self, slot: int) -> BatchContinuation:
        """A copy of lane ``slot``'s KV cache and offset, as the one graph of
        every slot (its outputs are static: copied out at once)."""
        at = torch.tensor([slot], dtype=torch.long)
        if self._graphs is None:
            with tracing.span("wait"):
                at = at.to(self.device)
            k, v, offset = _snapshot_lane(self._state["cache"], at)
            return BatchContinuation(k=k, v=v, offset=offset, capacity=self.capacity)
        graph = self._snapshot_graph()
        feed(graph.inputs, slot=at)
        k, v, offset = (t.clone() for t in graph.run())
        return BatchContinuation(k=k, v=v, offset=offset, capacity=self.capacity)

    def _harvest(self, done, active, n_frames, epochs) -> None:
        to_decode = []  # (slot, n) of finished plain requests
        for slot, info in enumerate(self._slot_info):
            if info.request is None or not (active[slot] and done[slot]):
                continue
            if info.epoch != epochs[slot]:
                continue  # stale block: its flags describe the previous occupant
            if info.streaming:
                # Every block was emitted already.
                req = info.request
                audio = np.concatenate(info.stream_parts) if info.stream_parts else np.zeros(0, np.float32)
                if req.keep_state:
                    # Before the end of the stream: stream_session's
                    # next_state() is read once the generator has ended.
                    req.state_out = self._snapshot(slot)
                req.stream.put(None)
                _try_resolve(req.future, result=audio)
                self._release_slots([slot])
            else:
                to_decode.append((slot, int(n_frames[slot])))
        if not to_decode:
            return
        # All finished lanes decode together (count padded like admission);
        # the drainer thread waits for the PCM, so the engine goes on.
        bucket = min(bk.pick_bucket(max(n for _s, n in to_decode), bk.DECODE_BUCKETS), self._state["frames"].shape[1])
        slot_ids = [s for s, _n in to_decode]
        slot_ids += [slot_ids[0]] * (self._pad_count(len(slot_ids)) - len(slot_ids))
        # Padding lanes are dropped before the copy to the host.
        pcm = HostCopy(self._harvest_decode(torch.as_tensor(slot_ids, dtype=torch.long), bucket)[: len(to_decode)])
        for slot, _n in to_decode:
            req = self._slot_info[slot].request
            if req.keep_state:
                # Before the slot is freed, and before the drainer resolves
                # the future.
                req.state_out = self._snapshot(slot)
        items = [(self._slot_info[s].request, n) for s, n in to_decode]
        self._release_slots([s for s, _n in to_decode])
        self._harvest_pool.submit(self._drain_harvest, pcm, items)

    def _drain_harvest(self, pcm, items) -> None:
        """Drainer thread: wait for the int16 PCM and resolve each lane's
        future (with the exception if the copy failed: never strand)."""
        try:
            samples_per = self.model.config.mimi.samples_per_latent
            pcm_np = pcm.numpy()
            for i, (req, n) in enumerate(items):
                audio = pcm_np[i, 0, : n * samples_per].astype(np.float32) / 32767.0
                _try_resolve(req.future, result=audio)
        except Exception as exc:  # noqa: BLE001
            for req, _n in items:
                _try_resolve(req.future, exc=exc)

    def _release_slots(self, slots_: List[int]) -> None:
        """Free the slots: one in-place update of the device's active flags."""
        for slot in slots_:
            info = self._slot_info[slot]
            info.epoch += 1
            info.request = None
            info.streaming = False
            info.stream_parts = None
        with tracing.span("wait"):  # a copy from pageable memory: waits for the stream
            idx = torch.as_tensor(slots_, dtype=torch.long).to(self.device)
        self._state["active"][idx] = False

    # -- the engine's programs: graphs, or eager on a replica across cards --

    @_program
    def _ar_block(self, k: int):
        """One AR block of ``k`` steps → ``(windows, n_new, flags)``
        (:func:`_ar_block_steps`), as the graph of its block size, which
        draws its noise from the engine's generator into its static buffer
        and writes every new state leaf back into ``self._state``: the state
        keeps its addresses, and admissions write into it between blocks.
        The outputs are static: copied or consumed before the next block."""
        params, cfg = self.model.params["flow_lm"], self.model.config.flow_lm
        time_cond, fused_ada = self._time_cond, self._fused_ada
        if self._graphs is None:
            self._state, windows, n_new, flags = _batched_ar_multi_step(
                params, cfg, self._state, k, 1, self._gen, time_cond, fused_ada
            )
            return windows, n_new, flags

        def make():
            frame = self._state["frame"]
            noise = torch.empty((k, frame.shape[0], frame.shape[2]), dtype=torch.float32, device=self.device)

            def body(inputs):
                new, windows, n_new, flags = _ar_block_steps(
                    params, cfg, inputs["state"], inputs["noise"], 1, time_cond, fused_ada
                )
                write_back(inputs["state"], new)
                return windows, n_new, flags

            return body, {"state": self._state, "noise": noise}

        graph = self._graphs.get(("block", self.slots, self.capacity, self.dtype, self.kv_quantize, k), make)
        graph.inputs["noise"].normal_(generator=self._gen)
        return graph.run()

    @_program
    def _stream_decode(self, windows: torch.Tensor, n_new: torch.Tensor, streaming: List[bool]) -> torch.Tensor:
        """:func:`_batched_stream_decode` of a block's frames for the
        streaming lanes, as the graph of its block size over the engine's
        stream state (updated in place) → int16 PCM (static)."""
        mask = torch.as_tensor(streaming)
        if self._graphs is None:
            pcm16, self._stream_state = _batched_stream_decode(
                self.model, self._stream_state, windows, n_new, mask.to(self.device, non_blocking=True)
            )
            return pcm16

        model = self.model

        def make():
            def body(inputs):
                pcm16, new = _batched_stream_decode(
                    model, inputs["state"], inputs["windows"], inputs["n_new"], inputs["mask"]
                )
                write_back(inputs["state"], new)
                return pcm16

            # The block graph's outputs are static: read in place.
            inputs = {"state": self._stream_state, "windows": windows, "n_new": n_new}
            return body, {**inputs, "mask": torch.empty(mask.shape, dtype=torch.bool, device=self.device)}

        graph = self._graphs.get(("stream", self.slots, self.dtype, windows.shape[1]), make)
        feed(graph.inputs, windows=windows, n_new=n_new, mask=mask)
        return graph.run()

    @_program
    def _harvest_decode(self, slot_ids: torch.Tensor, bucket: int) -> torch.Tensor:
        """:func:`_harvest_decode_pcm16` of the lanes ``slot_ids`` (a host
        tensor, padded to 1 or every slot) at ``bucket`` frames, as the graph
        of (lane count, bucket) with the ids in a static buffer → int16 PCM
        (static)."""
        if self._graphs is None:
            with tracing.span("wait"):
                slot_ids = slot_ids.to(self.device)
            return _harvest_decode_pcm16(self.model, self._state["frames"], slot_ids, self._state["n_frames"], bucket)

        model = self.model

        def make():
            def body(inputs):
                return _harvest_decode_pcm16(model, inputs["frames"], inputs["slots"], inputs["n_frames"], bucket)

            inputs = {"frames": self._state["frames"], "n_frames": self._state["n_frames"]}
            return body, {**inputs, "slots": torch.empty(slot_ids.shape, dtype=torch.long, device=self.device)}

        graph = self._graphs.get(("harvest", self.dtype, len(slot_ids), bucket), make)
        feed(graph.inputs, slots=slot_ids)
        return graph.run()

    def _admission_graph(self, n: int, bucket: int):
        flow, tcfg = self.model.params["flow_lm"], self.model.config.flow_lm.transformer
        capacity, d_model = self.capacity, flow["conditioner_embed"].shape[1]

        def make():
            def body(inputs):
                _insert_lanes(inputs["state"], inputs["values"], _prefill_lanes(flow, tcfg, inputs["embs"], capacity))

            return body, {
                "state": self._state,
                "embs": torch.zeros((n, bucket, d_model), dtype=self.dtype, device=self.device),
                "values": torch.zeros((6, n), dtype=torch.int32, device=self.device),
            }

        return self._graphs.get(("admit", n, bucket, capacity, self.dtype, self.kv_quantize), make)

    @_program
    def _admission(self, embs: torch.Tensor, values: torch.Tensor) -> None:
        """Prefill the burst ``embs [N, bucket, D]`` and splice its lanes
        into the state (``values``: :func:`_lane_values`), as the graph of
        (N, bucket, capacity, dtype, kv_quantize): the reference's
        ``_prefill_lanes`` then ``_insert_lanes``."""
        if self._graphs is None:
            lanes = _prefill_lanes(self.model.params["flow_lm"], self.model.config.flow_lm.transformer, embs,
                                   self.capacity)
            _insert_lanes(self._state, values.to(self.device, non_blocking=True), lanes)
            return
        graph = self._admission_graph(*embs.shape[:2])
        feed(graph.inputs, embs=embs, values=values)
        graph.run()

    def _slot_graph(self, bucket: int):
        flow, flow_cfg = self.model.params["flow_lm"], self.model.config.flow_lm
        if self._lane is None:
            tcfg = flow_cfg.transformer
            if self._rank_devices is not None:
                self._lane = ftr.init_kv_cache_tp(tcfg, 1, self.capacity, self.dtype, self._rank_devices)
            else:
                self._lane = ftr.init_kv_cache(tcfg, 1, self.capacity, self.dtype, self.device)
        d_model = flow["conditioner_embed"].shape[1]

        def make():
            def body(inputs):
                prefilled = flm.prompt(flow, flow_cfg, inputs["lane"], inputs["emb"], inputs["valid"])
                _insert_lanes(inputs["state"], inputs["values"], prefilled)

            return body, {
                "state": self._state,
                "lane": self._lane,
                "emb": torch.zeros((1, bucket, d_model), dtype=self.dtype, device=self.device),
                "valid": torch.zeros((), dtype=torch.int32, device=self.device),
                "values": torch.zeros((6, 1), dtype=torch.int32, device=self.device),
            }

        return self._graphs.get(("slot", bucket, self.capacity, self.dtype, self.kv_quantize), make)

    @_program
    def _slot_prefill(self, lane: State, emb: torch.Tensor, prompt_len: int, values: torch.Tensor) -> None:
        """Prefill ``emb [1, bucket, D]`` after the hydrated ``lane`` (a
        whole cache ``{k, v, offset}``, not written) and splice it into its
        slot, as the graph of (bucket, capacity, dtype, kv_quantize) over
        the engine's static lane (zero-made in the transformer's layout,
        per rank under tensor parallelism), into which ``lane`` is copied:
        the reference's ``_prefill`` then ``_insert_lane``."""
        flow, flow_cfg = self.model.params["flow_lm"], self.model.config.flow_lm
        if self._graphs is None:
            own = {
                "k": lane["k"].to(self.device, self.dtype, copy=True),
                "v": lane["v"].to(self.device, self.dtype, copy=True),
                "offset": lane["offset"].to(self.device, copy=True),
            }
            if self._rank_devices is not None:
                own = ftr.shard_cache_heads(own, self._rank_devices)
            own = flm.prompt(flow, flow_cfg, own, emb, prompt_len)
            _insert_lanes(self._state, values.to(self.device, non_blocking=True), own)
            return
        graph = self._slot_graph(emb.shape[1])
        parts = _kv_parts(self._lane)
        for name in ("k", "v"):
            for part, heads in zip(parts, lane[name].chunk(len(parts), dim=2)):
                part[name].copy_(heads, non_blocking=True)
        self._lane["offset"].copy_(lane["offset"], non_blocking=True)
        feed(graph.inputs, emb=emb, values=values)
        graph.inputs["valid"].fill_(prompt_len)
        graph.run()

    def _reset_graph(self, n: int):
        state = self._stream_state

        def make():
            return (lambda inputs: mimi_stream.reset_lanes(inputs["state"], inputs["slots"])), {
                "state": state,
                "slots": torch.zeros((n,), dtype=torch.long, device=self.device),
            }

        return self._graphs.get(("reset", self.slots, self.dtype, n), make)

    @_program
    def _reset_streams(self, slots_: List[int]) -> None:
        """Zero the stream decoder's lanes ``slots_`` in place, padded to 1
        or every slot by repeating the first (zeroing is idempotent), as the
        graph of that lane count: ``mimi_stream.reset_lanes``."""
        ids = torch.tensor(slots_ + slots_[:1] * (self._pad_count(len(slots_)) - len(slots_)), dtype=torch.long)
        if self._graphs is None:
            self._stream_state = mimi_stream.reset_lanes(self._stream_state, ids.to(self.device, non_blocking=True))
            return
        graph = self._reset_graph(len(ids))
        feed(graph.inputs, slots=ids)
        graph.run()

    @_program
    def _capture_admissions(self) -> None:
        """Capture, without running them, the admission graphs of every
        prompt bucket that fits the engine's capacity at both lane counts,
        the slot prefill's of every bucket, the snapshot's and the stream
        resets': a first burst of a new prompt bucket then pays no capture
        (a no-op without graphs; on the CPU it only makes the graphs)."""
        if self._graphs is None:
            return
        self._new_stream_state()
        graphs = [self._snapshot_graph()] + [self._reset_graph(n) for n in sorted({1, self.slots})]
        for bucket in bk.PROMPT_BUCKETS:
            if bucket + self.max_frames > self.capacity:
                break
            graphs += [self._admission_graph(n, bucket) for n in sorted({1, self.slots})]
            graphs.append(self._slot_graph(bucket))
        for graph in graphs:
            graph.capture()

    def _loop(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.no_grad(), _full_f32(self.dtype == torch.float32), kernels_scope(self.kernels):
                self._loop_inner()
        except Exception as exc:  # noqa: BLE001
            # A crashed engine must not leave callers waiting on futures.
            log.exception("batcher engine crashed: %s", exc)
            self._crashed = self._owner._crashed = exc
            self._fail_all(exc)

    def _fail_slots(self, exc: Exception) -> None:
        # Harvested waves belong to the drainer, which resolves them itself.
        # A stream consumer gets the exception itself, never a clean end.
        for info in self._slot_info:
            if info.request is not None:
                _fail_request(info.request, exc)
                info.request = None

    def _fail_queue(self, exc: Exception) -> None:
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            _fail_request(req, exc)

    def _fail_all(self, exc: Exception) -> None:
        self._fail_slots(exc)
        self._fail_queue(exc)

    def _reap_cancelled(self) -> None:
        """Free the lanes whose stream consumer went away. A block already
        enqueued runs the lane once more, for nobody; the future resolves
        with the audio streamed so far."""
        for slot, info in enumerate(self._slot_info):
            req = info.request
            if req is None or not req.cancelled.is_set():
                continue
            if req.stream is not None:
                req.stream.put(None)
            parts = info.stream_parts or []
            _try_resolve(req.future, result=np.concatenate(parts) if parts else np.zeros(0, np.float32))
            self._release_slots([slot])

    def _resolve_block(self, blk) -> None:
        """Read a block's outputs (their copies were enqueued with it, one
        iteration ago, so the wait overlaps the next block): emit the
        streamed PCM, then harvest the lanes it finished."""
        with tracing.span("wait", engine=self._index):
            flags = blk["flags"].numpy()
            if blk["pcm"] is not None:
                pcm, n_new = blk["pcm"].numpy(), blk["n_new"].numpy()
        if blk["pcm"] is not None:
            with tracing.span("emit", engine=self._index):
                self._emit_streams(pcm, n_new, blk["epochs"])
        with tracing.span("harvest", engine=self._index):
            self._harvest(flags[0].astype(bool), flags[1].astype(bool), flags[2], blk["epochs"])

    def _loop_inner(self) -> None:
        k_lo = self.steps_per_sync
        k_hi = self.steps_per_sync_burst or k_lo
        pending = None  # the previous block's outputs, not read yet
        # The loop's spans (reap, idle, block, admit, wait, emit, harvest)
        # follow one another on this thread without overlapping.
        while not self._stop.is_set():
            with tracing.span("reap", engine=self._index):
                self._reap_cancelled()
            if all(s.request is None for s in self._slot_info):
                # Nothing attached: a pending block has no reader. Admit
                # synchronously, or wait for a request.
                pending = None
                self._admit()
                if all(s.request is None for s in self._slot_info):
                    # Wait without taking from the queue: the request that
                    # wakes the engine keeps its place in the burst.
                    with tracing.span("idle", engine=self._index), self._arrival:
                        if self._queue.empty():
                            self._arrival.wait(timeout=0.05)
                    continue
            # Streaming consumers need steps_per_sync cadence; plain traffic
            # takes the burst block. Slots change only in _admit and harvest
            # (this thread), so the stream decode below sees the same set.
            streaming = [s.request is not None and s.streaming for s in self._slot_info]
            k = k_lo if any(streaming) else k_hi
            self._last_block_k = k
            with tracing.span("block", engine=self._index) as sp:
                windows, n_new, flags = self._ar_block(k)
                pcm = n_new_host = None
                if any(streaming):
                    pcm, n_new_host = HostCopy(self._stream_decode(windows, n_new, streaming)), HostCopy(n_new)
                flags = HostCopy(flags)
            if sp is not None:
                sp.set(k=k, attached=sum(s.request is not None for s in self._slot_info))
            # Admission after the block is enqueued: the host prepares it
            # while the device runs the block, and admitted lanes join from
            # the next block on.
            self._admit()
            prev, pending = pending, {
                "flags": flags,
                "pcm": pcm,
                "n_new": n_new_host,
                "epochs": [s.epoch for s in self._slot_info],
            }
            if prev is not None:
                self._resolve_block(prev)
        if pending is not None:  # so stop() strands no consumer
            self._resolve_block(pending)


class ContinuousBatcher(_Engine):
    """Slot-based continuous batching over one model, on one device or over
    a dp/tp mesh.

    ``submit`` is thread-safe and returns a Future resolving to float32 PCM
    at 24 kHz; ``submit_stream`` yields PCM blocks of ``steps_per_sync``
    frames as they are generated; ``generate_session`` and
    ``stream_session`` carry a lane's KV cache from one chunk into the next.
    A request's config may carry a voice embedding or a voice model state.
    ``device`` defaults to ``"cuda"`` and raises on a host without CUDA;
    ``device="cpu"`` runs the kernels' plain versions there.
    ``quantize=True`` (or 8) runs every linear with int8 weights,
    ``quantize=4`` with packed group-wise int4 weights (a model loaded from a
    pre-quantized checkpoint runs quantized as it is); ``kv_quantize`` keeps
    the KV cache in int8 with per-row scales. ``mesh`` (``parallel.mesh``;
    ``slots`` must split over its ``dp``) serves through one engine replica
    per dp row, sharded over its tp ranks, and ``device`` is then unused;
    ``pallas=False`` runs the kernels' plain versions on the card.
    """

    def __init__(
        self,
        model: PocketTTSModel,
        slots: int = 4,
        prompt_capacity: int = 128,
        max_frames: int = 256,
        dtype: torch.dtype = torch.float32,
        seed: Optional[int] = None,
        steps_per_sync: int = 8,
        steps_per_sync_burst: int = 0,
        quantize: Union[bool, int] = False,
        kv_quantize: bool = False,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
        mesh: Optional[Mesh] = None,
        pallas: Optional[bool] = None,
    ) -> None:
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"ContinuousBatcher: dtype {dtype} not supported (float32 or bfloat16)")
        if flm.is_hybrid(model.config.flow_lm):
            raise hybrid_backbone.unsupported("the continuous batcher" if mesh is None else "a dp/tp mesh")
        if mesh is not None and slots % mesh.dp:
            raise ValueError(f"ContinuousBatcher: {slots} slots do not split over dp={mesh.dp}")
        self.dtype = dtype
        self.mesh = mesh
        self.slots = slots
        self.steps_per_sync = max(steps_per_sync, 1)
        # Burst blocks: while no streaming lane is attached every block runs
        # ``steps_per_sync_burst`` steps, rounded up to a multiple of
        # ``steps_per_sync``; a streaming lane drops the next block back to
        # ``steps_per_sync`` (a stream admitted mid-burst waits out at most
        # one burst block). 0 (or a value not above it) keeps blocks at
        # ``steps_per_sync``.
        burst = int(steps_per_sync_burst or 0)
        if burst > self.steps_per_sync:
            self.steps_per_sync_burst = bk.round_up(burst, self.steps_per_sync)
        else:
            if burst > 0:
                log.warning(
                    "steps_per_sync_burst=%d <= steps_per_sync=%d has no effect; "
                    "running every block at the base size",
                    burst,
                    self.steps_per_sync,
                )
            self.steps_per_sync_burst = 0
        k_max = self.steps_per_sync_burst or self.steps_per_sync
        # Aligned to the largest block, so a lane's last window fits.
        self.max_frames = bk.round_up(max_frames, k_max)
        self.capacity = prompt_capacity + self.max_frames
        self.kv_quantize = kv_quantize
        self.kernels = resolve_pallas(pallas)
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        # Notified on every submission: an idle engine waits on it.
        self._arrival = threading.Condition()
        self._crashed: Optional[Exception] = None

        device = resolve_device(device) if mesh is None else mesh.devices[0][0]
        with torch.no_grad():
            model = kernel_model(quantized_model(model, quantize), self.kernels)
            if (model.device, model.dtype) != (device, dtype):
                model = model.to(device, dtype)
            state = make_batched_state(
                model.config.flow_lm,
                slots,
                self.capacity,
                self.max_frames,
                k_max,  # the frames slack covers the largest block
                dtype,
                kv_quantize=kv_quantize,
                device=device,
            )
            if mesh is None:
                self._replicas: Optional[List[_Engine]] = None
                self._init_engine(self, model, slots, device, seed, state)
                return
            if mesh.tp > 1:
                rows = shard_params_tp(model.params, mesh, model.config.flow_lm.transformer.num_heads)
                states = shard_state_tp(state, mesh)
            else:
                rows = replicate_params(model.params, mesh)
                states = shard_state(state, mesh)
        self.device = device
        self.model = PocketTTSModel(rows[0], model.config)
        self._replicas = []
        for i, (params, part) in enumerate(zip(rows, states)):
            replica = _Engine()
            replica._init_engine(
                self,
                PocketTTSModel(params, model.config),
                slots // mesh.dp,
                mesh.devices[i][0],
                None if seed is None else seed + i,
                part,
                index=i,
            )
            self._replicas.append(replica)

    def _engines(self) -> List[_Engine]:
        return self._replicas or [self]

    def graph_stats(self) -> List[Dict]:
        """Per engine (one, or one per dp replica): its device, its graphs,
        captures, capture seconds and pool bytes, or why it runs eagerly."""
        out = []
        for engine in self._engines():
            cache = engine._graphs
            out.append({
                "device": str(engine.device),
                "graphs": None if cache is None else len(cache),
                "captures": 0 if cache is None else cache.captures,
                "capture_seconds": 0.0 if cache is None else cache.capture_seconds,
                "pool_bytes": 0 if cache is None or engine.device.type != "cuda" else cache.pool_bytes(),
                "eager_reason": engine.eager_reason,
            })
        return out

    # -- public API --------------------------------------------------------

    def _enqueue(self, req: _Request) -> None:
        req.enqueued = tracing.now()
        self._queue.put(req)
        with self._arrival:
            self._arrival.notify_all()
        if self._crashed is not None:
            # Lost the race with a crashing engine: fail what it left queued.
            self._fail_queue(self._crashed)

    def submit(self, tokens, cfg: GenerateConfig) -> "Future[np.ndarray]":
        fut: Future = Future()
        if self._crashed is not None:
            fut.set_exception(self._crashed)
            return fut
        self._enqueue(_Request(list(tokens), cfg, fut))
        return fut

    def submit_stream(
        self,
        tokens,
        cfg: GenerateConfig,
        timeout: float = 300.0,
        cont: Optional[BatchContinuation] = None,
        keep_state: bool = False,
        _req_out: Optional[list] = None,
    ):
        """Stream PCM blocks (float32, ``steps_per_sync`` frames each, the
        last one shorter) as they are generated, through the shared batch.
        ``cont``/``keep_state`` carry a session as :meth:`generate_session`
        does (:meth:`stream_session` uses them).

        A failed engine or admission raises in the consumer, never ends the
        stream short; a stream that produces nothing for ``timeout``
        seconds raises ``TimeoutError``. Closing the generator early frees
        the lane at the next block."""
        if self._crashed is not None:
            raise self._crashed
        q: "queue.Queue" = queue.Queue()
        req = _Request(list(tokens), cfg, Future(), stream=q, cont=cont, keep_state=keep_state)
        if _req_out is not None:
            _req_out.append(req)
        self._enqueue(req)

        def gen():
            try:
                while True:
                    try:
                        item = q.get(timeout=timeout)
                    except queue.Empty:
                        raise TimeoutError(f"batcher stream produced no PCM block within {timeout}s") from None
                    if item is None:
                        return
                    if isinstance(item, BaseException):
                        raise item
                    yield item
            finally:
                # On exhaustion (already harvested: a no-op) and on an early
                # close of the generator: tell the engine to free the lane.
                req.cancelled.set()

        return gen()

    def generate(self, tokens, cfg: GenerateConfig, timeout: float = 120.0) -> np.ndarray:
        return self.submit(tokens, cfg).result(timeout=timeout)

    def generate_session(
        self,
        tokens,
        cfg: GenerateConfig,
        cont: Optional[BatchContinuation] = None,
        timeout: float = 120.0,
    ):
        """Synthesize one chunk through the batch, carrying the KV cache
        across calls (the counterpart of ``GPURuntime.generate_audio_session``):
        the chunk's lane is hydrated from ``cont``, generates with attention
        over the session so far, and is snapshotted before it is freed.
        Returns ``(audio, next BatchContinuation)``. Other requests go on
        sharing the batch.

        A chunk that cannot fit in the engine's KV capacity after ``cont``
        starts a fresh session; size ``prompt_capacity`` for the session
        length to carry."""
        cont = self._validate_cont(tokens, cfg, cont)
        cfg = _strip_voice_if_carried(cfg, cont)
        if self._crashed is not None:
            raise self._crashed
        req = _Request(list(tokens), cfg, Future(), cont=cont, keep_state=True)
        self._enqueue(req)
        audio = req.future.result(timeout=timeout)
        return audio, req.state_out

    def _validate_cont(self, tokens, cfg: GenerateConfig, cont: Optional[BatchContinuation]) -> Optional[BatchContinuation]:
        """``cont``, or None (a fresh session) when the next chunk cannot
        fit after it: the bound the slot prefill enforces. Reads the host
        offset on the caller's thread."""
        if cont is None:
            return None
        if cont.offset_host is None:
            cont.offset_host = int(cont.offset.reshape(-1)[0])
        bucket = bk.pick_bucket(len(tokens), bk.PROMPT_BUCKETS)
        max_steps = min(cfg.max_steps or cfg.estimated_max_steps or estimate_max_frames(len(tokens)), self.max_frames)
        if cont.capacity != self.capacity or cont.offset_host + bucket + max_steps > self.capacity:
            return None
        return cont

    def stream_session(
        self,
        tokens,
        cfg: GenerateConfig,
        cont: Optional[BatchContinuation] = None,
        timeout: float = 300.0,
    ):
        """Frame streaming with continuity: ``(blocks, next_state)``. Drain
        ``blocks``, then ``next_state()`` gives the chunk's snapshot (None if
        the stream was closed before it finished)."""
        cont = self._validate_cont(tokens, cfg, cont)
        cfg = _strip_voice_if_carried(cfg, cont)
        box: list = []
        blocks = self.submit_stream(tokens, cfg, timeout=timeout, cont=cont, keep_state=True, _req_out=box)
        return blocks, lambda: box[0].state_out if box else None

    def prewarm(self, token_lengths=(10, 30, 50), timeout: float = 600.0) -> None:
        """Run the engine's admission and streaming waves once before serving.

        First every engine captures, without running them, its admission
        graphs of every prompt bucket that fits its capacity at both lane
        counts, its slot prefill's of every bucket, its snapshot's and its
        stream resets': a burst's prompt bucket is its largest prompt's, so
        traffic alone would leave most of them to a first burst. Then a
        first wave pays for capturing the rest (the AR block of each block
        size, the stream decode, the harvest decode of each lane count and
        bucket it reaches), loading the kernel libraries, the caching
        allocator's first blocks: a full-slot admission at each token
        length, a single admission, a streamed single and a streamed
        full-slot wave. A later request of those buckets captures nothing. Sweeping the
        harvest-decode buckets as well (the reference's, against compile
        stalls) moved no first wave's latency on an H100
        (``scripts/torch_prewarm_ab.py``) and is not done."""
        for engine in self._engines():
            engine._capture_admissions()
        for n_tokens in token_lengths:
            cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=estimate_max_frames(n_tokens))
            for f in [self.submit([0] * n_tokens, cfg) for _ in range(self.slots)]:
                f.result(timeout=timeout)
            log.info("prewarmed batch bucket: %d tokens x %d slots", n_tokens, self.slots)
        short = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=self.steps_per_sync)
        tokens = [0] * token_lengths[0]
        self.generate(tokens, short, timeout=timeout)
        for _ in self.submit_stream(tokens, short, timeout=timeout):
            pass
        for blocks in [self.submit_stream(tokens, short, timeout=timeout) for _ in range(self.slots)]:
            for _ in blocks:
                pass
        log.info("prewarmed single admission and the stream decode")

    def start(self) -> None:
        for engine in self._engines():
            engine._start_engine()

    def stop(self) -> None:
        for engine in self._engines():
            engine._stop_engine()
        self._fail_queue(RuntimeError("batcher stopped with requests in flight"))


class BatcherRuntime:
    """Runtime adapter over :class:`ContinuousBatcher` with the single
    runtime's interface (``generate_audio``, ``generate_audio_session``,
    ``stream_generate``, ``stream_generate_session``, ``prewarm``,
    ``mimi_timing``); safe to call from many threads at once
    (``concurrent_safe``). The Service picks its routes by these names."""

    concurrent_safe = True

    def __init__(
        self,
        model: PocketTTSModel,
        slots: int = 4,
        dtype: torch.dtype = torch.float32,
        seed: Optional[int] = None,
        timeout: float = 300.0,
        quantize: Union[bool, int] = False,
        kv_quantize: bool = False,
        steps_per_sync: int = 8,
        steps_per_sync_burst: int = 0,
        prompt_capacity: int = 128,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
        mesh: Optional[Mesh] = None,
        pallas: Optional[bool] = None,
    ) -> None:
        self._model = model
        self._timeout = timeout
        self.batcher = ContinuousBatcher(
            model,
            slots=slots,
            prompt_capacity=prompt_capacity,
            dtype=dtype,
            seed=seed,
            quantize=quantize,
            kv_quantize=kv_quantize,
            steps_per_sync=steps_per_sync,
            steps_per_sync_burst=steps_per_sync_burst,
            device=device,
            mesh=mesh,
            pallas=pallas,
        )
        self.batcher.start()

    def mimi_timing(self):
        cfg = self._model.config.mimi
        return cfg.frame_rate, cfg.encoder_frame_rate, cfg.steps_per_latent

    def generate_audio(self, tokens, cfg: GenerateConfig) -> np.ndarray:
        return self.batcher.generate(tokens, cfg, timeout=self._timeout)

    def generate_audio_session(self, tokens, cfg: GenerateConfig, cont: Optional[BatchContinuation] = None):
        """Continuity through the batch: ``(audio, next state)``."""
        return self.batcher.generate_session(tokens, cfg, cont, timeout=self._timeout)

    def stream_generate(self, tokens, cfg: GenerateConfig):
        """Frame streaming through the shared batch: PCM blocks."""
        return self.batcher.submit_stream(tokens, cfg, timeout=self._timeout)

    def stream_generate_session(self, tokens, cfg: GenerateConfig, cont: Optional[BatchContinuation] = None):
        """Frame streaming with continuity: ``(blocks, next_state)``."""
        return self.batcher.stream_session(tokens, cfg, cont, timeout=self._timeout)

    def prewarm(self, token_lengths=(10, 30, 50)) -> None:
        self.batcher.prewarm(token_lengths)

    def close(self) -> None:
        self.batcher.stop()
