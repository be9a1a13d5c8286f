"""Continuous batching on the GPU: concurrent requests share one AR step
(counterpart of ``go_pocket_tts_tpu/parallel/batching.py``, its
non-streaming path).

A fixed set of request *slots* steps together:

- each slot is a lane of the batched KV cache with its **own offset**
  (``models.flow_transformer.transformer_step_batched``), so requests join
  and leave at any step (different prompt lengths and EOS times);
- admission is burst-batched: every queued request is prefilled in one
  batched forward and spliced into the batch state together, the count
  padded to 1 or the full slot count as the reference pads it;
- steps run in blocks of ``k`` (``steps_per_sync``, or
  ``steps_per_sync_burst``): the whole block is enqueued on the device with
  no host sync, and it ends with one packed flags copy (done, active,
  n_frames) on its way to the host;
- blocks pipeline one deep: block N's flags are read while block N+1 runs;
- the per-lane EOS countdown runs on the device, as in the single runtime;
- finished lanes are decoded together (int16 PCM) and freed; a drainer
  thread waits for the PCM and resolves the futures.

Unlike the reference, whose state arrays are donated to each program and
replaced, the KV cache, the frame buffer and the per-lane fields are
updated IN PLACE. All device work of the engine is issued from its thread
on one stream, so each in-place write is ordered after every read that was
enqueued before it. The LSD noise comes from a device ``torch.Generator``
the batcher owns, drawn per block on the device (JAX's threefry bits cannot
be reproduced, so the two packages agree at temperature 0 only).

Not ported yet (ROADMAP.md): streaming lanes (``submit_stream``),
sessions, ``prewarm``, dp/tp meshes, voice conditioning (a request whose
config carries a voice fails with a ``ValueError`` rather than being served
without it).
"""

from __future__ import annotations

import dataclasses
import logging
import math
import queue
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from go_pocket_tts_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from go_pocket_tts_tpu_torch.models import flow_lm as flm
from go_pocket_tts_tpu_torch.models import flow_transformer as ftr
from go_pocket_tts_tpu_torch.models.model import PocketTTSModel
from go_pocket_tts_tpu_torch.models.quantize import quantize_kv_rows
from go_pocket_tts_tpu_torch.runtime.generate import (
    GenerateConfig,
    HostCopy,
    _full_f32,
    decode_pcm16,
    quantized_model,
)
from go_pocket_tts_tpu_torch.text.prepare import estimate_max_frames
from go_pocket_tts_tpu_torch.utils import buckets as bk

log = logging.getLogger("pockettts.torch.batching")

__all__ = ["BatcherRuntime", "ContinuousBatcher", "make_batched_state"]

State = Dict


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


# -- the device side: state, AR block, admission, harvest decode -------------


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
    last, eos_logit = flm._hidden_and_eos(params, y)
    decoded = flm.fnet.lsd_decode(params["flow_net"], last, noise, decode_steps, time_cond, fused_ada)

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
    of the whole block is drawn on the device first, scaled per lane by
    ``sqrt(temperature)``. Returns ``(state, flags)``: ``flags`` is a fresh
    ``[3, B]`` int32 copy of done/active/n_frames."""
    frame = state["frame"]
    slots, latent = frame.shape[0], frame.shape[2]
    noise = torch.randn((k, slots, latent), generator=gen, device=frame.device, dtype=torch.float32)
    noise = (noise * state["sigma"][None, :, None]).to(frame.dtype)
    for step in range(k):
        state = _ar_step_body(params, cfg, state, noise[step], decode_steps, time_cond, fused_ada)
    flags = torch.stack([state["done"].int(), state["active"].int(), state["n_frames"]])
    return state, flags


def _set_cache_lanes(cache: State, idx: torch.Tensor, lanes_k: torch.Tensor, lanes_v: torch.Tensor, offsets: torch.Tensor) -> None:
    """Write prefilled float K/V lanes ``[L, N, H, C, Dh]`` into the stacked
    cache at lanes ``idx`` ``[N]``, in place, quantizing each row first when
    the cache is int8."""
    cache["offset"][idx] = offsets
    if "k_scale" in cache:
        for name, lane in (("k", lanes_k), ("v", lanes_v)):
            q, scale = quantize_kv_rows(lane)
            cache[name][:, idx] = q
            cache[f"{name}_scale"][:, idx] = scale
    else:
        cache["k"][:, idx] = lanes_k.to(cache["k"].dtype)
        cache["v"][:, idx] = lanes_v.to(cache["v"].dtype)


def _prefill_lanes(params, tcfg, embs: torch.Tensor, capacity: int):
    """Prefill ``N`` fresh lanes together: ``embs [N, bucket, D]``
    (zero-padded per lane) → K/V ``[L, N, H, capacity, Dh]``. Every lane
    starts at offset 0 with the same positions, so the uniform-offset
    forward applies; rows past a lane's prompt are never visible (its
    offset masks them, and its AR steps overwrite them)."""
    cache = ftr.init_kv_cache(tcfg, embs.shape[0], capacity, embs.dtype, embs.device)
    _, cache = ftr.transformer_forward_cached(params["transformer"], tcfg, cache, embs)
    return cache["k"], cache["v"]


def _insert_lanes(state: State, slots: List[int], lanes_k, lanes_v, offsets, max_steps, eos_thresholds, frames_after_eos, sigmas) -> None:
    """Splice N prefilled lanes into the batch state, in place (duplicate
    slots carry identical data)."""
    dev = state["frame"].device

    def lane_values(values, dtype):
        return torch.as_tensor(np.asarray(values), dtype=dtype).to(dev, non_blocking=True)

    idx = lane_values(slots, torch.long)
    _set_cache_lanes(state["cache"], idx, lanes_k, lanes_v, lane_values(offsets, torch.int32))
    state["frame"][idx] = float("nan")
    state["n_frames"][idx] = 0
    state["countdown"][idx] = -1
    state["done"][idx] = False
    state["active"][idx] = True
    state["max_steps"][idx] = lane_values(max_steps, torch.int32)
    state["eos_threshold"][idx] = lane_values(eos_thresholds, torch.float32)
    state["frames_after_eos"][idx] = lane_values(frames_after_eos, torch.int32)
    state["sigma"][idx] = lane_values(sigmas, torch.float32)


def _harvest_decode_pcm16(model: PocketTTSModel, frames: torch.Tensor, slots: torch.Tensor, n_frames: torch.Tensor, decode_frames: int) -> torch.Tensor:
    """Decode the finished lanes ``slots`` in one batch → int16 PCM
    ``[N, 1, decode_frames·1920]``; the host trims each to its n_frames."""
    return decode_pcm16(model, frames[slots], n_frames[slots], decode_frames)


# -- the host side: requests, slots, the engine loop -------------------------


@dataclasses.dataclass
class _Request:
    tokens: List[int]
    cfg: GenerateConfig
    future: Future


@dataclasses.dataclass
class _SlotInfo:
    request: Optional[_Request] = None
    # Bumped on every attach and release. A block is read one iteration
    # after it was enqueued; if its slot was harvested and re-admitted in
    # between, its flags describe the previous occupant. The epoch recorded
    # with the block keeps a recycled slot from acting on them.
    epoch: int = 0


class ContinuousBatcher:
    """Slot-based continuous batching over one model on one device.

    ``submit`` is thread-safe and returns a Future resolving to float32 PCM
    at 24 kHz. ``device`` defaults to ``"cuda"`` and raises on a host
    without CUDA; ``device="cpu"`` runs the kernels' plain versions there.
    ``quantize=True`` (or 8) runs every linear with int8 weights,
    ``quantize=4`` with packed group-wise int4 weights (a model loaded from a
    pre-quantized checkpoint runs quantized as it is); ``kv_quantize`` keeps
    the KV cache in int8 with per-row scales.
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
    ) -> None:
        self.device = resolve_device(device)
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"ContinuousBatcher: dtype {dtype} not supported (float32 or bfloat16)")
        self.dtype = dtype
        with torch.no_grad():
            model = quantized_model(model, quantize)
            if (model.device, model.dtype) != (self.device, dtype):
                model = model.to(self.device, dtype)
        self.model = model
        self.slots = slots
        self.steps_per_sync = max(steps_per_sync, 1)
        # Burst blocks: with no streaming lane (this port has none yet) every
        # block runs ``steps_per_sync_burst`` steps, rounded up to a multiple
        # of ``steps_per_sync``; 0 (or a value not above it) keeps blocks at
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
        self._last_block_k = 0  # block size of the last block enqueued
        self.max_frames = bk.round_up(max_frames, k_max)
        self.capacity = prompt_capacity + self.max_frames
        self.kv_quantize = kv_quantize

        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._slot_info = [_SlotInfo() for _ in range(slots)]
        self._harvest_pool: Optional[ThreadPoolExecutor] = self._new_pool()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._crashed: Optional[Exception] = None

        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(seed if seed is not None else time.time_ns() & 0x7FFFFFFF)
        flow = self.model.params["flow_lm"]
        with torch.no_grad():
            # Loop invariants of the AR step (the reference builds them inside
            # each block program).
            self._time_cond = flm.fnet.precompute_time_cond(flow["flow_net"], 1)
            self._fused_ada = flm.fnet.precompute_fused_adaln(flow["flow_net"])
            self._state = make_batched_state(
                self.model.config.flow_lm,
                slots,
                self.capacity,
                self.max_frames,
                k_max,  # the frames slack covers the largest block
                dtype,
                kv_quantize=kv_quantize,
                device=self.device,
            )

    @staticmethod
    def _new_pool() -> ThreadPoolExecutor:
        return ThreadPoolExecutor(max_workers=1, thread_name_prefix="pockettts-harvest")

    # -- public API --------------------------------------------------------

    def submit(self, tokens, cfg: GenerateConfig) -> "Future[np.ndarray]":
        fut: Future = Future()
        if cfg.voice_embedding is not None or cfg.voice_model_state is not None:
            fut.set_exception(
                ValueError(
                    "ContinuousBatcher: voice conditioning is not ported to the batcher yet "
                    "(it comes with the batcher's streaming lanes and sessions); "
                    "use GPURuntime for a voiced request"
                )
            )
            return fut
        if self._crashed is not None:
            fut.set_exception(self._crashed)
            return fut
        self._queue.put(_Request(list(tokens), cfg, fut))
        if self._crashed is not None:
            # Lost the race with a crashing engine: fail what it left queued.
            self._fail_all(self._crashed)
        return fut

    def generate(self, tokens, cfg: GenerateConfig, timeout: float = 120.0) -> np.ndarray:
        return self.submit(tokens, cfg).result(timeout=timeout)

    def start(self) -> None:
        self._stop.clear()
        if self._harvest_pool is None:  # restart after stop()
            self._harvest_pool = self._new_pool()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30)
        # Deliver every already-harvested wave before returning.
        if self._harvest_pool is not None:
            self._harvest_pool.shutdown(wait=True)
            self._harvest_pool = None
        # Never strand a caller: fail whatever is still attached or queued.
        if any(info.request is not None for info in self._slot_info) or not self._queue.empty():
            self._fail_all(RuntimeError("batcher stopped with requests in flight"))

    # -- engine ------------------------------------------------------------

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
            pending.append((free.pop(0), req))
        if pending:
            self._admit_batch(pending)

    def _admit_batch(self, items) -> None:
        """Prefill N requests in one batched forward and splice them in."""
        flow = self.model.params["flow_lm"]
        flow_cfg = self.model.config.flow_lm
        n_bins = flow["conditioner_embed"].shape[0]
        prepped = []
        for slot, req in items:
            try:
                cfg = req.cfg
                tokens = np.asarray(req.tokens, np.int64)
                if np.any(tokens < 0) or np.any(tokens >= n_bins):
                    raise ValueError(f"token id out of range [0,{n_bins})")
                max_steps = cfg.max_steps or cfg.estimated_max_steps or estimate_max_frames(len(tokens))
                max_steps = min(max_steps, self.max_frames)
                bucket = bk.pick_bucket(len(tokens), bk.PROMPT_BUCKETS)
                if bucket + self.max_frames > self.capacity:
                    raise ValueError(
                        f"prompt ({len(tokens)} tokens) exceeds batcher capacity "
                        f"{self.capacity - self.max_frames}; raise prompt_capacity"
                    )
                # Padded to the bucket on the host; the pad ids' K/V sit past
                # the lane's offset and are never attended.
                ids = np.zeros((1, bucket), np.int64)
                ids[0, : len(tokens)] = tokens
                emb = flm.text_embeddings(flow, torch.from_numpy(ids).to(self.device)).to(self.dtype)
                prepped.append((slot, req, emb, len(tokens), bucket, max_steps))
            except Exception as exc:  # noqa: BLE001
                _try_resolve(req.future, exc=exc)
        if not prepped:
            return

        try:
            # Every lane pads to the largest bucket present; the burst pads to
            # 1 or the full slot count by repeating its first entry.
            bucket = max(p[4] for p in prepped)
            padded = prepped + [prepped[0]] * (self._pad_count(len(prepped)) - len(prepped))
            embs = torch.cat(
                [torch.nn.functional.pad(p[2], (0, 0, 0, bucket - p[2].shape[1])) for p in padded]
            )
            lanes_k, lanes_v = _prefill_lanes(flow, flow_cfg.transformer, embs, self.capacity)
            _insert_lanes(
                self._state,
                [p[0] for p in padded],
                lanes_k,
                lanes_v,
                [p[3] for p in padded],
                [p[5] for p in padded],
                [p[1].cfg.eos_threshold for p in padded],
                [p[1].cfg.frames_after_eos for p in padded],
                [math.sqrt(max(float(p[1].cfg.temperature), 0.0)) for p in padded],
            )
        except Exception as exc:  # noqa: BLE001
            for _slot, req, *_ in prepped:
                _try_resolve(req.future, exc=exc)
            return
        for slot, req, *_ in prepped:
            info = self._slot_info[slot]
            info.epoch += 1
            info.request = req

    def _harvest(self, done, active, n_frames, epochs) -> None:
        to_decode = []  # (slot, n) of finished requests
        for slot in range(self.slots):
            info = self._slot_info[slot]
            if info.request is None or not (active[slot] and done[slot]):
                continue
            if info.epoch != epochs[slot]:
                continue  # stale block: its flags describe the previous occupant
            to_decode.append((slot, int(n_frames[slot])))
        if not to_decode:
            return
        # All finished lanes decode together (count padded like admission);
        # the drainer thread waits for the PCM, so the engine goes on.
        frames = self._state["frames"]
        bucket = min(bk.pick_bucket(max(n for _s, n in to_decode), bk.DECODE_BUCKETS), frames.shape[1])
        slot_ids = [s for s, _n in to_decode]
        slot_ids += [slot_ids[0]] * (self._pad_count(len(slot_ids)) - len(slot_ids))
        pcm = _harvest_decode_pcm16(
            self.model,
            frames,
            torch.as_tensor(slot_ids, dtype=torch.long).to(self.device),
            self._state["n_frames"],
            bucket,
        )
        # Padding lanes are dropped before the copy to the host.
        pcm = HostCopy(pcm[: len(to_decode)])
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
        idx = torch.as_tensor(slots_, dtype=torch.long).to(self.device)
        self._state["active"][idx] = False

    def _loop(self) -> None:
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            with torch.no_grad(), _full_f32(self.dtype == torch.float32):
                self._loop_inner()
        except Exception as exc:  # noqa: BLE001
            # A crashed engine must not leave callers waiting on futures.
            log.exception("batcher engine crashed: %s", exc)
            self._crashed = exc
            self._fail_all(exc)

    def _fail_all(self, exc: Exception) -> None:
        # Harvested waves belong to the drainer, which resolves them itself.
        for info in self._slot_info:
            if info.request is not None:
                _try_resolve(info.request.future, exc=exc)
                info.request = None
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                break
            _try_resolve(req.future, exc=exc)

    def _resolve_block(self, blk) -> None:
        """Read a block's flags (enqueued one iteration ago, so the wait
        overlaps the next block) and harvest the lanes it finished."""
        flags = blk["flags"].numpy()
        self._harvest(flags[0].astype(bool), flags[1].astype(bool), flags[2], blk["epochs"])

    def _loop_inner(self) -> None:
        params = self.model.params["flow_lm"]
        cfg = self.model.config.flow_lm
        k = self.steps_per_sync_burst or self.steps_per_sync
        pending = None  # the previous block's flags, not read yet
        while not self._stop.is_set():
            if all(s.request is None for s in self._slot_info):
                # Nothing attached: a pending block has no reader. Admit
                # synchronously, or wait for a request.
                pending = None
                self._admit()
                if all(s.request is None for s in self._slot_info):
                    try:
                        req = self._queue.get(timeout=0.05)
                        self._queue.put(req)
                    except queue.Empty:
                        pass
                    continue
            self._last_block_k = k
            self._state, flags = _batched_ar_multi_step(
                params, cfg, self._state, k, 1, self._gen, self._time_cond, self._fused_ada
            )
            flags = HostCopy(flags)
            # Admission after the block is enqueued: the host prepares it
            # while the device runs the block, and admitted lanes join from
            # the next block on.
            self._admit()
            prev, pending = pending, {"flags": flags, "epochs": [s.epoch for s in self._slot_info]}
            if prev is not None:
                self._resolve_block(prev)
        if pending is not None:  # so stop() strands no consumer
            self._resolve_block(pending)


class BatcherRuntime:
    """Runtime adapter over :class:`ContinuousBatcher` with the single
    runtime's interface (``generate_audio``, ``mimi_timing``); safe to call
    from many threads at once (``concurrent_safe``)."""

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
        )
        self.batcher.start()

    def mimi_timing(self):
        cfg = self._model.config.mimi
        return cfg.frame_rate, cfg.encoder_frame_rate, cfg.steps_per_latent

    def generate_audio(self, tokens, cfg: GenerateConfig) -> np.ndarray:
        return self.batcher.generate(tokens, cfg, timeout=self._timeout)

    def close(self) -> None:
        self.batcher.stop()
