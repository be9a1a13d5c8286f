"""The single-utterance generation path on the GPU (counterpart of
``go_pocket_tts_tpu/runtime/generate.py``: ``TPURuntime.generate_audio``).

Three stages, each on the device:

1. prefill — LUT text embedding → ``flow_lm.prompt`` (transformer, T > 1)
   into a static-capacity ``[L,B,H,C,Dh]`` KV cache (with the hybrid
   Mamba-2 / attention backbone, ``models/hybrid_backbone.py``, also each
   Mamba layer's conv and SSM states, zeroed for each request);
2. AR loop — per step ``flow_lm.ar_core`` (transformer step through the
   decode-attention kernel, EOS logit, LSD decode with the time conditioning
   and fused adaLN weights hoisted out of the loop) and the EOS countdown;
3. decode — frame mask → fused latent→mimi matmul → ``mimi_decode`` (its
   last stage in the fused SEANet tail kernel) → int16, truncating toward
   zero.

The reference runs the AR loop as one ``lax.while_loop`` inside one
compiled program per shape bucket, and the decode as another. Here, on the
card, the loop runs as captured CUDA graphs (``runtime/graphs.py``): one
graph of ``SYNC_EVERY`` AR steps, replayed until every lane is done or the
budget is spent, and one graph for a tail of ``n_steps mod SYNC_EVERY``
steps, so the graphs run exactly the steps of the eager loop (a runtime
whose ``_graphs`` is None, kept for comparisons). The loop's
state lives in static buffers on the device: the KV cache, frame buffer,
``n_frames``, countdown, ``done``, the step index, and the sampling knobs
(``sigma``, the EOS threshold and ``frames_after_eos``). The host reads
``done`` only between graphs. Steps run after every lane is done change
nothing the decode reads (their frames lie past ``n_frames`` and are
masked), and the loop ends by setting the cache offset to where the
while_loop stops (the K/V rows those steps wrote lie past it, unread), so
the audio and the carried cache are the while_loop's exactly. (The hybrid
backbone's recurrent states do advance over such steps; nothing reads
them after its last frame: it runs no sessions.) The loop
takes and returns its carry (cache, frame, countdown, ``done`` and the
request's noise), so the streaming path runs it in segments and a
continuity session carries the cache into the next chunk; a session's
cache is a copy, never the loop's buffers. The prefill (the reference's
``_embed_prefill``: embedding, voice concat and the transformer over the
prompt) is a graph per (batch, token bucket, voice length, capacity,
dtype, cache source) that writes the loop's static cache, so the loop
copies no K/V; a hydrated voice or a session's cache is copied into it
first. The decode is a graph per decode bucket. On the CPU the same bodies
run eagerly over the same buffers. The first request of a bucket pays a
capture, as the reference's pays a compile.

A request's LSD noise is drawn once, ``[steps, B, L]`` from its own
generator, and each graph reads its steps' rows from a static buffer: the
noise of a step does not depend on how the steps are cut into graphs or
segments, so the streamed and the one-shot paths give the same frames.

Voice conditioning (``GenerateConfig.voice_embedding`` or
``voice_model_state``) and continuity sessions (``generate_audio_session``,
``ContinuationState``) follow the reference's bucketing and capacity rules;
frame streaming lives in :mod:`runtime.streaming`.

Shapes are bucketed as in the reference (``utils/buckets.py``), so caches
and buffers keep a few static sizes.

The reference's switches: ``pallas`` (``None`` = auto, which reads
``POCKETTTS_PALLAS``, ``True``, ``False``) and ``matmul_precision``. With
``pallas=False`` every kernel call site runs its plain PyTorch version on
the card (the models' ``use_kernels`` flags, and the quantized linears'
plain backends while the runtime computes), so no launch counter moves;
auto and on run every kernel. ``matmul_precision`` sets TF32 for float32
products: ``highest`` keeps it off in matmuls and cuDNN convolutions,
``high`` turns it on in both, ``default`` leaves the process's flags as
they are; ``""`` or ``None`` is ``highest`` in float32 and ``default`` in
bfloat16, as in the reference.
"""

from __future__ import annotations

import contextlib
import logging
import math
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from go_pocket_tts_tpu_torch import tracing
from go_pocket_tts_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from go_pocket_tts_tpu_torch.models import flow_lm as flm
from go_pocket_tts_tpu_torch.models import flow_transformer as ftr
from go_pocket_tts_tpu_torch.models import hybrid_backbone as hyb
from go_pocket_tts_tpu_torch.models.model import PocketTTSModel, auto_pallas_mimi, with_kernels
from go_pocket_tts_tpu_torch.models.params import matmul_backends
from go_pocket_tts_tpu_torch.models.quantize import quantize_model_params
from go_pocket_tts_tpu_torch.runtime.graphs import GraphCache, feed
from go_pocket_tts_tpu_torch.text.prepare import estimate_max_frames
from go_pocket_tts_tpu_torch.utils import buckets as bk
from go_pocket_tts_tpu_torch.utils.safetensors import VoiceModelState

log = logging.getLogger("pockettts.torch.runtime")

__all__ = [
    "ContinuationState",
    "GenerateConfig",
    "GPURuntime",
    "HostCopy",
    "MATMUL_PRECISIONS",
    "decode_float",
    "decode_pcm16",
    "estimate_max_frames",
    "kernel_model",
    "own_cache",
    "quantized_model",
    "resolve_pallas",
]

@dataclass
class ContinuationState:
    """Cross-chunk prosody state: the FlowLM KV cache carried from one text
    chunk into the next. Single use: the next chunk's eager prefill (a
    runtime without graphs) writes into the cache buffers in place, so
    always pass the state the latest call returned."""

    cache: Dict
    capacity: int
    # Host-side upper bound on the written cache slots (the true offset is
    # on the device; EOS can end a chunk early, so this over-counts).
    used_ub: int


@dataclass
class GenerateConfig:
    """Per-chunk generation parameters (the reference's)."""

    temperature: float = 0.7
    eos_threshold: float = -4.0
    max_steps: int = 0
    estimated_max_steps: int = 0
    lsd_decode_steps: int = 1
    frames_after_eos: int = 3
    voice_embedding: Optional[np.ndarray] = None  # [1, Tv, D]
    voice_model_state: Optional[VoiceModelState] = None
    # Called after generation with (frames, max_steps).
    step_callback: Optional[Callable[[int, int], None]] = None


class HostCopy:
    """A device tensor on its way to the host: the copy is enqueued now (into
    pinned memory, behind the work that produces the tensor) and waited for
    in :meth:`numpy`, from any thread. The tensor may be a graph's static
    output: the next run of the graph does not change the copy."""

    def __init__(self, t: torch.Tensor) -> None:
        self._event = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t.clone()

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


# Holders of _full_f32 across threads (the batcher's engine replicas): the
# first saves the process's TF32 flags and turns them off, the last
# restores them.
_F32_LOCK = threading.Lock()
_F32_HOLD = {"count": 0, "saved": None}


@contextlib.contextmanager
def _full_f32(enabled: bool) -> Iterator[None]:
    """Keep float32 products in float32 (no TF32 in matmuls or cuDNN
    convolutions) while ``enabled``; the counterpart of the reference's
    HIGHEST matmul precision on its float32 path."""
    if not enabled:
        yield
        return
    with _F32_LOCK:
        if _F32_HOLD["count"] == 0:
            _F32_HOLD["saved"] = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        _F32_HOLD["count"] += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _F32_HOLD["count"] -= 1
            if _F32_HOLD["count"] == 0:
                torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = _F32_HOLD["saved"]


MATMUL_PRECISIONS = ("default", "high", "highest")


@contextlib.contextmanager
def _matmul_precision(precision: str) -> Iterator[None]:
    """TF32 for float32 products while the block runs: off (``highest``),
    on (``high``) or the process's own flags (``default``)."""
    if precision == "highest":
        with _full_f32(True):
            yield
        return
    if precision != "high":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with torch.backends.cudnn.flags(allow_tf32=True):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def resolve_pallas(pallas: Optional[bool]) -> bool:
    """The reference's tri-state kernel switch as a yes or no: ``None``
    (auto) is yes unless ``POCKETTTS_PALLAS=0``; auto and on run every
    kernel."""
    if pallas is None:
        return os.environ.get("POCKETTTS_PALLAS", "") != "0"
    return bool(pallas)


def kernel_model(model: PocketTTSModel, kernels: bool) -> PocketTTSModel:
    """``model`` with its kernel call sites off when ``kernels`` is no, then
    the Mimi env override (``auto_pallas_mimi``)."""
    return auto_pallas_mimi(model if kernels else with_kernels(model, False))


def kernels_scope(kernels: bool) -> contextlib.AbstractContextManager:
    """The quantized linears' plain backends while a runtime without
    kernels computes (nothing when ``kernels``)."""
    return contextlib.nullcontext() if kernels else matmul_backends("xla", "split")


def decode_float(
    model: PocketTTSModel, frames: torch.Tensor, n_frames: torch.Tensor, decode_frames: int
) -> torch.Tensor:
    """Mask → fused latent→mimi → Mimi decode: the PCM
    ``[B, 1, decode_frames·1920]`` of ``frames [B, W, L]`` in the model's
    dtype; frames at or past a lane's ``n_frames`` are zeroed."""
    frames = frames[:, :decode_frames]
    mask = (torch.arange(decode_frames, device=frames.device) < n_frames[:, None])[:, :, None]
    latent = torch.where(mask, frames, torch.zeros((), dtype=frames.dtype, device=frames.device))
    return model.mimi_decode(model.latent_to_mimi(latent))


def decode_pcm16(
    model: PocketTTSModel, frames: torch.Tensor, n_frames: torch.Tensor, decode_frames: int
) -> torch.Tensor:
    """:func:`decode_float`, then int16; the host trims each lane to
    ``n_frames·1920`` samples."""
    pcm = decode_float(model, frames, n_frames, decode_frames)
    # Truncation toward zero, as the reference's host WAV encoder does.
    return (pcm.float().clamp(-1.0, 1.0) * 32767.0).to(torch.int16)


def own_cache(cache: Dict) -> Dict:
    """A copy of a carried KV cache for a continuity session: the AR loop's
    cache is a graph's static buffer, which the runtime's next request of
    the same bucket writes."""
    return {key: val.clone() for key, val in cache.items()}


def _embed_prefill(
    model: PocketTTSModel,
    dtype: torch.dtype,
    cache: Dict,
    ids: torch.Tensor,
    valid: Union[int, torch.Tensor],
    voice_emb: Optional[torch.Tensor] = None,
) -> Dict:
    """Embed ``ids [B, P]`` (zero-padded), put ``voice_emb [B, V, D]`` in
    front if given, and prefill ``cache`` in place; ``valid`` counts the
    real rows, the voice's included (an int, or a device int32 scalar in a
    graph). The body of the prefill graph and of the eager prefill."""
    flow = model.params["flow_lm"]
    emb = flm.text_embeddings(flow, ids).to(dtype)
    if voice_emb is not None:
        emb = torch.cat([voice_emb.to(dtype), emb], dim=1)
    # Padded token slots embed row 0 of the LUT; they sit past the offset
    # and are never visible.
    return flm.prompt(flow, model.config.flow_lm, cache, emb, valid)


def quantized_model(model: PocketTTSModel, quantize: Union[bool, int]) -> PocketTTSModel:
    """``model`` with every float linear weight-only quantized: int8 when
    ``quantize`` is True or 8, packed int4 when it is 4; unchanged when it
    is False. Linears that are already quantized (a pre-quantized
    checkpoint) stay as they are, so on such a tree this is a no-op."""
    if not quantize:
        return model
    bits = 8 if quantize is True else int(quantize)
    return PocketTTSModel(quantize_model_params(model.params, bits=bits), model.config)


def _ar_steps(model: PocketTTSModel, fused_ada, s: Dict, noise: torch.Tensor, time_cond, decode_steps: int) -> None:
    """``len(noise)`` AR steps over the loop state ``s`` (cache ``k``,
    ``v``, ``offset``, and the hybrid backbone's states; ``frame``,
    ``countdown``, ``done``, ``frames``, ``n_frames``, the step index
    ``step`` and the knobs ``sigma``, ``eos_threshold``,
    ``frames_after_eos``), written back in place: the body of both the
    graphs and the eager loop."""
    flow = model.params["flow_lm"]
    flow_cfg = model.config.flow_lm
    cache = {key: s[key] for key in flm.cache_keys(flow_cfg)}
    frame, countdown, done, n_frames, step = s["frame"], s["countdown"], s["done"], s["n_frames"], s["step"]
    for i in range(noise.shape[0]):
        cache, frame, eos_logit = flm.ar_core(
            flow, flow_cfg, cache, frame, (noise[i] * s["sigma"]).to(frame.dtype), decode_steps, time_cond, fused_ada
        )
        s["frames"].index_copy_(1, step.reshape(1).long(), frame)
        # EOS bookkeeping: the frame from the EOS step is kept; the
        # countdown decrements after the zero check.
        is_eos = eos_logit.float() > s["eos_threshold"]
        newly = is_eos & (countdown < 0) & ~done
        countdown = torch.where(newly, s["frames_after_eos"], countdown)
        n_frames = torch.where(done, n_frames, step + 1)
        done = done | (countdown == 0)
        countdown = torch.where((countdown > 0) & ~done, countdown - 1, countdown)
        step = step + 1
    for key, val in (
        ("offset", cache["offset"]), ("frame", frame), ("countdown", countdown), ("done", done),
        ("n_frames", n_frames), ("step", step),
    ):
        s[key].copy_(val)


class GPURuntime:
    """Generation runtime over a loaded :class:`PocketTTSModel`.

    ``device`` defaults to ``"cuda"`` and raises on a host without CUDA;
    pass ``device="cpu"`` to run the plain PyTorch versions of the kernels
    there. ``dtype`` is ``torch.float32`` (the parity path) or
    ``torch.bfloat16``. ``quantize=True`` (or 8) runs every linear with int8
    weights and ``quantize=4`` with packed group-wise int4 weights
    (``models/quantize.py``), as ``TPURuntime(quantize=...)`` does; the AR
    step's linears then go through the quantized-matmul or the int4-matmul
    kernel. A model loaded from a pre-quantized checkpoint runs quantized
    as it is.
    Randomness comes from a ``torch.Generator`` seeded with ``seed``; each
    request draws its own seed from it, so a request's noise does not depend
    on how many steps earlier requests ran. ``pallas`` and
    ``matmul_precision`` are the reference's switches (module docstring).
    """

    SYNC_EVERY = 16  # AR steps between host reads of ``done``

    def __init__(
        self,
        model: PocketTTSModel,
        dtype: torch.dtype = torch.float32,
        seed: Optional[int] = None,
        frame_bucket: int = 256,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
        quantize: Union[bool, int] = False,
        pallas: Optional[bool] = None,
        matmul_precision: Optional[str] = None,
    ) -> None:
        self.device = resolve_device(device)
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"GPURuntime: dtype {dtype} not supported (float32 or bfloat16)")
        self.dtype = dtype
        if not matmul_precision:
            matmul_precision = "highest" if dtype == torch.float32 else "default"
        if matmul_precision not in MATMUL_PRECISIONS:
            raise ValueError(f"GPURuntime: matmul_precision {matmul_precision!r} (want one of {MATMUL_PRECISIONS})")
        self.matmul_precision = matmul_precision
        self.kernels = resolve_pallas(pallas)
        self.hybrid = flm.is_hybrid(model.config.flow_lm)
        if self.hybrid and quantize:
            raise hyb.unsupported(f"quantize={quantize!r}")
        model = kernel_model(quantized_model(model, quantize), self.kernels)
        self.model = model if (model.device, model.dtype) == (self.device, dtype) else model.to(
            self.device, dtype
        )
        self.frame_bucket = frame_bucket
        self._seeds = torch.Generator(device="cpu")
        self._seeds.manual_seed(seed if seed is not None else time.time_ns() & 0x7FFFFFFF)
        flow = self.model.params["flow_lm"]
        # Loop invariants of the AR step, built once per runtime.
        self._fused_ada = flm.fnet.precompute_fused_adaln(flow["flow_net"])
        self._time_cond = {}
        # The AR loop's, the decode's and the stream decoder's graphs, and
        # their static buffers. One caller at a time: the Service holds its
        # lock around a runtime, PocketTTSKernel its own.
        self._graphs: Optional[GraphCache] = GraphCache(self.device)
        self._buffers: Dict[tuple, Dict[str, torch.Tensor]] = {}

    def _compute(self) -> contextlib.ExitStack:
        """The context of the runtime's device work: inference mode, its
        matmul precision and, without kernels, the quantized linears' plain
        backends. The streaming paths enter it around each segment's work,
        never across a ``yield``."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        stack.enter_context(_matmul_precision(self.matmul_precision))
        stack.enter_context(kernels_scope(self.kernels))
        return stack

    def mimi_timing(self) -> Tuple[float, float, int]:
        """(frame rate, encoder frame rate, steps per latent)."""
        cfg = self.model.config.mimi
        return cfg.frame_rate, cfg.encoder_frame_rate, cfg.steps_per_latent

    def _request_generator(self) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(torch.randint(0, 2**62, (1,), generator=self._seeds)))
        return gen

    def _time_conditioning(self, decode_steps: int) -> torch.Tensor:
        tc = self._time_cond.get(decode_steps)
        if tc is None:
            tc = flm.fnet.precompute_time_cond(self.model.params["flow_lm"]["flow_net"], decode_steps)
            self._time_cond[decode_steps] = tc
        return tc

    # -- the three stages --------------------------------------------------

    def _prefill(
        self,
        tokens_padded: torch.Tensor,
        n_tokens: int,
        capacity: int,
        cache: Optional[Dict] = None,
        voice_emb: Optional[torch.Tensor] = None,
    ):
        """Embed ``tokens_padded`` (behind ``voice_emb``, if given) and
        prefill them into ``cache`` (a hydrated voice or session cache) or a
        new zero cache of ``capacity``: the reference's ``_embed_prefill``.

        As the graph of (batch, token bucket, voice length, capacity, dtype,
        cache source), whose output is the AR loop's static cache of (batch,
        capacity): a given cache is copied into it, and the loop then feeds
        nothing. Without graphs, eagerly into ``cache`` (written in place)
        or a new one."""
        batch, bucket = tokens_padded.shape
        voice_len = 0 if voice_emb is None else voice_emb.shape[1]
        valid = n_tokens + voice_len
        if self._graphs is None:
            if cache is None:
                cache = flm.init_cache(self.model.config.flow_lm, batch, capacity, self.dtype, self.device)
            return _embed_prefill(self.model, self.dtype, cache, tokens_padded, valid, voice_emb)
        fresh = cache is None
        static = self._cache_buffers(batch, capacity)
        keys = flm.cache_keys(self.model.config.flow_lm)
        key = ("prefill", batch, bucket, voice_len, capacity, self.dtype, "fresh" if fresh else "given")

        def make():
            model, dtype = self.model, self.dtype
            inputs = {
                **static,
                "ids": torch.empty_like(tokens_padded),
                "valid": torch.zeros((), dtype=torch.int32, device=self.device),
                "voice": None if voice_emb is None else torch.empty_like(voice_emb),
            }

            def body(inputs):
                cache = {key: inputs[key] for key in keys}
                if fresh:
                    for leaf in cache.values():
                        leaf.zero_()
                new = _embed_prefill(model, dtype, cache, inputs["ids"], inputs["valid"], inputs["voice"])
                inputs["offset"].copy_(new["offset"])

            return body, inputs

        graph = self._graphs.get(key, make)
        if not fresh:
            feed(graph.inputs, **{key: cache[key] for key in keys})
        feed(graph.inputs, ids=tokens_padded)
        if voice_emb is not None:
            feed(graph.inputs, voice=voice_emb)
        graph.inputs["valid"].fill_(valid)
        graph.run()
        return dict(static)

    def _new_carry(self, cfg: GenerateConfig, batch: int, steps: int) -> Dict:
        """The carry of a new request, from the BOS frame: no EOS yet, not
        done, and the noise of its ``steps`` AR steps, ``[steps, B, L]``
        float32 from the request's own generator (zeros at temperature 0),
        drawn at once so that a step's noise does not depend on how the
        steps are cut into graphs or segments."""
        latent = self.model.params["flow_lm"]["bos_emb"].shape[0]
        dev = self.device
        if cfg.temperature > 0:
            gen = self._request_generator()
            noise = torch.randn((steps, batch, latent), generator=gen, device=dev, dtype=torch.float32)
        else:
            noise = torch.zeros((steps, batch, latent), dtype=torch.float32, device=dev)
        return {
            # BOS sentinel: a NaN frame, replaced by bos_emb inside the step.
            "frame": torch.full((batch, 1, latent), float("nan"), dtype=self.dtype, device=dev),
            "countdown": torch.full((batch,), -1, dtype=torch.int32, device=dev),  # -1: no EOS yet
            "done": torch.zeros((batch,), dtype=torch.bool, device=dev),
            "noise": noise,
            "t": 0,  # noise rows used so far
        }

    def _ar_loop(
        self,
        cache,
        cfg: GenerateConfig,
        max_steps: int,
        decode_steps: int,
        max_frames: int,
        carry: Optional[Dict] = None,
    ):
        """Up to ``min(max_steps, max_frames)`` AR steps, resuming from
        ``carry`` (None: a new request; :meth:`_new_carry`). Returns
        (frames [B, max_frames, L], n_frames [B] int32, carry), all on the
        device; ``n_frames`` counts this call's frames, and ``carry`` holds
        the cache, the last frame, the countdown, ``done`` and the noise.

        Runs the graphs of ``SYNC_EVERY`` steps and of the tail over the
        static buffers of (batch, capacity) and of the frame width: the
        returned frames, counts and carry ARE those buffers, valid until
        the runtime's next call (copy them out, or enqueue the copy,
        first). Without graphs (``_graphs`` None: the eager loop the card
        checks compare with) the same steps run as eager launches over
        buffers of this call's own."""
        batch, capacity = cache["k"].shape[1], cache["k"].shape[3]
        n_steps = min(max_steps, max_frames)
        if carry is None:
            carry = self._new_carry(cfg, batch, n_steps)
        time_cond = self._time_conditioning(decode_steps)
        s = self._loop_buffers(batch, capacity, max_frames, fresh=self._graphs is None)
        keys = flm.cache_keys(self.model.config.flow_lm)
        feed(s, **{key: cache[key] for key in keys})
        feed(s, frame=carry["frame"], countdown=carry["countdown"], done=carry["done"])
        s["sigma"].fill_(math.sqrt(max(float(cfg.temperature), 0.0)))
        s["eos_threshold"].fill_(float(cfg.eos_threshold))
        s["frames_after_eos"].fill_(int(cfg.frames_after_eos))
        for key in ("frames", "n_frames", "step"):
            s[key].zero_()
        offset0 = s["offset"].clone()
        t, ran = carry["t"], n_steps
        for start in range(0, n_steps, self.SYNC_EVERY):
            n = min(self.SYNC_EVERY, n_steps - start)
            noise = carry["noise"][t + start : t + start + n]
            if self._graphs is None:
                _ar_steps(self.model, self._fused_ada, s, noise, time_cond, decode_steps)
            else:
                key = ("ar", batch, capacity, max_frames, self.dtype, decode_steps, n)
                graph = self._graphs.get(key, lambda: self._ar_graph(s, n, time_cond, decode_steps))
                graph.inputs["noise"].copy_(noise)
                graph.run()
            if start + n < n_steps:
                with tracing.span("wait"):
                    all_done = bool(s["done"].all())
                if all_done:
                    ran = start + n
                    break
        # The reference's loop stops at the step on which every lane is
        # done: it runs as many steps as the longest lane has frames. Steps
        # past that wrote K/V rows beyond this offset, which are never read.
        s["offset"].copy_(offset0 + s["n_frames"].max())
        carry = {
            "cache": {key: s[key] for key in keys},
            "frame": s["frame"],
            "countdown": s["countdown"],
            "done": s["done"],
            "noise": carry["noise"],
            "t": t + ran,
        }
        return s["frames"], s["n_frames"], carry

    def _ar_graph(self, s: Dict, n: int, time_cond: torch.Tensor, decode_steps: int):
        batch, _, latent = s["frame"].shape
        noise = torch.empty((n, batch, latent), dtype=torch.float32, device=self.device)
        # The body holds the model, not the runtime: dropping the runtime
        # frees its graphs and their pool.
        model, fused_ada = self.model, self._fused_ada

        def body(inputs):
            _ar_steps(model, fused_ada, inputs, inputs["noise"], time_cond, decode_steps)

        return body, {**s, "noise": noise}

    def _group(self, key: tuple, make: Callable[[], Dict], fresh: bool = False) -> Dict[str, torch.Tensor]:
        """The runtime's static buffers of ``key`` (made on first use), or
        new ones for one call with ``fresh``."""
        if fresh:
            return make()
        if key not in self._buffers:
            self._buffers[key] = make()
        return self._buffers[key]

    def _cache_buffers(self, batch: int, capacity: int, fresh: bool = False) -> Dict[str, torch.Tensor]:
        """The static cache of (batch, capacity): the prefill graph's
        output and the AR loop's carried input."""
        flow_cfg = self.model.config.flow_lm
        return self._group(
            ("cache", batch, capacity),
            lambda: flm.init_cache(flow_cfg, batch, capacity, self.dtype, self.device),
            fresh,
        )

    def _loop_buffers(self, batch: int, capacity: int, width: int, fresh: bool = False) -> Dict[str, torch.Tensor]:
        """The AR loop's static buffers: the cache's of (batch, capacity),
        the frames' of (batch, width) and the rest of (batch); with
        ``fresh``, new ones for one call."""
        latent = self.model.params["flow_lm"]["bos_emb"].shape[0]
        dev, dtype = self.device, self.dtype
        cache = self._cache_buffers(batch, capacity, fresh)
        frames = self._group(
            ("frames", batch, width),
            lambda: {"frames": torch.zeros((batch, width, latent), dtype=dtype, device=dev)},
            fresh,
        )
        loop = self._group(
            ("loop", batch),
            lambda: {
                "frame": torch.zeros((batch, 1, latent), dtype=dtype, device=dev),
                "countdown": torch.zeros((batch,), dtype=torch.int32, device=dev),
                "done": torch.zeros((batch,), dtype=torch.bool, device=dev),
                "n_frames": torch.zeros((batch,), dtype=torch.int32, device=dev),
                "step": torch.zeros((), dtype=torch.int32, device=dev),
                "sigma": torch.zeros((), dtype=torch.float32, device=dev),
                "eos_threshold": torch.zeros((), dtype=torch.float32, device=dev),
                "frames_after_eos": torch.zeros((), dtype=torch.int32, device=dev),
            },
            fresh,
        )
        return {**cache, **frames, **loop}

    def _decode(self, frames: torch.Tensor, n_frames: torch.Tensor, decode_frames: int, pcm16: bool = True):
        """The decode of ``frames [B, W, L]`` at ``decode_frames``
        (:func:`decode_pcm16`, or :func:`decode_float` when not ``pcm16``)
        as the graph of its bucket; the PCM is a static output."""
        fn = decode_pcm16 if pcm16 else decode_float
        if self._graphs is None:
            return fn(self.model, frames, n_frames, decode_frames)
        key = ("decode", *frames.shape[:2], decode_frames, self.dtype, pcm16)

        def make():
            model = self.model

            def body(inputs):
                return fn(model, inputs["frames"], inputs["n_frames"], decode_frames)

            return body, {"frames": torch.empty_like(frames), "n_frames": torch.empty_like(n_frames)}

        graph = self._graphs.get(key, make)
        feed(graph.inputs, frames=frames, n_frames=n_frames)
        return graph.run()

    def _decode_pcm16(self, frames: torch.Tensor, n_frames: torch.Tensor, decode_frames: int):
        return self._decode(frames, n_frames, decode_frames)

    # -- voice conditioning and bucketing ---------------------------------

    def _hydrate_voice_cache(self, state: VoiceModelState, capacity: int) -> Dict:
        with tracing.span("wait"):  # the state's host arrays, copied from pageable memory
            return ftr.kv_cache_from_voice_state(
                self.model.config.flow_lm.transformer, state.modules, capacity, self.dtype, self.device
            )

    def _voice(self, cfg: GenerateConfig):
        """(voice embedding on the device or None, its length, the voice
        model state's frames); raises on a bad voice."""
        if cfg.voice_embedding is not None and cfg.voice_model_state is not None:
            raise ValueError("generate: voice embedding and voice model state are mutually exclusive")
        if self.hybrid and (cfg.voice_embedding is not None or cfg.voice_model_state is not None):
            raise hyb.unsupported("a voice")
        voice_emb, voice_len = None, 0
        if cfg.voice_embedding is not None:
            with tracing.span("wait"):  # a copy from pageable memory
                voice_emb = torch.as_tensor(np.asarray(cfg.voice_embedding, np.float32), device=self.device)
            voice_emb = voice_emb.to(self.dtype)
            d_model = self.model.params["flow_lm"]["conditioner_embed"].shape[1]
            if voice_emb.ndim != 3 or voice_emb.shape[2] != d_model:
                raise ValueError(
                    f"voice embedding shape {tuple(voice_emb.shape)} incompatible with d_model {d_model}"
                )
            voice_len = voice_emb.shape[1]
        voice_frames = 0
        if cfg.voice_model_state is not None:
            first = next(iter(cfg.voice_model_state.modules.values()))
            voice_frames = int(np.asarray(first["offset"]).reshape(-1)[0])
        return voice_emb, voice_len, voice_frames

    def _request(self, tokens, cfg: GenerateConfig):
        """Validate one chunk: (token ids, max_steps, decode_steps,
        frame_bucket, token_bucket, ids padded to the token bucket on the
        device)."""
        if len(tokens) == 0:
            raise ValueError("generate: token slice must not be empty")
        max_steps = cfg.max_steps or cfg.estimated_max_steps or estimate_max_frames(len(tokens))
        tok_np = np.asarray(tokens, np.int64)
        n_bins = self.model.params["flow_lm"]["conditioner_embed"].shape[0]
        if np.any(tok_np < 0) or np.any(tok_np >= n_bins):
            raise ValueError(f"token id out of range [0,{n_bins})")
        frame_bucket = bk.pick_bucket(max_steps + 1, (self.frame_bucket, 512, 1024))
        token_bucket = bk.pick_bucket(len(tok_np), bk.PROMPT_BUCKETS)
        padded = np.zeros((1, token_bucket), np.int64)
        padded[0, : len(tok_np)] = tok_np
        with tracing.span("wait"):  # a copy from pageable memory: waits for the stream
            ids = torch.from_numpy(padded).to(self.device)
        return tok_np, max_steps, max(cfg.lsd_decode_steps, 1), frame_bucket, token_bucket, ids

    def _setup(self, tokens, cfg: GenerateConfig):
        """Validation, bucketing, voice and prefill of one chunk (the
        reference's ``_dispatch`` rules): (cache, max_steps, decode_steps,
        frame_bucket, n_tokens)."""
        tok_np, max_steps, decode_steps, frame_bucket, token_bucket, ids = self._request(tokens, cfg)
        voice_emb, voice_len, voice_frames = self._voice(cfg)
        # A hydrated voice cache advances the offset before prefill; its
        # length counts in the capacity, not in the prompt pad.
        capacity = bk.round_up(voice_frames + voice_len + token_bucket, 64) + frame_bucket
        voice_cache = None
        if cfg.voice_model_state is not None:
            voice_cache = self._hydrate_voice_cache(cfg.voice_model_state, capacity)
        cache = self._prefill(ids, len(tok_np), capacity, voice_cache, voice_emb)
        return cache, max_steps, decode_steps, frame_bucket, len(tok_np)

    def _mark_state(self, span: Optional[tracing.Span]) -> None:
        """A hybrid request's ``setup`` span carries ``state_bytes``: the
        recurrent state (conv and SSM) its prefill zeroed."""
        if span is not None and self.hybrid:
            span.set(state_bytes=hyb.state_bytes(self.model.config.flow_lm.transformer, 1, self.dtype))

    def _pcm(self, frames, n_frames, max_steps: int, frame_bucket: int,
             root: Optional[tracing.Span] = None) -> Callable[[], np.ndarray]:
        """Enqueue the decode and the int16 PCM's copy into pinned host
        memory, without blocking (a ``decode`` span under the request's
        ``root``); the returned resolver waits for the copy (a ``wait``
        span) and trims lane 0 to its frames (float32 PCM)."""
        with tracing.span("decode", parent=root):
            pcm = HostCopy(self._decode_pcm16(frames, n_frames, min(bk.round_up(max_steps, 32), frame_bucket))[0, 0])
            n = HostCopy(n_frames[:1])
        samples_per = self.model.config.mimi.samples_per_latent

        def resolve() -> np.ndarray:
            with tracing.span("wait", parent=root):
                pcm_np, n_np = pcm.numpy(), n.numpy()
            return pcm_np[: int(n_np[0]) * samples_per].astype(np.float32) / 32767.0

        return resolve

    # -- entry points ------------------------------------------------------

    def generate_audio(self, tokens, cfg: GenerateConfig) -> np.ndarray:
        """Synthesize one chunk of token ids → float32 PCM at 24 kHz."""
        return self.generate_audio_async(tokens, cfg)()

    def generate_audio_async(self, tokens, cfg: GenerateConfig) -> Callable[[], np.ndarray]:
        """Dispatch one chunk and return a zero-argument resolver of its
        float32 PCM (the counterpart of ``TPURuntime.generate_audio_async``).

        Prefill, AR loop and decode are enqueued, and the PCM's copy into
        pinned host memory is enqueued behind them without blocking; the
        resolver waits for that copy. A caller can so dispatch chunk k+1
        before it resolves chunk k (``Service``'s one-deep pipeline). The
        AR loop still reads ``done`` every ``SYNC_EVERY`` steps, so this
        returns once the last of those reads has come back, with up to
        ``SYNC_EVERY`` steps and the decode still in flight.
        """
        t0 = time.perf_counter()
        root = tracing.begin("request", request=tracing.next_request_id())
        try:
            with self._compute():
                with tracing.span("setup", parent=root) as sp:
                    cache, max_steps, decode_steps, frame_bucket, n_tokens = self._setup(tokens, cfg)
                    self._mark_state(sp)
                with tracing.span("ar", parent=root):
                    frames, n_frames, _ = self._ar_loop(cache, cfg, max_steps, decode_steps, frame_bucket)
                pcm = self._pcm(frames, n_frames, max_steps, frame_bucket, root)
        except BaseException:
            if root is not None:
                root.finish()
            raise
        samples_per = self.model.config.mimi.samples_per_latent

        def resolve() -> np.ndarray:
            try:
                audio = pcm()
                n = len(audio) // samples_per
                if cfg.step_callback is not None:
                    cfg.step_callback(n, max_steps)
            finally:
                if root is not None:
                    root.finish()
            log.debug(
                "generation complete: tokens=%d frames=%d total=%.1fms",
                n_tokens,
                n,
                (time.perf_counter() - t0) * 1e3,
            )
            return audio

        return resolve

    def generate_audio_staged(self, tokens, cfg: GenerateConfig) -> Tuple[np.ndarray, Dict[str, float]]:
        """Profiling variant of :meth:`generate_audio` (the counterpart of
        ``TPURuntime.generate_audio_staged``): prefill, AR loop and decode
        with the device synchronized at each boundary, returning (float32
        PCM, ``{"prefill", "ar", "decode"}`` seconds).

        The prefill goes through ``_setup``, so both voice forms count. The
        decode runs at ``pick_bucket(frames, DECODE_BUCKETS)`` and the PCM
        stays float, without the int16 step, as the reference's does; it is
        so within one PCM16 step of :meth:`generate_audio`'s. Slower than
        the one-shot path (a sync per stage), for the stage profiler.
        """
        stages: Dict[str, float] = {}

        def sync() -> None:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        with self._compute():
            t0 = time.perf_counter()
            cache, max_steps, decode_steps, frame_bucket, _ = self._setup(tokens, cfg)
            sync()
            stages["prefill"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            frames, n_frames, _ = self._ar_loop(cache, cfg, max_steps, decode_steps, frame_bucket)
            n = int(n_frames[0])  # waits for the loop
            stages["ar"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            pcm = self._decode(frames, n_frames, bk.pick_bucket(n, bk.DECODE_BUCKETS), pcm16=False)
            samples_per = self.model.config.mimi.samples_per_latent
            audio = pcm[0, 0, : n * samples_per].float().cpu().numpy()
            stages["decode"] = time.perf_counter() - t0
        return audio, stages

    # Cache size ceiling of a continuity session: a session that fills it
    # resets rather than run past the context the model was trained at.
    SESSION_CAPACITY = 1024

    def _session_ladder(self, max_capacity: int) -> tuple:
        """Ascending KV capacities of a continuity session: a session starts
        in the smallest that fits its first chunk and its carried cache
        grows up the ladder at chunk boundaries."""
        return tuple(b for b in (384, 640) if b < max_capacity) + (max_capacity,)

    @staticmethod
    def _grow_cache(cache: Dict, capacity: int) -> Dict:
        """Zero-pad a carried KV cache ``{k, v: [L,B,H,C,Dh]}`` to a larger
        capacity."""
        pad = capacity - cache["k"].shape[3]
        return {
            **cache,
            "k": torch.nn.functional.pad(cache["k"], (0, 0, 0, pad)),
            "v": torch.nn.functional.pad(cache["v"], (0, 0, 0, pad)),
        }

    def _session_setup(
        self,
        tokens,
        cfg: GenerateConfig,
        cont: Optional[ContinuationState],
    ):
        """Per-chunk session setup shared by :meth:`generate_audio_session`
        and the streamed session: validation, the capacity ladder and reset
        bookkeeping, voice hydration and the prefill. Returns (cache,
        capacity, used0, max_steps, decode_steps, frame_bucket, n_tokens)."""
        if self.hybrid:
            raise hyb.unsupported("a continuity session")
        tok_np, max_steps, decode_steps, frame_bucket, token_bucket, ids = self._request(tokens, cfg)
        voice_emb, voice_len, voice_frames = self._voice(cfg)
        # Peak write index of this chunk: prefill pads to the token bucket;
        # the AR loop writes at offset + len(tokens) + step. Grow the carried
        # cache up the ladder when the chunk does not fit; reset only once
        # the ceiling is reached.
        chunk_extent = max(token_bucket, len(tok_np) + max_steps)
        ladder = self._session_ladder(self.SESSION_CAPACITY)
        if cont is not None and cont.used_ub + chunk_extent > cont.capacity:
            needed = cont.used_ub + chunk_extent
            grow_to = next((b for b in ladder if b >= needed and b > cont.capacity), None)
            if grow_to is None:
                log.info(
                    "continuity session full (%d + %d > %d): resetting", cont.used_ub, chunk_extent, cont.capacity
                )
                cont = None
            else:
                log.debug("continuity session growing %d -> %d", cont.capacity, grow_to)
                cont = ContinuationState(self._grow_cache(cont.cache, grow_to), grow_to, cont.used_ub)

        if cont is not None:
            # Voice conditioning applies on a session's first chunk only;
            # later chunks inherit it through the carried cache.
            capacity, cache, voice_emb, used0 = cont.capacity, cont.cache, None, cont.used_ub
        else:
            min_needed = bk.round_up(voice_frames + voice_len + token_bucket, 64) + frame_bucket
            capacity = next((b for b in ladder if b >= min_needed), bk.round_up(min_needed, 64))
            cache = None
            if cfg.voice_model_state is not None:
                cache = self._hydrate_voice_cache(cfg.voice_model_state, capacity)
            used0 = voice_frames + voice_len
        cache = self._prefill(ids, len(tok_np), capacity, cache, voice_emb)
        return cache, capacity, used0, max_steps, decode_steps, frame_bucket, len(tok_np)

    def generate_audio_session(
        self,
        tokens,
        cfg: GenerateConfig,
        cont: Optional[ContinuationState] = None,
    ) -> Tuple[np.ndarray, ContinuationState]:
        """Synthesize one chunk, carrying the KV cache across calls.

        Pass the returned :class:`ContinuationState` as ``cont`` for the
        next chunk: its text is appended to the live cache after the
        previous chunk's frames, so prosody flows across the boundary. A
        chunk that does not fit the session's ceiling resets the session."""
        root = tracing.begin("request", request=tracing.next_request_id())
        try:
            with self._compute():
                with tracing.span("setup", parent=root):
                    cache, capacity, used0, max_steps, decode_steps, frame_bucket, n_tokens = self._session_setup(
                        tokens, cfg, cont
                    )
                with tracing.span("ar", parent=root):
                    frames, n_frames, carry = self._ar_loop(cache, cfg, max_steps, decode_steps, frame_bucket)
                audio = self._pcm(frames, n_frames, max_steps, frame_bucket, root)()
            n = len(audio) // self.model.config.mimi.samples_per_latent
            if cfg.step_callback is not None:
                cfg.step_callback(n, max_steps)
            return audio, ContinuationState(own_cache(carry["cache"]), capacity, used0 + n_tokens + n)
        finally:
            if root is not None:
                root.finish()

    def stream_generate_session(self, tokens, cfg: GenerateConfig, cont: Optional[ContinuationState] = None):
        """Frame streaming with continuity for one chunk → ``(blocks,
        next_state)`` (see :func:`runtime.streaming.stream_generate_session`)."""
        from go_pocket_tts_tpu_torch.runtime.streaming import stream_generate_session

        return stream_generate_session(self, tokens, cfg, cont)
