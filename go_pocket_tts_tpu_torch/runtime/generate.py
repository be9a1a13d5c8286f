"""The single-utterance generation path on the GPU (counterpart of
``go_pocket_tts_tpu/runtime/generate.py``: ``TPURuntime.generate_audio``).

Three stages, each on the device:

1. prefill — LUT text embedding → ``flow_lm.prompt`` (transformer, T > 1)
   into a static-capacity ``[L,B,H,C,Dh]`` KV cache;
2. AR loop — per step ``flow_lm.ar_core`` (transformer step through the
   decode-attention kernel, EOS logit, LSD decode with the time conditioning
   and fused adaLN weights hoisted out of the loop) and the EOS countdown;
3. decode — frame mask → fused latent→mimi matmul → ``mimi_decode`` (its
   last stage in the fused SEANet tail kernel) → int16, truncating toward
   zero.

The reference runs the AR loop as one ``lax.while_loop``. Here the loop is
driven from the host, but its state stays on the device: frame buffer,
``n_frames``, countdown, ``done`` and the cache offset. The host reads
``done`` only every ``SYNC_EVERY`` steps. Steps run after every lane is done
change nothing the decode reads (their frames lie past ``n_frames`` and are
masked), and the loop ends by setting the cache offset to where the
while_loop stops (the K/V rows those steps wrote lie past it, unread), so
the audio and the carried cache are the while_loop's exactly. The loop takes and returns its carry
(cache, frame, countdown, done, generator), so the streaming path runs it
in segments and a continuity session carries the cache into the next chunk.

Voice conditioning (``GenerateConfig.voice_embedding`` or
``voice_model_state``) and continuity sessions (``generate_audio_session``,
``ContinuationState``) follow the reference's bucketing and capacity rules;
frame streaming lives in :mod:`runtime.streaming`.

Shapes are bucketed as in the reference (``utils/buckets.py``), so caches
and buffers keep a few static sizes.
"""

from __future__ import annotations

import contextlib
import logging
import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from go_pocket_tts_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from go_pocket_tts_tpu_torch.models import flow_lm as flm
from go_pocket_tts_tpu_torch.models import flow_transformer as ftr
from go_pocket_tts_tpu_torch.models.model import PocketTTSModel
from go_pocket_tts_tpu_torch.models.quantize import quantize_model_params
from go_pocket_tts_tpu_torch.text.prepare import estimate_max_frames
from go_pocket_tts_tpu_torch.utils import buckets as bk
from go_pocket_tts_tpu_torch.utils.safetensors import VoiceModelState

log = logging.getLogger("pockettts.torch.runtime")

__all__ = [
    "ContinuationState",
    "GenerateConfig",
    "GPURuntime",
    "HostCopy",
    "decode_float",
    "decode_pcm16",
    "estimate_max_frames",
    "quantized_model",
]

@dataclass
class ContinuationState:
    """Cross-chunk prosody state: the FlowLM KV cache carried from one text
    chunk into the next. Single use: the next chunk's prefill writes into
    the cache buffers in place, so always pass the state the latest call
    returned."""

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
    in :meth:`numpy`, from any thread."""

    def __init__(self, t: torch.Tensor) -> None:
        self._event = None
        if t.is_cuda:
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def numpy(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


@contextlib.contextmanager
def _full_f32(enabled: bool) -> Iterator[None]:
    """Keep float32 products in float32 (no TF32 in matmuls or cuDNN
    convolutions) while ``enabled``; the counterpart of the reference's
    HIGHEST matmul precision on its float32 path."""
    if not enabled:
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.backends.cudnn.flags(allow_tf32=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


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


def quantized_model(model: PocketTTSModel, quantize: Union[bool, int]) -> PocketTTSModel:
    """``model`` with every float linear weight-only quantized: int8 when
    ``quantize`` is True or 8, packed int4 when it is 4; unchanged when it
    is False. Linears that are already quantized (a pre-quantized
    checkpoint) stay as they are, so on such a tree this is a no-op."""
    if not quantize:
        return model
    bits = 8 if quantize is True else int(quantize)
    return PocketTTSModel(quantize_model_params(model.params, bits=bits), model.config)


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
    on how many steps earlier requests ran.
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
    ) -> None:
        self.device = resolve_device(device)
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"GPURuntime: dtype {dtype} not supported (float32 or bfloat16)")
        self.dtype = dtype
        model = quantized_model(model, quantize)
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

    def _compute(self) -> contextlib.ExitStack:
        """The context of the runtime's device work: inference mode, and
        full float32 products on the float32 path. The streaming paths
        enter it around each segment's work, never across a ``yield``."""
        stack = contextlib.ExitStack()
        stack.enter_context(torch.inference_mode())
        stack.enter_context(_full_f32(self.dtype == torch.float32))
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
        prefill them into ``cache`` (a hydrated voice or session cache,
        written in place) or a new zero cache of ``capacity``."""
        flow = self.model.params["flow_lm"]
        flow_cfg = self.model.config.flow_lm
        emb = flm.text_embeddings(flow, tokens_padded).to(self.dtype)
        valid = n_tokens
        if voice_emb is not None:
            emb = torch.cat([voice_emb.to(self.dtype), emb], dim=1)
            valid += voice_emb.shape[1]
        if cache is None:
            cache = ftr.init_kv_cache(
                flow_cfg.transformer, tokens_padded.shape[0], capacity, self.dtype, self.device
            )
        # Padded token slots embed row 0 of the LUT; they sit past the
        # offset and are never visible.
        return flm.prompt(flow, flow_cfg, cache, emb, valid)

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
        ``carry`` (None: a new request, from the BOS frame). Returns
        (frames [B, max_frames, L], n_frames [B] int32, carry), all on the
        device; ``n_frames`` counts this call's frames, and ``carry`` holds
        the cache, the last frame, the countdown, ``done`` and the noise
        generator."""
        flow = self.model.params["flow_lm"]
        flow_cfg = self.model.config.flow_lm
        batch = cache["k"].shape[1]
        latent_dim = flow["bos_emb"].shape[0]
        dev, dtype = self.device, self.dtype

        sigma = math.sqrt(max(float(cfg.temperature), 0.0))
        time_cond = self._time_conditioning(decode_steps)
        if carry is None:
            carry = {
                # BOS sentinel: a NaN frame, replaced by bos_emb inside the step.
                "frame": torch.full((batch, 1, latent_dim), float("nan"), dtype=dtype, device=dev),
                "countdown": torch.full((batch,), -1, dtype=torch.int32, device=dev),  # -1: no EOS yet
                "done": torch.zeros((batch,), dtype=torch.bool, device=dev),
                "gen": self._request_generator() if sigma > 0 else None,
            }
        frame, countdown, done, gen = carry["frame"], carry["countdown"], carry["done"], carry["gen"]
        frames = torch.zeros((batch, max_frames, latent_dim), dtype=dtype, device=dev)
        n_frames = torch.zeros((batch,), dtype=torch.int32, device=dev)
        zero_noise = torch.zeros((batch, latent_dim), dtype=dtype, device=dev)

        n_steps = min(max_steps, max_frames)
        offset0 = cache["offset"]
        for step in range(n_steps):
            if gen is None:
                noise = zero_noise
            else:
                noise = (
                    torch.randn((batch, latent_dim), generator=gen, device=dev, dtype=torch.float32)
                    * sigma
                ).to(dtype)
            cache, frame, eos_logit = flm.ar_core(
                flow, flow_cfg, cache, frame, noise, decode_steps, time_cond, self._fused_ada
            )
            frames[:, step] = frame[:, 0]
            # EOS bookkeeping: the frame from the EOS step is kept; the
            # countdown decrements after the zero check.
            is_eos = eos_logit.float() > cfg.eos_threshold
            newly = is_eos & (countdown < 0) & ~done
            countdown = torch.where(newly, cfg.frames_after_eos, countdown)
            n_frames = torch.where(done, n_frames, step + 1).to(torch.int32)
            done = done | (countdown == 0)
            countdown = torch.where((countdown > 0) & ~done, countdown - 1, countdown)
            if (step + 1) % self.SYNC_EVERY == 0 and step + 1 < n_steps and bool(done.all()):
                break
        # The reference's loop stops at the step on which every lane is
        # done: it runs as many steps as the longest lane has frames. Steps
        # past that wrote K/V rows beyond this offset, which are never read.
        cache["offset"] = offset0 + n_frames.max()
        carry = {"cache": cache, "frame": frame, "countdown": countdown, "done": done, "gen": gen}
        return frames, n_frames, carry

    def _decode_pcm16(self, frames: torch.Tensor, n_frames: torch.Tensor, decode_frames: int):
        return decode_pcm16(self.model, frames, n_frames, decode_frames)

    # -- voice conditioning and bucketing ---------------------------------

    def _hydrate_voice_cache(self, state: VoiceModelState, capacity: int) -> Dict:
        return ftr.kv_cache_from_voice_state(
            self.model.config.flow_lm.transformer, state.modules, capacity, self.dtype, self.device
        )

    def _voice(self, cfg: GenerateConfig):
        """(voice embedding on the device or None, its length, the voice
        model state's frames); raises on a bad voice."""
        if cfg.voice_embedding is not None and cfg.voice_model_state is not None:
            raise ValueError("generate: voice embedding and voice model state are mutually exclusive")
        voice_emb, voice_len = None, 0
        if cfg.voice_embedding is not None:
            voice_emb = torch.as_tensor(np.asarray(cfg.voice_embedding, np.float32), device=self.device).to(self.dtype)
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

    def _pcm(self, frames, n_frames, max_steps: int, frame_bucket: int) -> Callable[[], np.ndarray]:
        """Enqueue the decode and the int16 PCM's copy into pinned host
        memory, without blocking; the returned resolver waits for the copy
        and trims lane 0 to its frames (float32 PCM)."""
        pcm = HostCopy(self._decode_pcm16(frames, n_frames, min(bk.round_up(max_steps, 32), frame_bucket))[0, 0])
        n = HostCopy(n_frames[:1])
        samples_per = self.model.config.mimi.samples_per_latent

        def resolve() -> np.ndarray:
            return pcm.numpy()[: int(n.numpy()[0]) * samples_per].astype(np.float32) / 32767.0

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
        with self._compute():
            cache, max_steps, decode_steps, frame_bucket, n_tokens = self._setup(tokens, cfg)
            frames, n_frames, _ = self._ar_loop(cache, cfg, max_steps, decode_steps, frame_bucket)
            pcm = self._pcm(frames, n_frames, max_steps, frame_bucket)
        samples_per = self.model.config.mimi.samples_per_latent

        def resolve() -> np.ndarray:
            audio = pcm()
            n = len(audio) // samples_per
            if cfg.step_callback is not None:
                cfg.step_callback(n, max_steps)
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
            pcm = decode_float(self.model, frames, n_frames, bk.pick_bucket(n, bk.DECODE_BUCKETS))
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
        with self._compute():
            cache, capacity, used0, max_steps, decode_steps, frame_bucket, n_tokens = self._session_setup(
                tokens, cfg, cont
            )
            frames, n_frames, carry = self._ar_loop(cache, cfg, max_steps, decode_steps, frame_bucket)
            audio = self._pcm(frames, n_frames, max_steps, frame_bucket)()
        n = len(audio) // self.model.config.mimi.samples_per_latent
        if cfg.step_callback is not None:
            cfg.step_callback(n, max_steps)
        return audio, ContinuationState(carry["cache"], capacity, used0 + n_tokens + n)

    def stream_generate_session(self, tokens, cfg: GenerateConfig, cont: Optional[ContinuationState] = None):
        """Frame streaming with continuity for one chunk → ``(blocks,
        next_state)`` (see :func:`runtime.streaming.stream_generate_session`)."""
        from go_pocket_tts_tpu_torch.runtime.streaming import stream_generate_session

        return stream_generate_session(self, tokens, cfg, cont)
