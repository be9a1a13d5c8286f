"""TTS orchestration service of the port (counterpart of the reference
package's ``tts/service.py``).

``Service`` owns the tokenizer and a runtime and drives text →
:func:`prepare_chunks` (≤50-token chunks) → per-chunk voice-conditioned
generation → concatenated float32 PCM at 24 kHz. Streaming yields one
:class:`PCMChunk` per text chunk, or, where the runtime streams frames
(:class:`GPURuntime`, :class:`BatcherRuntime`), one per PCM block of a few
latent frames.

Backends (``tts.backend``, `service.go:39-98`):

- ``gpu``: :class:`GPURuntime` (one request at a time) or, with
  ``runtime.batch_slots > 1``, :class:`BatcherRuntime` (the continuous
  batcher). Both run the port's CUDA kernels on the card, or their plain
  PyTorch versions when the config's device is the CPU;
- ``torch``: the independent torch oracle (:mod:`tts.runtime_torch`) on the
  config's device, with no hand-written kernel;
- ``cli``: a subprocess to an external ``pocket-tts`` binary
  (:mod:`tts.runtime_cli`), which takes the whole text and needs no
  tokenizer.

The routes of :meth:`Service.synthesize_stream` are chosen by what the
runtime offers (``synthesize_text``, ``generate_audio_session``,
``batcher``, ``generate_audio_async``, ``stream_generate_session``,
``stream_generate``), as in the reference.
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from go_pocket_tts_tpu_torch.config import BACKEND_CLI, BACKEND_TORCH, Config, normalize_backend
from go_pocket_tts_tpu_torch.device import resolve_device
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime
from go_pocket_tts_tpu_torch.runtime.streaming import stream_generate
from go_pocket_tts_tpu_torch.text import ChunkMetadata, estimate_max_frames, prepare_chunks
from go_pocket_tts_tpu_torch.text.sentencepiece import load_tokenizer
from go_pocket_tts_tpu_torch.utils import buckets as bk
from go_pocket_tts_tpu_torch.utils import safetensors as st

log = logging.getLogger("pockettts.torch.service")

__all__ = ["Service", "PCMChunk", "CancelledError", "MAX_TOKENS_PER_CHUNK", "load_voice_conditioning"]

# Token budget per synthesis chunk (`internal/tts/service.go:23`).
MAX_TOKENS_PER_CHUNK = 50

_DEFAULT_MAX_STEPS = 256  # config default used by generationStepLimit


@dataclass
class PCMChunk:
    samples: np.ndarray
    chunk_index: int
    final: bool


class CancelledError(RuntimeError):
    """Request cancelled (the ctx-cancellation analogue)."""


@dataclass
class _VoiceConditioning:
    embedding: Optional[np.ndarray] = None
    model_state: Optional[st.VoiceModelState] = None

    def apply_to(self, cfg: GenerateConfig) -> None:
        cfg.voice_embedding = self.embedding
        cfg.voice_model_state = self.model_state


_voice_cache: dict = {}
_voice_cache_lock = threading.Lock()


def load_voice_conditioning(voice_path: str) -> _VoiceConditioning:
    """Inspect and load a voice file: a model state hydrates the KV cache,
    an embedding is prepended to the prompt (`service.go:202-244`).

    Loads are cached by (path, mtime), so a hot serving path does not
    re-read the file per request."""
    if not voice_path or not voice_path.strip():
        return _VoiceConditioning()
    try:
        mtime = os.stat(voice_path).st_mtime_ns
    except OSError:
        mtime = None
    key = (voice_path, mtime)
    with _voice_cache_lock:
        cached = _voice_cache.get(key)
    if cached is not None:
        return cached

    kind = st.inspect_voice_file(voice_path)
    if kind == st.VoiceFileKind.MODEL_STATE:
        cond = _VoiceConditioning(model_state=st.load_voice_model_state(voice_path))
    else:
        cond = _VoiceConditioning(embedding=st.load_voice_embedding(voice_path))
    with _voice_cache_lock:
        if len(_voice_cache) > 32:
            _voice_cache.clear()
        _voice_cache[key] = cond
    return cond


def _stream_pcm_chunks(blocks, chunk_index: int, last_chunk: bool):
    """Wrap a PCM-block iterator as PCMChunks, marking the LAST block of the
    last chunk ``final=True`` (one-block lookahead). A final chunk that
    produces zero blocks still emits an empty final marker so consumers that
    wait on ``final`` never hang."""
    prev: Optional[np.ndarray] = None
    for block in blocks:
        if prev is not None:
            yield PCMChunk(samples=prev, chunk_index=chunk_index, final=False)
        prev = block
    if prev is not None:
        yield PCMChunk(samples=prev, chunk_index=chunk_index, final=last_chunk)
    elif last_chunk:
        yield PCMChunk(samples=np.zeros(0, np.float32), chunk_index=chunk_index, final=True)


_PALLAS = {"auto": None, "on": True, "true": True, "1": True, "off": False, "false": False, "0": False}


def _kernel_switch(value: str) -> Optional[bool]:
    """``--runtime-pallas`` as the runtimes' tri-state ``pallas``."""
    key = str(value).strip().lower()
    if key not in _PALLAS:
        raise ValueError(f"--runtime-pallas must be auto, on, or off (got {value!r})")
    return _PALLAS[key]


def _mesh(runtime_cfg):
    """The mesh of ``--runtime-dp``/``--runtime-tp`` on the configured
    device (None for neither): the reference's choice of ``dp_tp_mesh``
    or ``dp_mesh``. Raises where the host has fewer cards than asked."""
    from go_pocket_tts_tpu_torch.parallel.mesh import dp_mesh, dp_tp_mesh

    dp, tp, device = runtime_cfg.dp_devices, runtime_cfg.tp_devices, runtime_cfg.device
    if tp > 1:
        return dp_tp_mesh(max(dp, 1), tp, device=device)
    if dp > 1:
        return dp_mesh(dp, device=device)
    return None


class Service:
    """Owns tokenizer + runtime; thread-safe via an internal lock around the
    runtime (one request generates at a time per service; the HTTP layer adds
    its own worker-pool semaphore on top, `server.go:112-134`)."""

    def __init__(self, runtime, tokenizer, tts_cfg) -> None:
        self.runtime = runtime
        self.tokenizer = tokenizer
        self.tts_cfg = tts_cfg
        # Concurrency-native runtimes (the continuous batcher) handle their
        # own scheduling; others are serialized per service.
        if getattr(runtime, "concurrent_safe", False):
            self._lock = contextlib.nullcontext()
        else:
            self._lock = threading.Lock()

    # -- construction ------------------------------------------------------

    @classmethod
    def from_config(cls, cfg: Config) -> "Service":
        """The runtime the config names, on ``cfg.runtime.device`` (``cuda``
        unless the caller set ``cpu``): for ``gpu``, :class:`GPURuntime` at
        ``batch_slots <= 1``, else :class:`BatcherRuntime`; for ``torch``,
        :class:`TorchRuntime`; for ``cli``, :class:`CLIRuntime` (no device,
        no tokenizer). ``runtime.dp_devices``/``tp_devices`` above 1 serve
        the batcher over their mesh (``parallel/mesh.py``), ``runtime.pallas``
        and ``matmul_precision`` are the reference's switches. Raises on a
        host without CUDA when the device is ``cuda``, or with fewer cards
        than the mesh asks for; never falls back."""
        backend = normalize_backend(cfg.tts.backend)
        if backend == BACKEND_CLI:
            from go_pocket_tts_tpu_torch.tts.runtime_cli import CLIRuntime

            runtime = CLIRuntime(
                cfg.tts.cli_path or "pocket-tts",
                quiet=cfg.tts.quiet,
                extra_args=cfg.tts.cli_args,
                config_path=cfg.tts.cli_config_path,
            )
            return cls(runtime, None, cfg.tts)
        if backend == BACKEND_TORCH:
            device = resolve_device(cfg.runtime.device)
            from go_pocket_tts_tpu_torch.tts.runtime_torch import TorchRuntime

            tokenizer = load_tokenizer(cfg.paths.tokenizer_model)
            runtime = TorchRuntime.from_checkpoint(
                cfg.paths.model_path, seed=None if cfg.runtime.seed < 0 else cfg.runtime.seed, device=device
            )
            log.info("loaded torch runtime model=%s device=%s", cfg.paths.model_path, device)
            return cls(runtime, tokenizer, cfg.tts)
        pallas = _kernel_switch(cfg.runtime.pallas)
        batched = cfg.runtime.batch_slots > 1
        if not batched and cfg.runtime.kv_quantize:
            raise ValueError(
                "--runtime-kv-quantize requires the batched runtime: "
                "set --runtime-batch-slots > 1 (the single-request AR "
                "step is weight-bound; int8 KV only pays at batch>1)"
            )
        if not batched and (cfg.runtime.tp_devices > 1 or cfg.runtime.dp_devices > 1):
            # Meshes ride the continuous batcher; a silent single-card run
            # would report numbers as "N-way parallel", so refuse loudly.
            raise ValueError(
                "--runtime-tp/--runtime-dp require the batched runtime: "
                "set --runtime-batch-slots > 1 (got "
                f"tp={cfg.runtime.tp_devices} dp={cfg.runtime.dp_devices} "
                f"batch_slots={cfg.runtime.batch_slots})"
            )
        mesh = _mesh(cfg.runtime) if batched else None
        device = resolve_device(cfg.runtime.device)
        if cfg.runtime.compile_cache_dir:
            from go_pocket_tts_tpu_torch.kernels import build

            build.BUILD_DIR = Path(cfg.runtime.compile_cache_dir)

        from go_pocket_tts_tpu_torch.models.model import load_model
        from go_pocket_tts_tpu_torch.models.quantize import model_quantized_bits

        tokenizer = load_tokenizer(cfg.paths.tokenizer_model)
        model = load_model(cfg.paths.model_path, device=device)
        pre_bits = model_quantized_bits(model.params)
        if pre_bits:
            # A `model export --quantize` artifact: the weights arrived
            # quantized, so any --runtime-quantize walk is a no-op.
            log.info("checkpoint is pre-quantized (int%d); load-time weight quantization is skipped", pre_bits)
            cfg_bits = cfg.runtime.quantize_bits or 8
            if cfg.runtime.quantize and cfg_bits != pre_bits:
                # The artifact always wins, so say loudly that the configured
                # (or autotuned) width is NOT what will serve.
                log.warning(
                    "runtime.quantize requests int%d but the checkpoint carries int%d weights; the artifact's int%d serves",
                    cfg_bits,
                    pre_bits,
                    pre_bits,
                )
            if pre_bits == 4:
                log.warning(
                    "serving from an int4 artifact: it makes the model smaller on disk; "
                    "PERF.md holds the int4 and int8 kernels' times on the card"
                )
        dtype = torch.bfloat16 if cfg.runtime.dtype == "bfloat16" else torch.float32
        seed = None if cfg.runtime.seed < 0 else cfg.runtime.seed
        quantize = cfg.runtime.quantize_bits if cfg.runtime.quantize else False
        if batched:
            from go_pocket_tts_tpu_torch.parallel.batching import BatcherRuntime

            runtime = BatcherRuntime(
                model,
                slots=cfg.runtime.batch_slots,
                dtype=dtype,
                seed=seed,
                prompt_capacity=max(cfg.runtime.batch_prompt_capacity, 1),
                quantize=quantize,
                kv_quantize=cfg.runtime.kv_quantize,
                steps_per_sync=max(cfg.runtime.steps_per_sync, 1),
                steps_per_sync_burst=max(cfg.runtime.steps_per_sync_burst, 0),
                device=device,
                mesh=mesh,
                pallas=pallas,
            )
            log.info(
                "loaded batched runtime model=%s device=%s dtype=%s slots=%d mesh=%s",
                cfg.paths.model_path,
                device,
                dtype,
                cfg.runtime.batch_slots,
                None if mesh is None else mesh.shape,
            )
        else:
            runtime = GPURuntime(
                model,
                dtype=dtype,
                seed=seed,
                frame_bucket=cfg.runtime.frame_bucket,
                quantize=quantize,
                device=device,
                pallas=pallas,
                matmul_precision=cfg.runtime.matmul_precision or None,
            )
            log.info("loaded runtime model=%s device=%s dtype=%s", cfg.paths.model_path, device, dtype)
        return cls(runtime, tokenizer, cfg.tts)

    # -- synthesis ---------------------------------------------------------

    def _generate_config(self, chunk: ChunkMetadata, deadline: Optional[float] = None) -> GenerateConfig:
        """Per-chunk config with the dynamic step limit (`service.go:255-278`):
        the estimate wins unless the user overrode max_steps away from the
        default.

        ``deadline`` (absolute ``time.monotonic()`` seconds) additionally
        clamps the step budget: one step = one 80 ms latent frame, so the
        remaining wall-clock budget maps directly to a frame bound whenever
        generation runs at ≥1× real time. A request on the device cannot be
        aborted mid-run, so this is how a request timeout fires on time even
        for single-chunk requests.
        """
        frame_rate, _enc, _steps = self.runtime.mimi_timing()
        estimated = estimate_max_frames(chunk.num_tokens, frame_rate)
        configured = self.tts_cfg.max_steps
        # An explicitly user-set max_steps wins even when it equals the
        # default (config layer sets the marker); a non-default value also
        # counts as user intent (direct-construction callers).
        user_set = getattr(self.tts_cfg, "max_steps_user_set", False) or configured != _DEFAULT_MAX_STEPS
        if estimated > 0 and (configured <= 0 or not user_set):
            max_steps = estimated
        else:
            max_steps = configured
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise CancelledError("request deadline exceeded before dispatch")
            budget = max(int(remaining * frame_rate), 1)
            if budget < max_steps:
                log.info("clamping max_steps %d -> %d (%.1fs deadline budget)", max_steps, budget, remaining)
                max_steps = budget
        return GenerateConfig(
            temperature=self.tts_cfg.temperature,
            eos_threshold=self.tts_cfg.eos_threshold,
            max_steps=max_steps,
            estimated_max_steps=estimated,
            lsd_decode_steps=self.tts_cfg.lsd_decode_steps,
            frames_after_eos=chunk.frames_after_eos(),
        )

    def synthesize(
        self,
        input_text: str,
        voice_path: str = "",
        cancel: Optional[Callable[[], bool]] = None,
        deadline: Optional[float] = None,
        continuity: Optional[bool] = None,
    ) -> np.ndarray:
        """Full-text synthesis → float32 PCM (`service.go:115-156`)."""
        return np.concatenate(
            [
                c.samples
                for c in self.synthesize_stream(input_text, voice_path, cancel, deadline=deadline, continuity=continuity)
            ]
            or [np.zeros(0, np.float32)]
        )

    def estimate_total_frames(self, input_text: str) -> int:
        """Best-effort total-frame estimate for a request (progress bars),
        with the same chunker and the runtime's own frame rate, so that it
        agrees with the per-chunk ``estimated_max_steps``."""
        if self.tokenizer is None or self.runtime is None:
            return 0
        try:
            frame_rate, _enc, _steps = self.runtime.mimi_timing()
        except AttributeError:
            frame_rate = 0.0  # estimate_max_frames falls back to its default
        return sum(
            estimate_max_frames(c.num_tokens, frame_rate)
            for c in prepare_chunks(input_text, self.tokenizer, MAX_TOKENS_PER_CHUNK)
        )

    @property
    def supports_frame_streaming(self) -> bool:
        return isinstance(self.runtime, GPURuntime) or hasattr(self.runtime, "stream_generate")

    def synthesize_stream(
        self,
        input_text: str,
        voice_path: str = "",
        cancel: Optional[Callable[[], bool]] = None,
        frame_streaming: bool = False,
        deadline: Optional[float] = None,
        continuity: Optional[bool] = None,
    ) -> Iterator[PCMChunk]:
        """Streaming generator.

        ``frame_streaming=False``: one PCMChunk per text chunk
        (`service.go:161-200`). ``frame_streaming=True`` (where the runtime
        streams frames): PCM every few latent frames through the stateful
        block decoder. ``continuity`` overrides the service-level
        ``--continuity`` default for this request (None = the default).
        """
        if self.runtime is None:
            raise RuntimeError("tts runtime unavailable")
        # The cli backend synthesizes the whole text in the subprocess (no
        # local tokenizer round-trip, like the reference's cliSynthesizer).
        if hasattr(self.runtime, "synthesize_text"):
            pcm = self.runtime.synthesize_text(input_text, voice_path)
            yield PCMChunk(samples=pcm, chunk_index=0, final=True)
            return
        chunks = prepare_chunks(input_text, self.tokenizer, MAX_TOKENS_PER_CHUNK)
        conditioning = load_voice_conditioning(voice_path)
        use_frames = frame_streaming and self.supports_frame_streaming
        use_continuity = getattr(self.tts_cfg, "continuity", False) if continuity is None else bool(continuity)

        # Long-form continuity: thread the runtime's KV state through the
        # chunk loop so prosody carries across chunk boundaries. Sequential
        # by nature, so it takes precedence over the parallel chunk paths.
        if not use_frames and use_continuity and hasattr(self.runtime, "generate_audio_session"):
            with self._lock:
                cont = None
                for i, chunk in enumerate(chunks):
                    if cancel is not None and cancel():
                        raise CancelledError("synthesis cancelled")
                    cfg = self._generate_config(chunk, deadline)
                    # Apply the voice to EVERY chunk: runtimes ignore it while
                    # carried state survives, but an internal session reset
                    # (capacity full) must re-apply it.
                    conditioning.apply_to(cfg)
                    pcm, cont = self.runtime.generate_audio_session(chunk.token_ids, cfg, cont)
                    yield PCMChunk(samples=pcm, chunk_index=i, final=i == len(chunks) - 1)
            return

        # Concurrency-native runtime + multi-chunk text: submit every chunk
        # up front so they generate together in the shared batch; yield in
        # order.
        if not use_frames and len(chunks) > 1 and hasattr(self.runtime, "batcher"):
            futures = []
            for chunk in chunks:
                cfg = self._generate_config(chunk, deadline)
                conditioning.apply_to(cfg)
                futures.append(self.runtime.batcher.submit(chunk.token_ids, cfg))
            for i, fut in enumerate(futures):
                if cancel is not None and cancel():
                    raise CancelledError("synthesis cancelled")
                yield PCMChunk(
                    samples=fut.result(timeout=getattr(self.runtime, "_timeout", 300.0)),
                    chunk_index=i,
                    final=i == len(futures) - 1,
                )
            return

        # Sequential runtime + multi-chunk text + async-capable runtime:
        # one-deep pipeline — dispatch chunk k+1 before resolving chunk k's
        # PCM, hiding the per-chunk host↔device round trip.
        if not use_frames and len(chunks) > 1 and hasattr(self.runtime, "generate_audio_async"):
            with self._lock:
                pending = None  # (resolver, index)
                for i, chunk in enumerate(chunks):
                    if cancel is not None and cancel():
                        raise CancelledError("synthesis cancelled")
                    cfg = self._generate_config(chunk, deadline)
                    conditioning.apply_to(cfg)
                    resolver = self.runtime.generate_audio_async(chunk.token_ids, cfg)
                    if pending is not None:
                        yield PCMChunk(samples=pending[0](), chunk_index=pending[1], final=False)
                    pending = (resolver, i)
                yield PCMChunk(samples=pending[0](), chunk_index=pending[1], final=True)
            return

        # Frame streaming + continuity: sequential chunk loop threading the
        # carried state, blocks yielded as they arrive.
        if use_frames and use_continuity and hasattr(self.runtime, "stream_generate_session"):
            with self._lock:
                cont = None
                for i, chunk in enumerate(chunks):
                    if cancel is not None and cancel():
                        raise CancelledError("synthesis cancelled")
                    cfg = self._generate_config(chunk, deadline)
                    # Every chunk (see the non-streaming continuity loop).
                    conditioning.apply_to(cfg)
                    blocks, next_state = self.runtime.stream_generate_session(chunk.token_ids, cfg, cont)
                    yield from _stream_pcm_chunks(blocks, i, i == len(chunks) - 1)
                    cont = next_state()
            return

        for i, chunk in enumerate(chunks):
            if cancel is not None and cancel():
                raise CancelledError("synthesis cancelled")
            cfg = self._generate_config(chunk, deadline)
            conditioning.apply_to(cfg)
            last_chunk = i == len(chunks) - 1
            if use_frames:
                if hasattr(self.runtime, "stream_generate"):
                    # Concurrency-native runtime: streams through the shared
                    # batch, no service lock needed.
                    yield from _stream_pcm_chunks(self.runtime.stream_generate(chunk.token_ids, cfg), i, last_chunk)
                    continue
                # Yield as blocks arrive (the time-to-first-audio path). The
                # lock is held across the chunk, as the reference holds a
                # worker slot for the whole request.
                with self._lock:
                    yield from _stream_pcm_chunks(stream_generate(self.runtime, chunk.token_ids, cfg), i, last_chunk)
            else:
                with self._lock:
                    pcm = self.runtime.generate_audio(chunk.token_ids, cfg)
                yield PCMChunk(samples=pcm, chunk_index=i, final=last_chunk)

    def prewarm(self, token_lengths=(10, 30, 50), voice_paths=()) -> None:
        """Run the common shape buckets once before serving traffic.

        A first request of a bucket pays for capturing the runtime's CUDA
        graphs of that bucket (``runtime/graphs.py``: the prefill of its
        token bucket and capacity, the AR segments, the decode), as the
        reference's pays a compile, and the first request of a process for
        building or loading the kernel libraries and the caching
        allocator's first blocks; after this, a request of a warmed bucket
        captures nothing. Sessions capture their own prefill (a given
        cache) and capacities, so one plain and one streamed session of two
        chunks run too. Voices take their own buckets, so pass the serving
        voices' files in ``voice_paths`` (``serve --prewarm`` passes every
        voice in the manifest). A runtime with a ``prewarm`` of its own (the
        continuous batcher) runs its own traffic shapes (the admission at
        both lane counts, the AR blocks, the stream decode and its lane
        reset, the harvest decodes it reaches), then one plain session of
        two chunks (the slot prefill and the lane snapshot).
        """
        own = getattr(self.runtime, "prewarm", None)
        if own is not None:
            own(token_lengths)
            # Clients can ask for continuity per request ({"continuity":
            # true}) even when the server default is off.
            if hasattr(self.runtime, "generate_audio_session"):
                cfg = self._generate_config(ChunkMetadata(text="", token_ids=[0, 0, 0], num_tokens=3, num_words=3))
                cfg.max_steps = 2
                cfg.eos_threshold = 1e9  # pin the step count during warmup
                _pcm, cont = self.runtime.generate_audio_session([0, 0, 0], cfg, None)
                if cont is not None:
                    self.runtime.generate_audio_session([0, 0, 0], cfg, cont)
                log.info("prewarmed continuity session path")
            self._prewarm_voices(voice_paths, token_lengths)
            return
        gen = getattr(self.runtime, "generate_audio", None)
        if gen is None:
            return
        for n in token_lengths:
            cfg = self._generate_config(ChunkMetadata(text="", token_ids=[0] * n, num_tokens=n, num_words=n))
            cfg.max_steps = cfg.estimated_max_steps
            with self._lock:
                gen([0] * n, cfg)
            log.info("prewarmed bucket for %d tokens", n)
        # Continuity (plain and streamed sessions): clients can opt in per
        # request ({"continuity": true}) even when the server default is off.
        if hasattr(self.runtime, "generate_audio_session"):
            cfg = self._generate_config(ChunkMetadata(text="", token_ids=[0, 0, 0], num_tokens=3, num_words=3))
            cfg.max_steps = 2
            cfg.eos_threshold = 1e9  # pin the step count during warmup
            with self._lock:
                _pcm, cont = self.runtime.generate_audio_session([0, 0, 0], cfg, None)
                if cont is not None:
                    _pcm, cont = self.runtime.generate_audio_session([0, 0, 0], cfg, cont)
                if hasattr(self.runtime, "stream_generate_session"):
                    # 4+8+16: every adaptive segment size, fresh and carried.
                    cfg.max_steps = 28
                    blocks, next_state = self.runtime.stream_generate_session([0, 0, 0], cfg, None)
                    for _ in blocks:
                        pass
                    blocks, _ = self.runtime.stream_generate_session([0, 0, 0], cfg, next_state())
                    for _ in blocks:
                        pass
            log.info("prewarmed continuity session path")
        self._prewarm_voices(voice_paths, token_lengths)

    def prewarm_voice(self, voice_path: str, token_lengths=(10, 30, 50)) -> bool:
        """Warm one voice's conditioning buckets; True if fully warmed."""
        return self._prewarm_voices([voice_path], token_lengths) == 1

    def _prewarm_voices(self, voice_paths, token_lengths) -> int:
        """Warm voice-conditioned buckets (see ``prewarm``); returns how many
        voices warmed fully.

        Best-effort: a voice that fails to load or exceeds capacity is
        skipped with a warning — prewarm must never block serving."""
        warmed = 0
        gen = getattr(self.runtime, "generate_audio", None)
        if gen is None:
            return warmed
        for vp in voice_paths:
            try:
                conditioning = load_voice_conditioning(vp)
            except Exception as exc:  # noqa: BLE001 - warm-up only
                log.warning("prewarm: voice %r skipped (%s)", vp, exc)
                continue
            # Embedding voices shift the prompt width by their length, so
            # the warm token counts must land in each prompt bucket at that
            # offset as well as in each plain token bucket (the single
            # runtime buckets the token count alone; the batcher folds the
            # voice into the prompt bucket).
            voice_len = 0 if conditioning.embedding is None else int(np.asarray(conditioning.embedding).shape[-2])
            warm_lengths, prev = set(), 0
            for b in bk.PROMPT_BUCKETS:
                n = max(prev + 1 - voice_len, 1)
                if n <= MAX_TOKENS_PER_CHUNK and bk.pick_bucket(n + voice_len, bk.PROMPT_BUCKETS) == b:
                    warm_lengths.add(n)
                if prev + 1 <= MAX_TOKENS_PER_CHUNK:
                    warm_lengths.add(prev + 1)
                prev = b
            warm_lengths = sorted(warm_lengths) or [1]
            # With a batcher, warm every length at both admission counts (1
            # and all slots) by submitting a whole wave.
            batcher = getattr(self.runtime, "batcher", None)
            fully_warmed = True
            for n in warm_lengths:
                cfg = self._generate_config(ChunkMetadata(text="", token_ids=[0] * n, num_tokens=n, num_words=n))
                cfg.max_steps = 2
                cfg.eos_threshold = 1e9
                conditioning.apply_to(cfg)
                try:
                    if batcher is not None and batcher.slots > 1:
                        futs = [batcher.submit([0] * n, cfg) for _ in range(batcher.slots)]
                        for f in futs:
                            f.result(timeout=600)
                    with self._lock:
                        gen([0] * n, cfg)
                except Exception as exc:  # noqa: BLE001 - warm-up only
                    log.warning("prewarm: voice %r at %d tokens skipped (%s)", vp, n, exc)
                    fully_warmed = False
                    break
            if fully_warmed:
                warmed += 1
                log.info("prewarmed voice conditioning: %s", vp)
            else:
                log.warning("prewarm: voice %r only partially warmed", vp)
        return warmed

    def close(self) -> None:
        close = getattr(self.runtime, "close", None)
        if close is not None:
            close()
