"""In-memory kernel API: load everything from bytes, synthesize as a library
(counterpart of the reference package's ``kernel.py``).

This is the capability the reference's browser-WASM kernel exposes
(`cmd/pockettts-wasm/main_wasm.go:75-477`: JS global ``PocketTTSKernel`` with
``version / sampleRate / loadModel / normalize / tokenize / synthesize`` and
per-step progress callbacks). The embedding surface is preserved: no
filesystem access required, voice bytes accepted in either format, progress
callbacks per block of frames, carried prosody with ``continuity``.

Synthesis runs :class:`runtime.GPURuntime` on ``device`` (default ``"cuda"``;
raises without CUDA, ``"cpu"`` runs the kernels' plain versions there), so
the one-shot route launches the decode-attention and SEANet kernels and the
``progress`` route the streamed SEANet cascade.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, List, Optional, Union

import numpy as np
import torch

from go_pocket_tts_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from go_pocket_tts_tpu_torch.kernels import build
from go_pocket_tts_tpu_torch.models.model import load_model_from_store
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime
from go_pocket_tts_tpu_torch.runtime.streaming import stream_generate
from go_pocket_tts_tpu_torch.text import estimate_max_frames, normalize as normalize_text, prepare_chunks
from go_pocket_tts_tpu_torch.text.sentencepiece import load_tokenizer_from_bytes
from go_pocket_tts_tpu_torch.utils import safetensors as st
from go_pocket_tts_tpu_torch.utils import wav
from go_pocket_tts_tpu_torch.version import __version__

__all__ = ["PocketTTSKernel"]


class PocketTTSKernel:
    """Byte-oriented synthesis kernel.

    >>> kernel = PocketTTSKernel()
    >>> kernel.load_model(model_bytes, tokenizer_bytes)
    >>> wav_bytes = kernel.synthesize("Hello world", voice=voice_bytes)

    ``compile_cache_dir`` names the directory of the built CUDA kernel
    libraries (``None`` or ``""``: the package's ``_build/``); like the
    reference's compile cache it is process-wide.
    """

    version = __version__
    sample_rate = 24_000

    def __init__(
        self,
        dtype="float32",
        seed: Optional[int] = None,
        compile_cache_dir: Optional[str] = None,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
    ) -> None:
        self._dtype = dtype
        self._seed = seed
        self._compile_cache_dir = compile_cache_dir
        self._device = resolve_device(device)
        self._runtime: Optional[GPURuntime] = None
        self._tokenizer = None

    @property
    def loaded(self) -> bool:
        return self._runtime is not None

    def load_model(self, model_bytes: bytes, tokenizer_bytes: bytes) -> None:
        if self._compile_cache_dir:
            build.BUILD_DIR = Path(self._compile_cache_dir)
        dtype = torch.bfloat16 if self._dtype == "bfloat16" else torch.float32
        store = st.open_store_from_bytes(model_bytes)
        model = load_model_from_store(store, device=self._device, dtype=dtype)
        self._runtime = GPURuntime(model, dtype=dtype, seed=self._seed, device=self._device)
        self._tokenizer = load_tokenizer_from_bytes(tokenizer_bytes)

    def normalize(self, text: str) -> str:
        return normalize_text(text)

    def tokenize(self, text: str) -> List[int]:
        self._require_loaded()
        return self._tokenizer.encode(text)

    def synthesize(
        self,
        text: str,
        voice: Optional[bytes] = None,
        temperature: float = 0.7,
        eos_threshold: float = -4.0,
        lsd_decode_steps: int = 1,
        progress: Optional[Callable[[int, int], None]] = None,
        continuity: bool = False,
    ) -> bytes:
        """Synthesize → WAV bytes. ``voice`` accepts either voice-file format
        (embedding or model-state), like the WASM kernel's voice bytes.

        ``progress(frames_done, frames_total_estimate)`` fires at frame-block
        granularity (every 4–16 generated frames ≈ 320 ms–1.28 s of audio)
        through the frame-streaming path — the reference's per-step progress
        contract (`cmd/pockettts-wasm/main_wasm.go:75-477`) at the finest
        granularity that doesn't force a per-frame host sync. The total
        is the frame estimate and shrinks when EOS ends a chunk early; the
        final call is always ``(total, total)``.

        ``continuity=True`` carries the flow-LM KV state across text chunks
        (long-form prosody); progress keeps block granularity there too via
        the session-aware frame streamer."""
        self._require_loaded()
        voice_emb = voice_state = None
        if voice:
            kind = st.inspect_voice_file_bytes(voice)
            if kind == st.VoiceFileKind.MODEL_STATE:
                voice_state = st.load_voice_model_state_from_bytes(voice)
            else:
                voice_emb = st.load_voice_embedding_from_bytes(voice)

        chunks = prepare_chunks(self.normalize(text), self._tokenizer)
        estimates = [estimate_max_frames(c.num_tokens) for c in chunks]
        total_est = sum(estimates)
        samples_per = self._runtime.model.config.mimi.samples_per_latent

        if continuity:
            cont = None
            done = 0
            parts: List[np.ndarray] = []
            for i, chunk in enumerate(chunks):
                cfg = GenerateConfig(
                    temperature=temperature,
                    eos_threshold=eos_threshold,
                    max_steps=estimates[i],
                    lsd_decode_steps=lsd_decode_steps,
                    frames_after_eos=chunk.frames_after_eos(),
                    # every chunk: re-applies on an internal session reset;
                    # ignored while carried state survives (service semantics)
                    voice_embedding=voice_emb,
                    voice_model_state=voice_state,
                )
                if progress is None:
                    pcm, cont = self._runtime.generate_audio_session(
                        chunk.token_ids, cfg, cont
                    )
                    parts.append(pcm)
                    done += len(pcm) // samples_per
                    continue
                # Session-aware frame streaming: block-granular progress with
                # carried prosody (blocks concatenate to the session audio).
                blocks, next_state = self._runtime.stream_generate_session(
                    chunk.token_ids, cfg, cont
                )
                chunk_frames = 0
                for block in blocks:
                    parts.append(block)
                    chunk_frames += len(block) // samples_per
                    remaining = max(estimates[i] - chunk_frames, 0)
                    progress(
                        done + chunk_frames,
                        done + chunk_frames + remaining + sum(estimates[i + 1 :]),
                    )
                cont = next_state()
                done += chunk_frames
            if progress is not None:
                progress(done, done)
            pcm_all = np.concatenate(parts) if parts else np.zeros(0, np.float32)
            return wav.encode_wav(pcm_all, self.sample_rate)

        done_frames = 0
        samples: List[np.ndarray] = []
        for i, chunk in enumerate(chunks):
            cfg = GenerateConfig(
                temperature=temperature,
                eos_threshold=eos_threshold,
                max_steps=estimates[i],
                lsd_decode_steps=lsd_decode_steps,
                frames_after_eos=chunk.frames_after_eos(),
                voice_embedding=voice_emb,
                voice_model_state=voice_state,
            )
            if progress is None:
                samples.append(self._runtime.generate_audio(chunk.token_ids, cfg))
                continue
            # Frame streaming gives block-granular progress for free; the
            # blocks concatenate to the same chunk audio.
            parts: List[np.ndarray] = []
            chunk_frames = 0
            for block in stream_generate(self._runtime, chunk.token_ids, cfg):
                parts.append(block)
                chunk_frames += len(block) // samples_per
                progress(done_frames + chunk_frames, total_est)
            done_frames += chunk_frames
            # EOS can end the chunk early: shrink the estimate so the bar
            # never runs backwards and the final call is (total, total).
            total_est -= estimates[i] - chunk_frames
            samples.append(
                np.concatenate(parts) if parts else np.zeros(0, np.float32)
            )
        if progress is not None:
            progress(done_frames, done_frames)
        pcm = np.concatenate(samples) if samples else np.zeros(0, np.float32)
        return wav.encode_wav(pcm, self.sample_rate)

    def _require_loaded(self) -> None:
        if self._runtime is None or self._tokenizer is None:
            raise RuntimeError("kernel: loadModel must be called first")
