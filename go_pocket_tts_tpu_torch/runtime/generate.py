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
masked), so the audio is the while_loop's exactly.

Shapes are bucketed as in the reference (``utils/buckets.py``), so caches
and buffers keep a few static sizes.
"""

from __future__ import annotations

import contextlib
import logging
import math
import time
from dataclasses import dataclass
from typing import Callable, Iterator, Optional, Tuple, Union

import numpy as np
import torch

from go_pocket_tts_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from go_pocket_tts_tpu_torch.models import flow_lm as flm
from go_pocket_tts_tpu_torch.models import flow_transformer as ftr
from go_pocket_tts_tpu_torch.models.model import PocketTTSModel
from go_pocket_tts_tpu_torch.models.quantize import quantize_model_params
from go_pocket_tts_tpu_torch.utils import buckets as bk

log = logging.getLogger("pockettts.torch.runtime")

__all__ = ["GenerateConfig", "GPURuntime", "decode_pcm16", "estimate_max_frames", "quantized_model"]

DEFAULT_MIMI_FRAME_RATE = 12.5


def estimate_max_frames(token_count: int, frame_rate: float = DEFAULT_MIMI_FRAME_RATE) -> int:
    """Frame budget for a chunk of ``token_count`` tokens (a copy of the
    reference's ``text.prepare.estimate_max_frames``)."""
    token_count = max(token_count, 0)
    if not (frame_rate > 0) or math.isinf(frame_rate):
        frame_rate = DEFAULT_MIMI_FRAME_RATE
    return int(math.ceil((token_count / 3.0 + 2.0) * frame_rate))


@dataclass
class GenerateConfig:
    """Per-chunk generation parameters (the reference's, without the voice
    conditioning fields, which this slice does not port)."""

    temperature: float = 0.7
    eos_threshold: float = -4.0
    max_steps: int = 0
    estimated_max_steps: int = 0
    lsd_decode_steps: int = 1
    frames_after_eos: int = 3
    # Called after generation with (frames, max_steps).
    step_callback: Optional[Callable[[int, int], None]] = None


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


def decode_pcm16(
    model: PocketTTSModel, frames: torch.Tensor, n_frames: torch.Tensor, decode_frames: int
) -> torch.Tensor:
    """Mask → fused latent→mimi → Mimi decode → int16
    ``[B, 1, decode_frames·1920]`` of ``frames [B, W, L]``; frames at or past
    a lane's ``n_frames`` are zeroed, and the host trims each lane to
    ``n_frames·1920`` samples."""
    frames = frames[:, :decode_frames]
    mask = (torch.arange(decode_frames, device=frames.device) < n_frames[:, None])[:, :, None]
    latent = torch.where(mask, frames, torch.zeros((), dtype=frames.dtype, device=frames.device))
    pcm = model.mimi_decode(model.latent_to_mimi(latent))
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

    def _prefill(self, tokens_padded: torch.Tensor, n_tokens: int, capacity: int):
        flow = self.model.params["flow_lm"]
        flow_cfg = self.model.config.flow_lm
        emb = flm.text_embeddings(flow, tokens_padded).to(self.dtype)
        cache = ftr.init_kv_cache(
            flow_cfg.transformer, tokens_padded.shape[0], capacity, self.dtype, self.device
        )
        # Padded token slots embed row 0 of the LUT; they sit past the
        # offset and are never visible.
        return flm.prompt(flow, flow_cfg, cache, emb, n_tokens)

    def _ar_loop(self, cache, cfg: GenerateConfig, max_steps: int, decode_steps: int, max_frames: int):
        """Up to ``min(max_steps, max_frames)`` AR steps; returns
        (frames [B, max_frames, L], n_frames [B] int32), both on the device."""
        flow = self.model.params["flow_lm"]
        flow_cfg = self.model.config.flow_lm
        batch = cache["k"].shape[1]
        latent_dim = flow["bos_emb"].shape[0]
        dev, dtype = self.device, self.dtype

        sigma = math.sqrt(max(float(cfg.temperature), 0.0))
        gen = self._request_generator() if sigma > 0 else None
        time_cond = self._time_conditioning(decode_steps)

        # BOS sentinel: a NaN frame, replaced by bos_emb inside the step.
        frame = torch.full((batch, 1, latent_dim), float("nan"), dtype=dtype, device=dev)
        frames = torch.zeros((batch, max_frames, latent_dim), dtype=dtype, device=dev)
        n_frames = torch.zeros((batch,), dtype=torch.int32, device=dev)
        countdown = torch.full((batch,), -1, dtype=torch.int32, device=dev)  # -1: no EOS yet
        done = torch.zeros((batch,), dtype=torch.bool, device=dev)
        zero_noise = torch.zeros((batch, latent_dim), dtype=dtype, device=dev)

        for step in range(min(max_steps, max_frames)):
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
            if (step + 1) % self.SYNC_EVERY == 0 and bool(done.all()):
                break
        return frames, n_frames

    def _decode_pcm16(self, frames: torch.Tensor, n_frames: torch.Tensor, decode_frames: int):
        return decode_pcm16(self.model, frames, n_frames, decode_frames)

    # -- entry point -------------------------------------------------------

    def generate_audio(self, tokens, cfg: GenerateConfig) -> np.ndarray:
        """Synthesize one chunk of token ids → float32 PCM at 24 kHz."""
        t0 = time.perf_counter()
        if len(tokens) == 0:
            raise ValueError("generate: token slice must not be empty")
        max_steps = cfg.max_steps or cfg.estimated_max_steps or estimate_max_frames(len(tokens))
        decode_steps = max(cfg.lsd_decode_steps, 1)

        tok_np = np.asarray(tokens, np.int64)
        n_bins = self.model.params["flow_lm"]["conditioner_embed"].shape[0]
        if np.any(tok_np < 0) or np.any(tok_np >= n_bins):
            raise ValueError(f"token id out of range [0,{n_bins})")

        frame_bucket = bk.pick_bucket(max_steps + 1, (self.frame_bucket, 512, 1024))
        token_bucket = bk.pick_bucket(len(tok_np), bk.PROMPT_BUCKETS)
        capacity = bk.round_up(token_bucket, 64) + frame_bucket
        tokens_padded = np.zeros((1, token_bucket), np.int64)
        tokens_padded[0, : len(tok_np)] = tok_np

        with torch.inference_mode(), _full_f32(self.dtype == torch.float32):
            cache = self._prefill(
                torch.from_numpy(tokens_padded).to(self.device), len(tok_np), capacity
            )
            frames, n_frames = self._ar_loop(cache, cfg, max_steps, decode_steps, frame_bucket)
            pcm = self._decode_pcm16(
                frames, n_frames, min(bk.round_up(max_steps, 32), frame_bucket)
            )
            n = int(n_frames[0])
            samples_per = self.model.config.mimi.samples_per_latent
            audio = pcm[0, 0, : n * samples_per].cpu().numpy().astype(np.float32) / 32767.0

        if cfg.step_callback is not None:
            cfg.step_callback(n, max_steps)
        log.debug(
            "generation complete: tokens=%d frames=%d total=%.1fms",
            len(tok_np),
            n,
            (time.perf_counter() - t0) * 1e3,
        )
        return audio
