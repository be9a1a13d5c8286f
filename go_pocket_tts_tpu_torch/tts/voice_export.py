"""Voice export: speaker audio → voice file (counterpart of
``go_pocket_tts_tpu/tts/voice_export.py``).

1. decode the WAV to mono float32 (a linear resampler brings other rates
   to 24 kHz);
2. Mimi-encode it to the embedding ``[1, C, T]`` at 12.5 Hz
   (:mod:`models.mimi_encoder`);
3. lay it out as ``[1, T, C]`` and project it with the checkpoint's speaker
   projection to the conditioning ``[1, T, d_model]``;
4. write ``{audio_prompt: [1, T, D]}``, or, for the model-state format,
   prefill the FlowLM transformer with it and write each layer's KV cache
   in the upstream layout.

Encodes and prefills run in true float32 whatever the TF32 flags of the
caller's process (:func:`device.exact_float32`), as the reference computes
them on the CPU.
"""

from __future__ import annotations

import os
from typing import Mapping, Union

import numpy as np
import torch

from go_pocket_tts_tpu_torch.device import DEFAULT_DEVICE, exact_float32, resolve_device
from go_pocket_tts_tpu_torch.models import mimi_encoder as enc
from go_pocket_tts_tpu_torch.models.mimi import MimiConfig, load_mimi
from go_pocket_tts_tpu_torch.models.model import cast_params
from go_pocket_tts_tpu_torch.models.params import VarBuilder
from go_pocket_tts_tpu_torch.utils import wav as wavmod
from go_pocket_tts_tpu_torch.utils.safetensors import (
    VoiceFileKind,
    inspect_voice_file,
    load_file,
    load_voice_model_state,
    write_file,
)

__all__ = ["VoiceEncoder", "export_voice_embedding", "export_voice_model_state", "resample_linear"]

Checkpoint = Union[str, os.PathLike, Mapping[str, np.ndarray]]


def resample_linear(samples: np.ndarray, src_rate: int, dst_rate: int) -> np.ndarray:
    if src_rate == dst_rate:
        return samples
    n_out = int(round(len(samples) * dst_rate / src_rate))
    x_out = np.linspace(0.0, len(samples) - 1, n_out)
    return np.interp(x_out, np.arange(len(samples)), samples).astype(np.float32)


def _tensors(checkpoint: Checkpoint) -> Mapping[str, np.ndarray]:
    return load_file(checkpoint) if isinstance(checkpoint, (str, os.PathLike)) else checkpoint


class VoiceEncoder:
    """The Mimi encoder and the speaker projection of a checkpoint (a path
    or its tensors), float32 on ``device``."""

    def __init__(
        self, checkpoint: Checkpoint, mimi_cfg: MimiConfig = MimiConfig(), device: Union[str, torch.device] = DEFAULT_DEVICE
    ) -> None:
        self.device = resolve_device(device)
        vb = VarBuilder(_tensors(checkpoint))
        # Adopt the checkpoint's upsample grouping, as the decoder does.
        _, self.cfg = load_mimi(vb, mimi_cfg)
        encoder = enc.load_mimi_encoder(vb, self.cfg)
        if encoder is None:
            raise ValueError(
                "checkpoint has no Mimi encoder weights (voice cloning needs the "
                "full checkpoint, not the no-voice-cloning variant)"
            )
        proj = enc.load_speaker_projection(vb)
        if proj is None:
            raise ValueError(
                "checkpoint missing speaker projection "
                "(condition_provider.conditioners.speaker_wavs.output_proj.weight)"
            )
        self.encoder = cast_params(encoder, self.device, torch.float32)
        self.speaker_proj = proj.to(self.device)
        # The most latent frames one encode takes: the encoder's RoPE table
        # covers 8192 steps at 200 Hz, 512 frames (40.96 s).
        self.max_frames = enc.ROPE_ROWS // self.cfg.steps_per_latent

    def encode_samples(self, samples: np.ndarray, sample_rate: int, pad_to_bucket: bool = False) -> np.ndarray:
        """Mono samples → speaker conditioning ``[1, T, d_model]`` float32,
        T = whole 1920-sample frames of the audio at 24 kHz.

        ``pad_to_bucket=True`` zero-pads the audio to a power-of-two frame
        bucket (64, 128, 256 or 512 frames) and trims the frames back after
        the encode: the encoder is causal, so the kept frames are those of
        the unpadded encode, and uploads run on four shapes.
        Audio shorter than one frame, or longer than ``max_frames`` frames,
        raises ``ValueError`` before any encode."""
        if sample_rate != self.cfg.sample_rate:
            samples = resample_linear(samples, sample_rate, self.cfg.sample_rate)
        spf = self.cfg.samples_per_latent
        frames = len(samples) // spf
        if frames < 1:
            raise ValueError(
                f"voice audio is shorter than one latent frame ({spf} samples at {self.cfg.sample_rate} Hz)"
            )
        if frames > self.max_frames:
            raise ValueError(
                f"voice audio of {len(samples) / self.cfg.sample_rate:.2f} s ({frames} frames) exceeds the "
                f"encoder's limit of {self.max_frames} frames ({self.max_frames * spf / self.cfg.sample_rate:.2f} s)"
            )
        if pad_to_bucket:
            bucket = 64
            while bucket < frames:
                bucket *= 2
            # The samples past the last whole frame reach no kept frame.
            padded = np.zeros(bucket * spf, np.float32)
            padded[: frames * spf] = samples[: frames * spf]
            samples = padded
        pcm = torch.from_numpy(np.ascontiguousarray(samples, dtype=np.float32)).to(self.device)[None, None, :]
        with torch.inference_mode(), exact_float32():
            emb = enc.mimi_encode(self.encoder, self.cfg, pcm)  # [1, C, T]
            proj = torch.matmul(emb.transpose(1, 2), self.speaker_proj.T)  # [1, T, D]
            out = proj.cpu().numpy()
        return out[:, :frames, :] if pad_to_bucket else out

    def encode_wav_bytes(self, data: bytes, pad_to_bucket: bool = False) -> np.ndarray:
        samples, rate = wavmod.decode_wav(data)
        return self.encode_samples(samples, rate, pad_to_bucket=pad_to_bucket)


def _encode_file(tensors: Mapping[str, np.ndarray], input_audio: str, device) -> np.ndarray:
    with open(input_audio, "rb") as f:
        return VoiceEncoder(tensors, device=device).encode_wav_bytes(f.read())


def export_voice_embedding(
    model_path: str, input_audio: str, output_path: str, device: Union[str, torch.device] = DEFAULT_DEVICE
) -> np.ndarray:
    """The export-voice flow; writes and returns the ``[1, T, D]``
    embedding."""
    emb = _encode_file(load_file(model_path), input_audio, resolve_device(device))
    write_file(output_path, {"audio_prompt": emb})
    return emb


def export_voice_model_state(
    model_path: str,
    input_audio: str,
    output_path: str,
    num_heads: int = 16,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
) -> int:
    """Export an upstream-format model-state voice file: the speaker
    conditioning ``[1, T, D]`` prefilled through the FlowLM transformer
    (float32), each layer's KV cache saved as
    ``transformer.layers.N.self_attn/cache`` ``[2, B, T, H, Dh]`` (K then V,
    time-major) and ``.../offset`` ``[T]``. Returns T, the offset."""
    from go_pocket_tts_tpu_torch.models import flow_lm as flm
    from go_pocket_tts_tpu_torch.models import flow_transformer as ftr
    from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors

    dev = resolve_device(device)
    tensors = load_file(model_path)
    emb = _encode_file(tensors, input_audio, dev)
    t_v = emb.shape[1]

    model = load_model_from_tensors(tensors, num_heads=num_heads, device=dev)
    cfg = model.config.flow_lm
    tcfg = cfg.transformer
    cache = ftr.init_kv_cache(tcfg, batch=1, capacity=t_v, device=dev)
    with torch.inference_mode(), exact_float32():
        cache = flm.prompt(model.params["flow_lm"], cfg, cache, torch.from_numpy(emb).to(dev))
        k_all = cache["k"].cpu().numpy()  # [L, 1, H, T, Dh]
        v_all = cache["v"].cpu().numpy()

    out = {}
    for i in range(tcfg.num_layers):
        # [B, H, T, Dh] → upstream time-major [B, T, H, Dh], K and V stacked.
        module = f"transformer.layers.{i}.self_attn"
        out[f"{module}/cache"] = np.stack([np.moveaxis(k_all[i], 1, 2), np.moveaxis(v_all[i], 1, 2)])
        out[f"{module}/offset"] = np.array([float(t_v)], np.float32)
    write_file(output_path, out)

    # The written file must classify and load as model state.
    if inspect_voice_file(output_path) != VoiceFileKind.MODEL_STATE:
        raise RuntimeError(f"exported voice file {output_path!r} failed kind check")
    load_voice_model_state(output_path)
    return t_v
