"""Runtime voice upload: WAV bytes → encoded, registered, prewarmed voice
(counterpart of ``go_pocket_tts_tpu/tts/voice_upload.py``).

``POST /voices`` clones a voice from speaker audio while the server runs:
the Mimi encoder (:mod:`models.mimi_encoder`) encodes it on the uploader's
device, the embedding lands in the upload directory, the live
``VoiceManager`` registers it, and the service warms its conditioning
shapes.

The endpoint is off unless ``serve --voice-upload-dir`` names a directory:
an open server must not accept file writes by default. Voice ids are held
to a filename-safe charset (the id becomes the file's name), and the audio's
size is capped before the body is read.
"""

from __future__ import annotations

import logging
import os
import re
import threading
from typing import Union

import numpy as np
import torch

from go_pocket_tts_tpu_torch.device import DEFAULT_DEVICE

__all__ = ["DuplicateVoice", "VoiceUploader"]

log = logging.getLogger("pockettts.voice_upload")

_ID_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9._-]{0,63}\Z")


class DuplicateVoice(ValueError):
    """The voice id is already registered (HTTP 409)."""


class VoiceUploader:
    """Encode, persist, register and prewarm uploaded speaker audio.

    The ``VoiceEncoder`` is built on the first upload (it reads the encoder
    weights from the model checkpoint), once, under a lock, on ``device``;
    encodes pad the audio to a frame bucket
    (``VoiceEncoder.encode_samples(pad_to_bucket=True)``).
    """

    def __init__(
        self,
        model_path: str,
        upload_dir: str,
        voices,
        service=None,
        max_audio_bytes: int = 16 << 20,
        prewarm: bool = True,
        device: Union[str, torch.device] = DEFAULT_DEVICE,
    ) -> None:
        self.model_path = model_path
        self.upload_dir = upload_dir
        self.voices = voices
        self.service = service
        self.max_audio_bytes = int(max_audio_bytes)
        self.prewarm = bool(prewarm)
        self.device = device
        self._encoder = None
        self._lock = threading.Lock()

    def _get_encoder(self):
        with self._lock:
            if self._encoder is None:
                from go_pocket_tts_tpu_torch.tts.voice_export import VoiceEncoder

                try:
                    self._encoder = VoiceEncoder(self.model_path, device=self.device)
                except ValueError as exc:
                    # A checkpoint without encoder weights or speaker
                    # projection is the server's problem, not a bad request.
                    raise RuntimeError(str(exc)) from exc
            return self._encoder

    def upload(self, voice_id: str, wav_bytes: bytes, license: str = "") -> dict:
        """The whole upload; returns the voice's JSON-ready record.

        Raises ``ValueError`` for bad input (id, audio), ``DuplicateVoice``
        for an id already registered, and ``RuntimeError`` for a fault on
        the server's side (a checkpoint without an encoder, a directory it
        cannot write).
        """
        if not voice_id or not _ID_RE.match(voice_id):
            raise ValueError("voice id must be 1-64 chars of [A-Za-z0-9._-] starting with a letter or digit")
        if len(wav_bytes) > self.max_audio_bytes:
            raise ValueError(f"voice audio exceeds maximum size of {self.max_audio_bytes} bytes")
        if any(v.id == voice_id for v in self.voices.list_voices()):
            raise DuplicateVoice(f"duplicate voice id {voice_id!r}")

        emb = self._get_encoder().encode_wav_bytes(wav_bytes, pad_to_bucket=True)
        frames = int(emb.shape[1])

        from go_pocket_tts_tpu_torch.utils.safetensors import write_file

        # Absolute: a manifest-backed VoiceManager resolves a relative path
        # against the manifest's directory, not the server's working one.
        path = os.path.abspath(os.path.join(self.upload_dir, f"{voice_id}.safetensors"))
        try:
            os.makedirs(self.upload_dir, exist_ok=True)
            write_file(path, {"audio_prompt": np.asarray(emb, np.float32)})
        except OSError as exc:
            raise RuntimeError(f"cannot write voice file: {exc}") from exc

        try:
            voice = self.voices.register(voice_id, path, license=license)
        except ValueError as exc:
            # Lost a registration race after the early check.
            raise DuplicateVoice(str(exc)) from exc

        prewarmed = False
        if self.prewarm and self.service is not None:
            warm = getattr(self.service, "prewarm_voice", None)
            if warm is not None:
                prewarmed = bool(warm(path))
        log.info("voice uploaded: id=%s frames=%d path=%s prewarmed=%s", voice_id, frames, path, prewarmed)
        return {"id": voice.id, "path": voice.path, "license": voice.license, "frames": frames, "prewarmed": prewarmed}
