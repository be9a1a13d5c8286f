"""WAV encode/decode for 24 kHz mono 16-bit PCM, plus streaming header writer.

Behaviour parity with the reference (`internal/audio/encode.go`, `decode.go`,
`wav_stream.go`):

- :func:`encode_wav` — float32 samples → complete RIFF/WAVE file bytes
  (16-bit PCM, clamp to [-1, 1]) (`encode.go:14-40`, `wav_stream.go:37-54`)
- :func:`decode_wav` — strict validation of format (PCM16) on decode; returns
  float32 samples + sample rate (`decode.go:12-53`); multi-channel input is
  downmixed to mono like the reference's voice-audio loader
  (`internal/onnx/voice_encode.go:244-294`)
- :func:`streaming_wav_header` — 44-byte header with ``0xFFFFFFFF``
  RIFF/data sizes, the unknown-length streaming convention
  (`wav_stream.go:15-35`)
- :func:`pcm16_bytes` — clamp/convert float32 → little-endian int16 frames
  (`wav_stream.go:37-54`)

A C++ fast path for the float32→int16 conversion lives in
``native/audioio.cpp``; :mod:`go_pocket_tts_tpu_torch.native` loads it
lazily and this module falls back to NumPy, which gives the same bytes,
when it is unavailable.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

__all__ = [
    "DEFAULT_SAMPLE_RATE",
    "encode_wav",
    "decode_wav",
    "streaming_wav_header",
    "pcm16_bytes",
    "wav_duration_seconds",
]

DEFAULT_SAMPLE_RATE = 24_000


def pcm16_bytes(samples: np.ndarray) -> bytes:
    """Clamp float32 samples to [-1, 1] and convert to LE int16 bytes."""
    from go_pocket_tts_tpu_torch.native import audioio

    native = audioio.load()
    if native is not None:
        return native.pcm16_from_f32(samples)
    x = np.clip(np.asarray(samples, dtype=np.float32), -1.0, 1.0)
    return (x * 32767.0).astype("<i2").tobytes()


def streaming_wav_header(
    sample_rate: int = DEFAULT_SAMPLE_RATE, channels: int = 1, bits: int = 16
) -> bytes:
    """44-byte WAV header with unknown-length (0xFFFFFFFF) sizes."""
    byte_rate = sample_rate * channels * bits // 8
    block_align = channels * bits // 8
    return b"".join(
        [
            b"RIFF",
            struct.pack("<I", 0xFFFFFFFF),
            b"WAVE",
            b"fmt ",
            struct.pack("<IHHIIHH", 16, 1, channels, sample_rate, byte_rate, block_align, bits),
            b"data",
            struct.pack("<I", 0xFFFFFFFF),
        ]
    )


def encode_wav(samples: np.ndarray, sample_rate: int = DEFAULT_SAMPLE_RATE) -> bytes:
    """Encode float32 mono samples as a complete 16-bit PCM WAV file."""
    pcm = pcm16_bytes(samples)
    data_size = len(pcm)
    header = b"".join(
        [
            b"RIFF",
            struct.pack("<I", 36 + data_size),
            b"WAVE",
            b"fmt ",
            struct.pack("<IHHIIHH", 16, 1, 1, sample_rate, sample_rate * 2, 2, 16),
            b"data",
            struct.pack("<I", data_size),
        ]
    )
    return header + pcm


def _walk_riff_chunks(data: bytes):
    """Yield (chunk_id, payload_offset, payload_size) for top-level RIFF chunks."""
    pos = 12
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        (size,) = struct.unpack_from("<I", data, pos + 4)
        yield cid, pos + 8, size
        # Chunks are word-aligned; unknown-length streaming chunks (0xFFFFFFFF)
        # consume the remainder of the file.
        if size == 0xFFFFFFFF:
            return
        pos += 8 + size + (size & 1)


def decode_wav(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a WAV file to float32 mono samples in [-1, 1] and sample rate.

    Accepts 16-bit PCM (strict, like the reference decoder) plus IEEE float32
    for fixture convenience. Multi-channel audio is downmixed by averaging.
    """
    if len(data) < 44 or data[0:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("wav: not a RIFF/WAVE file")

    fmt = None
    pcm = None
    for cid, off, size in _walk_riff_chunks(data):
        if cid == b"fmt ":
            if size < 16:
                raise ValueError("wav: fmt chunk too small")
            fmt = struct.unpack_from("<HHIIHH", data, off)
        elif cid == b"data":
            end = len(data) if size == 0xFFFFFFFF else min(off + size, len(data))
            pcm = data[off:end]
    if fmt is None or pcm is None:
        raise ValueError("wav: missing fmt or data chunk")

    audio_format, channels, sample_rate, _byte_rate, _block_align, bits = fmt
    if channels < 1:
        raise ValueError("wav: invalid channel count")

    if audio_format == 1 and bits == 16:
        x = np.frombuffer(pcm[: len(pcm) // 2 * 2], dtype="<i2").astype(np.float32) / 32768.0
    elif audio_format == 3 and bits == 32:
        x = np.frombuffer(pcm[: len(pcm) // 4 * 4], dtype="<f4").astype(np.float32)
    else:
        raise ValueError(f"wav: unsupported format (fmt={audio_format}, bits={bits})")

    if channels > 1:
        usable = len(x) // channels * channels
        x = x[:usable].reshape(-1, channels).mean(axis=1)
    return x, sample_rate


def wav_duration_seconds(data: bytes) -> float:
    """RIFF-walking duration probe (`internal/bench/bench.go` WAVDuration)."""
    samples, rate = decode_wav(data)
    return len(samples) / float(rate)
