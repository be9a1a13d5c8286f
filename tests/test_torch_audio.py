"""The port's audio I/O against the JAX package's on the same float32 PCM:
WAV encode/decode, the streaming WAV header, PCM16 bytes, the FLAC
encoders (whole and streamed, byte for byte) and the DSP chain (within
1e-6)."""

import struct

import numpy as np
import pytest

from go_pocket_tts_tpu.utils import dsp as j_dsp
from go_pocket_tts_tpu.utils import flac as j_flac
from go_pocket_tts_tpu.utils import wav as j_wav
from go_pocket_tts_tpu_torch.utils import dsp as t_dsp
from go_pocket_tts_tpu_torch.utils import flac as t_flac
from go_pocket_tts_tpu_torch.utils import wav as t_wav


def _pcm(kind: str) -> np.ndarray:
    rng = np.random.RandomState(5)
    if kind == "speech":  # a random walk, as speech-like as noise gets
        return (np.cumsum(rng.randn(24000)) * 0.01).astype(np.float32)
    if kind == "clipping":  # well past [-1, 1] on both sides
        return (rng.randn(4000) * 3.0).astype(np.float32)
    if kind == "edges":
        return np.array(
            [1.0, -1.0, 0.0, -0.0, 1 / 32767, -1 / 32767, 0.99999, -0.99999, 1.0000001, -1.0000001, 2.0, -2.0,
             0.5, -0.5, 3e-5, -3e-5, np.finfo(np.float32).tiny, 1e30, -1e30],
            np.float32,
        )
    if kind == "silence":
        return np.zeros(1920, np.float32)
    if kind == "empty":
        return np.zeros(0, np.float32)
    if kind == "sine":
        return (0.8 * np.sin(np.arange(9600) * 2 * np.pi * 440 / 24000)).astype(np.float32)
    raise ValueError(kind)


KINDS = ["speech", "clipping", "edges", "silence", "empty", "sine"]


@pytest.mark.parametrize("kind", KINDS)
def test_wav_bytes_and_decode_match(kind):
    x = _pcm(kind)
    assert t_wav.pcm16_bytes(x) == j_wav.pcm16_bytes(x)
    body = t_wav.encode_wav(x)
    assert body == j_wav.encode_wav(x)
    got, rate = t_wav.decode_wav(body)
    want, want_rate = j_wav.decode_wav(body)
    assert rate == want_rate == 24000
    np.testing.assert_array_equal(got, want)
    assert t_wav.wav_duration_seconds(body) == j_wav.wav_duration_seconds(body)


@pytest.mark.parametrize("rate,channels,bits", [(24000, 1, 16), (48000, 2, 16), (16000, 1, 32)])
def test_streaming_header_matches(rate, channels, bits):
    assert t_wav.streaming_wav_header(rate, channels, bits) == j_wav.streaming_wav_header(rate, channels, bits)
    stream = t_wav.streaming_wav_header() + t_wav.pcm16_bytes(_pcm("speech")[:500])
    np.testing.assert_array_equal(t_wav.decode_wav(stream)[0], j_wav.decode_wav(stream)[0])


def _wav(payload: bytes, fmt: int, channels: int, bits: int, rate: int = 24000) -> bytes:
    block = channels * bits // 8
    fmt_chunk = struct.pack("<HHIIHH", fmt, channels, rate, rate * block, block, bits)
    return (
        b"RIFF" + struct.pack("<I", 36 + len(payload)) + b"WAVE" + b"fmt " + struct.pack("<I", 16) + fmt_chunk
        + b"data" + struct.pack("<I", len(payload)) + payload
    )


def test_decode_of_stereo_float_and_garbage_matches():
    rng = np.random.RandomState(1)
    stereo = _wav((rng.randn(400) * 8000).astype("<i2").tobytes(), 1, 2, 16)
    floats = _wav((rng.randn(300) * 0.3).astype("<f4").tobytes(), 3, 1, 32)
    for body in (stereo, floats):
        got, want = t_wav.decode_wav(body), j_wav.decode_wav(body)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]
    for bad in (b"", b"RIFF0000WAVE", b"x" * 64, _wav(b"\x00\x00", 1, 1, 8)):
        with pytest.raises(ValueError):
            j_wav.decode_wav(bad)
        with pytest.raises(ValueError):
            t_wav.decode_wav(bad)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("block_size", [4096, 1920])
def test_flac_bytes_match(kind, block_size):
    x = _pcm(kind)
    body = t_flac.encode_flac(x, block_size=block_size)
    assert body == j_flac.encode_flac(x, block_size=block_size)
    got, rate = t_flac.decode_flac(body)
    want, _ = j_flac.decode_flac(body)
    np.testing.assert_array_equal(got, want)
    assert rate == 24000


def test_flac_int16_input_matches():
    x = np.random.RandomState(0).randint(-32768, 32768, 5000).astype(np.int16)
    assert t_flac.encode_flac(x) == j_flac.encode_flac(x)


def test_flac_stream_bytes_match():
    x = _pcm("speech")
    t_enc, j_enc = t_flac.FlacStreamEncoder(), j_flac.FlacStreamEncoder()
    assert t_enc.header() == j_enc.header()
    body = t_enc.header()
    # Blocks of the streamed decoder's sizes (4, 8, 16 frames), an empty
    # one and one past FLAC's largest block.
    for n in (7680, 15360, 0, 1000, 70000):
        block = np.resize(x, n) if n else x[:0]
        got = t_enc.encode_block(block)
        assert got == j_enc.encode_block(block)
        body += got
    np.testing.assert_array_equal(t_flac.decode_flac(body)[0], j_flac.decode_flac(body)[0])


def test_flac_decoder_rejects_what_the_reference_rejects():
    body = bytearray(t_flac.encode_flac(_pcm("speech")[:5000]))
    body[100] ^= 0x40
    for bad in (b"", b"fLaC", bytes(body)):
        with pytest.raises(j_flac.FlacError):
            j_flac.decode_flac(bad)
        with pytest.raises(t_flac.FlacError):
            t_flac.decode_flac(bad)


@pytest.mark.parametrize("kind", ["speech", "clipping", "sine", "silence", "empty"])
def test_dsp_matches(kind):
    x = _pcm(kind)
    pairs = [
        (t_dsp.peak_normalize(x), j_dsp.peak_normalize(x)),
        (t_dsp.peak_normalize(x, 0.5), j_dsp.peak_normalize(x, 0.5)),
        (t_dsp.dc_block(x + 0.25), j_dsp.dc_block(x + 0.25)),
        (t_dsp.dc_block(x, cutoff_hz=80.0), j_dsp.dc_block(x, cutoff_hz=80.0)),
        (t_dsp.fade_in(x, ms=20.0), j_dsp.fade_in(x, ms=20.0)),
        (t_dsp.fade_out(x, ms=20.0), j_dsp.fade_out(x, ms=20.0)),
    ]
    for got, want in pairs:
        assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
