"""The port's native audio helper against the JAX package's: the same C++
functions, bit for bit, on every entry point; the port's WAV and FLAC bytes
and DC-block output with the helper and without it; and a failed build
falls back to the NumPy paths."""

import ctypes
import os
import subprocess

import numpy as np
import pytest

from go_pocket_tts_tpu.native import audioio as j_audioio
from go_pocket_tts_tpu.utils import dsp as j_dsp
from go_pocket_tts_tpu.utils import flac as j_flac
from go_pocket_tts_tpu.utils import wav as j_wav
from go_pocket_tts_tpu_torch.native import audioio
from go_pocket_tts_tpu_torch.utils import dsp, flac, wav


def _samples(n: int = 24_000, seed: int = 0) -> np.ndarray:
    """Speech-like noise plus the values that expose rounding modes (x.5
    products, the clamp edges, tiny magnitudes)."""
    edges = np.array(
        [0.25, -0.75, 2.0, -2.0, 0.0, 1.0, -1.0, 0.9999, -0.9999, 0.5 / 32767, -0.5 / 32767, 12345.5 / 32767],
        np.float32,
    )
    rng = np.random.RandomState(seed)
    return np.concatenate([edges, (rng.randn(n) * 0.3).astype(np.float32)])


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """The port's helper as the port loads it, and the JAX package's C++
    source built here by the same compiler and bound by its own wrapper
    (built apart from its source tree, which other test processes build
    into at the same time)."""
    port = audioio.load()
    assert port is not None, "the port's helper did not build with g++"
    ref_path = tmp_path_factory.mktemp("jax_native") / "libaudioio.so"
    source = os.path.join(os.path.dirname(j_audioio.__file__), "audioio.cpp")
    subprocess.run(["g++", *audioio.CXX_FLAGS, "-o", str(ref_path), source], check=True, timeout=120)
    return port, j_audioio._AudioIO(ctypes.CDLL(str(ref_path)))


def test_every_entry_point_is_bit_equal_to_the_reference(libs):
    port, ref = libs
    x = _samples()
    assert port.pcm16_from_f32(x) == ref.pcm16_from_f32(x)
    assert port.peak_abs(x) == ref.peak_abs(x) == 2.0
    pcm = np.frombuffer(port.pcm16_from_f32(x), np.int16)
    assert port.f32_from_pcm16(pcm).tobytes() == ref.f32_from_pcm16(pcm).tobytes()
    data = np.random.RandomState(1).bytes(5000)
    assert port.crc16_8005(data) == ref.crc16_8005(data)
    coeffs = dsp._highpass_coeffs(24_000, 20.0)
    assert port.biquad_df1(x, *coeffs).tobytes() == ref.biquad_df1(x, *coeffs).tobytes()
    assert port.pcm16_from_f32(np.zeros(0, np.float32)) == b""


def test_the_library_is_built_outside_the_source_tree(libs):
    path = audioio.library_path()
    assert path.exists() and path.parent.name == "_build" and path.parent.parent.name == "go_pocket_tts_tpu_torch"
    assert not [f for f in os.listdir(audioio.SOURCE.parent) if f.endswith(".so")]


def _with_and_without(monkeypatch, fn):
    with_helper = fn()
    with monkeypatch.context() as m:
        m.setattr(audioio, "load", lambda: None)
        without = fn()
    return with_helper, without


@pytest.mark.parametrize("seed", [0, 1])
def test_wav_and_flac_bytes_equal_with_and_without_the_helper(libs, monkeypatch, seed):
    x = _samples(seed=seed)
    for encode, reference in ((wav.encode_wav, j_wav.encode_wav), (flac.encode_flac, j_flac.encode_flac)):
        got, without = _with_and_without(monkeypatch, lambda: encode(x))
        assert got == without == reference(x)
    assert wav.pcm16_bytes(x) == j_wav.pcm16_bytes(x)
    frame = np.random.RandomState(seed).bytes(4000)
    crc, loop = _with_and_without(monkeypatch, lambda: flac._crc16(frame))
    assert crc == loop
    data = flac.encode_flac(x)
    helper, loop = _with_and_without(monkeypatch, lambda: flac.decode_flac(data))
    assert np.array_equal(helper[0], loop[0]) and helper[1] == loop[1] == 24_000


def test_dc_block_with_and_without_the_helper(libs, monkeypatch):
    x = (np.random.RandomState(7).uniform(-0.5, 0.5, 24_000) + 0.2).astype(np.float32)
    got, without = _with_and_without(monkeypatch, lambda: dsp.dc_block(x))
    # With the helper: the reference's C++ recursion, bit for bit.
    coeffs = j_dsp._highpass_coeffs(24_000, 20.0)
    assert got.tobytes() == libs[1].biquad_df1(x, *coeffs).tobytes()
    # Without: the NumPy path, the reference's fallback bit for bit, and the
    # sequential recursion within the budget tests/test_audio.py holds it to.
    assert without.tobytes() == j_dsp._biquad_numpy(x.astype(np.float64), *coeffs).astype(np.float32).tobytes()
    np.testing.assert_allclose(without, got, atol=1e-6)


def test_a_failed_build_falls_back_to_numpy(tmp_path, monkeypatch):
    monkeypatch.setattr(audioio, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed"):
        audioio.build()
    monkeypatch.setattr(audioio, "_loaded", None)
    monkeypatch.setattr(audioio, "_load_failed", False)
    assert audioio.load() is None and audioio._load_failed
    x = _samples()
    assert wav.encode_wav(x) == j_wav.encode_wav(x)
    assert flac.encode_flac(x) == j_flac.encode_flac(x)
    assert not list((tmp_path / "_build").glob("*.so"))
