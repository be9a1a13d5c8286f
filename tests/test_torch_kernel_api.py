"""The port's bytes-in, WAV-out kernel API (``go_pocket_tts_tpu_torch.kernel``)
against the JAX package's ``PocketTTSKernel``, on the CPU (the port's kernels
run their plain versions there): every ``synthesize`` route, one-shot, with
``progress``, with ``continuity`` with and without ``progress``, and voice
bytes of both formats, at temperature 0, PCM within 1e-3 RMS and the progress
calls equal; ``normalize``, ``tokenize`` and the not-loaded error equal."""

import numpy as np
import pytest
import torch

from go_pocket_tts_tpu.kernel import PocketTTSKernel as JKernel
from go_pocket_tts_tpu_torch.kernel import PocketTTSKernel
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.tts.parity import rms_delta
from go_pocket_tts_tpu_torch.utils import wav
from go_pocket_tts_tpu_torch.utils.safetensors import encode_tensors
from go_pocket_tts_tpu_torch.utils.safetensors import write_file
from torch_fixtures import ONE_CHUNK, tokenizer_bytes, voice_files

ARCH = synthetic.tiny_arch()
HEADS = 16  # the kernel API loads every model with 16 heads
SHORT = "Hello world."
TWO_CHUNKS = "The quick brown fox jumps over the sleepy dog. Hello world, the brown fox sings a song."


@pytest.fixture(scope="module")
def kernels():
    """Both kernels loaded from the same bytes."""
    model = encode_tensors(synthetic.build_checkpoint(ARCH, seed=88))
    tok = tokenizer_bytes()
    j = JKernel(seed=3, compile_cache_dir="")
    t = PocketTTSKernel(seed=3, device="cpu")
    j.load_model(model, tok)
    t.load_model(model, tok)
    return j, t


def _both(kernels, text, progress=False, **kw):
    """Each kernel's PCM for ``text`` at temperature 0, with its progress
    calls when ``progress`` (else None)."""
    out = []
    for k in kernels:
        calls = [] if progress else None
        if progress:
            kw["progress"] = lambda done, total: calls.append((done, total))
        data = k.synthesize(text, temperature=0.0, **kw)
        pcm, rate = wav.decode_wav(data)
        assert rate == 24000 and data[:4] == b"RIFF"
        out.append((pcm, calls))
    return out


ROUTES = {
    "one_shot": (SHORT, dict(eos_threshold=1e9)),
    "progress": (SHORT, dict(eos_threshold=1e9, progress=True)),
    "progress_eos": (ONE_CHUNK, dict(eos_threshold=-1e9, progress=True)),
    "continuity": (TWO_CHUNKS, dict(eos_threshold=1e9, continuity=True)),
    "continuity_progress": (TWO_CHUNKS, dict(eos_threshold=1e9, continuity=True, progress=True)),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_synthesize_routes_match_the_jax_kernel(kernels, route):
    text, kw = ROUTES[route]
    (want, j_calls), (got, t_calls) = _both(kernels, text, **kw)
    assert got.shape == want.shape and len(got) > 0 and len(got) % 1920 == 0
    assert rms_delta(got, want) < 1e-3
    assert t_calls == j_calls
    if t_calls is not None:
        frames = len(got) // 1920
        assert t_calls[-1] == (frames, frames) and len(t_calls) >= 2
        assert [d for d, _ in t_calls] == sorted(d for d, _ in t_calls)
        assert all(d <= total for d, total in t_calls)
    if route == "progress_eos":
        # EOS ended the chunk early: the total shrank below the estimate.
        assert t_calls[0][1] > t_calls[-1][1]


def _model_state_voice(path) -> None:
    """A model-state voice at the kernel's 16 heads."""
    rng = np.random.RandomState(4)
    tensors = {}
    for i in range(ARCH.num_layers):
        tensors[f"transformer.layers.{i}.self_attn/cache"] = (
            rng.randn(2, 1, 6, HEADS, ARCH.d_model // HEADS) * 0.2
        ).astype(np.float32)
        tensors[f"transformer.layers.{i}.self_attn/offset"] = np.array([6.0], np.float32)
    write_file(path, tensors)


@pytest.mark.parametrize("kind", ["embedding", "model_state"])
def test_voice_bytes_of_both_formats(kernels, tmp_path, kind):
    if kind == "embedding":
        path = voice_files(tmp_path)["embedding"]
    else:
        path = tmp_path / "state.safetensors"
        _model_state_voice(path)
    voice = open(path, "rb").read()
    (want, _), (got, _) = _both(kernels, SHORT, eos_threshold=1e9, voice=voice)
    assert rms_delta(got, want) < 1e-3
    (plain, _), = _both(kernels[1:], SHORT, eos_threshold=1e9)
    assert rms_delta(got, plain) > 1e-4  # the voice conditions the audio


def test_normalize_tokenize_and_metadata(kernels):
    j, t = kernels
    for text in ("  hello\r\nworld ", "Hello world, the quick fox.", "the   QUICK fox"):
        assert t.normalize(text) == j.normalize(text)
        assert t.tokenize(text) == j.tokenize(text)
    assert (t.sample_rate, t.loaded) == (j.sample_rate, j.loaded) == (24000, True)
    assert isinstance(t.version, str) and t.version


def test_load_model_must_come_first():
    errors = []
    for k in (JKernel(compile_cache_dir=""), PocketTTSKernel(device="cpu")):
        assert not k.loaded
        for call in (lambda: k.tokenize("x"), lambda: k.synthesize("x")):
            with pytest.raises(RuntimeError) as exc:
                call()
            errors.append(str(exc.value))
    assert errors[2:] == errors[:2] == ["kernel: loadModel must be called first"] * 2


def test_kernel_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert "cuda" in PocketTTSKernel.__init__.__defaults__
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PocketTTSKernel()


def test_compile_cache_dir_names_the_kernel_library_directory(tmp_path, monkeypatch):
    from go_pocket_tts_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    k = PocketTTSKernel(device="cpu", compile_cache_dir=str(tmp_path / "libs"))
    k.load_model(encode_tensors(synthetic.build_checkpoint(ARCH, seed=1)), tokenizer_bytes())
    assert build.BUILD_DIR == tmp_path / "libs"
