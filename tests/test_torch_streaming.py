"""Frame streaming and continuity sessions of the port against the JAX
package, on the CPU: the segmented AR loop (``runtime/streaming.py``) and
the session bookkeeping (``GPURuntime.generate_audio_session``).
Counterparts of tests/test_streaming.py, at temperature 0 where the two
packages meet (JAX threefry noise is not torch's) and at 0.7 within the
port. The block decoder's own tests are in test_torch_mimi_stream.py."""

import numpy as np
import pytest
import torch

import jax

from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.ops import TOLERANCES
from go_pocket_tts_tpu.runtime import GenerateConfig as JConfig
from go_pocket_tts_tpu.runtime import TPURuntime
from go_pocket_tts_tpu.runtime.streaming import stream_generate as j_stream_generate
from go_pocket_tts_tpu.runtime.streaming import stream_generate_session as j_stream_generate_session
from go_pocket_tts_tpu.utils.safetensors import encode_tensors, open_store_from_bytes
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime, stream_generate, stream_generate_session

ARCH = synthetic.tiny_arch()
SEED = 66
CONV_ATOL, CONV_RTOL = TOLERANCES["conv1d"]
PCM_ATOL = 3e-4  # the streamed float PCM against the int16-truncated one-shot PCM (1/32767 apart)


def _models(arch, seed=SEED):
    jm = load_model_from_store(
        open_store_from_bytes(encode_tensors(j_syn.build_checkpoint(arch, seed=seed))), num_heads=arch.num_heads
    )
    tm = load_model_from_tensors(synthetic.build_checkpoint(arch, seed=seed), num_heads=arch.num_heads, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _models(ARCH)


def _runtimes(models):
    jm, tm = models
    return TPURuntime(jm, seed=11, frame_bucket=64), GPURuntime(tm, seed=11, frame_bucket=64, device="cpu")


# -- streaming ------------------------------------------------------------------


def test_stream_generate_matches_generate_audio(models):
    """Same seed at temperature 0.7: the same frames in adaptive segments
    (4 then 6 frames) as the one-shot path."""
    _, tm = models
    tokens = [3, 8, 15]
    cfg = GenerateConfig(temperature=0.7, eos_threshold=1e9, max_steps=10)
    whole = GPURuntime(tm, seed=11, frame_bucket=64, device="cpu").generate_audio(tokens, cfg)
    blocks = list(stream_generate(GPURuntime(tm, seed=11, frame_bucket=64, device="cpu"), tokens, cfg))
    assert [len(b) // 1920 for b in blocks] == [4, 6]
    assert all(b.dtype == np.float32 for b in blocks)
    streamed = np.concatenate(blocks)
    assert len(streamed) == len(whole)
    np.testing.assert_allclose(streamed, whole, atol=PCM_ATOL, rtol=1e-3)


def test_stream_generate_matches_reference_temp0(models):
    jrt, trt = _runtimes(models)
    tokens = [3, 8, 15]
    kw = dict(temperature=0.0, eos_threshold=1e9, max_steps=10)
    want = list(j_stream_generate(jrt, tokens, JConfig(**kw), segment_frames=4))
    got = list(stream_generate(trt, tokens, GenerateConfig(**kw)))
    assert [len(b) for b in got] == [len(b) for b in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=CONV_ATOL, rtol=CONV_RTOL)


def test_stream_generate_decodes_past_the_frame_budget(models):
    """61 frames at a frame bucket of 64: the segments 4, 8, 16, 16, 16 and
    a last one of 16 decode 76 frames, past the bucket; the blocks still
    concatenate to the one-shot audio."""
    _, tm = models
    cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=61)
    whole = GPURuntime(tm, seed=11, frame_bucket=64, device="cpu").generate_audio([3, 8], cfg)
    blocks = list(stream_generate(GPURuntime(tm, seed=11, frame_bucket=64, device="cpu"), [3, 8], cfg))
    assert [len(b) // 1920 for b in blocks] == [4, 8, 16, 16, 16, 1]
    np.testing.assert_allclose(np.concatenate(blocks), whole, atol=PCM_ATOL, rtol=1e-3)


def test_stream_generate_eos_stops_early(models):
    _, tm = models
    cfg = GenerateConfig(temperature=0.0, eos_threshold=-1e9, max_steps=30, frames_after_eos=3)
    seen = []
    cfg.step_callback = lambda n, m: seen.append((n, m))
    blocks = list(stream_generate(GPURuntime(tm, seed=11, frame_bucket=64, device="cpu"), [3, 8], cfg))
    assert sum(len(b) for b in blocks) == 4 * 1920  # the EOS frame + 3
    assert seen == [(4, 30)]


def test_stream_generate_validates_like_generate_audio(models):
    _, tm = models
    rt = GPURuntime(tm, seed=11, frame_bucket=64, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        next(stream_generate(rt, [], GenerateConfig()))
    voice = np.zeros((1, 2, ARCH.d_model), np.float32)
    with pytest.raises(ValueError, match="mutually exclusive"):
        next(stream_generate(rt, [3], GenerateConfig(voice_embedding=voice, voice_model_state=object())))


# -- sessions -------------------------------------------------------------------


@pytest.mark.parametrize("eos_threshold", [1e9, -1.0], ids=["full", "eos"])
def test_sessions_match_reference_chunk_by_chunk(models, eos_threshold):
    """Three chunks through the plain and the streamed session, against the
    JAX package's plain and streamed sessions at temperature 0: the same PCM,
    ``used_ub``, capacity and carried cache offset after every chunk, also
    after a chunk that ends at EOS (whose steps past EOS must not advance
    the carried cache)."""
    jm, tm = models
    kw = dict(temperature=0.0, eos_threshold=eos_threshold, max_steps=10 if eos_threshold > 0 else 30)
    chunks = [[5, 9, 2], [7, 1, 4], [3, 8, 15]]
    jrt, trt = _runtimes(models)
    jrt_s, trt_s = _runtimes(models)
    jc = tc = jsc = tsc = None
    for chunk in chunks:
        want, jc = jrt.generate_audio_session(chunk, JConfig(**kw), jc)
        got, tc = trt.generate_audio_session(chunk, GenerateConfig(**kw), tc)
        blocks, next_state = j_stream_generate_session(jrt_s, chunk, JConfig(**kw), jsc)
        jstreamed = np.concatenate([np.asarray(b) for b in blocks])
        jsc = next_state()
        blocks, next_state = stream_generate_session(trt_s, chunk, GenerateConfig(**kw), tsc)
        streamed = np.concatenate(list(blocks))
        tsc = next_state()
        assert len(got) == len(want) == len(streamed) == len(jstreamed)
        np.testing.assert_allclose(got, want, atol=PCM_ATOL, rtol=1e-3)
        np.testing.assert_allclose(streamed, jstreamed, atol=CONV_ATOL, rtol=CONV_RTOL)
        np.testing.assert_allclose(streamed, got, atol=PCM_ATOL, rtol=1e-3)
        assert (tc.used_ub, tc.capacity) == (jc.used_ub, jc.capacity) == (tsc.used_ub, tsc.capacity)
        assert (jsc.used_ub, jsc.capacity) == (jc.used_ub, jc.capacity)
        assert int(tc.cache["offset"]) == int(jc.cache["offset"]) == int(tsc.cache["offset"])
    if eos_threshold < 0:
        assert len(got) < kw["max_steps"] * 1920  # the chunks did end at EOS


def test_eos_steps_leave_the_carried_offset(models):
    """The loop reads ``done`` once per 16 steps: the steps it runs after EOS
    must not advance the cache, so the carried offset is prompt + frames."""
    _, tm = models
    rt = GPURuntime(tm, seed=11, frame_bucket=64, device="cpu")
    cfg = GenerateConfig(temperature=0.0, eos_threshold=-1e9, max_steps=30, frames_after_eos=3)
    audio, cont = rt.generate_audio_session([5, 9, 2], cfg)
    assert len(audio) == 4 * 1920
    assert int(cont.cache["offset"]) == 3 + 4 == cont.used_ub


def test_session_state_conditions_later_chunks(models):
    _, tm = models
    cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=4)
    rt = GPURuntime(tm, seed=11, frame_bucket=64, device="cpu")
    blocks, next_state = stream_generate_session(rt, [5, 9, 2], cfg)
    list(blocks)
    blocks, _ = stream_generate_session(rt, [7, 1, 4], cfg, next_state())
    with_state = np.concatenate(list(blocks))
    blocks, _ = stream_generate_session(rt, [7, 1, 4], cfg, None)
    fresh = np.concatenate(list(blocks))
    assert with_state.shape == fresh.shape
    assert not np.allclose(with_state, fresh, atol=1e-5)


@pytest.mark.parametrize("streamed", [False, True])
def test_session_grows_then_resets_as_the_reference(models, streamed, monkeypatch):
    jrt, trt = _runtimes(models)
    monkeypatch.setattr(trt, "SESSION_CAPACITY", 128)
    cfg = dict(temperature=0.7, eos_threshold=1e9, max_steps=4)
    jc = tc = None
    seen = []
    for _ in range(8):
        _, jc = jrt.generate_audio_session([5, 9, 2], JConfig(**cfg), jc, session_capacity=128)
        if streamed:
            blocks, next_state = stream_generate_session(trt, [5, 9, 2], GenerateConfig(**cfg), tc)
            assert sum(len(b) for b in blocks) == 4 * 1920
            tc = next_state()
        else:
            audio, tc = trt.generate_audio_session([5, 9, 2], GenerateConfig(**cfg), tc)
            assert len(audio) == 4 * 1920
        assert (tc.used_ub, tc.capacity) == (jc.used_ub, jc.capacity)
        assert tc.used_ub <= tc.capacity
        seen.append(tc.used_ub)
    assert min(seen) < max(seen)  # grew, then reset at least once
    assert trt._session_ladder(1024) == jrt._session_ladder(1024) == (384, 640, 1024)


def test_grow_cache_pads_capacity(models):
    _, tm = models
    cache = {"k": torch.ones(2, 1, 4, 8, 16), "v": torch.ones(2, 1, 4, 8, 16), "offset": torch.tensor(5, dtype=torch.int32)}
    grown = GPURuntime._grow_cache(cache, 12)
    assert grown["k"].shape == (2, 1, 4, 12, 16) and not grown["v"][:, :, :, 8:].any()
    assert int(grown["offset"]) == 5


def test_next_state_requires_drain(models):
    _, tm = models
    rt = GPURuntime(tm, seed=11, frame_bucket=64, device="cpu")
    _blocks, next_state = stream_generate_session(rt, [5, 9, 2], GenerateConfig(temperature=0.0, max_steps=4))
    with pytest.raises(RuntimeError, match="drain"):
        next_state()
    _blocks, next_state = rt.stream_generate_session([5, 9, 2], GenerateConfig(temperature=0.0, max_steps=4))
    with pytest.raises(RuntimeError, match="drain"):
        next_state()


def test_streaming_leaves_no_inference_mode_behind(models):
    """The device work runs in inference mode per segment, never across a
    ``yield``: the caller's code between blocks runs as it would anyway."""
    _, tm = models
    rt = GPURuntime(tm, seed=11, frame_bucket=64, device="cpu")
    for _ in stream_generate(rt, [3, 8], GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=6)):
        assert not torch.is_inference_mode_enabled()
        assert jax.config is not None  # both frameworks stay importable side by side
