"""Voice conditioning of the port against the JAX package, on the CPU: the
hydrated voice cache (``flow_transformer.kv_cache_from_voice_state``), the
voice-file loaders of ``utils/safetensors.py``, and ``GenerateConfig``'s
``voice_embedding`` / ``voice_model_state`` through ``GPURuntime`` (one-shot,
streamed and in a session) at temperature 0."""

import numpy as np
import pytest
import torch

from go_pocket_tts_tpu.models import flow_transformer as j_ftr
from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.runtime import GenerateConfig as JConfig
from go_pocket_tts_tpu.runtime import TPURuntime
from go_pocket_tts_tpu_torch.tts.parity import rms_delta
from go_pocket_tts_tpu.utils import safetensors as j_io
from go_pocket_tts_tpu.utils.safetensors import encode_tensors, open_store_from_bytes
from go_pocket_tts_tpu_torch.models import flow_transformer as t_ftr
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime, stream_generate
from go_pocket_tts_tpu_torch.utils import safetensors as t_io

ARCH = synthetic.tiny_arch()
SEED = 9
TOKENS = [3, 17, 41]
RMS_BUDGET = 1e-3  # the waveform parity budget (BASELINE.md)
HEAD_DIM = ARCH.d_model // ARCH.num_heads


@pytest.fixture(scope="module")
def models():
    jm = load_model_from_store(
        open_store_from_bytes(encode_tensors(j_syn.build_checkpoint(ARCH, seed=SEED))), num_heads=ARCH.num_heads
    )
    tm = load_model_from_tensors(synthetic.build_checkpoint(ARCH, seed=SEED), num_heads=ARCH.num_heads, device="cpu")
    return jm, tm


def _modules(frames=12, offset=10, seed=0, heads=ARCH.num_heads, layers=ARCH.num_layers):
    rng = np.random.RandomState(seed)
    return {
        f"transformer.layers.{i}.self_attn": {
            "cache": (rng.randn(2, 1, frames, heads, HEAD_DIM) * 0.3).astype(np.float32),
            "offset": np.array([float(offset)], np.float32),
        }
        for i in range(layers)
    }


def _embedding(frames=7, seed=0):
    return (np.random.RandomState(seed).randn(1, frames, ARCH.d_model) * 0.02).astype(np.float32)


# -- the hydrated cache ---------------------------------------------------------


@pytest.mark.parametrize("frames,offset,capacity", [(12, 10, 64), (5, 5, 5), (3, 0, 128)])
def test_kv_cache_from_voice_state_matches_reference(models, frames, offset, capacity):
    jm, tm = models
    modules = _modules(frames, offset, seed=frames)
    want = j_ftr.kv_cache_from_voice_state(jm.config.flow_lm.transformer, modules, capacity)
    got = t_ftr.kv_cache_from_voice_state(tm.config.flow_lm.transformer, modules, capacity)
    assert set(got) == set(want) == {"k", "v", "offset"}
    for key in ("k", "v"):
        assert got[key].dtype == torch.float32 and tuple(got[key].shape) == np.asarray(want[key]).shape
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    assert got["offset"].dtype == torch.int32 and int(got["offset"]) == int(want["offset"]) == offset


def _bad(kind):
    modules = _modules()
    name = "transformer.layers.1.self_attn"
    if kind == "missing module":
        del modules[name]
    elif kind == "cache rank":
        modules[name]["cache"] = modules[name]["cache"][0]
    elif kind == "heads":
        modules[name]["cache"] = np.zeros((2, 1, 12, ARCH.num_heads + 1, HEAD_DIM), np.float32)
    elif kind == "fractional offset":
        modules[name]["offset"] = np.array([2.5], np.float32)
    elif kind == "offset past the cache":
        for m in modules.values():
            m["offset"] = np.array([13.0], np.float32)
    elif kind == "inconsistent offsets":
        modules[name]["offset"] = np.array([4.0], np.float32)
    return modules


@pytest.mark.parametrize(
    "kind,capacity,match",
    [
        ("missing module", 64, "missing module"),
        ("cache rank", 64, "want"),
        ("heads", 64, "heads/dim"),
        ("fractional offset", 64, "invalid"),
        ("offset past the cache", 64, "exceeds cache length"),
        ("inconsistent offsets", 64, "inconsistent"),
        ("fits", 8, "exceeds KV capacity"),
    ],
)
def test_kv_cache_from_voice_state_rejects_as_the_reference(models, kind, capacity, match):
    jm, tm = models
    modules = _bad(kind)
    with pytest.raises(ValueError, match=match) as want:
        j_ftr.kv_cache_from_voice_state(jm.config.flow_lm.transformer, modules, capacity)
    with pytest.raises(ValueError, match=match) as got:
        t_ftr.kv_cache_from_voice_state(tm.config.flow_lm.transformer, modules, capacity)
    assert str(got.value) == str(want.value)


def test_kv_cache_from_voice_state_takes_the_runtime_dtype(models):
    _, tm = models
    got = t_ftr.kv_cache_from_voice_state(tm.config.flow_lm.transformer, _modules(), 64, torch.bfloat16)
    assert got["k"].dtype == got["v"].dtype == torch.bfloat16 and got["offset"].dtype == torch.int32


# -- voice files ------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(7, 16), (1, 7, 16)])
def test_voice_embedding_file_reads_as_the_reference(tmp_path, shape):
    emb = np.random.RandomState(0).randn(*shape).astype(np.float32)
    path = tmp_path / "voice.safetensors"
    t_io.write_file(path, {"audio_prompt": emb})
    assert t_io.inspect_voice_file(path) == j_io.inspect_voice_file(path) == t_io.VoiceFileKind.EMBEDDING
    got, want = t_io.load_voice_embedding(path), j_io.load_voice_embedding(path)
    assert got.shape == want.shape == (1, 7, 16) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # Without an ``audio_prompt`` tensor both take the first one.
    data = t_io.encode_tensors({"other": emb})
    np.testing.assert_array_equal(t_io.load_voice_embedding_from_bytes(data), j_io.load_voice_embedding_from_bytes(data))


@pytest.mark.parametrize("offset_key", ["offset", "current_end"])
def test_voice_model_state_file_reads_as_the_reference(tmp_path, offset_key):
    rng = np.random.RandomState(1)
    tensors = {}
    for i in range(2):
        tensors[f"transformer.layers.{i}.self_attn/cache"] = rng.randn(2, 1, 6, 4, 8).astype(np.float32)
        tensors[f"transformer.layers.{i}.self_attn/{offset_key}"] = (
            np.array([5.0], np.float32) if offset_key == "offset" else np.zeros((6,), np.float32)
        )
    path = tmp_path / "state.safetensors"
    t_io.write_file(path, tensors)
    assert t_io.inspect_voice_file(path) == j_io.inspect_voice_file(path) == t_io.VoiceFileKind.MODEL_STATE
    got, want = t_io.load_voice_model_state(path), j_io.load_voice_model_state(path)
    assert isinstance(got, t_io.VoiceModelState)
    assert set(got.modules) == set(want.modules)
    for name, module in want.modules.items():
        assert set(got.modules[name]) == set(module) == {"cache", "offset"}
        for key, arr in module.items():
            assert got.modules[name][key].dtype == np.float32
            np.testing.assert_array_equal(got.modules[name][key], arr)
    assert got.modules["transformer.layers.0.self_attn"]["offset"][0] == (5.0 if offset_key == "offset" else 6.0)
    for load in (t_io.load_voice_embedding, j_io.load_voice_embedding):
        with pytest.raises(ValueError, match="model state"):
            load(path)


def test_voice_loaders_reject_as_the_reference():
    data = t_io.encode_tensors({"audio_prompt": np.zeros((7, 16), np.float32)})
    for load in (t_io.load_voice_model_state_from_bytes, j_io.load_voice_model_state_from_bytes):
        with pytest.raises(ValueError, match="not upstream model state"):
            load(data)
    data = t_io.encode_tensors({"audio_prompt": np.zeros((2, 3, 4, 5), np.float32)})
    for load in (t_io.load_voice_embedding_from_bytes, j_io.load_voice_embedding_from_bytes):
        with pytest.raises(ValueError, match="expected 2D or 3D"):
            load(data)


# -- conditioning through the runtime ---------------------------------------------


def _configs(kind):
    kw = dict(temperature=0.0, eos_threshold=1e9, max_steps=12)
    if kind == "embedding":
        emb = _embedding()
        return JConfig(**kw, voice_embedding=emb), GenerateConfig(**kw, voice_embedding=emb)
    modules = _modules()
    return (
        JConfig(**kw, voice_model_state=j_io.VoiceModelState(modules=modules)),
        GenerateConfig(**kw, voice_model_state=t_io.VoiceModelState(modules=modules)),
    )


@pytest.mark.parametrize("kind", ["embedding", "model_state"])
def test_voiced_generate_audio_matches_tpu_runtime(models, kind):
    jm, tm = models
    jcfg, tcfg = _configs(kind)
    want = TPURuntime(jm, seed=1, frame_bucket=64).generate_audio(TOKENS, jcfg)
    got = GPURuntime(tm, seed=1, frame_bucket=64, device="cpu").generate_audio(TOKENS, tcfg)
    assert len(got) == len(want) == 12 * 1920
    assert rms_delta(got, want) < RMS_BUDGET
    plain = GPURuntime(tm, seed=1, frame_bucket=64, device="cpu").generate_audio(
        TOKENS, GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=12)
    )
    assert not np.allclose(got, plain, atol=1e-4)  # the voice conditions the audio


@pytest.mark.parametrize("kind", ["embedding", "model_state"])
def test_voiced_stream_generate_equals_voiced_generate_audio(models, kind):
    _, tm = models
    _, tcfg = _configs(kind)
    whole = GPURuntime(tm, seed=1, frame_bucket=64, device="cpu").generate_audio(TOKENS, tcfg)
    streamed = np.concatenate(list(stream_generate(GPURuntime(tm, seed=1, frame_bucket=64, device="cpu"), TOKENS, tcfg)))
    assert len(streamed) == len(whole)
    np.testing.assert_allclose(streamed, whole, atol=3e-4, rtol=1e-3)


@pytest.mark.parametrize("kind", ["embedding", "model_state"])
def test_voiced_session_matches_reference(models, kind):
    """The voice conditions a session's first chunk; the next chunk inherits
    it through the carried cache, with the reference's bookkeeping."""
    jm, tm = models
    jcfg, tcfg = _configs(kind)
    jrt = TPURuntime(jm, seed=1, frame_bucket=64)
    trt = GPURuntime(tm, seed=1, frame_bucket=64, device="cpu")
    jc = tc = None
    for chunk in ([5, 9, 2], [7, 1, 4]):
        want, jc = jrt.generate_audio_session(chunk, jcfg, jc)
        got, tc = trt.generate_audio_session(chunk, tcfg, tc)
        assert len(got) == len(want)
        assert rms_delta(got, want) < RMS_BUDGET
        assert (tc.used_ub, tc.capacity) == (jc.used_ub, jc.capacity)
        assert int(tc.cache["offset"]) == int(jc.cache["offset"])


def test_voice_embedding_validation_matches_reference(models):
    jm, tm = models
    bad = np.zeros((1, 2, ARCH.d_model + 1), np.float32)
    for rt, cfg in (
        (TPURuntime(jm, seed=1), JConfig(voice_embedding=bad)),
        (GPURuntime(tm, seed=1, device="cpu"), GenerateConfig(voice_embedding=bad)),
    ):
        with pytest.raises(ValueError, match="incompatible with d_model"):
            rt.generate_audio([1], cfg)
    state = t_io.VoiceModelState(modules={"m": {"offset": np.array([0.0])}})
    with pytest.raises(ValueError, match="mutually exclusive"):
        GPURuntime(tm, seed=1, device="cpu").generate_audio(
            [1], GenerateConfig(voice_embedding=_embedding(), voice_model_state=state)
        )


@pytest.mark.parametrize("kind", ["embedding", "model_state"])
def test_batcher_serves_a_voiced_request(models, kind):
    """The batcher serves a voiced request with its voice: the single
    runtime's audio for the same voice (against the JAX batcher:
    tests/test_torch_batch_session.py)."""
    _, tm = models
    _, tcfg = _configs(kind)
    want = GPURuntime(tm, seed=1, frame_bucket=64, device="cpu").generate_audio(TOKENS, tcfg)
    batcher = ContinuousBatcher(tm, slots=2, prompt_capacity=64, max_frames=16, seed=1, device="cpu")
    batcher.start()
    try:
        got = batcher.submit(TOKENS, tcfg).result(timeout=60)
    finally:
        batcher.stop()
    assert got.shape == want.shape == (12 * 1920,)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
