"""The port's ``Service`` over ``GPURuntime(device="cpu")`` against the JAX
package's ``Service`` over ``TPURuntime``, on the same ``tiny_arch()``
checkpoint and tokenizer, at temperature 0 in float32: every route of
``synthesize_stream``, the batcher route, voiced requests, cancellation,
deadlines, the step limit, ``prewarm`` and ``from_config``."""

import contextlib
import time

import numpy as np
import pytest
import torch

from go_pocket_tts_tpu.config import TTSConfig as JTTSConfig
from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.runtime import TPURuntime
from go_pocket_tts_tpu.text import ChunkMetadata as JChunk
from go_pocket_tts_tpu.text.sentencepiece import load_tokenizer_from_bytes as j_tokenizer
from go_pocket_tts_tpu_torch.tts.parity import rms_delta
from go_pocket_tts_tpu.tts.service import Service as JService
from go_pocket_tts_tpu.utils.safetensors import encode_tensors, open_store_from_bytes, write_file
from go_pocket_tts_tpu_torch import config as t_config
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.parallel import BatcherRuntime
from go_pocket_tts_tpu_torch.runtime import GPURuntime
from go_pocket_tts_tpu_torch.text import ChunkMetadata
from go_pocket_tts_tpu_torch.text.sentencepiece import load_tokenizer_from_bytes as t_tokenizer
from go_pocket_tts_tpu_torch.tts.service import CancelledError, PCMChunk, Service
from torch_fixtures import ONE_CHUNK, STEPS, THREE_CHUNKS, run_stream, tokenizer_bytes, tts_config, voice_files

ARCH = synthetic.tiny_arch()
SEED = 21
RMS_BUDGET = 1e-3  # the waveform parity budget (BASELINE.md)


@pytest.fixture(scope="module")
def models():
    jm = load_model_from_store(
        open_store_from_bytes(encode_tensors(j_syn.build_checkpoint(ARCH, seed=SEED))), num_heads=ARCH.num_heads
    )
    tm = load_model_from_tensors(synthetic.build_checkpoint(ARCH, seed=SEED), num_heads=ARCH.num_heads, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def services(models):
    jm, tm = models
    data = tokenizer_bytes()
    j = JService(TPURuntime(jm, seed=1, frame_bucket=64), j_tokenizer(data), tts_config(JTTSConfig))
    t = Service(GPURuntime(tm, seed=1, frame_bucket=64, device="cpu"), t_tokenizer(data), tts_config(t_config.TTSConfig))
    return j, t


ROUTES = {
    "plain": (ONE_CHUNK, {}),
    "pipelined": (THREE_CHUNKS, {}),
    "continuity": (THREE_CHUNKS, {"continuity": True}),
    "frames": (THREE_CHUNKS, {"frame_streaming": True}),
    "frames_continuity": (THREE_CHUNKS, {"frame_streaming": True, "continuity": True}),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_synthesize_stream_routes_match(services, route, monkeypatch):
    j, t = services
    text, kw = ROUTES[route]
    if route == "pipelined":
        # The pipelined route dispatches through generate_audio_async.
        calls = []
        orig = t.runtime.generate_audio_async
        monkeypatch.setattr(t.runtime, "generate_audio_async", lambda *a: calls.append(1) or orig(*a))
    want_layout, want = run_stream(j, text, **kw)
    got_layout, got = run_stream(t, text, **kw)
    assert got_layout == want_layout
    assert got.dtype == np.float32 and len(got) > 0
    assert rms_delta(got, want) < RMS_BUDGET
    n_chunks = 1 if route == "plain" else 3
    assert got_layout[-1][:2] == (n_chunks - 1, True)
    if route.startswith("frames"):
        assert [n for _, _, n in got_layout] == [4 * 1920, 2 * 1920] * 3
    if route == "pipelined":
        assert len(calls) == 3


def test_synthesize_concatenates_the_stream(services):
    _, t = services
    _, streamed = run_stream(t, THREE_CHUNKS)
    np.testing.assert_array_equal(t.synthesize(THREE_CHUNKS), streamed)
    assert len(streamed) == 3 * STEPS * 1920


def test_generate_audio_async_resolves_to_generate_audio(models):
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig

    _, tm = models
    seen = []
    cfg = GenerateConfig(temperature=0.7, eos_threshold=1e9, max_steps=5, step_callback=lambda n, m: seen.append((n, m)))
    a = GPURuntime(tm, seed=3, frame_bucket=64, device="cpu")
    b = GPURuntime(tm, seed=3, frame_bucket=64, device="cpu")
    first, second = a.generate_audio_async([3, 5, 7], cfg), a.generate_audio_async([9, 2], cfg)
    assert seen == []  # the callback fires when the PCM is resolved
    got_first, got_second = first(), second()
    assert seen == [(5, 5), (5, 5)]
    cfg.step_callback = None
    np.testing.assert_array_equal(got_first, b.generate_audio([3, 5, 7], cfg))
    np.testing.assert_array_equal(got_second, b.generate_audio([9, 2], cfg))


@pytest.mark.parametrize("voice", ["embedding", "model_state"])
def test_voiced_request_matches(services, tmp_path, voice):
    j, t = services
    path = voice_files(tmp_path)[voice]
    want = j.synthesize(ONE_CHUNK, voice_path=path)
    got = t.synthesize(ONE_CHUNK, voice_path=path)
    assert len(got) == len(want) == STEPS * 1920
    assert rms_delta(got, want) < RMS_BUDGET
    assert rms_delta(got, t.synthesize(ONE_CHUNK)) > 1e-4  # the voice conditions the audio


def test_batcher_route_matches(services, models):
    j, _ = services
    _, tm = models
    rt = BatcherRuntime(tm, slots=2, seed=1, prompt_capacity=64, device="cpu")
    try:
        svc = Service(rt, t_tokenizer(tokenizer_bytes()), tts_config(t_config.TTSConfig))
        assert isinstance(svc._lock, contextlib.nullcontext)  # the batcher schedules itself
        got_layout, got = run_stream(svc, THREE_CHUNKS)
    finally:
        rt.close()
    want_layout, want = run_stream(j, THREE_CHUNKS)
    assert got_layout == want_layout
    assert rms_delta(got, want) < RMS_BUDGET
    assert svc.supports_frame_streaming  # the batcher streams frames (BatcherRuntime.stream_generate)


def test_cancel_raises(services):
    _, t = services
    with pytest.raises(CancelledError):
        list(t.synthesize_stream("hello world.", cancel=lambda: True))


def _fields(cfg):
    return (cfg.temperature, cfg.eos_threshold, cfg.max_steps, cfg.estimated_max_steps, cfg.lsd_decode_steps,
            cfg.frames_after_eos)


@pytest.mark.parametrize("max_steps,user_set", [(256, False), (256, True), (0, False), (12, False)])
def test_step_limit_matches(services, max_steps, user_set):
    """The estimate wins unless the user set max_steps, even to the
    default (the reference's tests/test_service.py)."""
    j, t = services
    for svc in (j, t):
        svc.tts_cfg.max_steps, svc.tts_cfg.max_steps_user_set = max_steps, user_set
    try:
        for n_tokens, n_words in ((30, 30), (3, 2), (50, 9)):
            want = j._generate_config(JChunk(text="x", token_ids=[1] * n_tokens, num_tokens=n_tokens, num_words=n_words))
            got = t._generate_config(ChunkMetadata(text="x", token_ids=[1] * n_tokens, num_tokens=n_tokens, num_words=n_words))
            assert _fields(got) == _fields(want)
    finally:
        for svc in (j, t):
            svc.tts_cfg.max_steps, svc.tts_cfg.max_steps_user_set = STEPS, False
    if (max_steps, user_set) == (256, False):
        assert got.max_steps == 234  # ceil((50/3 + 2) * 12.5), the estimate


def test_deadline_clamps_and_cancels(services):
    _, t = services
    t.tts_cfg.max_steps = 0
    try:
        chunk = ChunkMetadata(text="x", token_ids=[1] * 30, num_tokens=30, num_words=30)
        assert t._generate_config(chunk).max_steps == 150
        assert 1 <= t._generate_config(chunk, deadline=time.monotonic() + 2.0).max_steps <= 25
        with pytest.raises(CancelledError):
            t._generate_config(chunk, deadline=time.monotonic() - 1.0)
    finally:
        t.tts_cfg.max_steps = STEPS
    with pytest.raises(CancelledError):
        list(t.synthesize_stream("hello world.", deadline=time.monotonic() - 1.0))


def test_estimate_total_frames_matches(services):
    j, t = services
    for text in (ONE_CHUNK, THREE_CHUNKS):
        assert t.estimate_total_frames(text) == j.estimate_total_frames(text) > 0


def test_prewarm_and_prewarm_voice(services, tmp_path):
    _, t = services
    t.prewarm(token_lengths=(3,))
    assert t.prewarm_voice(voice_files(tmp_path)["embedding"], token_lengths=(3,))
    assert t.prewarm_voice(str(tmp_path / "missing.safetensors")) is False
    assert isinstance(next(t.synthesize_stream(ONE_CHUNK)), PCMChunk)


# -- from_config ----------------------------------------------------------------


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("service_fixtures")
    write_file(d / "model.safetensors", synthetic.build_checkpoint(ARCH, seed=SEED))
    (d / "tokenizer.model").write_bytes(tokenizer_bytes())
    return str(d / "model.safetensors"), str(d / "tokenizer.model")


def _config(fixture_files, **runtime):
    cfg = t_config.Config()
    cfg.paths.model_path, cfg.paths.tokenizer_model = fixture_files
    cfg.runtime.device = "cpu"
    cfg.tts.temperature, cfg.tts.eos_threshold, cfg.tts.max_steps = 0.0, 1e9, 4
    for k, v in runtime.items():
        setattr(cfg.runtime, k, v)
    return cfg


@pytest.mark.parametrize("batch_slots", [0, 2])
def test_from_config_builds_the_runtime_on_the_configured_device(fixture_files, batch_slots):
    svc = Service.from_config(_config(fixture_files, batch_slots=batch_slots, seed=3))
    try:
        want = BatcherRuntime if batch_slots > 1 else GPURuntime
        assert isinstance(svc.runtime, want)
        audio = svc.synthesize(ONE_CHUNK)
    finally:
        svc.close()
    assert audio.shape == (4 * 1920,) and np.isfinite(audio).all()


@pytest.mark.parametrize(
    "runtime,match",
    [
        ({"kv_quantize": True}, "requires the batched runtime"),
        ({"tp_devices": 2}, "require the batched runtime"),
        ({"dp_devices": 2}, "require the batched runtime"),
        ({"dp_devices": 2, "batch_slots": 2, "device": "cuda"}, "requested 2 devices but only"),
        ({"pallas": "sometimes"}, "must be auto, on, or off"),
    ],
)
def test_from_config_refusals(fixture_files, runtime, match):
    with pytest.raises(ValueError, match=match):
        Service.from_config(_config(fixture_files, **runtime))


@pytest.mark.parametrize("backend", ["torch", "cli", "tpu"])
def test_from_config_refuses_unported_backends(fixture_files, backend):
    """``tpu`` (the JAX engine's name) is refused; ``torch`` and ``cli``,
    ported since, build their runtimes: the torch oracle on the config's
    device with a tokenizer, the cli subprocess runtime without one."""
    from go_pocket_tts_tpu_torch.tts.runtime_cli import CLIRuntime
    from go_pocket_tts_tpu_torch.tts.runtime_torch import TorchRuntime

    cfg = _config(fixture_files)
    cfg.tts.backend = backend
    if backend == "tpu":
        with pytest.raises(ValueError, match="unsupported backend"):
            Service.from_config(cfg)
        return
    svc = Service.from_config(cfg)
    try:
        if backend == "torch":
            assert isinstance(svc.runtime, TorchRuntime) and svc.runtime.device == torch.device("cpu")
            assert svc.tokenizer is not None
        else:
            assert isinstance(svc.runtime, CLIRuntime) and svc.tokenizer is None
    finally:
        svc.close()


def test_from_config_raises_without_cuda(fixture_files, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _config(fixture_files)
    cfg.runtime.device = "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Service.from_config(cfg)


def test_compile_cache_dir_names_the_kernel_build_dir(fixture_files, tmp_path, monkeypatch):
    from go_pocket_tts_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)
    Service.from_config(_config(fixture_files, compile_cache_dir=str(tmp_path))).close()
    assert build.BUILD_DIR == tmp_path
