"""Voices, sessions and ``prewarm`` of the port's continuous batcher against
the JAX package's, on ``tiny_arch()`` at temperature 0, and the port's
``Service`` and HTTP server over ``BatcherRuntime`` against the JAX
package's over its own: voiced requests (an embedding and a model state),
continuity sessions plain and streamed (against the JAX batcher's and the
port's single runtime's), an int8-KV session, a session that fills its
capacity and resets, and the Service's continuity, frame-streaming and
voiced routes (``POST /tts/stream`` over these services is in
``test_torch_server.py``)."""

import numpy as np
import pytest

from go_pocket_tts_tpu.parallel import ContinuousBatcher as JBatcher
from go_pocket_tts_tpu.runtime import GenerateConfig as JConfig
from go_pocket_tts_tpu_torch.tts.parity import rms_delta
from go_pocket_tts_tpu.utils import safetensors as j_st
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime
from go_pocket_tts_tpu_torch.utils import safetensors as t_st
from torch_fixtures import ONE_CHUNK, THREE_CHUNKS, build_models, run_stream, service_pair, voice_files

ARCH = synthetic.tiny_arch()
SEED = 55
FLOAT_TOL = (1e-4, 1e-3)
INT8_KV_TOL = (5e-3, 1e-2)  # the JAX package's own budget for its int8-KV engine
RMS_BUDGET = 1e-3
COMMON = dict(slots=2, prompt_capacity=128, max_frames=64, seed=3)


@pytest.fixture(scope="module")
def models():
    return build_models(SEED)


def _cfg(**kw):
    return GenerateConfig(**{"temperature": 0.0, "eos_threshold": 1e9, "max_steps": 4, **kw})


def _jcfg(**kw):
    return JConfig(**{"temperature": 0.0, "eos_threshold": 1e9, "max_steps": 4, **kw})


def _close(got, want, tol=FLOAT_TOL):
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=tol[0], rtol=tol[1])


class _Engines:
    """A started JAX batcher and port batcher with the same knobs."""

    def __init__(self, models, **kw):
        jm, tm = models
        self.j = JBatcher(jm, **{**COMMON, **kw})
        self.t = ContinuousBatcher(tm, device="cpu", **{**COMMON, **kw})

    def __enter__(self):
        self.j.start()
        self.t.start()
        return self.j, self.t

    def __exit__(self, *exc):
        self.j.stop()
        self.t.stop()


def _voice_state(seed=4, frames=6):
    rng = np.random.RandomState(seed)
    head_dim = ARCH.d_model // ARCH.num_heads
    modules = {
        f"transformer.layers.{i}.self_attn": {
            "cache": (rng.randn(2, 1, frames, ARCH.num_heads, head_dim) * 0.2).astype(np.float32),
            "offset": np.array([float(frames)], np.float32),
        }
        for i in range(ARCH.num_layers)
    }
    return j_st.VoiceModelState(modules=modules), t_st.VoiceModelState(modules=modules)


def _voice_embedding(seed=4, frames=5):
    return (np.random.RandomState(seed).randn(1, frames, ARCH.d_model) * 0.1).astype(np.float32)


# -- voices ---------------------------------------------------------------------


def test_voices_match_reference(models):
    """An embedding voice (admitted with a plain request in one burst) and a
    model-state voice (prefilled into its slot alone) against the JAX
    batcher; each voice changes the audio."""
    emb = _voice_embedding()
    j_state, t_state = _voice_state()
    with _Engines(models) as (jb, tb):
        cases = [({"voice_embedding": emb}, {"voice_embedding": emb}), ({"voice_model_state": j_state}, {"voice_model_state": t_state})]
        for j_kw, t_kw in cases:
            want = jb.generate([5, 9, 2], _jcfg(**j_kw), timeout=120)
            futs = [tb.submit([5, 9, 2], _cfg(**t_kw)), tb.submit([7, 1, 4], _cfg())]
            got, _neighbour = (f.result(timeout=120) for f in futs)
            assert len(got) == 4 * 1920
            _close(got, want)
        plain = tb.generate([5, 9, 2], _cfg())
    assert rms_delta(got, plain) > 1e-4


def test_embedding_voice_with_model_state_or_session_raises(models):
    _, tm = models
    emb = _voice_embedding()
    _, t_state = _voice_state()
    tb = ContinuousBatcher(tm, device="cpu", **COMMON)
    tb.start()
    try:
        with pytest.raises(ValueError, match="mutually exclusive"):
            tb.generate([5, 9, 2], _cfg(voice_embedding=emb, voice_model_state=t_state))
        _audio, cont = tb.generate_session([5, 9, 2], _cfg())
        fut = tb.submit([7, 1], _cfg(voice_embedding=emb))
        # A carried chunk submitted as it is (generate_session would strip
        # the voice first).
        with pytest.raises(ValueError, match="mutually exclusive"):
            list(tb.submit_stream([7, 1], _cfg(voice_embedding=emb), timeout=60, cont=cont))
        assert len(fut.result(timeout=60)) == 4 * 1920  # the batch goes on
    finally:
        tb.stop()


# -- sessions -------------------------------------------------------------------


@pytest.mark.parametrize("kv_quantize", [False, True], ids=["float_kv", "int8_kv"])
def test_session_matches_reference(models, kv_quantize):
    """A three-chunk session against the JAX batcher's, with plain requests
    in the other slot; the float one also against the port's
    ``GPURuntime.generate_audio_session``."""
    chunks = ([5, 9, 2], [7, 1, 4], [8, 3])
    tol = INT8_KV_TOL if kv_quantize else FLOAT_TOL
    with _Engines(models, kv_quantize=kv_quantize) as (jb, tb):
        want, cont = [], None
        for tokens in chunks:
            audio, cont = jb.generate_session(tokens, _jcfg(), cont, timeout=120)
            want.append(audio)
        got, cont = [], None
        for tokens in chunks:
            load = tb.submit([4, 4, 4], _cfg(max_steps=6))
            audio, cont = tb.generate_session(tokens, _cfg(), cont)
            got.append(audio)
            assert len(load.result(timeout=60)) == 6 * 1920
    for g, w in zip(got, want):
        _close(g, w, tol)
    assert cont.k.dtype == cont.v.dtype == tb.dtype and cont.offset_host is None
    if not kv_quantize:
        rt = GPURuntime(models[1], seed=3, frame_bucket=64, device="cpu")
        single, rcont = [], None
        for tokens in chunks:
            audio, rcont = rt.generate_audio_session(tokens, _cfg(), rcont)
            single.append(audio)
        for g, w in zip(got, single):
            _close(g, w)


def test_continuation_is_reusable_and_conditions(models):
    """A continuation submitted twice gives the same chunk (hydration copies
    it), and that chunk differs from the same text without it."""
    _, tm = models
    tb = ContinuousBatcher(tm, device="cpu", **COMMON)
    tb.start()
    try:
        _a, cont = tb.generate_session([5, 9, 2], _cfg())
        first, _ = tb.generate_session([7, 1, 4], _cfg(), cont)
        second, _ = tb.generate_session([7, 1, 4], _cfg(), cont)
        fresh, _ = tb.generate_session([7, 1, 4], _cfg(), None)
    finally:
        tb.stop()
    np.testing.assert_array_equal(first, second)
    assert not np.allclose(first, fresh, atol=1e-5)


def test_session_resets_when_full_and_reapplies_the_voice(models):
    """Capacity 16 + 64: a 64-frame chunk fills the lane, so the next chunk
    starts a fresh session, with the voice applied again: it equals a fresh
    voiced chunk, as in the JAX batcher."""
    emb = _voice_embedding(frames=2)
    kw = dict(prompt_capacity=16)
    with _Engines(models, **kw) as (jb, tb):
        outs = []
        for batcher, cfg in ((jb, _jcfg), (tb, _cfg)):
            fresh, _ = batcher.generate_session([7, 1, 4], cfg(voice_embedding=emb), None, timeout=120)
            _a, cont = batcher.generate_session([5, 9, 2], cfg(voice_embedding=emb, max_steps=64), None, timeout=120)
            offsets = [int(np.asarray(cont.offset).reshape(-1)[0])]
            reset, cont = batcher.generate_session([7, 1, 4], cfg(voice_embedding=emb), cont, timeout=120)
            offsets.append(int(np.asarray(cont.offset).reshape(-1)[0]))
            outs.append((fresh, reset, offsets))
    (j_fresh, j_reset, j_offsets), (t_fresh, t_reset, t_offsets) = outs
    assert t_offsets == j_offsets and t_offsets[1] < t_offsets[0]
    np.testing.assert_array_equal(t_reset, t_fresh)
    _close(t_reset, j_reset)


def test_stream_session_matches_generate_session(models):
    """``stream_session`` over two chunks against the JAX batcher's and
    against the port's own ``generate_session``; ``next_state()`` is set
    once the stream has ended."""
    with _Engines(models, steps_per_sync=2) as (jb, tb):
        plain, streamed, want, cont, scont, jcont = [], [], [], None, None, None
        for tokens in ([5, 9, 2], [7, 1, 4]):
            audio, cont = tb.generate_session(tokens, _cfg(), cont)
            plain.append(audio)
            blocks, next_state = tb.stream_session(tokens, _cfg(), scont)
            blocks = list(blocks)
            assert [len(b) for b in blocks] == [2 * 1920, 2 * 1920]
            streamed.append(np.concatenate(blocks))
            scont = next_state()
            assert scont is not None
            jblocks, jnext = jb.stream_session(tokens, _jcfg(), jcont, timeout=120)
            want.append(np.concatenate(list(jblocks)))
            jcont = jnext()
    for s, p, w in zip(streamed, plain, want):
        np.testing.assert_allclose(s, p, atol=1e-3)
        np.testing.assert_allclose(s, w, atol=1e-3)


def test_prewarm_then_serve(models):
    _, tm = models
    tb = ContinuousBatcher(tm, device="cpu", **dict(COMMON, steps_per_sync=2))
    tb.start()
    try:
        tb.prewarm(token_lengths=(3,), timeout=120)
        assert tb._stream_state is not None  # the streamed waves made the decoder's state
        assert len(tb.generate([5, 9, 2], _cfg(max_steps=3))) == 3 * 1920
        assert tb._crashed is None
    finally:
        tb.stop()


# -- the Service and the server over the batcher --------------------------------


@pytest.fixture(scope="module")
def batcher_services(models):
    with service_pair(models) as pair:
        yield pair


ROUTES = {
    "continuity": (THREE_CHUNKS, {"continuity": True}),
    "frames": (THREE_CHUNKS, {"frame_streaming": True}),
    "frames_continuity": (THREE_CHUNKS, {"frame_streaming": True, "continuity": True}),
}


@pytest.mark.parametrize("route", list(ROUTES))
def test_service_routes_over_the_batcher_match(batcher_services, route, monkeypatch):
    j, t = batcher_services
    assert t.supports_frame_streaming and j.supports_frame_streaming
    text, kw = ROUTES[route]
    calls = []
    name = {"continuity": "generate_audio_session", "frames": "stream_generate"}.get(route, "stream_generate_session")
    orig = getattr(t.runtime, name)
    monkeypatch.setattr(t.runtime, name, lambda *a: calls.append(1) or orig(*a))
    want_layout, want = run_stream(j, text, **kw)
    got_layout, got = run_stream(t, text, **kw)
    assert len(calls) == 3  # the route went through the batcher's own method
    assert got_layout == want_layout
    if route.startswith("frames"):
        assert [n for _, _, n in got_layout] == [4 * 1920, 2 * 1920] * 3
    assert rms_delta(got, want) < RMS_BUDGET


@pytest.mark.parametrize("voice", ["embedding", "model_state"])
def test_voiced_service_request_over_the_batcher_matches(batcher_services, tmp_path, voice):
    j, t = batcher_services
    path = voice_files(tmp_path)[voice]
    want = j.synthesize(ONE_CHUNK, voice_path=path)
    got = t.synthesize(ONE_CHUNK, voice_path=path)
    assert len(got) == len(want) > 0
    assert rms_delta(got, want) < RMS_BUDGET
    assert rms_delta(got, t.synthesize(ONE_CHUNK)) > 1e-4


def test_service_prewarm_reaches_the_batcher(batcher_services, monkeypatch):
    _, t = batcher_services
    seen = []
    orig = t.runtime.batcher.prewarm
    monkeypatch.setattr(t.runtime.batcher, "prewarm", lambda lengths, **kw: seen.append(lengths) or orig(lengths, **kw))
    t.prewarm(token_lengths=(3,))
    assert seen == [(3,)]
    assert len(t.synthesize(ONE_CHUNK)) > 0
