"""The port's prefill, admission, slot prefill, snapshot and stream-reset
graphs (``runtime/graphs.py``) on the CPU, where each graph's body runs
eagerly over its static buffers: the single runtime's prefill (fresh, an
embedding voice, a hydrated voice state, a session's carried cache), the
batcher's burst admission (1 and every slot, int8 KV, an embedding voice),
its hydrated or session lane and snapshot, and the mesh replicas' graphs,
each bit-equal to the eager path (``_graphs = None``) and within
``ops.TOLERANCES`` of the JAX package at temperature 0; the prefill keys,
the loop cache the prefill writes, the cross-device replica's eager rule
and ``prewarm``'s warmed buckets."""

import queue
from concurrent.futures import Future

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.ops import TOLERANCES
from go_pocket_tts_tpu.parallel import ContinuousBatcher as JBatcher
from go_pocket_tts_tpu.parallel import mesh as j_mesh
from go_pocket_tts_tpu.runtime import GenerateConfig as JConfig
from go_pocket_tts_tpu.runtime import TPURuntime
from go_pocket_tts_tpu.utils import safetensors as j_st
from go_pocket_tts_tpu.utils.safetensors import encode_tensors, open_store_from_bytes
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher, batching, dp_mesh, dp_tp_mesh
from go_pocket_tts_tpu_torch.parallel.batching import _Request
from go_pocket_tts_tpu_torch.runtime import ContinuationState, GenerateConfig, GPURuntime, generate
from go_pocket_tts_tpu_torch.utils import safetensors as t_st

ARCH = synthetic.tiny_arch()
SEED = 23
TOKENS = [3, 17, 41, 9]
NEXT = [5, 9, 30]
HEAD_DIM = ARCH.d_model // ARCH.num_heads
ATOL, RTOL = TOLERANCES["conv_transpose1d"]  # PCM through the Mimi decoder's last stage


@pytest.fixture(scope="module")
def models():
    jm = load_model_from_store(
        open_store_from_bytes(encode_tensors(j_syn.build_checkpoint(ARCH, seed=SEED))), num_heads=ARCH.num_heads
    )
    tm = load_model_from_tensors(synthetic.build_checkpoint(ARCH, seed=SEED), num_heads=ARCH.num_heads, device="cpu")
    return jm, tm


def _modules(frames=6, seed=4):
    rng = np.random.RandomState(seed)
    return {
        f"transformer.layers.{i}.self_attn": {
            "cache": (rng.randn(2, 1, frames, ARCH.num_heads, HEAD_DIM) * 0.3).astype(np.float32),
            "offset": np.array([float(frames)], np.float32),
        }
        for i in range(ARCH.num_layers)
    }


def _embedding(frames=5, seed=4):
    return (np.random.RandomState(seed).randn(1, frames, ARCH.d_model) * 0.02).astype(np.float32)


def _voice(case, torch_side=True):
    """The config fields of a voice case, for the port or the reference."""
    if case == "voice_embedding":
        return {"voice_embedding": _embedding()}
    if case == "voice_state":
        state = (t_st if torch_side else j_st).VoiceModelState(modules=_modules())
        return {"voice_model_state": state}
    return {}


def _runtime(tm, graphs_on: bool, **kw) -> GPURuntime:
    rt = GPURuntime(tm, seed=5, device="cpu", **{"frame_bucket": 64, **kw})
    rt.SYNC_EVERY = 4
    if not graphs_on:
        rt._graphs = None  # the eager prefill and loops
    return rt


def _cfg(**kw):
    return GenerateConfig(**{"temperature": 0.0, "eos_threshold": 1e9, "max_steps": 6, **kw})


def _copy(cont: ContinuationState) -> ContinuationState:
    return ContinuationState(generate.own_cache(cont.cache), cont.capacity, cont.used_ub)


def _same(got, want, what) -> None:
    """Bit-equal, NaN sentinels included."""
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True, msg=lambda m: f"output {what}: {m}")


# -- the single runtime ---------------------------------------------------------


def _prefilled(rt, case):
    """The case's chunk prefilled: (K rows, V rows below the offset, the
    offset), copied; then the chunk's PCM."""
    cfg = _cfg(**_voice(case))
    cont = rt.generate_audio_session(TOKENS, cfg)[1] if case == "session" else None
    with rt._compute():
        if case == "session":
            cache = rt._session_setup(NEXT, _cfg(), _copy(cont))[0]
        else:
            cache = rt._setup(TOKENS, cfg)[0]
        off = int(cache["offset"])
        rows = (cache["k"][:, :, :, :off].clone(), cache["v"][:, :, :, :off].clone(), off)
    pcm = rt.generate_audio_session(NEXT, _cfg(), cont)[0] if case == "session" else rt.generate_audio(TOKENS, cfg)
    return rows, pcm


@pytest.mark.parametrize("case", ["fresh", "voice_embedding", "voice_state", "session"])
def test_prefill_graph_is_the_eager_prefill(models, case):
    _, tm = models
    graphed = _runtime(tm, True)
    (k, v, off), pcm = _prefilled(graphed, case)
    (k_e, v_e, off_e), pcm_e = _prefilled(_runtime(tm, False), case)
    assert off == off_e >= len(TOKENS if case != "session" else NEXT)
    assert torch.equal(k, k_e) and torch.equal(v, v_e)
    np.testing.assert_array_equal(pcm, pcm_e)
    prefill = [key for key in graphed._graphs.keys() if key[0] == "prefill"]
    sources = {"session": {"fresh", "given"}, "voice_state": {"given"}}.get(case, {"fresh"})
    assert {key[-1] for key in prefill} == sources


def test_prefill_graphs_match_the_reference(models):
    """Plain, voiced (state) and a session's second chunk, graphs on,
    against ``TPURuntime`` at temperature 0."""
    jm, tm = models
    kw = dict(temperature=0.0, eos_threshold=1e9, max_steps=6)
    want_rt = TPURuntime(jm, dtype=jnp.float32, seed=1, frame_bucket=64)
    rt = _runtime(tm, True)
    for case in ("fresh", "voice_state"):
        want = want_rt.generate_audio(TOKENS, JConfig(**kw, **_voice(case, torch_side=False)))
        got = rt.generate_audio(TOKENS, GenerateConfig(**kw, **_voice(case)))
        np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)
    _, j_cont = want_rt.generate_audio_session(TOKENS, JConfig(**kw))
    want, _ = want_rt.generate_audio_session(NEXT, JConfig(**kw), j_cont)
    _, cont = rt.generate_audio_session(TOKENS, GenerateConfig(**kw))
    got, _ = rt.generate_audio_session(NEXT, GenerateConfig(**kw), cont)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


def test_the_prefill_writes_the_loop_cache(models, monkeypatch):
    """The prefill graph's output is the AR loop's static cache: the loop's
    feed copies no K/V; a given cache is copied in, and left as it was."""
    _, tm = models
    rt = _runtime(tm, True)
    copied = []
    real_feed = generate.feed

    def recording_feed(buffers, **tensors):
        copied.extend(name for name, t in tensors.items() if t is not buffers[name])
        real_feed(buffers, **tensors)

    monkeypatch.setattr(generate, "feed", recording_feed)
    with rt._compute():
        cache, max_steps, decode_steps, frame_bucket, _ = rt._setup(TOKENS, _cfg())
        static = rt._buffers[("cache", 1, cache["k"].shape[3])]
        assert all(cache[key] is static[key] for key in ("k", "v", "offset"))
        copied.clear()
        rt._ar_loop(cache, _cfg(), max_steps, decode_steps, frame_bucket)
    assert not {"k", "v", "offset"} & set(copied)
    _, cont = rt.generate_audio_session(TOKENS, _cfg())
    kept = generate.own_cache(cont.cache)
    copied.clear()
    with rt._compute():
        cache = rt._session_setup(NEXT, _cfg(), cont)[0]
    assert {"k", "v", "offset"} <= set(copied)  # the carried cache copied in once
    assert cache["k"] is rt._buffers[("cache", 1, cont.capacity)]["k"]
    assert all(torch.equal(cont.cache[key], kept[key]) for key in kept)


# Each case changes one static field of the base prefill and names its
# position in the key ("prefill", batch, bucket, voice length, capacity,
# dtype, cache source).
KEYS = {
    "token_bucket": ({"bucket": 32}, 2),
    "capacity": ({"capacity": 192}, 4),
    "voice_len": ({"voice": 5}, 3),
    "cache_source": ({"given": True}, 6),
    "dtype": ({"dtype": torch.bfloat16}, 5),
}


@pytest.mark.parametrize("case", list(KEYS))
def test_prefill_graph_keys(models, case):
    _, tm = models
    change, field = KEYS[case]

    def prefill(rt, bucket=16, capacity=128, voice=0, given=False, **_):
        ids = torch.zeros((1, bucket), dtype=torch.long)
        ids[0, :4] = torch.tensor(TOKENS)
        emb = torch.as_tensor(_embedding(voice)) if voice else None
        cache = rt._cache_buffers(1, capacity, fresh=True) if given else None
        with rt._compute():
            rt._prefill(ids, 4, capacity, cache, emb)

    rt = _runtime(tm, True)
    prefill(rt)
    prefill(rt)  # a repeated bucket reuses its graph
    (base,) = rt._graphs.keys()
    if "dtype" in change:
        rt = _runtime(tm, True, dtype=change["dtype"])
    prefill(rt, **change)
    new = [key for key in rt._graphs.keys() if key != base]
    assert len(new) == 1
    assert [i for i, (a, b) in enumerate(zip(base, new[0])) if a != b] == [field]


# -- the batcher ----------------------------------------------------------------


def _batcher(tm, graphs_on: bool, slots=2, **kw) -> ContinuousBatcher:
    b = ContinuousBatcher(tm, slots=slots, prompt_capacity=32, max_frames=16, seed=3, steps_per_sync=2,
                          device="cpu", **kw)
    if not graphs_on:
        for engine in b._engines():
            engine._graphs = None
    return b


def _put(b, tokens, cfg, stream=False, cont=None, keep_state=False):
    b._queue.put(_Request(list(tokens), cfg, Future(), stream=queue.Queue() if stream else None, cont=cont,
                          keep_state=keep_state))


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in _leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for val in tree for leaf in _leaves(val)]
    return [tree.clone()]


def _state(engine) -> list:
    """Every leaf of the engine's state, copied."""
    return _leaves(engine._state)


def _blocks(engine, n=2) -> list:
    out = []
    for _ in range(n):
        out += [t.clone() for t in engine._ar_block(2)]
    return out


ADMISSIONS = {  # (lanes admitted, batcher knobs, a voice embedding on lane 0)
    "1": (1, {}, False),
    "slots": (2, {}, False),
    "int8_kv": (2, {"quantize": True, "kv_quantize": True}, False),
    "voice": (2, {}, True),
}


def _admitted(b, case):
    n, _knobs, voiced = ADMISSIONS[case]
    with torch.no_grad():
        for i in range(n):
            voice = {"voice_embedding": _embedding()} if voiced and i == 0 else {}
            _put(b, TOKENS[: 3 + i], _cfg(temperature=0.7 if i else 0.0, max_steps=5 + i, **voice))
        b._admit()
        out = _state(b) + _blocks(b)
        out.append(b._harvest_decode(torch.tensor([0] * n if n == 1 else [1, 0]), 16).clone())
    return out


@pytest.mark.parametrize("case", list(ADMISSIONS))
def test_admission_graph_is_the_eager_admission(models, case):
    _, tm = models
    n, knobs, _ = ADMISSIONS[case]
    graphed = _batcher(tm, True, **knobs)
    got, want = _admitted(graphed, case), _admitted(_batcher(tm, False, **knobs), case)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, i)
    (key,) = [k for k in graphed._graphs.keys() if k[0] == "admit"]
    assert key[1] == n and key[-1] == bool(knobs.get("kv_quantize"))
    # The packed per-lane values: float fields through their bits.
    assert float(graphed._state["sigma"][1 if n == 2 else 0]) == float(np.float32(np.sqrt(0.7 if n == 2 else 0.0)))


def _hydrated(b, case):
    """A plain lane's snapshot, then a voice-state or session lane in slot
    0, its state, blocks and snapshot; the first snapshot must not move."""
    out = []
    with torch.no_grad():
        _put(b, TOKENS, _cfg(max_steps=8))
        b._admit()
        out += _blocks(b)
        first = b._snapshot(0)
        kept = [first.k.clone(), first.v.clone(), first.offset.clone()]
        b._release_slots([0])
        if case == "session":
            first.offset_host = int(first.offset[0])
            _put(b, NEXT, _cfg(), cont=first)
        else:
            _put(b, NEXT, _cfg(**_voice("voice_state")))
        b._admit()
        out += _state(b) + _blocks(b)
        snap = b._snapshot(0)
        out += [snap.k, snap.v, snap.offset, first.k, first.v, first.offset]
        assert all(torch.equal(a, c) for a, c in zip(kept, (first.k, first.v, first.offset)))
    return out


@pytest.mark.parametrize("case", ["voice_state", "session"])
@pytest.mark.parametrize("kv_quantize", [False, True])
def test_hydrated_lane_and_snapshot_graphs_are_eager(models, case, kv_quantize):
    _, tm = models
    graphed = _batcher(tm, True, kv_quantize=kv_quantize)
    got, want = _hydrated(graphed, case), _hydrated(_batcher(tm, False, kv_quantize=kv_quantize), case)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, i)
    kinds = {k[0] for k in graphed._graphs.keys()}
    assert {"admit", "slot", "snapshot"} <= kinds


# -- the mesh replicas ------------------------------------------------------------

MESHES = {  # (JAX mesh, port mesh)
    "dp2": (lambda: j_mesh.dp_mesh(2), lambda: dp_mesh(2, device="cpu")),
    "tp2": (lambda: j_mesh.dp_tp_mesh(1, 2), lambda: dp_tp_mesh(1, 2, device="cpu")),
    "dp2tp2": (lambda: j_mesh.dp_tp_mesh(2, 2), lambda: dp_tp_mesh(2, 2, device="cpu")),
}
MESH_TOKENS = ([5, 9, 2], [7, 1, 4, 8], [11, 3], [2, 6, 9, 12, 4])


def _drive_replicas(b) -> list:
    """Every replica's programs by hand, in this thread: a burst admitted
    over the replicas (a streamed lane on the first), three blocks with the
    stream decode, the harvest decode, a snapshot, and a session chunk
    admitted into a freed slot from it."""
    out = []
    engines = b._engines()
    with torch.no_grad():
        for i, tokens in enumerate(MESH_TOKENS[: b.slots]):
            _put(b, tokens, _cfg(), stream=i == 0)
        for engine in engines:
            engine._admit()
        for _ in range(3):
            for engine in engines:
                windows, n_new, flags = engine._ar_block(2)
                out += [t.clone() for t in (windows, n_new, flags)]
                streaming = [s.request is not None and s.streaming for s in engine._slot_info]
                if any(streaming):
                    out.append(engine._stream_decode(windows, n_new, streaming).clone())
        for engine in engines:
            out.append(engine._harvest_decode(torch.tensor([0] * engine.slots), 16).clone())
        snap = engines[-1]._snapshot(engines[-1].slots - 1)
        snap.offset_host = int(snap.offset[0])
        engines[0]._release_slots([0])
        _put(b, NEXT, _cfg(), cont=snap)
        engines[0]._admit()
        out += [snap.k, snap.v, snap.offset] + _state(engines[0]) + _blocks(engines[0])
    return out


@pytest.mark.parametrize("name", list(MESHES))
def test_mesh_replica_graphs_are_the_eager_replica(models, name):
    jm, tm = models
    j_make, t_make = MESHES[name]
    need = 4 if name == "dp2tp2" else 2
    if len(jax.devices()) < need:
        pytest.skip(f"needs {need} virtual CPU devices (tests/conftest.py makes 8)")
    slots = 4 if name != "tp2" else 2
    common = dict(slots=slots, prompt_capacity=32, max_frames=16, seed=3, steps_per_sync=2)
    graphed = ContinuousBatcher(tm, mesh=t_make(), device="cpu", **common)
    eager = ContinuousBatcher(tm, mesh=t_make(), device="cpu", **common)
    for engine in eager._engines():
        engine._graphs = None
    got, want = _drive_replicas(graphed), _drive_replicas(eager)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _same(g, w, i)
    stats = graphed.graph_stats()
    assert len(stats) == graphed.mesh.dp and all(s["eager_reason"] is None and s["graphs"] for s in stats)
    # Served through the replicas' threads against the JAX batcher over the same mesh.
    tokens = list(MESH_TOKENS[:slots])
    batcher = ContinuousBatcher(tm, mesh=t_make(), device="cpu", **common)
    jb = JBatcher(jm, mesh=j_make(), **common)
    outs = []
    for b, config in ((jb, JConfig), (batcher, GenerateConfig)):
        b.start()
        try:
            futs = [b.submit(t, config(temperature=0.0, eos_threshold=1e9, max_steps=6)) for t in tokens]
            outs.append([f.result(timeout=300) for f in futs])
        finally:
            b.stop()
    for w, g in zip(*outs):
        assert g.shape == w.shape == (6 * 1920,)
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL)


def test_a_replica_across_devices_runs_eagerly(models, monkeypatch):
    """The rule is the mesh's: ranks on the engine's own device capture,
    ranks across devices run eagerly; the stats say which and why."""
    cuda0, cuda1 = torch.device("cuda", 0), torch.device("cuda", 1)
    assert batching._spans_devices(cuda0, None) is None
    assert batching._spans_devices(cuda0, [cuda0, cuda0]) is None
    assert "cuda:0, cuda:1" in batching._spans_devices(cuda0, [cuda0, cuda1])
    _, tm = models
    # Two CPU ranks stand for two cards: the rule sees them as spanning.
    monkeypatch.setattr(batching, "_spans_devices", lambda device, ranks: None if ranks is None else "spans")
    b = ContinuousBatcher(tm, slots=2, prompt_capacity=32, max_frames=16, seed=3, device="cpu",
                          mesh=dp_tp_mesh(1, 2, device="cpu"))
    (stats,) = b.graph_stats()
    assert stats == {"device": "cpu", "graphs": None, "captures": 0, "capture_seconds": 0.0, "pool_bytes": 0,
                     "eager_reason": "spans"}
    b.start()
    try:
        audio = b.generate(TOKENS, _cfg(), timeout=120)
    finally:
        b.stop()
    assert audio.shape == (6 * 1920,) and np.all(np.isfinite(audio))


def test_prewarm_leaves_no_capture_for_a_warmed_bucket(models):
    """After ``prewarm``, plain and streamed requests of its buckets add no
    graph: its traffic made the blocks, stream decode and harvest, and its
    captures every prompt bucket's admission (both lane counts) and slot
    prefill, the snapshot and the resets, without touching the state."""
    _, tm = models
    b = _batcher(tm, True, slots=2)
    before = _state(b)
    b._capture_admissions()
    for g, w in zip(_state(b), before):
        _same(g, w, "state after the captures")
    admits = sorted((k[1], k[2]) for k in b._graphs.keys() if k[0] == "admit")
    assert admits == [(1, 16), (1, 32), (2, 16), (2, 32)]  # prompt capacity 32
    b.start()
    try:
        b.prewarm(token_lengths=(3,))
        warmed = set(b._graphs.keys())
        assert {"admit", "slot", "snapshot", "block", "stream", "reset", "harvest"} <= {k[0] for k in warmed}
        short = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=b.steps_per_sync)
        b.generate([7, 8, 9], short, timeout=120)
        b.generate([7, 8, 9] * 7, short, timeout=120)  # prompt bucket 32: not in prewarm's traffic
        list(b.submit_stream([7, 8, 9], short, timeout=120))
        assert set(b._graphs.keys()) == warmed
    finally:
        b.stop()
