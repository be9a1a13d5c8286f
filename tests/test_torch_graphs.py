"""The port's per-bucket graphs (``runtime/graphs.py``) on the CPU, where
each graph's body runs eagerly over its static buffers: the single
runtime's AR segments (a tail, an early ``done``) and decode, the
streamer's segments (4, 8, 16 frames and a tail), the batcher's AR block
with admissions between blocks, its stream decode and its harvest decode
at both lane counts, each bit-equal to the eager loops they replace and
within ``ops.TOLERANCES`` of the JAX package at temperature 0 (the
streamed path's: ``tests/test_torch_streaming.py``); a session's
carried cache against a later request; the graph keys; and the launch
accounting of capture and replay, with a stub wrapper."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.ops import TOLERANCES
from go_pocket_tts_tpu.parallel import ContinuousBatcher as JBatcher
from go_pocket_tts_tpu.runtime import GenerateConfig as JConfig
from go_pocket_tts_tpu.runtime import TPURuntime
from go_pocket_tts_tpu.utils.safetensors import encode_tensors, open_store_from_bytes
from go_pocket_tts_tpu_torch.kernels import seanet_tail as st
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher
from go_pocket_tts_tpu_torch.parallel.batching import _harvest_decode_pcm16, _Request
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime, stream_generate, stream_generate_session
from go_pocket_tts_tpu_torch.runtime import graphs

ARCH = synthetic.tiny_arch()
SEED = 21
TOKENS = [3, 17, 41, 9]
ATOL, RTOL = TOLERANCES["conv_transpose1d"]  # PCM through the Mimi decoder's last stage


@pytest.fixture(scope="module")
def models():
    jm = load_model_from_store(
        open_store_from_bytes(encode_tensors(j_syn.build_checkpoint(ARCH, seed=SEED))), num_heads=ARCH.num_heads
    )
    tm = load_model_from_tensors(synthetic.build_checkpoint(ARCH, seed=SEED), num_heads=ARCH.num_heads, device="cpu")
    return jm, tm


def _runtime(tm, graphs_on: bool, sync_every: int = 4, **kw) -> GPURuntime:
    rt = GPURuntime(tm, seed=5, device="cpu", **{"frame_bucket": 64, **kw})
    rt.SYNC_EVERY = sync_every
    if not graphs_on:
        rt._graphs = None  # the eager loops
    return rt


# -- the single runtime and the streamer ---------------------------------------

# (max_steps, eos_threshold, temperature): 10 steps are two 4-step graphs
# and a 2-step tail; an EOS on step 0 with 2 frames after it ends the loop
# after the first graph (done read between graphs); and sampled noise.
SINGLE = {
    "tail": (10, 1e9, 0.0),
    "early_done": (30, -1e9, 0.0),
    "sampled": (10, 1e9, 0.7),
}


@pytest.mark.parametrize("case", list(SINGLE))
def test_single_graphs_are_the_eager_loop(models, case):
    _, tm = models
    steps, eos, temp = SINGLE[case]
    cfg = GenerateConfig(temperature=temp, eos_threshold=eos, max_steps=steps, frames_after_eos=2)
    outs = []
    for graphs_on in (True, False):
        rt = _runtime(tm, graphs_on)
        with rt._compute():
            cache, max_steps, decode_steps, frame_bucket, _ = rt._setup(TOKENS, cfg)
            frames, n_frames, carry = rt._ar_loop(cache, cfg, max_steps, decode_steps, frame_bucket)
            frames, n_frames, offset = frames.clone(), n_frames.clone(), carry["cache"]["offset"].clone()
        outs.append((frames, n_frames, offset, carry["t"], rt.generate_audio(TOKENS, cfg)))
    (f, n, o, t, audio), (f_e, n_e, o_e, t_e, audio_e) = outs
    assert torch.equal(f, f_e) and torch.equal(n, n_e) and torch.equal(o, o_e) and t == t_e
    np.testing.assert_array_equal(audio, audio_e)
    assert int(n[0]) == (3 if case == "early_done" else steps)
    assert t == (4 if case == "early_done" else steps)


def test_single_graphs_match_the_reference(models):
    jm, tm = models
    kw = dict(temperature=0.0, eos_threshold=1e9, max_steps=10)
    want = TPURuntime(jm, dtype=jnp.float32, seed=1, frame_bucket=64).generate_audio(TOKENS, JConfig(**kw))
    rt = _runtime(tm, True)
    got = rt.generate_audio(TOKENS, GenerateConfig(**kw))
    assert len(rt._graphs) == 4  # prefill, AR 4 steps, AR 2-step tail, decode
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("temperature", [0.0, 0.7])
def test_streamed_graphs_are_the_eager_segments(models, temperature):
    """31 frames: segments of 4, 8, 16 and a 3-step tail of the 16-frame
    segment, each a graph of its own, bit-equal to the eager segments and
    blocks; sampled, the blocks are the one-shot path's frames too."""
    _, tm = models
    cfg = GenerateConfig(temperature=temperature, eos_threshold=1e9, max_steps=31)
    rt = _runtime(tm, True, sync_every=16)
    got = list(stream_generate(rt, TOKENS, cfg))
    want = list(stream_generate(_runtime(tm, False, sync_every=16), TOKENS, cfg))
    assert [len(b) // 1920 for b in got] == [4, 8, 16, 3]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    # AR keys: (segment size, steps) = (4, 4), (8, 8), (16, 16) and the tail (16, 3).
    ar_keys = sorted((k[3], k[-1]) for k in rt._graphs.keys() if k[0] == "ar")
    assert ar_keys == [(4, 4), (8, 8), (16, 3), (16, 16)]
    assert sorted(k[2] for k in rt._graphs.keys() if k[0] == "stream") == [4, 8, 16]
    whole = _runtime(tm, True, sync_every=16).generate_audio(TOKENS, cfg)
    np.testing.assert_allclose(np.concatenate(got), whole, atol=3e-4, rtol=1e-3)  # int16 truncation apart


@pytest.mark.parametrize("streamed", [False, True])
def test_a_session_cache_outlives_the_next_request(models, streamed):
    """The carried cache is the session's own copy: a later request of the
    same bucket (the loop's static cache) leaves it as it was."""
    _, tm = models
    rt = _runtime(tm, True)
    cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=6)
    if streamed:
        blocks, next_state = stream_generate_session(rt, TOKENS, cfg)
        list(blocks)
        cont = next_state()
    else:
        _, cont = rt.generate_audio_session(TOKENS, cfg)
    kept = {key: val.clone() for key, val in cont.cache.items()}
    static = rt._buffers[("cache", 1, cont.capacity)]
    assert all(cont.cache[key] is not static[key] for key in kept)
    assert torch.equal(cont.cache["k"], static["k"])  # the copy was taken at the chunk's end
    rt.generate_audio_session([9, 9, 2, 5, 30], cfg)  # a new session, the same key
    assert not torch.equal(static["k"], kept["k"])
    for key, val in kept.items():
        assert torch.equal(cont.cache[key], val)
    # The carried chunk goes on as the eager loop's would.
    got, _ = rt.generate_audio_session([5, 9], cfg, cont)
    want_rt = _runtime(tm, False)
    _, want_cont = want_rt.generate_audio_session(TOKENS, cfg)
    want, _ = want_rt.generate_audio_session([5, 9], cfg, want_cont)
    np.testing.assert_array_equal(got, want)


# Each case changes one static field of the base request and names the key
# field (position in the AR key) that must change with it.
BASE = dict(temperature=0.0, eos_threshold=1e9, max_steps=8)
KEYS = {
    "repeat": ({}, {}, None),
    "steps": ({"max_steps": 7}, {}, 6),  # a 3-step tail
    "decode_steps": ({"lsd_decode_steps": 2}, {}, 5),
    "frame_bucket": ({"max_steps": 8}, {"frame_bucket": 8}, 3),  # 9 frames pick the next bucket
    "capacity": ({"tokens": [i % 50 + 1 for i in range(70)]}, {}, 2),  # prompt bucket 16 -> 128
    "dtype": ({}, {"dtype": torch.bfloat16}, 4),
    "temperature": ({"temperature": 0.7, "eos_threshold": -4.0, "frames_after_eos": 5}, {}, None),
}


@pytest.mark.parametrize("case", list(KEYS))
def test_graph_keys(models, case):
    """A repeated bucket reuses its graphs and a sampling knob is no part
    of a key; every static field gives new ones."""
    _, tm = models
    change, rt_kw, field = KEYS[case]
    rt = _runtime(tm, True)
    rt.generate_audio(TOKENS, GenerateConfig(**BASE))
    base = set(rt._graphs.keys())
    if rt_kw:
        rt = _runtime(tm, True, **rt_kw)
    cfg = {**BASE, **change}
    tokens = cfg.pop("tokens", TOKENS)
    rt.generate_audio(tokens, GenerateConfig(**cfg))
    new = {k for k in rt._graphs.keys() if k[0] == "ar"} - base
    if field is None:
        assert set(rt._graphs.keys()) == base
        return
    assert new, case
    base_ar = {k for k in base if k[0] == "ar"}
    for key in new:
        assert all(key[field] != b[field] for b in base_ar), (case, key, base_ar)


# -- the batcher ----------------------------------------------------------------


def _engine(tm, graphs_on: bool, **kw) -> ContinuousBatcher:
    batcher = ContinuousBatcher(
        tm, slots=2, prompt_capacity=32, max_frames=16, seed=3, steps_per_sync=2, device="cpu", **kw
    )
    if not graphs_on:
        batcher._graphs = None
    return batcher


def _drive(batcher: ContinuousBatcher) -> list:
    """Drive the engine's programs by hand, in this thread: a streamed lane
    admitted alone, two blocks, a plain lane admitted between blocks (a
    one-lane prefill), three more blocks with the stream decode, then the
    harvest decode at both lane counts. Returns every output, copied."""
    import queue

    from concurrent.futures import Future

    out = []
    with torch.no_grad():
        batcher._queue.put(_Request([3, 17, 41], GenerateConfig(temperature=0.7, eos_threshold=1e9, max_steps=9),
                                    Future(), stream=queue.Queue()))
        batcher._admit()
        for block in range(5):
            if block == 2:
                batcher._queue.put(_Request([5, 9, 2, 60], GenerateConfig(temperature=0.0, eos_threshold=-1e9,
                                                                          max_steps=9, frames_after_eos=3), Future()))
                batcher._admit()
            windows, n_new, flags = batcher._ar_block(2)
            pcm16 = batcher._stream_decode(windows, n_new, [True, False])
            out += [t.clone() for t in (windows, n_new, flags, pcm16)]
        for lanes in ([1], [1, 0]):
            out.append(batcher._harvest_decode(torch.tensor(lanes), 16).clone())
        state = batcher._state
        out += [state["frames"].clone(), state["cache"]["k"].clone(), state["cache"]["offset"].clone()]
        out += [t.clone() for t in batcher._stream_state.values()]
    return out


@pytest.mark.parametrize("quantize", [False, True])
def test_batcher_graphs_are_the_eager_engine(models, quantize):
    _, tm = models
    kw = dict(quantize=True, kv_quantize=True) if quantize else {}
    graphed = _engine(tm, True, **kw)
    got = _drive(graphed)
    want = _drive(_engine(tm, False, **kw))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert torch.equal(g, w), i
    keys = graphed._graphs.keys()
    assert {k[0] for k in keys} == {"block", "stream", "harvest", "admit", "reset"}
    assert sorted(k[2] for k in keys if k[0] == "harvest") == [1, 2]
    # The harvest decode is the eager function over the engine's state.
    frames, n_frames = graphed._state["frames"], graphed._state["n_frames"]
    eager = _harvest_decode_pcm16(graphed.model, frames, torch.tensor([1, 0]), n_frames, 16)
    assert torch.equal(graphed._harvest_decode(torch.tensor([1, 0]), 16), eager)


def test_batcher_graphs_match_the_reference(models):
    jm, tm = models
    reqs = [([3, 17, 41], 7), ([5, 9, 2, 60, 7], 11)]
    common = dict(slots=2, prompt_capacity=32, max_frames=16, seed=3, steps_per_sync=2)

    def serve(batcher, config):
        batcher.start()
        try:
            futs = [batcher.submit(t, config(temperature=0.0, eos_threshold=1e9, max_steps=n)) for t, n in reqs]
            out = [f.result(timeout=120) for f in futs]
            return out, batcher._graphs.keys() if hasattr(batcher, "_graphs") else None
        finally:
            batcher.stop()

    want, _ = serve(JBatcher(jm, **common), JConfig)
    graphed = ContinuousBatcher(tm, device="cpu", **common)
    got, keys = serve(graphed, GenerateConfig)
    assert {k[0] for k in keys} == {"block", "harvest", "admit"}
    assert len(graphed._graphs) == 0  # stop() released them
    for (_, n), g, w in zip(reqs, got, want):
        assert len(g) == len(w) == n * 1920
        np.testing.assert_allclose(g, np.asarray(w), atol=ATOL, rtol=RTOL)


# -- the plain streamed cascade a graph can capture -------------------------------


def test_plain_stream_cascade_without_a_host_read(models):
    """The form the card's graphs capture (every halo length, selected per
    lane) is the host-grouped one at mixed starts, inside ``start < HALO``
    too."""
    gen = torch.Generator().manual_seed(0)
    shapes = ((128, 256, 10), (128,), (64, 128, 3), (64,), (128, 64, 1), (128,), (64, 128, 8), (64,),
              (32, 64, 3), (32,), (64, 32, 1), (64,), (1, 64, 7), (1,))
    weights = [torch.randn(s, generator=gen) * 0.05 for s in shapes]
    x = torch.randn((5, 256, 4), generator=gen)
    halo = torch.randn((5, 256, st.HALO), generator=gen)
    start = torch.tensor([0, 2, 5, 40, 3], dtype=torch.int32)
    want = st.fused_up2_up3_tail_stream_plain(x, halo, start, *weights)
    got = st._stream_plain_every_halo(x, halo, start, *weights)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)  # lanes batched apart: summation order


# -- launch accounting ------------------------------------------------------------


def _stub_wrapper():
    def launch(x):
        launch.launches += 1
        launch.shapes[tuple(x.shape)] = launch.shapes.get(tuple(x.shape), 0) + 1

    launch.launches, launch.shapes = 5, {(2, 3): 5}
    return launch


class _FakeCUDAGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


@pytest.mark.parametrize("replays", [1, 3])
def test_capture_counts_come_out_and_each_replay_adds_its_tally(replays, monkeypatch):
    stub = _stub_wrapper()
    x, y = torch.zeros(2, 3), torch.zeros(4)

    def body(inputs):
        stub(inputs["x"])
        stub(inputs["x"])
        stub(inputs["y"])
        return inputs["x"] + 1

    # Warm-up and capture both launch; only the capture's count is kept.
    out, tally = graphs.accounted([stub], lambda: body({"x": x, "y": y}), lambda: body({"x": x, "y": y}))
    assert torch.equal(out, x + 1)
    assert (stub.launches, stub.shapes) == (5, {(2, 3): 5})
    assert tally == [(3, {(2, 3): 2, (4,): 1})]

    cache = graphs.GraphCache(torch.device("cuda"))  # replay with a stand-in for the captured graph
    cache.wrappers = [stub]

    def fake_capture(graph):
        graph.outputs, graph.tally = graphs.accounted(cache.wrappers, lambda: None, lambda: graph.body(graph.inputs))
        graph._graph = _FakeCUDAGraph()

    monkeypatch.setattr(cache, "_capture", fake_capture)
    graph = cache.get(("k",), lambda: (body, {"x": x, "y": y}))
    for _ in range(replays):
        assert torch.equal(graph.run(), x + 1)
    assert graph._graph.replays == replays
    assert stub.launches == 5 + 3 * replays
    assert stub.shapes == {(2, 3): 5 + 2 * replays, (4,): replays}
    assert cache.get(("k",), lambda: pytest.fail("made twice")) is graph


def test_a_failed_capture_leaves_the_counts_and_raises():
    stub = _stub_wrapper()

    def capture():
        stub(torch.zeros(1))
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match="capturing"):
        graphs.accounted([stub], lambda: stub(torch.zeros(1)), capture)
    assert (stub.launches, stub.shapes) == (5, {(2, 3): 5})


def test_outputs_are_static_on_the_cpu():
    """A graph's outputs are the same tensors at every run, overwritten,
    as on the card: a caller copies them before the next run."""
    cache = graphs.GraphCache(torch.device("cpu"))
    state = {"n": torch.zeros(()), "t": {"m": torch.ones(2)}}

    def body(inputs):
        new = {"n": inputs["n"] + 1, "t": {"m": inputs["t"]["m"] * 2}}
        graphs.write_back(inputs, new)
        return inputs["n"] * 10

    graph = cache.get("g", lambda: (body, state))
    first = graph.run()
    kept = first.clone()
    second = graph.run()
    assert second is first and float(second) == 20.0 and float(kept) == 10.0
    assert float(state["n"]) == 2.0 and state["t"]["m"].tolist() == [4.0, 4.0]
    buf = {"a": torch.zeros(3)}
    graphs.feed(buf, a=torch.arange(3.0))
    assert buf["a"].tolist() == [0.0, 1.0, 2.0]
    same = buf["a"]
    graphs.feed(buf, a=same)
    assert buf["a"] is same


def test_a_dropped_cache_frees_its_graphs_without_a_collection():
    """A graph refers to its cache only weakly: dropping the cache (or
    releasing it) frees its graphs at once, never in a garbage collection,
    which could run inside another capture."""
    import gc
    import weakref

    enabled = gc.isenabled()
    gc.disable()
    try:
        cache = graphs.GraphCache(torch.device("cpu"))
        released = weakref.ref(cache.get("b", lambda: (lambda inputs: None, {})))
        cache.release()
        assert released() is None and len(cache) == 0
        cache = graphs.GraphCache(torch.device("cpu"))
        dropped = weakref.ref(cache.get("a", lambda: (lambda inputs: None, {})))
        del cache
        assert dropped() is None
    finally:
        if enabled:
            gc.enable()
