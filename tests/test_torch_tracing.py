"""The port's request-scoped spans (``go_pocket_tts_tpu_torch/tracing.py``)
on the CPU, on ``tiny_arch()``: off, nothing is recorded and the audio is
the same bit for bit; on, every request through ``GPURuntime`` and
``stream_generate`` has one root span and every request through the batcher
one ``queue`` span, children lie inside their parents and carry their ids,
the engine loop's spans follow one another
without overlapping, the AR blocks' sizes add up to the steps the engine
ran, a streamed request has one enqueue/wait/emit triple a block, and the
switch changes no graph."""

import threading

import numpy as np
import pytest

from go_pocket_tts_tpu_torch import tracing
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime, stream_generate

ARCH = synthetic.tiny_arch()
TOKENS = [[3, 17, 41, 9], [5, 8, 13]]
STEPS = 6  # a streamed request: segments of 4 and 2 (a tail) frames
ENGINE_LOOP = {"reap", "idle", "block", "admit", "wait", "emit", "harvest"}
TIMEOUT = 60.0


def _cfg(steps=STEPS):
    return GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=steps)


@pytest.fixture(scope="module")
def runs():
    """Each system run twice, tracing off then on (each on the same objects:
    the switch must change no graph): the outputs, the graph keys and
    captures after each run, and the second run's spans."""
    tracing.disable()
    tracing.reset()
    model = load_model_from_tensors(synthetic.build_checkpoint(ARCH, seed=31), num_heads=ARCH.num_heads, device="cpu")
    rt = GPURuntime(model, seed=5, device="cpu", frame_bucket=64)
    b = ContinuousBatcher(model, slots=2, prompt_capacity=64, max_frames=16, steps_per_sync=4, seed=3, device="cpu")
    out = {}
    try:
        for on in (False, True):
            if on:
                tracing.enable()
            steps = []
            out[on] = {
                "runtime": _run_runtime(rt),
                "batcher": _run_batcher(b, steps),
                "steps": steps,
                "graphs": (set(rt._graphs.keys()), rt._graphs.captures, set(b._graphs.keys()), b.graph_stats()),
                "spans": tracing.spans(),
            }
    finally:
        tracing.disable()
        tracing.reset()
    return out


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _run_runtime(rt):
    """One one-shot and one streamed request per token list, one at a time."""
    out = []
    for tokens in TOKENS:
        out.append(rt.generate_audio(tokens, _cfg()))
        out.append(list(stream_generate(rt, tokens, _cfg())))
    return out


def _run_batcher(b, steps):
    """One one-shot then one streamed request per token list, one at a time
    (so that both runs make the same blocks), then every list at once,
    one-shot. ``steps`` receives each AR block's size."""
    orig = b._ar_block
    b._ar_block = lambda k: (steps.append(k), orig(k))[1]
    b.start()
    try:
        out = []
        for tokens in TOKENS:
            out.append(b.submit(tokens, _cfg()).result(timeout=TIMEOUT))
            out.append(list(b.submit_stream(tokens, _cfg(), timeout=TIMEOUT)))
        futures = [b.submit(tokens, _cfg(4)) for tokens in TOKENS]
        burst = [f.result(timeout=TIMEOUT) for f in futures]
    finally:
        b.stop()
        del b._ar_block
    return out, burst


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if isinstance(x, list):
            _same(x, y)
        else:
            assert x.dtype == y.dtype and np.array_equal(x, y)


def _inside(child, parent):
    return parent.start <= child.start and child.end <= parent.end


def test_an_off_site_allocates_nothing():
    assert tracing.span("block", engine=0) is tracing.span("wait")
    with tracing.span("wait") as sp:
        assert sp is None
    assert tracing.begin("request", request=1) is None and tracing.now() is None
    tracing.record("queue", 1, request=1, engine=0)
    assert tracing.spans() == []
    a, b = tracing.next_request_id(), tracing.next_request_id()
    assert isinstance(a, int) and b > a


@pytest.mark.parametrize("system", ["runtime", "batcher"])
def test_off_records_nothing_and_on_changes_no_sample(runs, system):
    assert runs[False]["spans"] == [] and runs[True]["spans"]
    off, on = runs[False][system], runs[True][system]
    if system == "batcher":
        off, on = off[0], on[0]  # the burst's admissions follow the threads' timing
    _same(off, on)


def test_the_switch_changes_no_graph(runs):
    assert runs[False]["graphs"] == runs[True]["graphs"]


def test_single_runtime_requests(runs):
    out = runs[True]["runtime"]
    spans = [s for s in runs[True]["spans"] if s.engine is None]
    roots = [s for s in spans if s.name == "request"]
    assert len(roots) == 2 * len(TOKENS) and len({r.request for r in roots}) == len(roots)
    by_id = {s.id: s for s in spans}
    for s in spans:
        assert s.end >= s.start
        if s.parent is not None:
            assert _inside(s, by_id[s.parent]) and s.request == by_id[s.parent].request
    for i, root in enumerate(roots):
        kids = [s for s in spans if s.parent == root.id]
        names = [s.name for s in kids]
        if i % 2 == 0:  # one-shot
            assert names == ["setup", "ar", "decode", "wait"]
        else:  # streamed: setup, then one enqueue, wait, emit triple a block
            blocks = out[i]
            assert names == ["setup"] + ["enqueue", "wait", "emit"] * len(blocks)
            enq = [s for s in kids if s.name == "enqueue"]
            assert [s.attrs["frames"] for s in enq] == [len(b) // 1920 for b in blocks]
        # The prefill's copy of the ids waits inside the setup.
        assert [s.name for s in spans if s.parent == kids[0].id] == ["wait"]


def test_batcher_requests_and_engine_loop(runs):
    out, burst = runs[True]["batcher"]
    spans = [s for s in runs[True]["spans"] if s.engine is not None]
    by_id = {s.id: s for s in spans}
    queued = [s for s in spans if s.name == "queue"]
    assert len(queued) == len(out) + len(burst) and len({q.request for q in queued}) == len(queued)
    assert all(q.parent is None and q.engine == 0 and q.start <= q.end for q in queued)
    admits = [s for s in spans if s.name == "admit"]
    # An engine takes a request off the queue, then opens the admission.
    assert all(any(q.end <= a.start for a in admits) for q in queued)
    # Every other span: inside its parent, with its request id and engine.
    for s in spans:
        if s.parent is not None:
            p = by_id[s.parent]
            assert _inside(s, p) and s.request == p.request and s.engine == p.engine == 0
    loop = [s for s in spans if s.name in ENGINE_LOOP and s.request is None]
    assert len({s.thread for s in loop}) == 1
    top = sorted((s for s in loop if s.parent is None), key=lambda s: s.start)
    assert {s.name for s in top} == ENGINE_LOOP
    for a, c in zip(top, top[1:]):
        assert a.end <= c.start
    for w in (s for s in loop if s.name == "wait"):
        assert any(_inside(w, t) for t in top)
    # The ids' copy of an admission and the slot release's copy wait.
    assert {by_id[w.parent].name for w in loop if w.name == "wait" and w.parent is not None} == {"prepare", "harvest"}
    blocks = [s for s in spans if s.name == "block"]
    assert sum(s.attrs["k"] for s in blocks) == sum(runs[True]["steps"]) > 0
    assert all(0 < s.attrs["attached"] <= 2 for s in blocks)


def test_a_span_across_threads():
    tracing.enable()
    root = tracing.begin("request", request=7)
    with tracing.span("setup", parent=root) as sp:
        with tracing.span("wait") as inner:
            pass
    done = threading.Event()

    def end():
        root.finish()
        root.finish()  # a second end records nothing
        done.set()

    threading.Thread(target=end).start()
    assert done.wait(5)
    t = tracing.now()
    waited = threading.Thread(target=tracing.record, args=("queue", t), kwargs={"request": 8, "engine": 1})
    waited.start()
    waited.join(5)
    spans = tracing.spans()
    assert [s.name for s in spans] == ["wait", "setup", "request", "queue"]
    assert spans[-1].start == t < spans[-1].end and (spans[-1].request, spans[-1].engine) == (8, 1)
    assert inner.parent == sp.id and sp.parent == root.id and inner.request == sp.request == 7
    tracing.reset()
    assert tracing.spans() == []
