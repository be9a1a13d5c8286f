"""The readers of the port's own spans (``pbench/spans.py``): a tiny single
and a tiny batcher cell run on the CPU with ``--trace 1`` read the queue
wait, the attached lanes and the runtime's time a frame, and no device
idle share (no device operation); a ``--trace 0`` run loads none of them
and records no span; a port without spans reads nothing; the window's
readers leave out the traced slice; and the idle split and the clock lags
worked by hand."""

import json
import time
import types

import pytest

from go_pocket_tts_tpu_torch import tracing
from pbench import harness, registry, spans, systems
from pbench.trace import DeviceTrace

# Importing pbench.spans turned tracing on for the whole process: off again,
# so that no other benchmark test runs traced. The tests here switch it.
tracing.disable()

NEW = ("queue_wait_p95_ms.batch", "attached_lane_share.batch", "runtime_ms_per_frame.single",
       "device_idle_host_pct.single", "device_idle_host_pct.batch")
SECONDS = 2.0


@pytest.fixture(autouse=True)
def tracing_reset(monkeypatch):
    for cls in (systems.RuntimeSystem, systems.BatcherSystem):
        monkeypatch.setattr(cls, "warm", lambda self, *a: None)
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _run(root, cell, trace):
    # Trace the last quarter of the window: the window's readers read the
    # part before it.
    path = root / "workloads" / f"{cell}.json"
    path.write_text(json.dumps(dict(json.loads(path.read_text()), trace={"seconds": SECONDS / 4})))
    keep = {}
    out = harness.run_cell(root, root / "BENCHMARK.json", cell, 2**32 + 5, SECONDS, trace, time.perf_counter(),
                           device="cpu", require_card=False, log=lambda s: None, keep=keep)
    return out, keep["run"]


def test_traced_cells_read_the_spans(tiny_root):
    tracing.enable()  # as importing pbench.spans did, once per process
    out, run = _run(tiny_root, "tiny-oneshot", True)
    m = out["metrics"]
    assert out["correct"] and not set(NEW[2:4]) & set(m)
    assert 0 <= m["queue_wait_p95_ms.batch"]["value"] < 1e3 * (SECONDS + 60)
    assert 0 < m["attached_lane_share.batch"]["value"] <= 1
    assert m["queue_wait_p95_ms.batch"]["unit"] == "ms" and m["attached_lane_share.batch"]["unit"] == "ratio"
    # No device operation on the CPU: no idle share to split.
    assert "device_idle_host_pct.batch" not in m and spans.device_idle_by_span(run, "engine") is None
    tracing.reset()
    out, run = _run(tiny_root, "tiny-stream", True)
    m = out["metrics"]
    assert out["correct"] and not {n for n in NEW if n.endswith(".batch")} & set(m)
    ms = m["runtime_ms_per_frame.single"]["value"]
    t0, t1 = spans.untraced(run)
    assert run.trace is not None and run.t0 == t0 < t1 == min(run.trace.t0, run.t1)
    frames = sum(sp.attrs["frames"] for name, s, _e, sp in spans.read("runtime") if name == "enqueue" and t0 <= s < t1)
    assert 0 < ms and ms * frames <= 1e3 * (t1 - t0) * 1.01
    assert "device_idle_host_pct.single" not in m and spans.device_idle_host_pct(run, "runtime") is None


def test_an_untraced_run_loads_no_span_reader_and_records_nothing(tiny_root):
    spec = registry.load_spec(tiny_root / "BENCHMARK.json")
    for cell in ("tiny-stream", "tiny-oneshot", "tiny-mixed"):
        assert not set(NEW) & {m["name"] for m in registry.cell_metrics(spec, cell, trace=False)}
    assert {m["name"] for m in registry.cell_metrics(spec, "tiny-oneshot", trace=True)} >= {
        "queue_wait_p95_ms.batch", "attached_lane_share.batch", "device_idle_host_pct.batch"}
    out, _run_ = _run(tiny_root, "tiny-mixed", False)
    assert out["correct"] and not tracing.enabled() and tracing.spans() == []


def test_a_port_without_spans_reads_nothing(monkeypatch):
    monkeypatch.setattr(spans, "tracing", None)
    trace = DeviceTrace(t0=0.0, t1=1.0, ops=[("k", 0.1, 0.2)], kernels=[], counts0={}, counts1={})
    run = types.SimpleNamespace(t0=0.0, t1=1.0, config={"system": {"slots": 8}}, trace=trace)
    assert spans.read("engine") == [] and spans.read("runtime") == []
    assert spans.queue_wait_p95_ms(run) is None and spans.attached_lane_share(run) is None
    assert spans.runtime_ms_per_frame(run) is None and spans.clock_lags(run) == []
    for kind in ("engine", "runtime"):  # a device trace, and no span to split its idle time by
        assert spans.device_idle_by_span(run, kind) is None and spans.device_idle_host_pct(run, kind) is None


def _span(name, start, end, thread=1, parent=None, sid=0, **attrs):
    return (name, start, end, types.SimpleNamespace(thread=thread, parent=parent, id=sid, attrs=attrs))


def test_the_window_readers_leave_out_the_traced_slice(monkeypatch):
    # A window of 10 s whose last 2 s are traced. Before the slice: 40 queue
    # waits of 10 ms, blocks of 8 steps with 6 lanes attached, segments of 4
    # frames taking 4 ms. In the slice the traced engine backs up: queue
    # waits of 900 ms, blocks with 1 lane, segments of 4 frames taking 40 ms.
    recorded = {"engine": [], "runtime": []}
    for i in range(40):
        t = 0.1 + 0.2 * i
        recorded["engine"] += [_span("queue", t - 0.010, t), _span("block", t, t + 0.01, k=8, attached=6)]
        recorded["runtime"].append(_span("enqueue", t, t + 0.004, frames=4))
    for i in range(5):
        t = 8.1 + 0.3 * i
        recorded["engine"] += [_span("queue", t - 0.900, t), _span("block", t, t + 0.05, k=8, attached=1)]
        recorded["runtime"].append(_span("enqueue", t, t + 0.040, frames=4))
    monkeypatch.setattr(spans, "read", lambda kind: recorded[kind])
    trace = DeviceTrace(t0=8.0, t1=10.0, ops=[("k", 8.5, 0.1)], kernels=[], counts0={}, counts1={})
    run = types.SimpleNamespace(t0=0.0, t1=10.0, config={"system": {"slots": 8}}, trace=trace)
    assert spans.untraced(run) == (0.0, 8.0)
    assert spans.queue_wait_p95_ms(run) == pytest.approx(10.0)
    assert spans.attached_lane_share(run) == pytest.approx(6 / 8)
    assert spans.runtime_ms_per_frame(run) == pytest.approx(1.0)
    # Without a trace the whole window counts, the slowed requests with it.
    run.trace = None
    assert spans.untraced(run) == (0.0, 10.0)
    assert spans.queue_wait_p95_ms(run) == pytest.approx(900.0)
    assert spans.attached_lane_share(run) == pytest.approx((40 * 6 + 5) / (45 * 8))
    assert spans.runtime_ms_per_frame(run) == pytest.approx((40 * 4 + 5 * 40) / (45 * 4))


def test_idle_split_and_clock_lags_by_hand(monkeypatch):
    # A slice of 10 ms; the device runs 1-3 ms and 6-7 ms. The engine thread:
    # block 0-1.5 ms, wait 1.5-4 ms, harvest 4-5 (a nested wait 4.2-4.4),
    # idle 5-5.5, block 5.8-6.5; nothing open after 6.5.
    ms = 1e-3
    recorded = [
        _span("block", 0 * ms, 1.5 * ms, sid=1),
        _span("wait", 1.5 * ms, 4 * ms, sid=2),
        _span("harvest", 4 * ms, 5 * ms, sid=3),
        _span("wait", 4.2 * ms, 4.4 * ms, parent=3, sid=4),
        _span("idle", 5 * ms, 5.5 * ms, sid=5),
        _span("block", 5.8 * ms, 6.5 * ms, sid=6),
        _span("queue", 0, 9 * ms, thread=2, sid=7),  # another thread's, across threads: never innermost
    ]
    monkeypatch.setattr(spans, "read", lambda kind: recorded)
    trace = DeviceTrace(t0=0.0, t1=10 * ms, ops=[("k", 1 * ms, 2 * ms), ("k", 6 * ms, 1 * ms)], kernels=[],
                        counts0={}, counts1={})
    run = types.SimpleNamespace(trace=trace)
    by = spans.device_idle_by_span(run, "engine")
    want = {"block": 1.0 * ms + 0.2 * ms, "wait": 1.0 * ms + 0.2 * ms, "harvest": 0.8 * ms, "idle": 0.5 * ms,
            spans.OUTSIDE: 0.3 * ms + 3.0 * ms}
    assert by.keys() == want.keys() and all(by[k] == pytest.approx(v) for k, v in want.items())
    assert sum(by.values()) == pytest.approx(7 * ms)
    assert spans.device_idle_host_pct(run, "engine") == pytest.approx(100 * 2.0 / 10)
    assert spans.clock_lags(run) == []  # no runtime span


def test_clock_lags_by_hand(monkeypatch):
    # The single runtime: a request's setup launches its prefill (device at
    # 0.5 ms); segment 1's enqueue, wait to 3 ms, emit; segment 2's enqueue
    # at 3.4 ms, its first operation at 3.5 ms. Only segment 2 is timed.
    ms = 1e-3
    recorded = [
        _span("setup", 0.2 * ms, 0.8 * ms, parent=9, sid=1),
        _span("wait", 0.3 * ms, 0.4 * ms, parent=1, sid=2),
        _span("enqueue", 0.8 * ms, 1.0 * ms, parent=9, sid=3),
        _span("wait", 1.0 * ms, 3.0 * ms, parent=9, sid=4),
        _span("emit", 3.0 * ms, 3.1 * ms, parent=9, sid=5),
        _span("enqueue", 3.4 * ms, 3.6 * ms, parent=9, sid=6),
    ]
    monkeypatch.setattr(spans, "read", lambda kind: recorded)
    ops = [("k", 0.5 * ms, 2.4 * ms), ("k", 3.5 * ms, 1 * ms)]
    run = types.SimpleNamespace(trace=DeviceTrace(t0=0.0, t1=10 * ms, ops=ops, kernels=[], counts0={}, counts1={}))
    assert spans.clock_lags(run) == [pytest.approx(0.1 * ms)]
    # A device clock 0.2 ms early reads -0.1 ms.
    early = [(n, s - 0.2 * ms, d) for n, s, d in ops]
    run.trace = DeviceTrace(t0=0.0, t1=10 * ms, ops=early, kernels=[], counts0={}, counts1={})
    assert spans.clock_lags(run) == [pytest.approx(-0.1 * ms)]
