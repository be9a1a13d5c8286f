"""Arithmetic over the port's own spans (``go_pocket_tts_tpu_torch/
tracing.py``): the readers of the batcher's queue wait and attached lanes,
of the single runtime's time a frame, and of the device's idle time put
down to the host work behind it.

Importing this module turns the port's tracing on, for the whole process
and until ``tracing.disable()``. The harness loads the per-layer readers,
and so this module, only for a traced run and before it builds the system:
a traced run records the spans of its warm-up and its window, and a run
with ``--trace 0`` leaves tracing off. A port without the tracing module
reads nothing here: every reader returns None.

Spans are on ``time.perf_counter_ns()``, the clock of ``run.t0``/``t1``
and of the device trace (``pbench/trace.py``).

The window's readers (queue wait, attached lanes, time a frame) read the
part of the window before the traced slice, ``[run.t0, run.trace.t0)``:
the profiler slows the port's graph launches several times over inside the
slice, and the work backs up there. The device-idle readers can read only
the slice, and so describe the traced program.
"""

from __future__ import annotations

import bisect
from typing import Dict, Iterable, List, Optional, Tuple

from pbench import derive
from pbench.trace import busy_intervals, merge

try:
    from go_pocket_tts_tpu_torch import tracing
except ImportError:  # a port without spans
    tracing = None
else:
    tracing.enable()

__all__ = [
    "CROSS_THREAD",
    "NOT_HOST",
    "OUTSIDE",
    "attached_lane_share",
    "clock_lags",
    "device_idle_by_span",
    "device_idle_host_pct",
    "innermost",
    "intersect",
    "queue_wait_p95_ms",
    "read",
    "runtime_ms_per_frame",
    "untraced",
]

# A request's spans that start on one thread and end on another; never an
# issuing thread's innermost span.
CROSS_THREAD = ("request", "queue")
# Every other span of an issuing thread is host work: the engine's reap,
# block, admit (prepare, enqueue), emit and harvest; the runtime's setup,
# enqueue, emit, ar and decode.
NOT_HOST = ("wait", "idle")
OUTSIDE = "outside the port"

Interval = Tuple[float, float]


def read(kind: str) -> List:
    """The recorded spans of the batcher's engines (``kind`` "engine") or of
    the single runtime ("runtime"), their times in seconds: a list of
    ``(name, start, end, span)``; empty where the port has no spans."""
    if tracing is None:
        return []
    engine = kind == "engine"
    return [(s.name, s.start * 1e-9, s.end * 1e-9, s) for s in tracing.spans() if (s.engine is not None) == engine]


def untraced(run) -> Interval:
    """The part of the window the profiler does not touch: from its start
    to the traced slice's, or the whole window in a run without a trace."""
    return run.t0, run.t1 if run.trace is None else min(run.t1, run.trace.t0)


def _clip(intervals: Iterable[Interval], t0: float, t1: float) -> List[Interval]:
    return [(max(a, t0), min(b, t1)) for a, b in intervals if min(b, t1) > max(a, t0)]


def _length(intervals: Iterable[Interval]) -> float:
    return sum(b - a for a, b in intervals)


def intersect(xs: List[Interval], ys: List[Interval]) -> List[Interval]:
    """The intersection of two sorted lists of disjoint intervals."""
    out, i, j = [], 0, 0
    while i < len(xs) and j < len(ys):
        a, b = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if b > a:
            out.append((a, b))
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return out


def _complement(busy: List[Interval], t0: float, t1: float) -> List[Interval]:
    out, prev = [], t0
    for a, b in busy:
        if a > prev:
            out.append((prev, a))
        prev = max(prev, b)
    if t1 > prev:
        out.append((prev, t1))
    return out


# -- the batcher -------------------------------------------------------------


def queue_wait_p95_ms(run) -> Optional[float]:
    """The nearest-rank p95 of the ``queue`` spans that end inside the
    window before the traced slice (:func:`untraced`), in ms."""
    t0, t1 = untraced(run)
    waits = [e - s for name, s, e, _ in read("engine") if name == "queue" and t0 <= e < t1]
    return derive.p95_ms(waits)


def attached_lane_share(run) -> Optional[float]:
    """Σ k·attached ÷ Σ k·slots over the ``block`` spans that start inside
    the window before the traced slice (:func:`untraced`)."""
    slots = run.config["system"]["slots"]
    t0, t1 = untraced(run)
    blocks = [sp.attrs for name, s, _e, sp in read("engine") if name == "block" and t0 <= s < t1]
    steps = sum(a["k"] for a in blocks)
    if steps <= 0:
        return None
    return sum(a["k"] * a["attached"] for a in blocks) / (steps * slots)


# -- the single runtime --------------------------------------------------------


def runtime_ms_per_frame(run) -> Optional[float]:
    """The union of the runtime's spans on each requests' thread (every span
    but the request's root, which holds the caller's time too) inside the
    window before the traced slice (:func:`untraced`), over the frames of
    the ``enqueue`` spans that start in it, in ms a frame."""
    t0, t1 = untraced(run)
    spans = [(name, s, e, sp) for name, s, e, sp in read("runtime") if name not in CROSS_THREAD]
    frames = sum(sp.attrs.get("frames", 0) for name, s, _e, sp in spans if name == "enqueue" and t0 <= s < t1)
    if frames <= 0:
        return None
    busy = 0.0
    for thread in {sp.thread for *_, sp in spans}:
        busy += _length(merge(_clip(((s, e) for _n, s, e, sp in spans if sp.thread == thread), t0, t1)))
    return busy / frames * 1e3


# -- the device's idle time, by the innermost span of the issuing thread -------


def innermost(spans: List) -> List[Tuple[float, float, str]]:
    """``(start, end, name)`` pieces of time in which the span named is the
    innermost open one, for the spans of one thread (nested, as the spans
    of one thread are)."""
    out: List[Tuple[float, float, str]] = []
    stack: List[Tuple[float, str]] = []  # (end, name) of the open spans
    t = None
    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][0] <= s:
            end, top = stack.pop()
            if end > t:
                out.append((t, end, top))
                t = end
        if stack and s > t:
            out.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s
    while stack:
        end, top = stack.pop()
        if end > t:
            out.append((t, end, top))
            t = end
    return out


def device_idle_by_span(run, kind: str) -> Optional[Dict[str, float]]:
    """Seconds of the traced slice in which no device operation ran, by the
    name of the innermost span open then on an issuing thread (the
    engine's, or the requests' of the single runtime; ``OUTSIDE`` when none
    is): None without a trace, without device operations in it, or
    without spans (a port that records none). Where several threads issue,
    each of their idle pieces counts."""
    tr = run.trace
    spans = [(name, s, e, sp) for name, s, e, sp in read(kind) if name not in CROSS_THREAD]
    if tr is None or not tr.ops or not spans:
        return None
    idle = _complement(busy_intervals(tr), tr.t0, tr.t1)
    out: Dict[str, float] = {}
    inside: List[Interval] = []
    for thread in {sp.thread for *_, sp in spans}:
        pieces = innermost([(n, s, e) for n, s, e, sp in spans if sp.thread == thread])
        for name in {p[2] for p in pieces}:
            mine = _clip(((a, b) for a, b, n in pieces if n == name), tr.t0, tr.t1)
            out[name] = out.get(name, 0.0) + _length(intersect(idle, merge(mine)))
        inside += _clip(((a, b) for a, b, _n in pieces), tr.t0, tr.t1)
    out[OUTSIDE] = _length(idle) - _length(intersect(idle, merge(inside)))
    return out


def device_idle_host_pct(run, kind: str) -> Optional[float]:
    """The share of the traced slice, in %, in which no device operation
    ran while the innermost span open on the issuing thread was one of
    host work (not a ``wait``, not the engine's ``idle``, not outside the
    port). It describes the traced program, whose graph launches the
    profiler slows."""
    by = device_idle_by_span(run, kind)
    if by is None:
        return None
    host = sum(v for k, v in by.items() if k not in NOT_HOST and k != OUTSIDE)
    return 100.0 * host / run.trace.window_s


def clock_lags(run) -> List[float]:
    """For each ``enqueue`` span of the single runtime that starts in the
    traced slice right after a segment's ``wait`` and ``emit``: the start of
    the first device operation after that ``wait`` ended, less the span's
    start, in seconds. Nothing is launched in between (the host converts the
    block and the caller takes it), so a lag below 0, an operation before
    the host launched it, means that the two clocks disagree. (The
    batcher's engine launches harvest decodes, slot releases and admissions
    between its waits and its next block: no lag of its tests the clocks.)"""
    tr = run.trace
    if tr is None or not tr.ops:
        return []
    starts = sorted(s for _n, s, _d in tr.ops)
    names = {}
    spans = []
    for name, s, e, sp in read("runtime"):
        names[sp.id] = name
        spans.append((name, s, e, sp))
    seen: Dict[int, float] = {}  # thread -> the end of its last segment's wait
    out = []
    for name, s, e, sp in sorted(spans, key=lambda x: x[1]):
        if names.get(sp.parent, "request") not in CROSS_THREAD or name == "emit":
            continue  # a nested span, or one that launches nothing
        if name == "wait":
            seen[sp.thread] = e
            continue
        last = seen.pop(sp.thread, None)
        if name == "enqueue" and last is not None and tr.t0 <= s < tr.t1:
            i = bisect.bisect_left(starts, last)
            if i < len(starts):
                out.append(starts[i] - s)
    return out
