"""Request-scoped spans of the port's host work, kept in memory.

A span is one record: its name, id, parent span's id, request id (or
None), engine index (the batcher's engine; None in the single runtime),
the thread that opened it, its start and end on ``time.perf_counter_ns()``
(the clock the benchmark's device trace is put on, so the spans and the
card's operations share one timeline) and a few small integer attributes.

Tracing is off by default; :func:`enable` and :func:`disable` are its only
switch. Off, a span site costs one check of a module-level flag and
allocates nothing: :func:`span` and :func:`begin` hand back a shared
do-nothing context (whose ``as`` target is None) or None. On, the records
of ended spans go into one process-wide ring of :data:`RING_SPANS`, read
with :func:`spans` and emptied with :func:`reset`; nothing is written out.

Spans sit only at the program boundaries of the batcher's engine loop and
of the single runtime's requests, never inside a graph body, an AR step, a
layer or a kernel wrapper. Request ids (:func:`next_request_id`) are
handed out whether tracing is on or not.

Three forms:

- ``with span(name, ...) as sp:`` on one thread. Its parent is the span
  given, or else the innermost ``with`` span open on the thread, whose
  request id and engine it takes where none is given.
- ``sp = begin(name, ..., parent=...)`` then ``sp.finish()``, possibly on
  another thread: a span across threads (a request's queue wait) or across
  a generator's ``yield``. It never becomes a parent by itself.
- ``t = now()`` on one thread, then ``record(name, t, ...)`` on another: a
  span across threads whose end alone knows its engine (a request's queue
  wait, from the client's thread to the engine that takes it).

``sp.set(name=value, ...)`` adds attributes, also after the span ended (the
record is the span itself), up to when the spans are read.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import Deque, Dict, List, Optional

__all__ = [
    "RING_SPANS", "Span", "begin", "disable", "enable", "enabled", "next_request_id", "now", "record", "reset", "span",
    "spans",
]

# Ended spans kept: a 51-s benchmark run and its warm-up write ~10^5 at most.
RING_SPANS = 1 << 18

_on = False
_ring: Deque["Span"] = collections.deque(maxlen=RING_SPANS)
_lock = threading.Lock()
_local = threading.local()
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget every recorded span."""
    with _lock:
        _ring.clear()


def spans() -> List["Span"]:
    """The recorded spans, oldest first."""
    with _lock:
        return list(_ring)


def next_request_id() -> int:
    return next(_request_ids)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class Span:
    __slots__ = ("name", "id", "parent", "request", "engine", "thread", "start", "end", "attrs")

    def __init__(self, name: str, request: Optional[int], engine: Optional[int], parent: Optional["Span"]) -> None:
        self.name = name
        self.id = next(_span_ids)
        self.parent: Optional[int] = None
        self.request, self.engine = request, engine
        if parent is not None:
            self._adopt(parent)
        self.thread = threading.get_ident()
        self.attrs: Dict[str, int] = {}
        self.end: Optional[int] = None
        self.start = time.perf_counter_ns()

    def _adopt(self, parent: "Span") -> None:
        self.parent = parent.id
        if self.request is None:
            self.request = parent.request
        if self.engine is None:
            self.engine = parent.engine

    def set(self, **attrs: int) -> None:
        self.attrs.update(attrs)

    def finish(self) -> None:
        """End the span and record it; a second call does nothing."""
        t = time.perf_counter_ns()
        with _lock:
            if self.end is None:
                self.end = t
                _ring.append(self)

    def __enter__(self) -> "Span":
        stack = _stack()
        if self.parent is None and stack:
            self._adopt(stack[-1])
        stack.append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        _stack().pop()
        self.finish()
        return False

    def __repr__(self) -> str:
        return (f"Span({self.name!r}, id={self.id}, parent={self.parent}, request={self.request}, "
                f"engine={self.engine}, start={self.start}, end={self.end}, attrs={self.attrs})")


class _Off:
    """The do-nothing span of a site while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False


_OFF = _Off()


def span(name: str, request: Optional[int] = None, engine: Optional[int] = None, parent: Optional[Span] = None):
    """A span over a ``with`` block on this thread (see the module
    docstring); its ``as`` target is the :class:`Span`, or None when
    tracing is off."""
    if not _on:
        return _OFF
    return Span(name, request, engine, parent)


def begin(name: str, request: Optional[int] = None, engine: Optional[int] = None,
          parent: Optional[Span] = None) -> Optional[Span]:
    """Open a span that :meth:`Span.finish` ends, on any thread; None when
    tracing is off."""
    if not _on:
        return None
    return Span(name, request, engine, parent)


def now() -> Optional[int]:
    """The start of a span that :func:`record` ends; None when tracing is
    off."""
    return time.perf_counter_ns() if _on else None


def record(name: str, start: Optional[int], request: Optional[int] = None, engine: Optional[int] = None) -> None:
    """Record a span from ``start`` (:func:`now`) to now; nothing where
    ``start`` is None or tracing is off."""
    if start is None or not _on:
        return
    sp = Span(name, request, engine, None)
    sp.start = start
    sp.finish()
