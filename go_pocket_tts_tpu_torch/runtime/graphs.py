"""Captured CUDA graphs, one per shape bucket: the port's counterpart of the
reference's jitted programs (``runtime/generate.py``'s ``_ar_loop`` and
``_decode_pcm16``, ``runtime/streaming.py``'s ``_stream_ar_segment`` and
``_stream_decode_segment``, ``parallel/batching.py``'s
``_batched_ar_multi_step``, ``_harvest_decode_pcm16`` and
``_batched_stream_decode``) and of ``utils/compile_cache.py``, which keeps
those programs per shape.

A :class:`GraphCache` belongs to one runtime or batcher engine. Each graph
is keyed by what the reference keeps static (``static_argnames``): batch or
slots, KV capacity, frame bucket, dtype, LSD decode steps and the number of
steps or the block size; sampling knobs are tensors in static buffers, never
part of a key. A graph runs ``body(inputs)`` over static input buffers at
fixed addresses, which the caller fills before each run (:func:`feed`);
what the body returns are static outputs, overwritten by the graph's next
run, so a caller copies them out (or enqueues the copy) before it runs the
graph again. A body that carries state writes every new leaf back into its
input buffers (:func:`write_back`).

On the card a graph is captured on first use of its key, as JAX compiles
on first use of a bucket, and replayed with one host launch after that;
all graphs of a cache share one memory pool. Every capture follows an eager
warm-up of the body on copies of its inputs, on the capture stream, so
that the kernel libraries, the SEANet wrappers' repacked weights
(``kernels.seanet_tail.kernel_weight``) and the cuBLAS handles are made
outside the graph. Captures run one at a time in a process, in the
``thread_local`` capture mode, in the thread that replays the graph, with
the cyclic garbage collector paused; a graph is freed with its cache (no
reference cycle) or by :meth:`GraphCache.release`, never inside a
capture. Threads that enqueue beside another's captures (a batcher's
engine replicas on one card) hold the same lock around each program
(:func:`exclusive`), so no capture sees their launches. A failed capture
or replay raises: nothing carries on eagerly.

On the CPU the body runs eagerly over the same static buffers, and its
outputs are copied into the first run's, so the buffer handling (feeding,
write-back, the outputs' reuse) is the code the CPU tests run; only
capture and replay are the card's.

Launch counts: the kernel wrappers count a launch where they enqueue it,
which during a capture happens once, not at each replay. The warm-up's and
the capture's counts are taken back out, the capture's are kept as the
graph's tally, and each replay adds the tally (:attr:`Graph.tally`).
"""

from __future__ import annotations

import contextlib
import gc
import threading
import time
import weakref
from typing import Callable, Dict, Hashable, List, Optional, Tuple

import torch

from go_pocket_tts_tpu_torch import kernels

__all__ = ["Graph", "GraphCache", "accounted", "exclusive", "feed", "write_back"]

# CUDA allows one stream capture at a time in a process, and
# torch.cuda.graph hands every capture without a stream the same one.
# Graphs are destroyed under it too (reentrant: a cache dropped by the
# capturing thread itself must not deadlock).
_CAPTURE_LOCK = threading.RLock()

Counts = List[Tuple[int, Optional[Dict]]]


def exclusive() -> threading.RLock:
    """The process's capture lock, for a thread that enqueues device work
    beside other threads' captures (a batcher's engine replicas): while it
    is held no capture runs, so none is invalidated or miscounted by this
    thread's launches (:func:`accounted` restores the wrappers' counts)."""
    return _CAPTURE_LOCK


def _counts(wrappers) -> Counts:
    return [(fn.launches, dict(fn.shapes) if hasattr(fn, "shapes") else None) for fn in wrappers]


def _restore(wrappers, counts: Counts) -> None:
    for fn, (n, shapes) in zip(wrappers, counts):
        fn.launches = n
        if shapes is not None:
            fn.shapes = dict(shapes)


def _tally(before: Counts, after: Counts) -> Counts:
    tally = []
    for (n0, s0), (n1, s1) in zip(before, after):
        shapes = None
        if s1 is not None:
            shapes = {k: c - s0.get(k, 0) for k, c in s1.items() if c != s0.get(k, 0)}
        tally.append((n1 - n0, shapes))
    return tally


def _add(wrappers, tally: Counts) -> None:
    for fn, (n, shapes) in zip(wrappers, tally):
        fn.launches += n
        for shape, c in (shapes or {}).items():
            fn.shapes[shape] = fn.shapes.get(shape, 0) + c


def accounted(wrappers, warm_up: Callable[[], None], capture: Callable):
    """Run ``warm_up()`` then ``capture()`` and take every launch they
    counted back out of ``wrappers``' counts; returns ``(capture's result,
    the launches capture() counted)``, the tally each replay adds."""
    before = _counts(wrappers)
    try:
        warm_up()
        warm = _counts(wrappers)
        result = capture()
        return result, _tally(warm, _counts(wrappers))
    finally:
        _restore(wrappers, before)


def _clone(tree):
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_clone(v) for v in tree)
    return tree


def _copy_into(dst, src) -> None:
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, (tuple, list)):
        for d, s in zip(dst, src):
            _copy_into(d, s)


@contextlib.contextmanager
def _no_collection():
    """No cyclic garbage collection while a capture runs: a collection could
    destroy another cache's graphs in this thread, which a capture forbids
    (it would invalidate the capture)."""
    enabled = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if enabled:
            gc.enable()


def feed(buffers: Dict, **tensors: torch.Tensor) -> None:
    """Copy each tensor into the static buffer of its name, unless it is
    that buffer already (a carry handed back by the previous run)."""
    for name, t in tensors.items():
        if t is not buffers[name]:
            buffers[name].copy_(t, non_blocking=True)


def write_back(state: Dict, new: Dict) -> None:
    """Copy every leaf of ``new`` into ``state``'s leaf of the same name,
    in place, skipping leaves that are already ``state``'s own tensors
    (buffers the body wrote in place)."""
    for key, val in new.items():
        old = state[key]
        if isinstance(val, dict):
            write_back(old, val)
        elif val is not old:
            old.copy_(val)


class Graph:
    """One program: ``body(inputs)`` over the static ``inputs`` (fill them,
    then :meth:`run`). ``outputs`` are static too; ``tally`` is what one
    replay adds to the kernel wrappers' launch counts."""

    def __init__(self, cache: "GraphCache", key: Hashable, body: Callable, inputs: Dict) -> None:
        # The cache holds its graphs; a graph only refers back to it, so
        # dropping a cache frees its graphs at once, never in a collection.
        self._cache = weakref.ref(cache)
        self.device, self.key, self.body, self.inputs = cache.device, key, body, inputs
        self.outputs = None
        self.tally: Optional[Counts] = None
        self._graph: Optional[torch.cuda.CUDAGraph] = None

    def capture(self) -> None:
        """Capture the graph now, without running it (a no-op on the CPU
        or once captured): its warm-up runs on copies of the inputs, so
        the inputs are left as they are."""
        if self.device.type != "cuda" or self._graph is not None:
            return
        cache = self._cache()
        if cache is None:
            raise RuntimeError(f"graph {self.key}: its cache was released")
        cache._capture(self)

    def run(self):
        """Replay the graph (capturing it first on its key's first use); on
        the CPU, run the body over the static buffers. Returns the static
        outputs."""
        if self.device.type != "cuda":
            out = self.body(self.inputs)
            if self.outputs is None:
                self.outputs = out
            else:
                _copy_into(self.outputs, out)
            return self.outputs
        cache = self._cache()
        if cache is None:
            raise RuntimeError(f"graph {self.key}: its cache was released")
        if self._graph is None:
            cache._capture(self)
        self._graph.replay()
        _add(cache.wrappers, self.tally)
        return self.outputs


class GraphCache:
    """The graphs of one runtime or engine on ``device``, by key, over one
    memory pool. ``captures``, ``capture_seconds`` and :meth:`pool_bytes`
    report what the captures cost."""

    def __init__(self, device: torch.device) -> None:
        self.device = torch.device(device)
        self.wrappers = kernels.WRAPPERS
        self.captures = 0
        self.capture_seconds = 0.0
        self._graphs: Dict[Hashable, Graph] = {}
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None

    def __len__(self) -> int:
        return len(self._graphs)

    def keys(self) -> List[Hashable]:
        return list(self._graphs)

    def get(self, key: Hashable, make: Callable[[], Tuple[Callable, Dict]]) -> Graph:
        """The graph of ``key``; on its first use ``make()`` gives its
        ``(body, inputs)``."""
        graph = self._graphs.get(key)
        if graph is None:
            body, inputs = make()
            graph = self._graphs[key] = Graph(self, key, body, inputs)
        return graph

    def _capture(self, graph: Graph) -> None:
        t0 = time.perf_counter()
        with _CAPTURE_LOCK, _no_collection(), torch.cuda.device(self.device):
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
                self._pool = torch.cuda.graph_pool_handle()
            stream = self._stream
            cuda_graph = torch.cuda.CUDAGraph()

            def warm_up() -> None:
                stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(stream):
                    graph.body(_clone(graph.inputs))

            def capture():
                with torch.cuda.graph(cuda_graph, pool=self._pool, stream=stream, capture_error_mode="thread_local"):
                    return graph.body(graph.inputs)

            outputs, tally = accounted(self.wrappers, warm_up, capture)
            torch.cuda.current_stream(self.device).wait_stream(stream)
        graph._graph, graph.outputs, graph.tally = cuda_graph, outputs, tally
        self.captures += 1
        self.capture_seconds += time.perf_counter() - t0

    def release(self) -> None:
        """Drop every graph; their pool goes back to the caching allocator.
        Never while another thread captures: destroying a graph is one of
        the calls a capture forbids."""
        with _CAPTURE_LOCK:
            self._graphs.clear()

    def __del__(self) -> None:
        self.release()

    def pool_bytes(self) -> int:
        """Bytes the caching allocator holds in this cache's graph pool (0
        before the first capture)."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(
            seg["total_size"] for seg in torch.cuda.memory_snapshot() if tuple(seg["segment_pool_id"]) == pool
        )
