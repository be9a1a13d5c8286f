"""Arithmetic the metric readers share: what reached the clients in the
window, latencies, AR steps from the kernel counters, operations and
bounds summed over a window or a traced slice.

Kernel wrappers are named as the port's ``kernels.WRAPPERS`` name them;
device kernels as they appear in the trace (a substring of the name).
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Tuple

from pbench import roofline
from pbench.stats import MISS, audio_seconds, percentile

__all__ = [
    "MISS_MS",
    "ar_steps",
    "audio_seconds_in_window",
    "first_block_latencies",
    "frames_in_window",
    "launches",
    "p95_ms",
    "percentile_ms",
    "request_latencies",
    "stream_cascade_roofline_pct",
    "trace_kernels",
    "window_flops",
]

SAMPLES_PER_FRAME = 1920
# A percentile that falls on a miss reports this many milliseconds.
MISS_MS = 1e6


def in_window(run, t: float) -> bool:
    return run.t0 <= t < run.t1


def audio_seconds_in_window(run) -> float:
    return audio_seconds(sum(n for r in run.records for t, n in r.blocks if in_window(run, t)))


def frames_in_window(run) -> float:
    return sum(n for r in run.records for t, n in r.blocks if in_window(run, t)) / SAMPLES_PER_FRAME


def _latency(rec, end: Optional[float]) -> float:
    if rec.error is not None or end is None:
        return MISS
    return end - rec.due


def first_block_latencies(run) -> List[float]:
    return [_latency(r, r.first) for r in run.records if r.request.route == "stream"]


def request_latencies(run) -> List[float]:
    return [_latency(r, r.done) for r in run.records if r.request.route == "oneshot"]


def percentile_ms(values: List[float], q: float) -> Optional[float]:
    p = percentile(values, q)
    if p is None:
        return None
    return MISS_MS if p == MISS else p * 1e3


def p95_ms(values: List[float]) -> Optional[float]:
    return percentile_ms(values, 95.0)


def launches(counts0: Dict, counts1: Dict, names: Iterable[str]) -> int:
    return sum(counts1[n]["launches"] - counts0[n]["launches"] for n in names)


def shape_counts(counts0: Dict, counts1: Dict, name: str) -> Dict[Tuple, int]:
    s0, s1 = counts0[name]["shapes"], counts1[name]["shapes"]
    return {k: c - s0.get(k, 0) for k, c in s1.items() if c != s0.get(k, 0)}


# Kernel 1, the single runtime's decode attention; kernel 4, the batcher's
# (float or int8 cache): one launch per layer per AR step.
SINGLE_ATTENTION = ("decode_attention_step",)
BATCH_ATTENTION = ("batched_decode_attention", "batched_decode_attention_int8")


def ar_steps(run, wrappers: Iterable[str], traced: bool = False) -> float:
    """AR steps run over the window (or the traced slice): the attention
    kernel's launches over the layers."""
    c0, c1 = (run.trace.counts0, run.trace.counts1) if traced else (run.counts0, run.counts1)
    return launches(c0, c1, wrappers) / run.config["num_layers"]


def trace_kernels(run, pattern: str) -> List[Tuple[str, float, float]]:
    """The traced slice's kernels whose name holds ``pattern`` and that
    started inside it."""
    tr = run.trace
    return [k for k in tr.kernels if pattern in k[0] and tr.t0 <= k[1] < tr.t1]


def mean_rows(run) -> Optional[float]:
    """The mean number of KV rows an AR step of the window's finished
    requests attends to: a request of P tokens and F frames attends to
    P + 1 .. P + F."""
    total = frames = 0
    for r in run.records:
        if r.error is None and r.done is not None and in_window(run, r.done):
            p, f = len(r.request.tokens), r.request.frames
            total += f * p + f * (f + 1) / 2
            frames += f
    return total / frames if frames else None


def _request_flops(layout, arch: Dict, n_tokens: int, first: int, count: int, prefill: bool) -> float:
    steps = sum(layout.frame_step_flops(arch, n_tokens + j + 1) for j in range(first, first + count))
    ops = steps + roofline.decode_flops(arch, first, count)
    return ops + (layout.prefill_flops(arch, n_tokens) if prefill else 0.0)


def window_flops(run) -> float:
    """The model operations that the audio delivered in the window needed:
    each delivered frame's AR step and decode, and the prefill of each
    request whose first audio arrived in the window. The AR step's and the
    prefill's counts are the configuration's reference module's."""
    arch = run.config
    total = 0.0
    for r in run.records:
        n_tok = len(r.request.tokens)
        done = 0
        for i, (t, n) in enumerate(r.blocks):
            frames = n // SAMPLES_PER_FRAME
            if in_window(run, t):
                total += _request_flops(run.reference, arch, n_tok, done, frames, prefill=(i == 0))
            done += frames
    return total


def mfu_pct(run) -> Optional[float]:
    ops = window_flops(run)
    if ops <= 0:
        return None
    return 100.0 * ops / (run.seconds * roofline.PEAK_FLOPS["bfloat16"])


def idle_pct(run) -> Optional[float]:
    s = run.trace_summary
    if s is None or s["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def roofline_pct(least_s: float, kernels: List[Tuple[str, float, float]]) -> Optional[float]:
    took = sum(d for _n, _s, d in kernels)
    if not kernels or took <= 0:
        return None
    return 100.0 * least_s / took


# Kernel 8's stream blocks in the trace, and its wrapper's shape counters.
CASCADE_KERNEL = "cascade_mma_kernel"
CASCADE_WRAPPER = "fused_up2_up3_tail"


def stream_cascade_roofline_pct(run) -> Optional[float]:
    """Kernel 8's stream blocks in the traced slice: their least time (each
    at the mean of the shapes the wrapper launched in the slice) over their
    device time, in %; None where the slice has none."""
    if run.trace is None:
        return None
    kernels = trace_kernels(run, CASCADE_KERNEL)
    shapes = shape_counts(run.trace.counts0, run.trace.counts1, CASCADE_WRAPPER)
    n = sum(shapes.values())
    if not kernels or n <= 0:
        return None
    mean = sum(c * roofline.seanet_bound_s(run.config, CASCADE_WRAPPER, s) for s, c in shapes.items()) / n
    return roofline_pct(len(kernels) * mean, kernels)


def median(values: List[float]) -> Optional[float]:
    return statistics.median(values) if values else None
