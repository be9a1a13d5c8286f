"""The device trace of a traced run: ``torch.profiler`` (CUDA activity, from
CUPTI) over a slice of the window, reduced to the device operations with
their times, the busy and idle time, and the longest idle gaps with what
the benchmark's clients were doing in each.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

__all__ = ["DeviceTrace", "Profiler", "busy_intervals", "merge", "summarize"]



@dataclass
class DeviceTrace:
    t0: float  # perf_counter seconds at the slice's start and end
    t1: float
    # (name, start, duration) in seconds on the perf_counter clock, device
    # operations only (kernels, copies, fills).
    ops: List[Tuple[str, float, float]]
    kernels: List[Tuple[str, float, float]]
    # Wrapper launch counts (and SEANet shapes) at the slice's start and end.
    counts0: Dict
    counts1: Dict

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0


def merge(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def busy_intervals(trace: DeviceTrace) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals, clipped to the slice."""
    spans = []
    for _n, s, d in trace.ops:
        a, b = max(s, trace.t0), min(s + d, trace.t1)
        if b > a:
            spans.append((a, b))
    return merge(spans)


class Profiler:
    """Starts ``torch.profiler`` on the device's activity and stops it; the
    events come back on the host's ``perf_counter`` clock.

    Start and stop run inside ``hold()``, a context in which no thread
    launches device work and the device is idle: stopping the profiler
    while another thread replays CUDA graphs hung on an H100 (torch
    2.11), and holding the clients at both ends did not."""

    def __init__(self, counts, hold) -> None:
        self._counts = counts
        self._hold = hold
        self._prof = None
        self._t0 = self._t1 = self._t_enter = 0.0
        self._c0: Dict = {}

    @staticmethod
    def _activities():
        import torch
        from torch.profiler import ProfilerActivity

        return [ProfilerActivity.CUDA] if torch.cuda.is_available() else [ProfilerActivity.CPU]

    @classmethod
    def warm(cls) -> None:
        """Start and stop the profiler once, before the window: its first
        start initialises CUPTI, which takes seconds."""
        import torch
        from torch.profiler import profile

        with profile(activities=cls._activities()):
            torch.zeros(1).add_(1)

    def start(self) -> None:
        from torch.profiler import profile

        self._prof = profile(activities=self._activities())
        with self._hold():
            a = time.perf_counter()
            self._prof.__enter__()
            self._t_enter = (a + time.perf_counter()) / 2
            self._c0 = self._counts()
            self._t0 = time.perf_counter()

    def stop(self) -> DeviceTrace:
        with self._hold():
            self._t1 = time.perf_counter()
            c1 = self._counts()
            self._prof.__exit__(None, None, None)
        ops = self._device_ops()
        kernels = [op for op in ops if op[3] == "kernel"]
        return DeviceTrace(
            t0=self._t0,
            t1=self._t1,
            ops=[op[:3] for op in ops],
            kernels=[op[:3] for op in kernels],
            counts0=self._c0,
            counts1=c1,
        )

    def _device_ops(self) -> List[Tuple[str, float, float, str]]:
        """(name, start, duration, kind) of every device operation, start on
        the perf_counter clock: the trace's start is taken to be the moment
        the profiler was entered."""
        res = self._prof.profiler.kineto_results
        out = []
        for ev in res.events():
            if ev.device_type().name != "CUDA":
                continue
            name = ev.name()
            low = name.lower()
            kind = "copy" if "memcpy" in low else "fill" if "memset" in low else "kernel"
            out.append((name, ev.start_ns(), ev.duration_ns() / 1e9, kind))
        if not out:
            return []
        start_ns = res.trace_start_ns() if hasattr(res, "trace_start_ns") else min(s for _n, s, _d, _k in out)
        return [(n, (s - start_ns) / 1e9 + self._t_enter, d, k) for n, s, d, k in out]


def label_gaps(gaps: List[Tuple[float, float]], records) -> List[Tuple[str, float]]:
    """Name what the clients were doing at the middle of each gap: a stream
    waiting for its first block, a stream between blocks, a one-shot request
    in flight, or nothing."""
    order = ("stream waiting for its first block", "one-shot request in flight", "stream between blocks")
    out = []
    for a, b in gaps:
        mid = (a + b) / 2
        found = set()
        for rec in records:
            if rec.sent <= mid and (rec.done is None or mid < rec.done):
                if rec.request.route != "stream":
                    found.add(order[1])
                elif rec.first is None or mid < rec.first:
                    found.add(order[0])
                else:
                    found.add(order[2])
        out.append((next((o for o in order if o in found), "no request in flight"), b - a))
    return out


def summarize(trace: DeviceTrace, records) -> Dict:
    busy = busy_intervals(trace)
    busy_s = sum(b - a for a, b in busy)
    gaps = []
    prev = trace.t0
    for a, b in busy:
        if a > prev:
            gaps.append((prev, a))
        prev = b
    if trace.t1 > prev:
        gaps.append((prev, trace.t1))
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    by_name: Dict[str, float] = {}
    for n, _s, d in trace.ops:
        by_name[n] = by_name.get(n, 0.0) + d
    top = sorted(by_name.items(), key=lambda kv: kv[1], reverse=True)[:10]
    return {
        "busy_s": busy_s,
        "window_s": trace.window_s,
        "device_ops": [[n, s] for n, s in top],
        "idle_gaps": [[label, s] for label, s in label_gaps(gaps[:10], records)],
    }

