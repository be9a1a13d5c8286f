"""Where the device's idle time goes, by the port's own spans, and a check
that the spans' clock and the device trace's agree.

Runs a cell with ``--trace 1`` (``harness.run_cell(..., keep=...)``) and
prints, for the traced slice:

- its idle time (no device operation running) by the innermost port span
  open on the issuing thread (the batcher's engine thread, or the single
  runtime's requests' thread): each host span's name, ``wait``, the
  engine's ``idle``, or outside the port;
- per span name (a nested span as ``parent/name``): how many ended in the
  slice, their mean length and the share of it in which the device was
  idle; and their count and mean length in the window before the slice,
  where the device is not traced;
- in a single-runtime cell, the lag from each segment's ``enqueue`` to the
  first device operation after the previous segment's ``wait``
  (``pbench.spans.clock_lags``): minimum and median. A minimum below
  -0.1 ms means that the device trace is placed on the host's clock
  (``pbench/trace.py``, ``_t_enter``, the middle of the profiler's entry)
  off by more than the gaps' resolution; the entry's length, which this
  tool times, bounds that placement's error at half of it. The same check
  from the other side: each segment's ``wait`` ends once the device has
  finished what it waits for, and nothing runs after it, so the end of
  the device's last operation begun before the wait's end should come
  before it (``wait_lag``);
- the frames delivered a second inside the slice and in the window before
  it (and, for the batcher, the AR steps a second): what the profiler's
  tracing of the device costs in the slice;
- the run's per-layer metrics and its busy share.

Usage (on a card): ``python benchmark/tools/idle_by_span.py --workload NAME
--seed N [--seconds 51] [--out FILE]``.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
HOST_THREADS = 2  # as benchmark/run.py
os.environ.setdefault("OMP_NUM_THREADS", str(HOST_THREADS))
sys.path.insert(0, str(ROOT))
sys.path.insert(1, str(ROOT.parent))

import torch  # noqa: E402

from pbench import derive, harness, registry, spans  # noqa: E402  (spans turns the port's tracing on)
from pbench.trace import busy_intervals, merge  # noqa: E402


def span_lengths(run, kind: str, t0: float, t1: float, busy=None) -> dict:
    """Per span name (``parent/name`` for a nested one) of the spans that end
    in ``[t0, t1)``: their count, mean length in ms and, given the device's
    ``busy`` intervals, the share of their time (clipped to ``t0``) in which
    the device was idle."""
    recorded = spans.read(kind)
    names = {sp.id: name for name, _s, _e, sp in recorded}
    groups: dict = {}
    for name, s, e, sp in recorded:
        if t0 <= e < t1:
            key = name if sp.parent not in names or name in spans.CROSS_THREAD else f"{names[sp.parent]}/{name}"
            groups.setdefault(key, []).append((max(s, t0), e))
    out = {}
    for key, ivs in sorted(groups.items()):
        out[key] = {"n": len(ivs), "mean_ms": sum(b - a for a, b in ivs) / len(ivs) * 1e3}
        if busy is not None:
            time_in = merge(ivs)
            total = sum(b - a for a, b in time_in)
            inside = sum(b - a for a, b in spans.intersect(time_in, busy))
            out[key]["idle_share"] = 1.0 - inside / total if total > 0 else None
    return out


def wait_lags(run) -> list:
    """For each segment ``wait`` of the single runtime that ends in the
    traced slice: its end less the end of the device's last operation begun
    before it, in seconds (below 0: the device seen busy after the host saw
    it done)."""
    tr = run.trace
    if tr is None or not tr.ops:
        return []
    recorded = spans.read("runtime")
    names = {sp.id: name for name, _s, _e, sp in recorded}
    ops = sorted((s, s + d) for _n, s, d in tr.ops)
    starts = [s for s, _e in ops]
    out = []
    for name, _s, e, sp in recorded:
        if name == "wait" and names.get(sp.parent, "request") in spans.CROSS_THREAD and tr.t0 <= e < tr.t1:
            i = bisect.bisect_left(starts, e)
            if i > 0:
                out.append(e - max(end for _s2, end in ops[max(0, i - 64):i]))
    return out


def timeline(run, n: int = 3) -> list:
    """The first ``n`` segments of the slice: the runtime's spans and the
    device operations from the segment's ``enqueue`` to the end of its
    ``emit``, on the host clock in ms from the enqueue's start."""
    tr = run.trace
    if tr is None:
        return []
    recorded = sorted(spans.read("runtime"), key=lambda x: x[1])
    out = []
    for i, (name, s, _e, sp) in enumerate(recorded):
        if name != "enqueue" or not tr.t0 <= s < tr.t1 or len(out) >= n:
            continue
        end = next((e for nm, _s2, e, _sp in recorded[i + 1:] if nm == "emit"), s + 0.05)
        host = [(nm, round((a - s) * 1e3, 4), round((b - s) * 1e3, 4)) for nm, a, b, _sp in recorded
                if s - 1e-3 <= a <= end]
        dev = [(op, round((a - s) * 1e3, 4), round(d * 1e3, 5)) for op, a, d in tr.ops if s - 1e-3 <= a <= end]
        out.append({"spans": host, "device_ops": len(dev), "first_ops": dev[:20], "last_ops": dev[-20:]})
    return out


def rates(run, kind: str) -> dict:
    """Frames delivered a second (and the engine's AR steps a second) inside
    the traced slice and in the window before it."""
    tr = run.trace
    if tr is None:
        return {}
    out = {}
    for where, a, b in (("slice", tr.t0, tr.t1), ("before", run.t0, tr.t0)):
        if b <= a:
            continue
        frames = sum(n for r in run.records for t, n in r.blocks if a <= t < b) / derive.SAMPLES_PER_FRAME
        out[f"frames_per_s_{where}"] = frames / (b - a)
        if kind == "engine":
            steps = sum(sp.attrs.get("k", 0) for name, t, _e, sp in spans.read(kind) if name == "block" and a <= t < b)
            out[f"ar_steps_per_s_{where}"] = steps / (b - a)
    return out


def breakdown(run, kind: str) -> dict:
    """The idle seconds of the traced slice by span, the spans' lengths, and
    the clock lags."""
    tr = run.trace
    idle = spans.device_idle_by_span(run, kind) or {}
    lags = spans.clock_lags(run) if kind == "runtime" else []
    ends = wait_lags(run) if kind == "runtime" else []
    return {
        "slice_s": run.trace.window_s if run.trace is not None else None,
        "idle_s": sum(idle.values()),
        "idle_by_span_s": dict(sorted(idle.items(), key=lambda kv: kv[1], reverse=True)),
        "spans": span_lengths(run, kind, tr.t0, tr.t1, busy_intervals(tr)) if tr is not None and tr.ops else {},
        "spans_before": span_lengths(run, kind, run.t0, tr.t0) if tr is not None else {},
        **rates(run, kind),
        "lags": len(lags),
        "lag_min_ms": min(lags) * 1e3 if lags else None,
        "lag_median_ms": statistics.median(lags) * 1e3 if lags else None,
        "lags_ms": sorted(round(x * 1e3, 4) for x in lags),
        "wait_lag_min_ms": min(ends) * 1e3 if ends else None,
        "wait_lag_median_ms": statistics.median(ends) * 1e3 if ends else None,
        "wait_lags_ms": sorted(round(x * 1e3, 4) for x in ends),
        "timeline": timeline(run) if kind == "runtime" else [],
    }


def _time_profiler_entry(entries: list) -> None:
    """Record the length of every ``torch.profiler.profile.__enter__``."""
    from torch.profiler import profile

    enter = profile.__enter__

    def timed(self):
        t = time.perf_counter()
        try:
            return enter(self)
        finally:
            entries.append(time.perf_counter() - t)

    profile.__enter__ = timed


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    torch.set_num_threads(HOST_THREADS)
    entries: list = []
    _time_profiler_entry(entries)
    keep: dict = {}
    result = harness.run_cell(ROOT, ROOT.parent / "BENCHMARK.json", args.workload, args.seed, args.seconds, True,
                              T_START, device=args.device, require_card=args.device != "cpu", keep=keep)
    run = keep["run"]
    kind = "engine" if registry.load_config(ROOT, run.workload["config"])["system"]["kind"] == "batcher" else "runtime"
    out = {"workload": args.workload, "seed": args.seed, "card": run.card, "kind": kind,
           "correct": result["correct"], "metrics": result["metrics"], "device": result["device"],
           "profiler_entry_ms": entries[-1] * 1e3 if entries else None, **breakdown(run, kind)}
    print(json.dumps(out), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
