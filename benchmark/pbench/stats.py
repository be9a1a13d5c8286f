"""Percentile and rate arithmetic of the benchmark's end-to-end metrics.

The audio arithmetic is a frozen copy of ``go_pocket_tts_tpu_torch/bench/
harness.py``'s (``RunResult``: audio seconds are samples over 24 kHz, and
× real time is audio seconds over wall seconds); the percentile is the
nearest rank, so a tail is a latency some request really had, and a
request that failed or never delivered counts as a miss, above every
latency.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

__all__ = ["MISS", "audio_seconds", "median", "percentile", "rate", "x_realtime"]

SAMPLE_RATE = 24_000
MISS = math.inf


def audio_seconds(n_samples: int, sample_rate: int = SAMPLE_RATE) -> float:
    return n_samples / sample_rate


def x_realtime(audio_s: float, wall_s: float) -> float:
    return audio_s / wall_s if wall_s > 0 else 0.0


def rate(amount: float, seconds: float) -> float:
    """``amount`` per second over a window of ``seconds``."""
    if seconds <= 0:
        raise ValueError("rate over an empty window")
    return amount / seconds


def percentile(values: Sequence[float], q: float) -> Optional[float]:
    """The nearest-rank ``q``-th percentile (0 < q <= 100): the smallest
    value with at least ``q``% of the values at or below it. None for no
    values; ``MISS`` where the rank falls on a miss."""
    if not values:
        return None
    if not 0 < q <= 100:
        raise ValueError(f"percentile {q} outside (0, 100]")
    ordered = sorted(values)
    rank = max(int(math.ceil(q / 100.0 * len(ordered))), 1)
    return ordered[rank - 1]


def median(values: Sequence[float]) -> Optional[float]:
    return percentile(values, 50.0)
