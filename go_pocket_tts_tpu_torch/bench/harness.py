"""Benchmark harness (a copy of ``go_pocket_tts_tpu/bench/harness.py``;
`internal/bench/bench.go:19-246`).

RTF here follows the reference's definition: ``synthesis_time / audio_time``
(lower is better; <1 = faster than real time). The inverse ("×-real-time",
higher is better) is also reported because BASELINE.md's target is stated
that way (≥ 50× real time per device).

Unlike the reference's bench command (which only drives the CLI subprocess
backend, `cmd/pockettts/bench.go:116-151`), this harness drives any Service.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

__all__ = [
    "RunResult",
    "BenchStats",
    "calc_rtf",
    "compute_stats",
    "check_rtf_threshold",
    "format_table",
    "format_json",
    "run_bench",
]


@dataclass
class RunResult:
    run_index: int
    synth_seconds: float
    audio_seconds: float
    ttfa_seconds: float = 0.0  # time to first audio chunk
    cold: bool = False

    @property
    def rtf(self) -> float:
        return calc_rtf(self.synth_seconds, self.audio_seconds)

    @property
    def x_realtime(self) -> float:
        return self.audio_seconds / self.synth_seconds if self.synth_seconds > 0 else 0.0


def calc_rtf(synth_seconds: float, audio_seconds: float) -> float:
    if audio_seconds <= 0:
        return float("inf")
    return synth_seconds / audio_seconds


@dataclass
class BenchStats:
    runs: List[RunResult] = field(default_factory=list)

    def _vals(self, fn) -> List[float]:
        return [fn(r) for r in self.runs if not r.cold] or [fn(r) for r in self.runs]

    @property
    def rtf_min(self) -> float:
        return min(self._vals(lambda r: r.rtf))

    @property
    def rtf_mean(self) -> float:
        v = self._vals(lambda r: r.rtf)
        return sum(v) / len(v)

    @property
    def rtf_max(self) -> float:
        return max(self._vals(lambda r: r.rtf))

    @property
    def ttfa_p50(self) -> float:
        return float(np.median(self._vals(lambda r: r.ttfa_seconds)))


def compute_stats(runs: List[RunResult]) -> BenchStats:
    if not runs:
        raise ValueError("no bench runs")
    return BenchStats(runs=list(runs))


def check_rtf_threshold(stats: BenchStats, threshold: float) -> None:
    """CI gate (`bench.go:151-163`): fail when mean RTF exceeds the
    threshold; 0 disables."""
    if threshold > 0 and stats.rtf_mean > threshold:
        raise RuntimeError(
            f"mean RTF {stats.rtf_mean:.4f} exceeds threshold {threshold:.4f}"
        )


def format_table(stats: BenchStats) -> str:
    lines = [
        f"{'run':>4} {'cold':>5} {'synth_s':>9} {'audio_s':>9} {'rtf':>8} {'x_rt':>8} {'ttfa_ms':>8}",
    ]
    for r in stats.runs:
        lines.append(
            f"{r.run_index:>4} {str(r.cold):>5} {r.synth_seconds:>9.3f} "
            f"{r.audio_seconds:>9.3f} {r.rtf:>8.4f} {r.x_realtime:>8.1f} "
            f"{r.ttfa_seconds * 1e3:>8.1f}"
        )
    lines.append(
        f"rtf min/mean/max = {stats.rtf_min:.4f}/{stats.rtf_mean:.4f}/{stats.rtf_max:.4f}"
        f"  ttfa p50 = {stats.ttfa_p50 * 1e3:.1f} ms"
    )
    return "\n".join(lines)


def format_json(stats: BenchStats) -> str:
    return json.dumps(
        {
            "runs": [
                {
                    "run": r.run_index,
                    "cold": r.cold,
                    "synth_seconds": r.synth_seconds,
                    "audio_seconds": r.audio_seconds,
                    "rtf": r.rtf,
                    "x_realtime": r.x_realtime,
                    "ttfa_seconds": r.ttfa_seconds,
                }
                for r in stats.runs
            ],
            "rtf_min": stats.rtf_min,
            "rtf_mean": stats.rtf_mean,
            "rtf_max": stats.rtf_max,
            "ttfa_p50_seconds": stats.ttfa_p50,
        }
    )


def run_bench(
    service,
    text: str,
    runs: int = 3,
    voice_path: str = "",
    include_cold: bool = True,
    sample_rate: int = 24_000,
    on_run: Optional[Callable[[RunResult], None]] = None,
) -> BenchStats:
    """Run synthesis ``runs`` times (+1 cold run) and collect RTF/TTFA."""
    results: List[RunResult] = []
    total = runs + (1 if include_cold else 0)
    for i in range(total):
        cold = include_cold and i == 0
        start = time.perf_counter()
        ttfa = 0.0
        samples = []
        for chunk in service.synthesize_stream(text, voice_path):
            if not samples:
                ttfa = time.perf_counter() - start
            samples.append(chunk.samples)
        synth = time.perf_counter() - start
        pcm = np.concatenate(samples) if samples else np.zeros(0, np.float32)
        audio_seconds = len(pcm) / sample_rate
        r = RunResult(
            run_index=i,
            synth_seconds=synth,
            audio_seconds=audio_seconds,
            ttfa_seconds=ttfa,
            cold=cold,
        )
        results.append(r)
        if on_run:
            on_run(r)
    return compute_stats(results)
