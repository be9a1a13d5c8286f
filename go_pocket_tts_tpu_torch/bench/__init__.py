"""Benchmark harnesses of the port: RTF/TTFA measurement, stats, stage
profiler and kernel micro-benchmarks (counterpart of
``go_pocket_tts_tpu/bench/``)."""

from go_pocket_tts_tpu_torch.bench.harness import (
    BenchStats,
    RunResult,
    calc_rtf,
    check_rtf_threshold,
    compute_stats,
    format_json,
    format_table,
    run_bench,
)

__all__ = [
    "BenchStats",
    "RunResult",
    "calc_rtf",
    "check_rtf_threshold",
    "compute_stats",
    "format_json",
    "format_table",
    "run_bench",
]
