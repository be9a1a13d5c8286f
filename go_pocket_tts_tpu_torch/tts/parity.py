"""Cross-backend parity harness (counterpart of the reference package's
``tts/parity.py``; `internal/tts/parity.go:25-203`).

Run the same (text, voice, seed) through several backends and snapshot
``{chunk/sample counts, peakAbs, RMS, sha256(PCM16)}`` per backend, with
JSON save/load for golden records; the JSON is byte-equal to the reference
package's for equal inputs.

The strongest check: at ``temperature=0`` the CUDA engine (``gpu``) and the
independently implemented torch engine (``torch``,
:mod:`tts.runtime_torch`) must produce waveforms within the 1e-3 RMS
budget (BASELINE.md).
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import asdict, dataclass
from typing import Callable, Dict, Mapping

import numpy as np

from go_pocket_tts_tpu_torch.utils import wav

__all__ = [
    "ParitySnapshot",
    "TensorParityReport",
    "compare_tensor",
    "snapshot_pcm",
    "run_parity_case",
    "save_snapshots",
    "load_snapshots",
    "rms_delta",
]


@dataclass
class TensorParityReport:
    """Per-tensor parity report (`internal/native/parity.go:11-70`)."""

    name: str
    shape_match: bool
    max_abs_err: float
    max_rel_err: float
    passed: bool


def compare_tensor(
    name: str,
    got: np.ndarray,
    want: np.ndarray,
    atol: float = 2e-4,
    rtol: float = 5e-3,
) -> TensorParityReport:
    """Compare against an oracle with the reference's abs/rel budget scheme
    (default budgets from `ops/tolerance.go` / the Python-parity fixtures)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return TensorParityReport(name, False, float("inf"), float("inf"), False)
    diff = np.abs(got - want)
    max_abs = float(diff.max()) if diff.size else 0.0
    denom = np.maximum(np.abs(want), 1e-12)
    max_rel = float((diff / denom).max()) if diff.size else 0.0
    passed = bool(np.all(diff <= atol + rtol * np.abs(want)))
    return TensorParityReport(name, True, max_abs, max_rel, passed)


@dataclass
class ParitySnapshot:
    backend: str
    num_chunks: int
    num_samples: int
    peak_abs: float
    rms: float
    pcm_sha256: str


def snapshot_pcm(backend: str, samples: np.ndarray, num_chunks: int = 1) -> ParitySnapshot:
    x = np.asarray(samples, np.float32)
    peak = float(np.max(np.abs(x))) if x.size else 0.0
    rms = float(np.sqrt(np.mean(np.square(x)))) if x.size else 0.0
    digest = hashlib.sha256(wav.pcm16_bytes(x)).hexdigest()
    return ParitySnapshot(
        backend=backend,
        num_chunks=num_chunks,
        num_samples=int(x.size),
        peak_abs=peak,
        rms=rms,
        pcm_sha256=digest,
    )


def run_parity_case(
    backends: Mapping[str, Callable[[], object]],
    input_text: str,
    voice_path: str = "",
) -> Dict[str, ParitySnapshot]:
    """``backends`` maps name → factory returning a Service; each service is
    run once on the same input and closed."""
    out: Dict[str, ParitySnapshot] = {}
    for name, factory in backends.items():
        svc = factory()
        try:
            chunks = list(svc.synthesize_stream(input_text, voice_path))
            pcm = np.concatenate([c.samples for c in chunks]) if chunks else np.zeros(0)
            out[name] = snapshot_pcm(name, pcm, num_chunks=len(chunks))
        finally:
            svc.close()
    return out


def rms_delta(a: np.ndarray, b: np.ndarray) -> float:
    """RMS of the difference (the BASELINE.md waveform-parity metric)."""
    n = min(len(a), len(b))
    if n == 0:
        return math.inf if len(a) != len(b) else 0.0
    d = np.asarray(a[:n], np.float64) - np.asarray(b[:n], np.float64)
    return float(np.sqrt(np.mean(np.square(d))))


def save_snapshots(path: str, snaps: Mapping[str, ParitySnapshot]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        json.dump({k: asdict(v) for k, v in snaps.items()}, f, indent=2, sort_keys=True)


def load_snapshots(path: str) -> Dict[str, ParitySnapshot]:
    with open(path, "r", encoding="utf-8") as f:
        data = json.load(f)
    return {k: ParitySnapshot(**v) for k, v in data.items()}
