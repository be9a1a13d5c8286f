"""The check of what the timed path produced: ``correct``.

Once the window has closed and the program's state is freed, a sample of
the greedy requests the window finished (drawn from the seed, the longest
always in it) is held against the plain reference, computed from the same
weights and token ids. Greedy requests are mixed into every workload for
this: at temperature 0 a request's audio is a function of its text. The
numbers compared, each against its limit from the workload's
``check.limits``:

- ``never_delivered``: requests of the window that failed or never ended
  (limit 0);
- ``malformed``: finished requests whose PCM is not ``frames · 1920``
  samples, or not finite (limit 0);
- ``step_err``: teacher forcing. Each served frame against the frame the
  reference makes from the text and the served frames before it; the
  largest RMS gap over the sampled requests' frames, relative to the RMS of
  the reference's frames of that request. It covers the prefill, every AR
  step and the flowNet at every position the requests reach;
- ``decode_rel_rms``: the served PCM against the reference's decode of the
  served frames (``latent_to_mimi``, Mimi and the SEANet), the largest RMS
  gap relative to the reference PCM's RMS;
- ``decode_vs_control``: the served PCM's gap from the reference's decode
  of the served frames, as a share of the gap that the control (the
  reference in the configuration's ``control`` precision) makes decoding
  the same frames; the largest over the sampled requests. The weights from
  the seed set the decoder's output level, and a relative gap with it, in
  both gaps alike: this share is free of the level. Computed only where
  the workload gives it a limit (one more decode per request);
- ``head_rel_rms``: the start, free-running. The first ``head_frames``
  frames' PCM against the reference's own synthesis from the text alone;
  the largest relative RMS gap.

A cell compares the numbers its workload file gives limits for
(``never_delivered`` and ``malformed`` always); the others are printed on
an earlier line, after one line per sampled request with its own readings. The served frames are read from the program's state as it runs
(``pbench/probe.py``): a free-running reference parts from any sound
low-precision run within a few frames, because the AR loop feeds each
frame back and amplifies a rounding difference, so past the head only
teacher forcing can hold a frame to the reference.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

__all__ = ["NUMBERS", "check_outputs", "rel_rms", "sample", "step_errors"]

SAMPLES_PER_FRAME = 1920
NUMBERS = ("never_delivered", "malformed", "step_err", "decode_rel_rms", "decode_vs_control", "head_rel_rms")
MEASURED = NUMBERS[2:]


def rel_rms(got: np.ndarray, want: np.ndarray) -> float:
    """RMS of ``got − want`` over the RMS of ``want``; inf where the
    lengths differ or ``got`` is not finite."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if len(got) != len(want) or not np.all(np.isfinite(got)):
        return math.inf
    scale = math.sqrt(float(np.mean(want * want))) if len(want) else 0.0
    err = math.sqrt(float(np.mean((got - want) ** 2))) if len(want) else 0.0
    return err / scale if scale > 0 else (0.0 if err == 0 else math.inf)


def step_errors(served: torch.Tensor, predicted: torch.Tensor) -> torch.Tensor:
    """Per frame, the RMS gap between the served and the predicted frame
    over the RMS of the predicted frames."""
    served, predicted = served.float(), predicted.float().to(served.device)
    scale = predicted.pow(2).mean().sqrt().clamp_min(1e-30)
    return (served - predicted).pow(2).mean(dim=1).sqrt() / scale


def sample(records, n: int, seed: int) -> List:
    """Up to ``n`` finished greedy records: the one with the most frames,
    and the rest drawn from ``seed``."""
    pool = [r for r in records if r.request.greedy and r.error is None and r.pcm is not None]
    if not pool:
        return []
    longest = max(pool, key=lambda r: (r.request.frames, -r.request.index))
    rest = [r for r in pool if r is not longest]
    rng = np.random.Generator(np.random.PCG64(int(seed) & (2**63 - 1)))
    picked = [rest[i] for i in sorted(rng.permutation(len(rest))[: max(n - 1, 0)].tolist())]
    return [longest] + picked


def _largest_gap_frame(got: np.ndarray, want: np.ndarray) -> int:
    """The frame whose PCM differs most (by RMS) between ``got`` and ``want``."""
    n = len(want) // SAMPLES_PER_FRAME
    if n == 0:
        return 0
    d = (np.asarray(got[: n * SAMPLES_PER_FRAME], np.float64) - np.asarray(want[: n * SAMPLES_PER_FRAME], np.float64))
    return int(np.argmax((d.reshape(n, SAMPLES_PER_FRAME) ** 2).mean(axis=1)))


def _rms(x: np.ndarray) -> float:
    x = np.asarray(x, np.float64)
    return math.sqrt(float(np.mean(x * x))) if len(x) else 0.0


def gap_share(got: np.ndarray, control: np.ndarray, want: np.ndarray) -> float:
    """RMS of ``got − want`` over the RMS of ``control − want``; inf where
    the lengths differ or ``got`` is not finite."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if len(got) != len(want) or not np.all(np.isfinite(got)):
        return math.inf
    err, scale = _rms(got - want), _rms(np.asarray(control, np.float64) - want)
    return err / scale if scale > 0 else (0.0 if err == 0 else math.inf)


def measure(ref, records, frames_of: Callable, head_frames: int, notes: Optional[List[str]] = None,
            control=None) -> Dict[str, float]:
    """The comparisons over ``records`` (each with its served PCM),
    ``frames_of(record)`` giving its served frames or None. ``notes``, where
    given, receives one line of readings per request; ``control``, where
    given (the reference in the control's precision), adds
    ``decode_vs_control``."""
    worst = {name: 0.0 for name in MEASURED if control is not None or name != "decode_vs_control"}
    for r in records:
        req = r.request
        served = frames_of(r)
        if served is None or served.shape[0] != req.frames or not bool(torch.isfinite(served).all()):
            return {k: math.inf for k in worst}
        served = served.to(ref.device)
        steps = step_errors(served, ref.teacher_frames(req.tokens, served))
        want = ref.decode(served)
        decode = rel_rms(r.pcm, want)
        h = min(head_frames, req.frames)
        head = rel_rms(r.pcm[: h * SAMPLES_PER_FRAME], ref.decode(ref.frames(req.tokens, h)))
        worst["step_err"] = max(worst["step_err"], float(steps.max()))
        worst["decode_rel_rms"] = max(worst["decode_rel_rms"], decode)
        worst["head_rel_rms"] = max(worst["head_rel_rms"], head)
        share = ""
        if control is not None:
            vs = gap_share(r.pcm, control.decode(served), want)
            worst["decode_vs_control"] = max(worst["decode_vs_control"], vs)
            share = f"; decode_vs_control {vs!r}"
        if notes is not None:
            notes.append(
                f"check request {req.index}: {len(req.tokens)} tokens, {req.frames} frames; "
                f"step_err {float(steps.max())!r} at frame {int(steps.argmax())}; "
                f"decode_rel_rms {decode!r} (reference RMS {_rms(want)!r}, largest gap at frame "
                f"{_largest_gap_frame(r.pcm, want) if math.isfinite(decode) else -1}){share}; head_rel_rms {head!r}")
    return worst


def check_outputs(run, reference_module, host_weights, device: torch.device, seed: int, probe) -> Dict:
    probe.raise_if_moved()
    spec = run.workload["check"]
    limits = spec["limits"]
    numbers: Dict[str, float] = {
        "never_delivered": float(sum(1 for r in run.records if r.error is not None)),
        "malformed": float(sum(
            1 for r in run.records
            if r.error is None and (r.samples != r.request.frames * SAMPLES_PER_FRAME
                                    or (r.pcm is not None and not np.all(np.isfinite(r.pcm))))
        )),
    }
    picked = sample(run.records, int(spec["requests"]), seed)
    notes: List[str] = []
    if picked:
        weights = {k: v.to(device) for k, v in host_weights.items()}
        ref = reference_module.PocketTTSReference(weights, run.config, run.config.get("reference"))
        control = None
        if "decode_vs_control" in limits:
            control = reference_module.PocketTTSReference(weights, run.config, run.config["control"])
        numbers.update(measure(ref, picked, lambda r: probe.frames(r.request.index, r.request.frames),
                               int(spec["head_frames"]), notes, control))
        del ref, control, weights
    else:
        numbers.update({k: math.inf for k in MEASURED})
    correct = bool(picked)
    compared = [n for n in NUMBERS if n in limits or n in ("never_delivered", "malformed")]
    lines = notes + [f"check: {len(picked)} greedy requests, {sum(r.request.frames for r in picked)} frames "
             f"against the reference; not compared: "
             + ", ".join(f"{n} {numbers[n]!r}" for n in NUMBERS if n not in compared and n in numbers)]
    out = {}
    for name in compared:
        value, limit = numbers[name], float(limits[name])
        ok = value <= limit
        correct = correct and ok
        out[name] = {"value": value if math.isfinite(value) else 1e300, "limit": limit}
        lines.append(f"check {name}: {value!r} (limit {limit!r}) {'ok' if ok else 'FAILED'}")
    return {"correct": correct, "numbers": out, "lines": lines}
