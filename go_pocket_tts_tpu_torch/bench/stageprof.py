"""Stage profiler (counterpart of ``go_pocket_tts_tpu/bench/stageprof.py``;
`bench/stageprof/stageprof.go:34-245`).

Breaks one synthesis into prepare / prefill / ar / decode / generate /
encode wall times through ``GPURuntime.generate_audio_staged``, which
synchronizes the device at each boundary; a runtime without it (the
batcher) reports ``generate`` alone. With ``trace_dir`` the run is wrapped
in ``torch.profiler.profile`` (CPU, and CUDA on the card) and a Chrome trace
is written into that directory, the counterpart of the reference's
``jax.profiler.trace``.

The request's voice is applied to every chunk, as ``Service`` applies it,
so a voiced profile has the voiced prompt, cache and audio (the reference's
profiler leaves the voice out).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from go_pocket_tts_tpu_torch.text import prepare_chunks
from go_pocket_tts_tpu_torch.tts.service import MAX_TOKENS_PER_CHUNK, load_voice_conditioning
from go_pocket_tts_tpu_torch.utils import wav

__all__ = ["StageProfile", "profile_synthesis", "TRACE_FILE"]

log = logging.getLogger("pockettts.stageprof")

TRACE_FILE = "stageprof.trace.json"


@dataclass
class StageProfile:
    stages: Dict[str, float] = field(default_factory=dict)  # seconds
    rtf: float = 0.0
    audio_seconds: float = 0.0
    trace_path: str = ""  # the Chrome trace, when one was asked for

    def format_table(self) -> str:
        lines = [f"{'stage':>10} {'ms':>10}"]
        for name, secs in self.stages.items():
            lines.append(f"{name:>10} {secs * 1e3:>10.1f}")
        lines.append(f"rtf={self.rtf:.4f} audio={self.audio_seconds:.2f}s")
        return "\n".join(lines)


def _profiler():
    """``torch.profiler.profile`` over the CPU, and the card where there is one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    return profile(activities=activities)


def profile_synthesis(
    service,
    text: str,
    voice_path: str = "",
    trace_dir: Optional[str] = None,
) -> StageProfile:
    """Profile one synthesis of ``text`` by ``service`` (one pass, chunk by
    chunk, under the service's lock)."""
    prof = StageProfile()
    trace_cm = _profiler() if trace_dir else contextlib.nullcontext()
    conditioning = load_voice_conditioning(voice_path)

    with trace_cm as tracer:
        t0 = time.perf_counter()
        chunks = prepare_chunks(text, service.tokenizer, MAX_TOKENS_PER_CHUNK)
        prof.stages["prepare"] = time.perf_counter() - t0

        samples: List[np.ndarray] = []
        t_gen = 0.0
        staged = getattr(service.runtime, "generate_audio_staged", None)
        for chunk in chunks:
            cfg = service._generate_config(chunk)
            conditioning.apply_to(cfg)
            g0 = time.perf_counter()
            with service._lock:
                if staged is not None:
                    pcm, stage_times = staged(chunk.token_ids, cfg)
                    for name, secs in stage_times.items():
                        prof.stages[name] = prof.stages.get(name, 0.0) + secs
                else:
                    pcm = service.runtime.generate_audio(chunk.token_ids, cfg)
            t_gen += time.perf_counter() - g0
            samples.append(pcm)
        prof.stages["generate"] = t_gen

        e0 = time.perf_counter()
        pcm_all = np.concatenate(samples) if samples else np.zeros(0, np.float32)
        wav_bytes = wav.encode_wav(pcm_all)
        prof.stages["encode"] = time.perf_counter() - e0

    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.trace_path = os.path.join(trace_dir, TRACE_FILE)
        tracer.export_chrome_trace(prof.trace_path)
    prof.audio_seconds = len(pcm_all) / 24_000
    total = sum(prof.stages.values())
    prof.rtf = total / prof.audio_seconds if prof.audio_seconds > 0 else float("inf")
    log.debug("stageprof: %s (%d wav bytes)", prof.stages, len(wav_bytes))
    return prof
