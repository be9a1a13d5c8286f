"""The system under test: the port's single runtime or its continuous
batcher, built from a configuration file, with the routes a workload
drives (``stream``, ``oneshot``), their warm-up and their counters.

This is the only module of the benchmark that imports the port
(``go_pocket_tts_tpu_torch``), and it does so inside functions.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, Iterable, Iterator, List, Optional

import numpy as np
import torch

from pbench.probe import FrameProbe

__all__ = ["System", "build_system", "host_copy"]

TIMEOUT_S = 120.0
QUIESCE_S = 0.05


def _synchronize(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_copy(weights: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The checkpoint tensors on the host, each in its own dtype, copied one
    at a time: the port's loader reads host arrays, and the card needs no
    room beyond the set."""
    return {name: t.cpu() for name, t in weights.items()}


def _gen_config(temperature: float, frames: int):
    from go_pocket_tts_tpu_torch.runtime.generate import GenerateConfig

    return GenerateConfig(temperature=temperature, eos_threshold=1e9, max_steps=frames, lsd_decode_steps=1)


def _kernel_counts() -> Dict[str, Dict]:
    """Every kernel wrapper's launches and, for the SEANet ones, launches by
    input shape."""
    from go_pocket_tts_tpu_torch import kernels

    out = {}
    for fn in kernels.WRAPPERS:
        out[fn.__name__] = {"launches": fn.launches, "shapes": dict(getattr(fn, "shapes", {}) or {})}
    return out


class System:
    """One port system; ``stream``/``oneshot`` are the routes."""

    kind = ""

    def __init__(self, config: Dict, host_weights: Dict[str, torch.Tensor], device: torch.device, seed: int) -> None:
        from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors

        self.config = config
        self.system = config["system"]
        self.probe = FrameProbe()
        self.dtype = getattr(torch, self.system["dtype"])
        self.device = device
        # Float32 first, as the Service loads it: the runtime quantizes and
        # casts.
        self.model = load_model_from_tensors(host_weights, num_heads=config["num_heads"], device=device)

    def stream(self, tokens: List[int], temperature: float, frames: int, key: Optional[int] = None) -> Iterator[np.ndarray]:
        """Stream one request's PCM blocks; with ``key``, its frames are kept
        for the output check."""
        raise NotImplementedError

    def oneshot(self, tokens: List[int], temperature: float, frames: int, key: Optional[int] = None) -> np.ndarray:
        raise NotImplementedError

    def warm(self, token_counts: Iterable[int], frame_range: Iterable[int], routes: Iterable[str]) -> None:
        raise NotImplementedError

    def captures(self) -> int:
        raise NotImplementedError

    def kernel_counts(self) -> Dict[str, Dict]:
        return _kernel_counts()

    def quiesce(self):
        """A context in which no thread launches device work on the system
        and the device is idle."""
        raise NotImplementedError

    def close(self) -> None:
        pass


def _bucket_lengths(token_counts: Iterable[int]) -> List[int]:
    """The largest token count of each prompt bucket the traffic reaches."""
    from go_pocket_tts_tpu_torch.utils import buckets as bk

    best: Dict[int, int] = {}
    for n in token_counts:
        b = bk.pick_bucket(n, bk.PROMPT_BUCKETS)
        best[b] = max(best.get(b, 0), n)
    return [best[b] for b in sorted(best)]


class RuntimeSystem(System):
    """``GPURuntime``: one request at a time (the Service holds a lock
    around it too)."""

    kind = "runtime"

    def __init__(self, config, host_weights, device, seed) -> None:
        super().__init__(config, host_weights, device, seed)
        from go_pocket_tts_tpu_torch.runtime.generate import GPURuntime

        self.runtime = GPURuntime(self.model, dtype=self.dtype, seed=seed, device=device,
                                  quantize=self.system.get("quantize", False))
        self.probe.attach_runtime(self.runtime)
        self.model = None
        self._lock = threading.Lock()

    def stream(self, tokens, temperature, frames, key=None):
        from go_pocket_tts_tpu_torch.runtime.streaming import stream_generate

        with self._lock, self.probe.recording(key):
            yield from stream_generate(self.runtime, tokens, _gen_config(temperature, frames))

    def oneshot(self, tokens, temperature, frames, key=None):
        with self._lock, self.probe.recording(key):
            return self.runtime.generate_audio(tokens, _gen_config(temperature, frames))

    def warm(self, token_counts, frame_range, routes) -> None:
        """Greedy requests through each route the traffic drives: one per
        prompt bucket it reaches, then 32 consecutive frame counts from its
        shortest (every remainder of a segment or sync size that divides
        32) and its frame range in steps of 16 (every decode width)."""
        lo, hi = min(frame_range), max(frame_range)
        frames = sorted(set(range(lo, min(lo + 32, hi + 1))) | set(range(lo, hi + 1, 16)) | {hi})
        short = min(token_counts)
        for route in sorted(routes):
            run = self._run_route(route)
            for n in _bucket_lengths(token_counts):
                run([0] * n, lo)
            for m in frames:
                run([0] * short, m)

    def _run_route(self, route: str):
        if route == "stream":
            return lambda tokens, m: [b for b in self.stream(tokens, 0.0, m)]
        return lambda tokens, m: self.oneshot(tokens, 0.0, m)

    def captures(self) -> int:
        graphs = self.runtime._graphs
        return 0 if graphs is None else graphs.captures

    @contextlib.contextmanager
    def quiesce(self):
        """Between two requests: the runtime's callers hold its lock."""
        with self._lock:
            _synchronize(self.device)
            yield

    def close(self) -> None:
        self.runtime = None


class BatcherSystem(System):
    """``ContinuousBatcher`` with the serving settings of the
    configuration; safe from many client threads."""

    kind = "batcher"

    def __init__(self, config, host_weights, device, seed) -> None:
        super().__init__(config, host_weights, device, seed)
        from go_pocket_tts_tpu_torch.parallel.batching import ContinuousBatcher

        s = self.system
        self.slots = int(s["slots"])
        self.batcher = ContinuousBatcher(
            self.model,
            slots=self.slots,
            prompt_capacity=int(s["prompt_capacity"]),
            max_frames=int(s["max_frames"]),
            dtype=self.dtype,
            seed=seed,
            steps_per_sync=int(s["steps_per_sync"]),
            steps_per_sync_burst=int(s.get("steps_per_sync_burst", 0)),
            quantize=s.get("quantize", False),
            kv_quantize=s.get("kv_quantize", False),
            device=device,
        )
        self.probe.attach_engine(self.batcher)
        self.model = None
        self.batcher.start()

    def _config(self, temperature, frames, key):
        cfg = _gen_config(temperature, frames)
        self.probe.want(cfg, key)
        return cfg

    def stream(self, tokens, temperature, frames, key=None):
        yield from self.batcher.submit_stream(tokens, self._config(temperature, frames, key), timeout=TIMEOUT_S)

    def oneshot(self, tokens, temperature, frames, key=None):
        return self.batcher.submit(tokens, self._config(temperature, frames, key)).result(timeout=TIMEOUT_S)

    def warm(self, token_counts, frame_range, routes) -> None:
        """``prewarm`` at the largest token count of each prompt bucket the
        traffic reaches, then the harvest decode of every decode bucket its
        frame range reaches, for one lane and for a full batch."""
        from go_pocket_tts_tpu_torch.utils import buckets as bk

        self.batcher.prewarm(tuple(_bucket_lengths(token_counts)), timeout=600.0)
        if "oneshot" not in routes:
            return
        widest: Dict[int, int] = {}
        for m in frame_range:
            b = bk.pick_bucket(m, bk.DECODE_BUCKETS)
            widest[b] = max(widest.get(b, 0), m)
        short = [0] * min(token_counts)
        for m in sorted(widest.values()):
            self.oneshot(short, 0.0, m)
            for f in [self.batcher.submit(short, _gen_config(0.0, m)) for _ in range(self.slots)]:
                f.result(timeout=TIMEOUT_S)

    def captures(self) -> int:
        return sum(s["captures"] for s in self.batcher.graph_stats())

    @contextlib.contextmanager
    def quiesce(self):
        """The engine waits at its next program: every program is enqueued
        under the process's capture lock (``runtime/graphs.py``
        ``exclusive``). The pause lets it finish the host work between two
        programs, and the synchronisation lets the harvest drainer's copies
        complete."""
        from go_pocket_tts_tpu_torch.runtime.graphs import exclusive

        with exclusive():
            time.sleep(QUIESCE_S)
            _synchronize(self.device)
            yield

    def close(self) -> None:
        self.batcher.stop()
        self.batcher = None


SYSTEMS = {"runtime": RuntimeSystem, "batcher": BatcherSystem}


def build_system(config: Dict, host_weights, device, seed: int) -> System:
    kind = config["system"]["kind"]
    if kind not in SYSTEMS:
        raise ValueError(f"configuration {config.get('name')!r}: unknown system kind {kind!r}")
    return SYSTEMS[kind](config, host_weights, device, seed)

