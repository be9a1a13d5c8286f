"""The frames a request's audio was decoded from, read from the program's
own state as the timed path runs.

The output check holds each served frame against the frame the reference
makes from the served frames before it (teacher forcing), because a
free-running reference parts from any sound low-precision run within a few
frames (the AR loop feeds each frame back and amplifies a rounding
difference). The port returns PCM only, so the frames are read where the
program keeps them, for the requests the check may sample (the greedy
ones), with device copies enqueued behind the work that made them:

- the single runtime: each ``GPURuntime._ar_loop`` call's static frame
  buffer and frame count (one call per streamed segment, one per one-shot
  request), copied as the call returns, for the request that the calling
  client thread has marked;
- the batcher: a lane's row of the engine's frame buffer, copied as the
  engine frees the lane (``_release_slots``, on the engine's thread and
  stream, after the lane's last block and before the slot is reused).

These are private attributes of the port; where one is missing or no
longer has the shape read here, the run stops with no result rather than
check less, and the ``ProbeError`` names the attribute, so that a change
to the port knows what to keep (or the public hook that replaces them).
A shape that moved is seen when the wrapped call first runs; the error is
kept there, so the program's own thread goes on, and raised when the
frames are asked for.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from pbench.registry import BenchError

__all__ = ["FrameProbe", "ProbeError"]


class ProbeError(BenchError):
    """The port's private attribute that the probe reads moved."""


class FrameProbe:
    def __init__(self) -> None:
        self._local = threading.local()
        self._segments: Dict[int, List[Tuple[torch.Tensor, torch.Tensor]]] = {}
        self._lanes: Dict[int, torch.Tensor] = {}
        # id(GenerateConfig) -> (key, the config, kept alive so its id stays its own)
        self._wanted: Dict[int, Tuple[int, object]] = {}
        self._lock = threading.Lock()
        self._broken: Optional[str] = None

    def _moved(self, what: str, exc: BaseException) -> None:
        if self._broken is None:
            self._broken = f"{what} moved ({type(exc).__name__}: {exc}): the frame probe cannot read the frames"

    # -- the single runtime ----------------------------------------------

    def attach_runtime(self, runtime) -> None:
        orig = getattr(runtime, "_ar_loop", None)
        if orig is None:
            raise ProbeError("GPURuntime has no _ar_loop: the frame probe cannot attach")
        local = self._local

        def ar_loop(*args, **kwargs):
            out = orig(*args, **kwargs)
            segments = getattr(local, "segments", None)
            if segments is not None:
                try:
                    frames, n_frames, _carry = out
                    segments.append((frames[0].clone(), n_frames[:1].clone()))
                except (TypeError, ValueError, IndexError, AttributeError) as exc:
                    self._moved("GPURuntime._ar_loop's return (frames [B, T, L], n_frames [B], carry)", exc)
            return out

        runtime._ar_loop = ar_loop

    @contextlib.contextmanager
    def recording(self, key: Optional[int]) -> Iterator[None]:
        """Mark the calling thread's runtime calls as request ``key``'s."""
        if key is None:
            yield
            return
        self._local.segments = segments = []
        try:
            yield
        finally:
            self._local.segments = None
            with self._lock:
                self._segments[key] = segments

    # -- the batcher -----------------------------------------------------

    def attach_engine(self, engine) -> None:
        for name in ("_release_slots", "_slot_info", "_state"):
            if not hasattr(engine, name):
                raise ProbeError(f"the batcher's engine has no {name}: the frame probe cannot attach")
        state = engine._state
        if not hasattr(state, "get") or not isinstance(state.get("frames"), torch.Tensor):
            raise ProbeError("the batcher's engine._state has no 'frames' tensor: the frame probe cannot attach")
        if not all(hasattr(info, "request") for info in engine._slot_info):
            raise ProbeError("the batcher's engine._slot_info entries have no .request: the frame probe cannot attach")
        orig = engine._release_slots

        def release(slots):
            try:
                for slot in slots:
                    req = engine._slot_info[slot].request
                    hit = None if req is None else self._wanted.get(id(req.cfg))
                    if hit is not None and hit[1] is req.cfg:
                        self._lanes[hit[0]] = engine._state["frames"][slot].clone()
            except (TypeError, KeyError, IndexError, AttributeError) as exc:
                self._moved("the batcher's engine._slot_info[slot].request.cfg or engine._state['frames'][slot]", exc)
            return orig(slots)

        engine._release_slots = release

    def want(self, cfg, key: Optional[int]) -> None:
        """Keep the frames of the lane that serves ``cfg`` as ``key``'s."""
        if key is not None:
            with self._lock:
                self._wanted[id(cfg)] = (key, cfg)

    def put(self, key: int, frames: torch.Tensor) -> None:
        """Keep ``frames`` as request ``key``'s: a stand-in for the program
        (the control) hands its frames over here."""
        with self._lock:
            self._lanes[key] = frames

    # -- after the window --------------------------------------------------

    def raise_if_moved(self) -> None:
        if self._broken is not None:
            raise ProbeError(self._broken)

    def frames(self, key: int, n_frames: int) -> Optional[torch.Tensor]:
        """The ``[n_frames, latent]`` float32 frames of request ``key``, or
        None where none were kept. Raises ``ProbeError`` where a private
        attribute it reads moved."""
        self.raise_if_moved()
        if key in self._lanes:
            return self._lanes[key][:n_frames].float()
        segments = self._segments.get(key)
        if not segments:
            return None
        parts = [f[: int(n.item())] for f, n in segments]
        return torch.cat(parts)[:n_frames].float()
