"""Frame-level streaming synthesis on the GPU (counterpart of
``go_pocket_tts_tpu/runtime/streaming.py``).

The AR loop runs in short segments (4 latent frames = 320 ms of audio
first, then 8, then 16, capped by the runtime's ``frame_bucket``), and each
segment goes through the stateful block decoder (``models/mimi_stream.py``,
whose last two SEANet stages are the cascade kernel), so PCM reaches the
caller while the utterance is still being generated. Time to first audio
becomes prefill + one segment of AR steps + one block decode.

Exactness: the block decoder is sample-exact with the whole-sequence
decoder, and the segments thread the AR carry (cache, frame, countdown,
``done`` and the request's noise, drawn once for all its steps), so the
frames are those of ``GPURuntime.generate_audio`` for the same seed.

On the card each segment is two graphs (``runtime/graphs.py``, the
reference's ``_stream_ar_segment`` and ``_stream_decode_segment``): the
runtime's AR graph of the segment's steps (a tail segment, shorter than
its size, has a key of its own), then one graph of the frame mask,
``latent_to_mimi`` and ``mimi_stream.decode_block`` per segment size, over
a static stream state zeroed at each stream's start. On the CPU the same
bodies run eagerly over the same buffers.

Dispatch is the cost here (the host reads ``n`` and ``done`` after each
segment), so unlike the reference, which dispatches segment k+1 before it
fetches segment k, each segment's block is copied to pinned host memory and
handed to the caller before the next segment is enqueued: the first block
is never held back behind a second segment's launches.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from go_pocket_tts_tpu_torch import tracing
from go_pocket_tts_tpu_torch.models import mimi_stream
from go_pocket_tts_tpu_torch.runtime.generate import ContinuationState, GenerateConfig, HostCopy, own_cache
from go_pocket_tts_tpu_torch.runtime.graphs import feed, write_back

__all__ = ["stream_generate", "stream_generate_session"]

SEGMENT_FRAMES = 4  # the first segment: 320 ms of audio
MAX_SEGMENT_FRAMES = 16  # segments double up to this (and the frame bucket)


def stream_generate(runtime, tokens, cfg: GenerateConfig) -> Iterator[np.ndarray]:
    """Yield float32 PCM blocks for one chunk. ``runtime`` is a
    :class:`runtime.GPURuntime`; validation, voice conditioning and
    bucketing are those of its ``generate_audio``."""
    root = tracing.begin("request", request=tracing.next_request_id())
    try:
        with tracing.span("setup", parent=root), runtime._compute():
            cache, max_steps, decode_steps, frame_bucket, _ = runtime._setup(tokens, cfg)
            start = _stream_start(runtime, cfg, max_steps, frame_bucket)
        yield from _segment_loop(runtime, cfg, cache, max_steps, decode_steps, start, root)
    finally:
        if root is not None:
            root.finish()


def _stream_start(runtime, cfg: GenerateConfig, max_steps: int, frame_budget: int):
    """A new stream's decoder state and AR carry."""
    return _stream_state(runtime, frame_budget), runtime._new_carry(cfg, 1, max_steps)


def _segment_loop(runtime, cfg: GenerateConfig, cache: Dict, max_steps: int, decode_steps: int, start,
                  root: Optional[tracing.Span]):
    """Run the AR loop in adaptive segments over a prefilled ``cache``
    from ``start`` (:func:`_stream_start`), yielding PCM blocks;
    generator-returns ``(cache, emitted_frames)`` so a session can carry
    the final KV cache (``yield from``). Each segment is an ``enqueue``, a
    ``wait`` and an ``emit`` span under the request's ``root``; the time the
    generator sits at ``yield`` is the caller's and has none."""
    samples_per = runtime.model.config.mimi.samples_per_latent
    state, carry = start
    dispatched, emitted = 0, 0
    seg = SEGMENT_FRAMES
    while dispatched < max_steps:
        steps = min(seg, max_steps - dispatched)
        with tracing.span("enqueue", parent=root) as sp, runtime._compute():
            frames, n, carry = runtime._ar_loop(cache, cfg, steps, decode_steps, seg, carry)
            cache = carry["cache"]
            pcm, state = _decode_segment(runtime, state, frames, n)
            fetched = [HostCopy(t) for t in (pcm, n, carry["done"])]
        dispatched += steps
        with tracing.span("wait", parent=root):
            pcm_np, n_np, done_np = (h.numpy() for h in fetched)
        n = int(n_np[0])
        if sp is not None:
            sp.set(frames=n)
        if n > 0:
            emitted += n
            with tracing.span("emit", parent=root):
                if cfg.step_callback is not None:
                    cfg.step_callback(emitted, max_steps)
                block = pcm_np[0, 0, : n * samples_per].astype(np.float32)
            yield block
        if bool(done_np[0]) or n == 0:
            break
        seg = min(seg * 2, MAX_SEGMENT_FRAMES, runtime.frame_bucket)
    return cache, emitted


def _stream_state(runtime, frame_budget: int) -> Dict:
    """A zero stream decoder state for one stream: the runtime's static one
    of this capacity (zeroed) on the graph path. Every segment is decoded
    at its full size, so the decoded frames may pass the budget by up to
    one segment: the decoder's K/V capacity counts that segment too."""
    mimi_cfg = runtime.model.config.mimi
    steps = (frame_budget + MAX_SEGMENT_FRAMES) * mimi_cfg.steps_per_latent
    if runtime._graphs is None:
        return mimi_stream.init_stream_state(runtime.model.params["mimi"], mimi_cfg, 1, steps, runtime.dtype)
    key = ("stream_state", steps)
    if key not in runtime._buffers:
        runtime._buffers[key] = mimi_stream.init_stream_state(
            runtime.model.params["mimi"], mimi_cfg, 1, steps, runtime.dtype
        )
    state = runtime._buffers[key]
    for leaf in state.values():
        leaf.zero_()
    return state


def _stream_block(model, state: Dict, frames: torch.Tensor, n: torch.Tensor):
    """Mask → fused latent→mimi → one stream decoder block: ``(float32 PCM
    [B, 1, W·1920], new state)`` for the segment ``frames [B, W, L]`` of
    which ``n`` are real."""
    seg = frames.shape[1]
    mask = (torch.arange(seg, device=frames.device) < n[:, None])[:, :, None]
    latent = torch.where(mask, frames, torch.zeros((), dtype=frames.dtype, device=frames.device))
    pcm, state = mimi_stream.decode_block(model.params["mimi"], model.config.mimi, state, model.latent_to_mimi(latent))
    return pcm.float(), state


def _decode_segment(runtime, state: Dict, frames: torch.Tensor, n: torch.Tensor):
    """:func:`_stream_block` as the graph of its segment size over the
    static ``state`` (updated in place); returns ``(PCM, state)``."""
    if runtime._graphs is None:
        return _stream_block(runtime.model, state, frames, n)
    key = ("stream", *frames.shape[:2], state["kv_k"].shape[3], runtime.dtype)

    def make():
        model = runtime.model

        def body(inputs):
            pcm, new = _stream_block(model, inputs["state"], inputs["frames"], inputs["n"])
            write_back(inputs["state"], new)
            return pcm

        return body, {"state": state, "frames": torch.empty_like(frames), "n": torch.empty_like(n)}

    graph = runtime._graphs.get(key, make)
    feed(graph.inputs, frames=frames, n=n)
    return graph.run(), state


def stream_generate_session(
    runtime,
    tokens,
    cfg: GenerateConfig,
    cont: Optional[ContinuationState] = None,
):
    """Frame streaming with continuity: one chunk's PCM blocks, resuming
    from (and handing back) the session's KV cache. Returns ``(blocks,
    next_state)``: drain ``blocks``, then call ``next_state()`` for the
    :class:`ContinuationState` of the next chunk (single use). The frames
    are those of ``GPURuntime.generate_audio_session`` (same setup and
    prefill, the same AR steps in segments), so at temperature 0 the blocks
    concatenate to its PCM."""
    holder: Dict = {}
    blocks = _stream_session_blocks(runtime, tokens, cfg, cont, holder)

    def next_state() -> ContinuationState:
        if "cont" not in holder:
            raise RuntimeError(
                "stream_generate_session: drain the block iterator before reading the continuation state"
            )
        return holder["cont"]

    return blocks, next_state


def _stream_session_blocks(
    runtime,
    tokens,
    cfg: GenerateConfig,
    cont: Optional[ContinuationState],
    holder: Dict,
) -> Iterator[np.ndarray]:
    """Session variant of :func:`stream_generate`; its setup is
    ``GPURuntime._session_setup``, the plain session's."""
    root = tracing.begin("request", request=tracing.next_request_id())
    try:
        with tracing.span("setup", parent=root), runtime._compute():
            cache, capacity, used0, max_steps, decode_steps, frame_budget, n_tokens = runtime._session_setup(
                tokens, cfg, cont
            )
            start = _stream_start(runtime, cfg, max_steps, frame_budget)
        cache, emitted = yield from _segment_loop(runtime, cfg, cache, max_steps, decode_steps, start, root)
        holder["cont"] = ContinuationState(own_cache(cache), capacity, used0 + n_tokens + emitted)
    finally:
        if root is not None:
            root.finish()
