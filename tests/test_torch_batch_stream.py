"""Streaming lanes of the port's continuous batcher against the JAX
package's, on ``tiny_arch()`` at temperature 0: ``submit_stream`` block by
block, a stream finishing mid-block, streams next to plain requests (the
block size drops to ``steps_per_sync`` and comes back), a lane idle for a
block while another streams, the batched stream decode itself, and the
ways a stream ends early: its consumer closing it, an engine crash, a
kernel failure in the stream decode, a stall, a failed admission and
``stop()``."""

import random
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from go_pocket_tts_tpu.models import mimi_stream as j_ms
from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.parallel import ContinuousBatcher as JBatcher
from go_pocket_tts_tpu.parallel import batching as j_batching
from go_pocket_tts_tpu.runtime import GenerateConfig as JConfig
from go_pocket_tts_tpu.utils.safetensors import encode_tensors, open_store_from_bytes
from go_pocket_tts_tpu_torch.kernels import seanet_tail as t_st
from go_pocket_tts_tpu_torch.models import mimi_stream as t_ms
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher
from go_pocket_tts_tpu_torch.parallel import batching as t_batching
from go_pocket_tts_tpu_torch.runtime import GenerateConfig

ARCH = synthetic.tiny_arch()
SEED = 55
ATOL = 1e-3  # streamed PCM: int16 truncation of two decoders one ulp apart
COMMON = dict(slots=2, prompt_capacity=64, max_frames=64, seed=3, steps_per_sync=4)


@pytest.fixture(scope="module")
def models():
    jm = load_model_from_store(
        open_store_from_bytes(encode_tensors(j_syn.build_checkpoint(ARCH, seed=SEED))), num_heads=ARCH.num_heads
    )
    tm = load_model_from_tensors(synthetic.build_checkpoint(ARCH, seed=SEED), num_heads=ARCH.num_heads, device="cpu")
    return jm, tm


def _cfg(**kw):
    return GenerateConfig(**{"temperature": 0.0, "eos_threshold": 1e9, "max_steps": 4, **kw})


def _jcfg(**kw):
    return JConfig(**{"temperature": 0.0, "eos_threshold": 1e9, "max_steps": 4, **kw})


def _running(batcher):
    batcher.start()
    return batcher


def _wait_idle(batcher, seconds=30.0):
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        if all(s.request is None for s in batcher._slot_info):
            return
        time.sleep(0.02)
    raise AssertionError("the engine did not free its lanes")


@pytest.mark.parametrize("max_steps,sizes", [(10, [4, 4, 2]), (7, [4, 3])], ids=["whole_blocks", "mid_block_finish"])
def test_streamed_blocks_match_reference(models, max_steps, sizes):
    """The same block sizes as the JAX batcher's, the same PCM, and the
    blocks concatenate to the port's own one-shot ``generate``."""
    jm, tm = models
    jb = _running(JBatcher(jm, **COMMON))
    try:
        want = list(jb.submit_stream([5, 9, 2], _jcfg(max_steps=max_steps), timeout=120))
    finally:
        jb.stop()
    tb = _running(ContinuousBatcher(tm, device="cpu", **COMMON))
    try:
        whole = tb.generate([5, 9, 2], _cfg(max_steps=max_steps))
        got = list(tb.submit_stream([5, 9, 2], _cfg(max_steps=max_steps), timeout=120))
    finally:
        tb.stop()
    assert [len(b) // 1920 for b in got] == [len(b) // 1920 for b in want] == sizes
    for g, w in zip(got, want):
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=ATOL)
    np.testing.assert_allclose(np.concatenate(got), whole, atol=ATOL)


def test_streaming_next_to_plain_requests(models):
    """A stream and a plain request share the batch as they do in the JAX
    batcher; blocks run ``steps_per_sync`` while the stream is attached and
    go back to the burst size after it."""
    jm, tm = models
    kw = dict(COMMON, steps_per_sync_burst=16)

    def serve(batcher, cfg):
        stream = batcher.submit_stream([5, 9, 2], cfg(max_steps=8), timeout=120)
        fut = batcher.submit([7, 1, 4], cfg(max_steps=8))
        blocks, sizes = [], set()
        for block in stream:
            blocks.append(block)
            sizes.add(batcher._last_block_k)
        return blocks, fut.result(timeout=120), sizes

    jb = _running(JBatcher(jm, **kw))
    try:
        want_blocks, want_plain, _ = serve(jb, _jcfg)
    finally:
        jb.stop()
    tb = _running(ContinuousBatcher(tm, device="cpu", **kw))
    try:
        tb.generate([5, 9, 2], _cfg(max_steps=24))
        assert tb._last_block_k == 16  # plain traffic alone takes burst blocks
        got_blocks, got_plain, sizes = serve(tb, _cfg)
        assert 4 in sizes  # the stream dropped the block size
        tb.generate([5, 9, 2], _cfg(max_steps=24))
        assert tb._last_block_k == 16  # and it came back
    finally:
        tb.stop()
    assert [len(b) for b in got_blocks] == [len(b) for b in want_blocks] == [4 * 1920, 4 * 1920]
    np.testing.assert_allclose(np.concatenate(got_blocks), np.concatenate(want_blocks), atol=ATOL)
    np.testing.assert_allclose(got_plain, want_plain, atol=1e-4, rtol=1e-3)


def test_lane_idle_while_another_streams(models):
    """Two streams of 4 and 12 frames: the short one is done after its first
    block and sits idle (``n_new == 0``, frozen, its decoder K/V rows
    written in place) while the long one streams on. Both match the JAX
    batcher."""
    jm, tm = models

    def serve(batcher, cfg):
        streams = [batcher.submit_stream(t, cfg(max_steps=n), timeout=120) for t, n in (([5, 9, 2], 4), ([7, 1], 12))]
        return [list(s) for s in streams]

    jb = _running(JBatcher(jm, **COMMON))
    try:
        want = serve(jb, _jcfg)
    finally:
        jb.stop()
    tb = _running(ContinuousBatcher(tm, device="cpu", **COMMON))
    try:
        got = serve(tb, _cfg)
    finally:
        tb.stop()
    for g, w in zip(got, want):
        assert [len(b) for b in g] == [len(b) for b in w]
        np.testing.assert_allclose(np.concatenate(g), np.concatenate(w), atol=ATOL)


def test_batched_stream_decode_with_an_idle_lane(models):
    """The stream decode alone, three blocks over two lanes, lane 0 idle in
    the second block and streaming again in the third: the port's (decoder
    K/V written in place, every other leaf frozen) against the JAX
    package's, whose frozen lanes keep every leaf."""
    jm, tm = models
    rng = np.random.RandomState(7)
    k, lanes = 2, 2
    mask = np.array([True, True])
    j_state = j_ms.init_stream_state(
        jm.params["mimi"], jm.config.mimi, batch=lanes, max_steps=8 * 16, dtype=jnp.float32, per_lane_offsets=True
    )
    t_state = t_ms.init_stream_state(tm.params["mimi"], tm.config.mimi, lanes, 8 * 16, per_lane_offsets=True)
    for n_new in ([2, 2], [0, 2], [1, 2]):
        windows = rng.randn(lanes, k, ARCH.latent_dim).astype(np.float32)
        n = np.array(n_new, np.int32)
        want, j_state = j_batching._batched_stream_decode(
            jm.params, jm.config.mimi, j_state, jnp.asarray(windows), jnp.asarray(n), jnp.asarray(mask)
        )
        got, t_state = t_batching._batched_stream_decode(
            tm, t_state, torch.from_numpy(windows), torch.from_numpy(n), torch.from_numpy(mask)
        )
        assert got.dtype == torch.int16 and tuple(got.shape) == (lanes, 1, k * 1920)
        for lane in range(lanes):
            keep = n_new[lane] * 1920
            diff = np.abs(got[lane, 0, :keep].numpy().astype(np.int32) - np.array(want)[lane, 0, :keep])
            assert diff.max(initial=0) <= 1, (n_new, lane)  # int16 truncation one ulp apart at most
        np.testing.assert_array_equal(t_state["offset"].numpy(), np.array(j_state["offset"]))


def test_close_frees_the_lane(models):
    """A consumer that closes its stream after the first block: the lane is
    freed, the future holds the audio streamed so far, and the engine
    serves the next request."""
    _, tm = models
    tb = _running(ContinuousBatcher(tm, device="cpu", **dict(COMMON, steps_per_sync=2)))
    try:
        box = []
        stream = tb.submit_stream([5, 9, 2], _cfg(max_steps=60), timeout=120, _req_out=box)
        first = next(stream)
        assert len(first) == 2 * 1920
        stream.close()
        _wait_idle(tb)
        partial = box[0].future.result(timeout=10)
        assert len(partial) >= len(first) and len(partial) < 60 * 1920
        np.testing.assert_array_equal(partial[: len(first)], first)
        assert len(tb.generate([7, 1, 4], _cfg(max_steps=3))) == 3 * 1920
    finally:
        tb.stop()


def test_engine_crash_raises_in_the_stream(models):
    _, tm = models
    tb = ContinuousBatcher(tm, device="cpu", **COMMON)

    def boom():
        raise RuntimeError("engine boom")

    tb._admit = boom
    tb.start()
    try:
        with pytest.raises(RuntimeError, match="engine boom"):
            list(tb.submit_stream([5, 9], _cfg(max_steps=2), timeout=30))
        with pytest.raises(RuntimeError, match="engine boom"):
            tb.submit_stream([5, 9], _cfg(max_steps=2), timeout=30)  # a dead engine raises at once
    finally:
        tb.stop()


def test_kernel_failure_in_the_stream_decode_raises(models, monkeypatch):
    """A launch error in the batched stream decode (here raised by the
    cascade's streaming form) reaches the stream's consumer and every other
    request of the batch as an exception, never as a short stream."""
    _, tm = models

    def broken(*args, **kwargs):
        raise RuntimeError("fused_up2_up3_tail_stream: CUDA launch failed (cudaError 700)")

    monkeypatch.setattr(t_st, "fused_up2_up3_tail_stream_plain", broken)
    tb = _running(ContinuousBatcher(tm, device="cpu", **COMMON))
    try:
        fut = tb.submit([7, 1, 4], _cfg(max_steps=12))
        with pytest.raises(RuntimeError, match="cudaError 700"):
            list(tb.submit_stream([5, 9, 2], _cfg(max_steps=12), timeout=30))
        with pytest.raises(RuntimeError, match="cudaError 700"):
            fut.result(timeout=30)
    finally:
        tb.stop()


def test_stall_raises_timeout(models):
    _, tm = models
    tb = ContinuousBatcher(tm, device="cpu", **COMMON)  # never started: nothing is produced
    with pytest.raises(TimeoutError, match="no PCM block"):
        next(tb.submit_stream([5, 9], _cfg(max_steps=2), timeout=0.2))


def test_admission_failure_reaches_the_consumer(models):
    _, tm = models
    tb = _running(ContinuousBatcher(tm, device="cpu", **COMMON))
    try:
        with pytest.raises(ValueError, match="capacity"):
            list(tb.submit_stream(list(range(3)) * 60, _cfg(), timeout=15))
        with pytest.raises(ValueError, match="out of range"):
            list(tb.submit_stream([ARCH.n_bins + 1], _cfg(), timeout=15))
        assert len(tb.generate([5, 9, 2], _cfg(max_steps=2))) == 2 * 1920
    finally:
        tb.stop()


def test_stop_strands_no_stream_consumer(models):
    _, tm = models
    tb = _running(ContinuousBatcher(tm, device="cpu", **dict(COMMON, slots=1, steps_per_sync=2)))
    running = tb.submit_stream([5, 9, 2], _cfg(max_steps=60), timeout=30)
    queued = tb.submit_stream([7, 1], _cfg(max_steps=60), timeout=30)  # waits for the slot
    next(running)
    tb.stop()
    outcomes = []
    for stream in (running, queued):
        got = 0
        try:
            for block in stream:  # never a hang: a stopped engine ends every stream
                got += len(block)
        except RuntimeError as exc:
            assert "stopped with requests in flight" in str(exc)
            outcomes.append("failed")
        else:
            assert got == 60 * 1920 - (0 if stream is queued else 2 * 1920), got  # never a short clean end
            outcomes.append("finished")
    assert "failed" in outcomes  # the queued one at least was still waiting


def test_random_mix_of_plain_streamed_and_abandoned_requests(models):
    """A race canary for the one-deep pipeline: plain, streamed and
    abandoned streams arriving at random times; every finished request has
    its exact frame count, and the engine ends idle and healthy."""
    _, tm = models
    rng = random.Random(0xC0FFEE)
    tb = _running(ContinuousBatcher(tm, device="cpu", **dict(COMMON, slots=3, steps_per_sync=3)))
    errors = []

    def plain(tokens, n, delay):
        time.sleep(delay)
        try:
            assert len(tb.generate(tokens, _cfg(max_steps=n), timeout=120)) == n * 1920
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    def streamer(tokens, n, delay, abandon):
        time.sleep(delay)
        try:
            stream = tb.submit_stream(tokens, _cfg(max_steps=n), timeout=120)
            got = 0
            for block in stream:
                got += len(block)
                if abandon:
                    stream.close()
                    return
            assert got == n * 1920, (got, n)
        except Exception as exc:  # noqa: BLE001
            errors.append(exc)

    try:
        threads = []
        for _ in range(8):
            tokens = [rng.randrange(3, 50) for _ in range(rng.randrange(1, 6))]
            args = (tokens, rng.randrange(2, 10), rng.random() * 0.5)
            kind = rng.random()
            if kind < 0.4:
                threads.append(threading.Thread(target=plain, args=args))
            else:
                threads.append(threading.Thread(target=streamer, args=args + (kind > 0.85,)))
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=180)
            assert not t.is_alive(), "a worker hung"
        assert not errors, errors
        _wait_idle(tb)
        assert tb._crashed is None
    finally:
        tb.stop()
