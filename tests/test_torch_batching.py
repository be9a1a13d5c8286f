"""The continuous batcher of the port against the JAX package's, on
``tiny_arch()`` at temperature 0: its int8-KV attention, the batched step,
and whole requests through ``ContinuousBatcher(device="cpu")`` with plain,
int8-weight and int8-KV knobs. Also the batcher's own invariants: the same
audio as the single runtime, more requests than slots, EOS, a lane that
fills its capacity, and failures that reach every future."""

import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from go_pocket_tts_tpu.models import flow_transformer as j_ftr
from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.models.quantize import quantize_kv_rows as j_quantize_kv_rows
from go_pocket_tts_tpu.ops import TOLERANCES
from go_pocket_tts_tpu.ops.attention import attention_with_positions_int8kv as j_att8
from go_pocket_tts_tpu.parallel import ContinuousBatcher as JBatcher
from go_pocket_tts_tpu.runtime import GenerateConfig as JConfig
from go_pocket_tts_tpu.utils.safetensors import encode_tensors, open_store_from_bytes
from go_pocket_tts_tpu_torch import kernels
from go_pocket_tts_tpu_torch.kernels import batched_decode_attention as t_bda
from go_pocket_tts_tpu_torch.models import flow_transformer as t_ftr
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.models.quantize import quantize_kv_rows
from go_pocket_tts_tpu_torch.ops import apply_rope_rows, build_rope_tables
from go_pocket_tts_tpu_torch.ops.attention import attention_with_positions_int8kv
from go_pocket_tts_tpu_torch.parallel import BatcherRuntime, ContinuousBatcher
from go_pocket_tts_tpu_torch.parallel import batching as t_batching
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime

ARCH = synthetic.tiny_arch()
SEED = 55
ATOL, RTOL = TOLERANCES["attention"]
# Whole-request tolerances (atol, rtol). The int8-KV budget is the JAX
# package's own for its int8-KV engine (tests/test_batching.py).
KNOBS = {
    "plain": ({}, (1e-4, 1e-3)),
    "quantize": ({"quantize": True}, (1e-4, 1e-3)),
    "kv_quantize": ({"kv_quantize": True}, (5e-3, 1e-2)),
}
REQUESTS = (([5, 9, 2], 4), ([7, 1, 4, 8, 11, 13, 2], 6))


@pytest.fixture(scope="module")
def models():
    jm = load_model_from_store(
        open_store_from_bytes(encode_tensors(j_syn.build_checkpoint(ARCH, seed=SEED))),
        num_heads=ARCH.num_heads,
    )
    tm = load_model_from_tensors(synthetic.build_checkpoint(ARCH, seed=SEED), num_heads=ARCH.num_heads, device="cpu")
    return jm, tm


def _cfg(**kw):
    return GenerateConfig(**{"temperature": 0.0, "eos_threshold": 1e9, "max_steps": 4, **kw})


def _serve(batcher, requests, timeout=120):
    batcher.start()
    try:
        futs = [batcher.submit(tokens, cfg) for tokens, cfg in requests]
        return [f.result(timeout=timeout) for f in futs]
    finally:
        batcher.stop()


def _np(x) -> np.ndarray:
    return np.array(x, np.float32)


# -- ops and the batched step -------------------------------------------------


@pytest.mark.parametrize("context", [None, 5])
def test_attention_int8kv_matches_reference(context):
    b, h, c, d = 3, 2, 12, 16
    rng = np.random.RandomState(4)
    q = rng.randn(b, h, 1, d).astype(np.float32)
    kq, ks = j_quantize_kv_rows(jnp.asarray(rng.randn(b, h, c, d).astype(np.float32)))
    vq, vs = j_quantize_kv_rows(jnp.asarray(rng.randn(b, h, c, d).astype(np.float32)))
    pos_q = np.array([[0], [6], [11]], np.int32)
    pos_k = np.broadcast_to(np.arange(c, dtype=np.int32), (b, c)).copy()
    want = j_att8(jnp.asarray(q), kq, ks, vq, vs, jnp.asarray(pos_q), jnp.asarray(pos_k), context)
    got = attention_with_positions_int8kv(
        torch.from_numpy(q), *(torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs)),
        torch.from_numpy(pos_q), torch.from_numpy(pos_k), context,
    )
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=RTOL)


def test_row_scatter_matches_reference_indexing():
    """``buf[i, lanes, :, offsets, :]`` (integer, array, slice, array,
    slice) puts the lane dimension first on both sides; a write past the
    capacity is dropped."""
    n_layers, b, h, c, d, i = 2, 3, 2, 4, 5, 1
    rng = np.random.RandomState(0)
    buf = rng.randn(n_layers, b, h, c, d).astype(np.float32)
    vals = rng.randn(b, h, d).astype(np.float32)
    offsets = np.array([0, 3, 4], np.int32)  # the last lane is at the capacity
    want = jnp.asarray(buf).at[i, jnp.arange(b), :, jnp.asarray(offsets), :].set(jnp.asarray(vals))
    got = torch.from_numpy(buf.copy())
    pos = torch.from_numpy(offsets).long()
    t_bda.write_rows(got[i], torch.arange(b), pos.clamp(max=c - 1), pos < c, torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
def test_fused_step_plain_is_the_op_sequence(int8, dtype):
    """On the CPU the fused step runs its plain version: the batched step's
    former op sequence (RoPE of q and k, row quantization, the four row
    scatters, then the attention's plain version), to the byte, with q, k
    and v as views into one QKV projection; no kernel launch is counted."""
    n_layers, b, h, c, d, layer = 2, 5, 2, 24, 64, 1
    rng = np.random.RandomState(7 + int8)
    qkv = torch.from_numpy(rng.randn(b, 1, 3 * h * d).astype(np.float32)).to(dtype)
    q, k, v = qkv.reshape(b, 1, 3, h, d).permute(2, 0, 3, 1, 4)
    k_all, v_all = (torch.from_numpy((rng.randn(n_layers, b, h, c, d) * 0.5).astype(np.float32)).to(dtype) for _ in range(2))
    bufs = [*quantize_kv_rows(k_all), *quantize_kv_rows(v_all)] if int8 else [k_all, v_all]
    offsets = torch.tensor([0, 9, c - 1, c, c + 3], dtype=torch.int32)  # the last two are past the capacity
    cos, sin = build_rope_tables(64, d)
    mine, ref = [x.clone() for x in bufs], [x.clone() for x in bufs]

    pos = offsets.long()
    idx = pos.clamp(0, cos.shape[0] - 1)
    cos_rows, sin_rows = cos.index_select(0, idx)[:, None, None, :], sin.index_select(0, idx)[:, None, None, :]
    lanes, rows, keep = torch.arange(b), pos.clamp(0, c - 1), pos < c
    q_r, k_r = apply_rope_rows(q.contiguous(), cos_rows, sin_rows), apply_rope_rows(k.contiguous(), cos_rows, sin_rows)
    if int8:
        kc, ks, vc, vs = ref
        (kq, kss), (vq, vss) = quantize_kv_rows(k_r[:, :, 0, :]), quantize_kv_rows(v.contiguous()[:, :, 0, :])
        for buf, val in ((kc[layer], kq), (vc[layer], vq), (ks[layer], kss), (vs[layer], vss)):
            t_bda.write_rows(buf, lanes, rows, keep, val)
        want = t_bda.batched_decode_attention_int8_plain(q_r, kc, ks, vc, vs, offsets, layer)
        kernels.reset_launches()
        got = t_bda.batched_decode_attention_step(q, k, v, mine[0], mine[2], offsets, cos, sin, layer, mine[1], mine[3])
    else:
        kc, vc = ref
        t_bda.write_rows(kc[layer], lanes, rows, keep, k_r[:, :, 0, :])
        t_bda.write_rows(vc[layer], lanes, rows, keep, v.contiguous()[:, :, 0, :])
        want = t_bda.batched_decode_attention_plain(q_r, kc, vc, offsets, layer)
        kernels.reset_launches()
        got = t_bda.batched_decode_attention_step(q, k, v, mine[0], mine[1], offsets, cos, sin, layer)
    assert [fn.launches for fn in kernels.WRAPPERS] == [0] * len(kernels.WRAPPERS)
    assert got.dtype == dtype and torch.equal(got, want)
    for x, y in zip(mine, ref):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert not torch.equal(mine[0], bufs[0])  # the in-range lanes wrote their rows


@pytest.mark.parametrize("int8", [False, True])
def test_transformer_step_batched_matches_reference(models, int8):
    jm, tm = models
    tcfg_j, tcfg_t = jm.config.flow_lm.transformer, tm.config.flow_lm.transformer
    b, c = 4, 24
    rng = np.random.RandomState(int8)
    shape = (tcfg_t.num_layers, b, tcfg_t.num_heads, c, tcfg_t.head_dim)
    k, v = ((rng.randn(*shape) * 0.5).astype(np.float32) for _ in range(2))
    x = rng.randn(b, 1, tcfg_t.d_model).astype(np.float32)
    offsets = np.array([0, 9, c - 1, c], np.int32)  # the last lane has filled its capacity
    if int8:
        (kq, ks), (vq, vs) = j_quantize_kv_rows(jnp.asarray(k)), j_quantize_kv_rows(jnp.asarray(v))
        jcache = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs, "offset": jnp.asarray(offsets)}
    else:
        jcache = {"k": jnp.asarray(k), "v": jnp.asarray(v), "offset": jnp.asarray(offsets)}
    tcache = {name: torch.from_numpy(np.array(a)) for name, a in jcache.items()}
    want_y, want_cache = j_ftr.transformer_step_batched(
        jm.params["flow_lm"]["transformer"], tcfg_j, jcache, jnp.asarray(x)
    )
    got_y, got_cache = t_ftr.transformer_step_batched(
        tm.params["flow_lm"]["transformer"], tcfg_t, tcache, torch.from_numpy(x)
    )
    assert got_cache["k"] is tcache["k"]  # written in place
    np.testing.assert_allclose(got_y.numpy(), _np(want_y), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(got_cache["offset"].numpy(), offsets + 1)
    for name in jcache:
        if name == "offset":
            continue
        got, want = got_cache[name].numpy(), np.array(want_cache[name])
        if got.dtype == np.int8:  # a row quantized from a 1-ulp-different k may round one step apart
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1, name
        else:
            np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL, err_msg=name)


# -- whole requests ------------------------------------------------------------


@pytest.mark.parametrize("knob", list(KNOBS))
def test_batcher_matches_reference_batcher(models, knob):
    jm, tm = models
    kw, (atol, rtol) = KNOBS[knob]
    common = dict(slots=2, prompt_capacity=64, max_frames=64, seed=3, **kw)
    want = _serve(JBatcher(jm, **common), [(t, JConfig(temperature=0.0, eos_threshold=1e9, max_steps=n)) for t, n in REQUESTS])
    got = _serve(ContinuousBatcher(tm, device="cpu", **common), [(t, _cfg(max_steps=n)) for t, n in REQUESTS])
    for (tokens, n), g, w in zip(REQUESTS, got, want):
        assert g.dtype == np.float32 and len(g) == len(w) == n * 1920
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)


def test_batcher_matches_single_runtime(models):
    """A request served next to another one, admitted later, gives the
    single runtime's audio."""
    _, tm = models
    single = GPURuntime(tm, seed=3, frame_bucket=64, device="cpu")
    want_a = single.generate_audio([5, 9, 2], _cfg(max_steps=12))
    want_b = single.generate_audio([8, 3], _cfg(max_steps=5))
    batcher = ContinuousBatcher(tm, slots=2, prompt_capacity=64, max_frames=64, seed=3, steps_per_sync=2, device="cpu")
    batcher.start()
    try:
        fut_a = batcher.submit([5, 9, 2], _cfg(max_steps=12))
        time.sleep(0.2)  # A runs a few blocks alone
        got_b = batcher.generate([8, 3], _cfg(max_steps=5), timeout=120)
        got_a = fut_a.result(timeout=120)
    finally:
        batcher.stop()
    np.testing.assert_allclose(got_a, want_a, atol=1e-4, rtol=1e-3)
    np.testing.assert_allclose(got_b, want_b, atol=1e-4, rtol=1e-3)


def test_more_requests_than_slots(models):
    _, tm = models
    batcher = ContinuousBatcher(tm, slots=2, prompt_capacity=64, max_frames=64, seed=3, device="cpu")
    outs = _serve(batcher, [([3 + i, 4], _cfg(max_steps=3)) for i in range(5)])
    assert all(o.shape == (3 * 1920,) and np.isfinite(o).all() for o in outs)
    # The first request again, alone: prefilled in a batch of its own.
    np.testing.assert_allclose(outs[0], _serve(
        ContinuousBatcher(tm, slots=2, prompt_capacity=64, max_frames=64, seed=3, device="cpu"),
        [([3, 4], _cfg(max_steps=3))],
    )[0], atol=1e-4, rtol=1e-3)


def test_eos_early_exit(models):
    """eos_threshold -1e9: EOS on the first frame, then frames_after_eos
    more."""
    _, tm = models
    batcher = ContinuousBatcher(tm, slots=2, prompt_capacity=64, max_frames=64, seed=3, device="cpu")
    (out,) = _serve(batcher, [([5, 6], _cfg(eos_threshold=-1e9, max_steps=20, frames_after_eos=3))])
    assert len(out) == 4 * 1920


@pytest.mark.parametrize("kv_quantize", [False, True])
def test_lane_that_fills_its_capacity(models, kv_quantize):
    """A 16-token prompt at prompt_capacity 16 with max_frames steps ends at
    offset == capacity; the block after it steps the frozen lane there (its
    write is dropped), and the audio is the reference batcher's."""
    jm, tm = models
    tokens = [(3 * i) % 60 for i in range(16)]
    common = dict(slots=2, prompt_capacity=16, max_frames=16, seed=3, steps_per_sync=8, kv_quantize=kv_quantize)
    batcher = ContinuousBatcher(tm, device="cpu", **common)
    assert batcher.capacity == 32
    (got,) = _serve(batcher, [(tokens, _cfg(max_steps=16))])
    assert int(batcher._state["cache"]["offset"][0]) == 32
    (want,) = _serve(JBatcher(jm, **common), [(tokens, JConfig(temperature=0.0, eos_threshold=1e9, max_steps=16))])
    atol, rtol = KNOBS["kv_quantize" if kv_quantize else "plain"][1]
    assert len(got) == 16 * 1920
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_burst_blocks_round_up(models):
    _, tm = models
    batcher = ContinuousBatcher(
        tm, slots=2, prompt_capacity=64, max_frames=32, seed=3, steps_per_sync=4, steps_per_sync_burst=13, device="cpu"
    )
    assert batcher.steps_per_sync_burst == 16 and batcher.max_frames == 32
    assert batcher._state["frames"].shape[1] == 32 + 16
    (out,) = _serve(batcher, [([5, 9, 2], _cfg(max_steps=24))])
    assert len(out) == 24 * 1920 and batcher._last_block_k == 16
    plain = ContinuousBatcher(tm, slots=2, steps_per_sync=8, steps_per_sync_burst=8, device="cpu")
    assert plain.steps_per_sync_burst == 0


def test_bad_requests_fail_alone(models):
    _, tm = models
    batcher = ContinuousBatcher(tm, slots=2, prompt_capacity=16, max_frames=16, seed=3, device="cpu")
    batcher.start()
    try:
        bad_id = batcher.submit([ARCH.n_bins + 1], _cfg())
        too_long = batcher.submit(list(range(40)), _cfg())
        good = batcher.submit([5, 9], _cfg(max_steps=2))
        with pytest.raises(ValueError, match="out of range"):
            bad_id.result(timeout=60)
        with pytest.raises(ValueError, match="capacity"):
            too_long.result(timeout=60)
        assert len(good.result(timeout=60)) == 2 * 1920
    finally:
        batcher.stop()
    assert batcher._crashed is None


def test_engine_crash_fails_futures(models):
    _, tm = models
    batcher = ContinuousBatcher(tm, slots=2, prompt_capacity=64, max_frames=64, seed=3, device="cpu")

    def boom():
        raise RuntimeError("engine boom")

    batcher._admit = boom  # crash on the first iteration
    batcher.start()
    fut = batcher.submit([5, 9], _cfg(max_steps=2))
    with pytest.raises(RuntimeError, match="engine boom"):
        fut.result(timeout=30)
    batcher.stop()
    late = batcher.submit([5], _cfg())
    with pytest.raises(RuntimeError, match="engine boom"):
        late.result(timeout=1)


def test_kernel_failure_mid_block_fails_futures(models, monkeypatch):
    """A launch error inside an AR block (here raised by the attention
    wrapper) crashes the engine and reaches every attached and queued
    request."""
    _, tm = models

    def broken(*args, **kwargs):
        raise RuntimeError("batched_decode_attention_step: CUDA launch failed (cudaError 700)")

    monkeypatch.setattr(t_ftr.bda, "batched_decode_attention_step", broken)
    batcher = ContinuousBatcher(tm, slots=1, prompt_capacity=64, max_frames=64, seed=3, device="cpu")
    batcher.start()
    futs = [batcher.submit([5, 9], _cfg(max_steps=2)) for _ in range(3)]
    for fut in futs:
        with pytest.raises(RuntimeError, match="cudaError 700"):
            fut.result(timeout=30)
    batcher.stop()


def test_drain_failure_fails_futures(models):
    """A failed PCM copy fails every future of its wave; a future already
    failed elsewhere is left as it is."""
    _, tm = models
    batcher = ContinuousBatcher(tm, slots=2, prompt_capacity=64, max_frames=64, seed=3, device="cpu")

    class _Poison:
        def numpy(self):
            raise RuntimeError("device copy failed")

    f1, f2 = Future(), Future()
    f2.set_exception(RuntimeError("already failed"))
    items = [(t_batching._Request([1], _cfg(), f1), 2), (t_batching._Request([1], _cfg(), f2), 2)]
    batcher._drain_harvest(_Poison(), items)
    with pytest.raises(RuntimeError, match="device copy failed"):
        f1.result(timeout=1)
    with pytest.raises(RuntimeError, match="already failed"):
        f2.result(timeout=1)


def test_batcher_runtime_interface(models):
    _, tm = models
    rt = BatcherRuntime(tm, slots=2, seed=3, quantize=True, kv_quantize=True, device="cpu")
    try:
        assert rt.concurrent_safe
        assert rt.mimi_timing() == GPURuntime(tm, device="cpu").mimi_timing()
        audio = rt.generate_audio([5, 9, 2], _cfg(max_steps=3))
    finally:
        rt.close()
    assert audio.shape == (3 * 1920,) and np.isfinite(audio).all()
    state = rt.batcher._state
    assert state["cache"]["k"].dtype == torch.int8 and state["cache"]["k_scale"].dtype == torch.float32
