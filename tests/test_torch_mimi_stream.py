"""The port's stateful block decoder (``models/mimi_stream.py``) against
the JAX package's, on the CPU: block by block, against the whole-sequence
decode, with per-lane offsets, frozen and reset lanes. Counterparts of
tests/test_streaming.py's decoder tests; under a SEANet widened to the
kernels' channels the last stages run the cascade's streaming form."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from go_pocket_tts_tpu.models import mimi_stream as j_ms
from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.ops import TOLERANCES
from go_pocket_tts_tpu.utils.safetensors import encode_tensors, open_store_from_bytes
from go_pocket_tts_tpu_torch.kernels import seanet_tail as t_st
from go_pocket_tts_tpu_torch.models import mimi_stream as t_ms
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors

ARCH = synthetic.tiny_arch()
WIDE = dataclasses.replace(ARCH, seanet_channels=(32, 256, 128, 64))  # up2 → up3 at the kernels' widths
CONV_ATOL, CONV_RTOL = TOLERANCES["conv1d"]


def _models(arch, seed=66):
    jm = load_model_from_store(
        open_store_from_bytes(encode_tensors(j_syn.build_checkpoint(arch, seed=seed))), num_heads=arch.num_heads
    )
    tm = load_model_from_tensors(synthetic.build_checkpoint(arch, seed=seed), num_heads=arch.num_heads, device="cpu")
    return jm, tm


@pytest.fixture(scope="module")
def models():
    return _models(ARCH)


# -- the block decoder --------------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, WIDE], ids=["tiny", "wide"])
def test_block_decoder_matches_reference_and_whole(arch, monkeypatch):
    """Blocks of 1, 3 and 4 frames: each equals the JAX block decoder's,
    and together they equal the whole-sequence decode. Under the widened
    SEANet the last stages run the cascade's streaming form."""
    jm, tm = _models(arch, seed=3)
    latent = np.random.RandomState(1).randn(1, arch.mimi_dim, 8).astype(np.float32) * 0.1
    whole = tm.mimi_decode(torch.from_numpy(latent))
    calls = []
    real = t_st.fused_up2_up3_tail_stream
    monkeypatch.setattr(t_st, "fused_up2_up3_tail_stream", lambda *a: calls.append(a[0].shape) or real(*a))
    params, cfg = tm.params["mimi"], tm.config.mimi
    state = t_ms.init_stream_state(params, cfg, 1, 8 * cfg.steps_per_latent)
    jstate = j_ms.init_stream_state(jm.params["mimi"], jm.config.mimi, 1, 8 * cfg.steps_per_latent)
    outs, pos = [], 0
    for n in (1, 3, 4):
        pcm, state = t_ms.decode_block(params, cfg, state, torch.from_numpy(latent[:, :, pos : pos + n]))
        jpcm, jstate = j_ms.decode_block(jm.params["mimi"], jm.config.mimi, jstate, jnp.asarray(latent[:, :, pos : pos + n]))
        assert pcm.shape == (1, 1, 1920 * n)
        np.testing.assert_allclose(pcm.numpy(), np.asarray(jpcm), atol=CONV_ATOL, rtol=CONV_RTOL)
        outs.append(pcm)
        pos += n
    np.testing.assert_allclose(torch.cat(outs, dim=2).numpy(), whole.numpy(), atol=CONV_ATOL, rtol=CONV_RTOL)
    assert int(state["offset"]) == int(jstate["offset"]) == 8 * 16
    # The CUDA kernel's gate takes the widened SEANet only (on the CPU its
    # wrapper runs the plain version); tiny_arch runs the plain form directly.
    assert calls == ([torch.Size([1, 256, 96 * n]) for n in (1, 3, 4)] if arch is WIDE else [])


def test_stream_state_layout(models):
    """The reference's leaves up to res1_c2, then one up2_in leaf in place of
    its seven per-stage tails."""
    jm, tm = models
    state = t_ms.init_stream_state(tm.params["mimi"], tm.config.mimi, 2, 64, per_lane_offsets=True)
    jstate = j_ms.init_stream_state(jm.params["mimi"], jm.config.mimi, 2, 64, per_lane_offsets=True)
    kept = list(jstate)[: list(jstate).index("res1_c2") + 1]
    assert list(state) == kept + ["up2_in"]
    for key in kept:
        assert tuple(state[key].shape) == tuple(jstate[key].shape), key
    assert tuple(state["up2_in"].shape) == (2, ARCH.seanet_channels[1], t_st.HALO)


def test_reset_lanes_matches_reset_lane(models):
    _, tm = models
    rng = np.random.RandomState(9)
    params, cfg = tm.params["mimi"], tm.config.mimi
    state = t_ms.init_stream_state(params, cfg, 4, 8 * cfg.steps_per_latent, per_lane_offsets=True)
    state = {k: v + torch.from_numpy(rng.randn(*v.shape) * 3).to(v.dtype) for k, v in state.items()}
    eager = t_ms.reset_lane(t_ms.reset_lane(state, 1), 3)
    batched = t_ms.reset_lanes({k: v.clone() for k, v in state.items()}, torch.tensor([1, 3, 1]))
    for key in state:
        torch.testing.assert_close(eager[key], batched[key], rtol=0, atol=0, msg=key)
        lanes = eager[key].movedim(1 if key.startswith("kv_") else 0, 0)
        assert not lanes[[1, 3]].any() and (lanes[[0, 2]] == state[key].movedim(1 if key.startswith("kv_") else 0, 0)[[0, 2]]).all()


@pytest.mark.parametrize("arch", [ARCH, WIDE], ids=["tiny", "wide"])
def test_batched_per_lane_stream_decode(arch):
    """Per-lane offsets: lanes that join late (reset_lanes) and pause
    (freeze_lanes) reproduce each lane's whole decode."""
    jm, tm = _models(arch, seed=5)
    rng = np.random.RandomState(5)
    params, cfg = tm.params["mimi"], tm.config.mimi
    t_total, block, lanes = 6, 2, 3
    latents = [rng.randn(1, arch.mimi_dim, t_total).astype(np.float32) * 0.1 for _ in range(lanes)]
    whole = [np.asarray(jm.mimi_decode(jnp.asarray(lat))) for lat in latents]
    state = t_ms.init_stream_state(params, cfg, lanes, t_total * cfg.steps_per_latent, per_lane_offsets=True)
    assert state["offset"].shape == (lanes,)
    state = {k: v + 1.0 if v.is_floating_point() else v for k, v in state.items()}  # pollute, then reset
    state = t_ms.reset_lanes(state, torch.tensor([0, 1, 2, 2]))
    outs = [[] for _ in range(lanes)]
    progress = [0, 0, 0]
    for live_flags in [(True, True, True), (True, False, True), (True, True, True), (False, True, False)]:
        batch = np.zeros((lanes, arch.mimi_dim, block), np.float32)
        for lane in range(lanes):
            if live_flags[lane] and progress[lane] < t_total:
                batch[lane] = latents[lane][0, :, progress[lane] : progress[lane] + block]
        pcm, new_state = t_ms.decode_block(params, cfg, state, torch.from_numpy(batch))
        state = t_ms.freeze_lanes(new_state, state, torch.tensor(live_flags))
        for lane in range(lanes):
            if live_flags[lane] and progress[lane] < t_total:
                outs[lane].append(pcm[lane : lane + 1].numpy())
                progress[lane] += block
    for lane in range(lanes):
        np.testing.assert_allclose(np.concatenate(outs[lane], axis=2), whole[lane], atol=CONV_ATOL, rtol=CONV_RTOL)


def test_per_lane_rows_past_the_capacity_are_dropped():
    """A lane's K/V rows at slots past the capacity are dropped, as the
    reference's scatter drops them: a lane below the end, one that straddles
    it (a row lands on the last slot) and one wholly past it."""
    rng = np.random.RandomState(2)
    buf = torch.from_numpy(rng.randn(3, 2, 8, 4).astype(np.float32))  # [B, H, S, Dh]
    rows = torch.from_numpy(rng.randn(3, 3, 2, 4).astype(np.float32))  # [B, T, H, Dh]
    slots = torch.tensor([[1, 2, 3], [6, 7, 8], [9, 10, 11]])
    want = buf.clone()
    for lane in range(3):
        for t in range(3):
            if slots[lane, t] < 8:
                want[lane, :, slots[lane, t]] = rows[lane, t]
    t_ms._write_rows(buf, torch.arange(3)[:, None], slots, rows)
    torch.testing.assert_close(buf, want, rtol=0, atol=0)
