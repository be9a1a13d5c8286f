"""The whole slice: ``GPURuntime(device="cpu").generate_audio`` against
``TPURuntime.generate_audio`` on ``tiny_arch()``, at temperature 0, in
float32 and bfloat16, with and without an EOS trim."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.runtime import GenerateConfig as JConfig
from go_pocket_tts_tpu.runtime import TPURuntime
from go_pocket_tts_tpu.text import estimate_max_frames as j_estimate
from go_pocket_tts_tpu_torch.tts.parity import rms_delta
from go_pocket_tts_tpu.utils import buckets as j_bk
from go_pocket_tts_tpu.utils.safetensors import encode_tensors, open_store_from_bytes
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime
from go_pocket_tts_tpu_torch.runtime.generate import estimate_max_frames
from go_pocket_tts_tpu_torch.utils import buckets as t_bk

ARCH = synthetic.tiny_arch()
SEED = 9
TOKENS = [3, 17, 41, 9, 22]
RMS_BUDGET = 1e-3  # the waveform parity budget (BASELINE.md)


@pytest.fixture(scope="module")
def models():
    jm = load_model_from_store(
        open_store_from_bytes(encode_tensors(j_syn.build_checkpoint(ARCH, seed=SEED))),
        num_heads=ARCH.num_heads,
    )
    tm = load_model_from_tensors(
        synthetic.build_checkpoint(ARCH, seed=SEED), num_heads=ARCH.num_heads, device="cpu"
    )
    return jm, tm


# Frames per case. In bfloat16 the two frameworks round at different places
# (XLA keeps excess precision inside its fusions), and on random weights the
# AR loop amplifies that ~1.3x per frame: 3e-4 RMS on frame 0, 1e-3 by frame
# 8, 1e-2 by frame 18 for this checkpoint. So the bfloat16 case holds the
# budget over 8 frames; float32 stays near 1e-6 over all 20.
MAX_STEPS = {"float32": 20, "bfloat16": 8}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("eos_threshold", [1e9, -1.0])  # fixed length / EOS trim
def test_generate_audio_matches_tpu_runtime(models, dtype, eos_threshold):
    jm, tm = models
    steps = MAX_STEPS[dtype]
    kw = dict(temperature=0.0, eos_threshold=eos_threshold, max_steps=steps)
    want = TPURuntime(jm, dtype=getattr(jnp, dtype), seed=1, frame_bucket=64).generate_audio(
        TOKENS, JConfig(**kw)
    )
    rt = GPURuntime(tm, dtype=getattr(torch, dtype), seed=1, frame_bucket=64, device="cpu")
    got = rt.generate_audio(TOKENS, GenerateConfig(**kw))
    assert got.dtype == np.float32
    assert len(got) == len(want) > 0  # same n_frames, EOS countdown included
    if eos_threshold > 0:
        assert len(got) == steps * 1920
    else:
        assert len(got) < steps * 1920
    assert rms_delta(got, want) < RMS_BUDGET


def test_sync_interval_does_not_change_the_audio(models):
    _, tm = models
    cfg = GenerateConfig(temperature=0.7, eos_threshold=-1.0, max_steps=20)
    outs = []
    for every in (1, 16):
        rt = GPURuntime(tm, seed=3, frame_bucket=64, device="cpu")
        rt.SYNC_EVERY = every
        outs.append(rt.generate_audio(TOKENS, cfg))
    np.testing.assert_array_equal(outs[0], outs[1])


def test_seeded_sampling_is_reproducible(models):
    _, tm = models
    cfg = GenerateConfig(temperature=0.7, eos_threshold=1e9, max_steps=6)
    a = GPURuntime(tm, seed=5, frame_bucket=64, device="cpu").generate_audio(TOKENS, cfg)
    b = GPURuntime(tm, seed=5, frame_bucket=64, device="cpu").generate_audio(TOKENS, cfg)
    c = GPURuntime(tm, seed=6, frame_bucket=64, device="cpu").generate_audio(TOKENS, cfg)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_int16_truncation_and_range(models):
    _, tm = models
    rt = GPURuntime(tm, seed=1, frame_bucket=64, device="cpu")
    pcm = rt._decode_pcm16(
        torch.randn(1, 32, ARCH.latent_dim) * 3, torch.tensor([32], dtype=torch.int32), 32
    )
    assert pcm.dtype == torch.int16 and pcm.shape == (1, 1, 32 * 1920)
    x = torch.tensor([0.99999, -0.99999, 2.0, -2.0, 1e-5])
    assert (x.clamp(-1, 1) * 32767.0).to(torch.int16).tolist() == [32766, -32766, 32767, -32767, 0]


def test_step_callback_and_timing(models):
    jm, tm = models
    seen = []
    cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=4, step_callback=lambda n, m: seen.append((n, m)))
    rt = GPURuntime(tm, seed=1, frame_bucket=64, device="cpu")
    audio = rt.generate_audio(TOKENS, cfg)
    assert seen == [(4, 4)] and len(audio) == 4 * 1920
    assert rt.mimi_timing() == TPURuntime(jm, seed=1).mimi_timing()


@pytest.mark.parametrize("tokens", [[], [ARCH.n_bins + 1], [-1]])
def test_bad_tokens_raise(models, tokens):
    rt = GPURuntime(models[1], seed=1, device="cpu")
    with pytest.raises(ValueError):
        rt.generate_audio(tokens, GenerateConfig())


def test_unsupported_dtype_raises(models):
    with pytest.raises(ValueError):
        GPURuntime(models[1], dtype=torch.float16, device="cpu")


@pytest.mark.parametrize("n", [0, 1, 5, 50, 200])
def test_frame_budget_and_buckets_match_reference(n):
    assert estimate_max_frames(n) == j_estimate(n)
    for buckets in ("PROMPT_BUCKETS", "FRAME_BUCKETS", "DECODE_BUCKETS"):
        assert getattr(t_bk, buckets) == getattr(j_bk, buckets)
        assert t_bk.pick_bucket(n, getattr(t_bk, buckets)) == j_bk.pick_bucket(n, getattr(j_bk, buckets))
    assert t_bk.round_up(n, 64) == j_bk.round_up(n, 64)
