"""The port's CUDA kernels against their plain versions, on a card.

A CUDA kernel has no interpret mode, so these tests need a GPU and ``nvcc``;
elsewhere they skip. On a card host::

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from go_pocket_tts_tpu_torch import kernels
from go_pocket_tts_tpu_torch.kernels import decode_attention as da
from go_pocket_tts_tpu_torch.kernels import seanet_tail as st
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.ops import build_rope_tables, repack_conv_transpose_kernel
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    tol = 2e-4 if dtype == torch.float32 else 1e-2  # bf16: one final rounding apart
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0, 77, 319])
def test_decode_attention_kernel(card, dtype, offset):
    gen = torch.Generator(device=card).manual_seed(offset)
    shape = (1, 16, 1, 64)
    q, k_new, v_new = (torch.randn(shape, generator=gen, device=card).to(dtype) for _ in range(3))
    kc = (torch.randn((6, 1, 16, 320, 64), generator=gen, device=card) * 0.3).to(dtype)
    vc = (torch.randn((6, 1, 16, 320, 64), generator=gen, device=card) * 0.3).to(dtype)
    cos, sin = (t.to(card) for t in build_rope_tables(8192, 64))
    off = torch.tensor(offset, dtype=torch.int32, device=card)
    kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
    before = da.decode_attention_step.launches
    got, _, _ = da.decode_attention_step(q, k_new, kk, vk, v_new, off, cos, sin, 2)
    want, _, _ = da.decode_attention_step_plain(q, k_new, kp, vp, v_new, off, cos, sin, 2)
    torch.cuda.synchronize()
    assert da.decode_attention_step.launches == before + 1
    _close(got, want, dtype)
    _close(kk, kp, dtype)
    _close(vk, vp, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seanet_kernels(card, dtype):
    gen = torch.Generator(device=card).manual_seed(0)

    def rnd(*shape, scale=0.1):
        return (torch.randn(shape, generator=gen, device=card) * scale).to(dtype)

    tail = [rnd(32, 64, 3), rnd(32), rnd(64, 32, 1), rnd(64), rnd(1, 64, 7), rnd(1)]
    wu = repack_conv_transpose_kernel(torch.randn((128, 64, 8), generator=gen, device=card) * 0.1).to(dtype)
    x_up = rnd(2, 128, 1024, scale=0.5)
    bu = rnd(64)
    _close(st.fused_seanet_up_tail(x_up, wu, bu, *tail), st.fused_seanet_up_tail_plain(x_up, wu, bu, *tail), dtype)
    x = rnd(2, 64, 3840, scale=0.5)
    _close(st.fused_seanet_tail(x, *tail), st.fused_seanet_tail_plain(x, *tail), dtype)


def test_wrappers_raise_on_what_the_kernels_do_not_take(card):
    x = torch.zeros((1, 64, 100), device=card)  # T not a multiple of 128
    tail = [torch.zeros(s, device=card) for s in ((32, 64, 3), (32,), (64, 32, 1), (64,), (1, 64, 7), (1,))]
    with pytest.raises(ValueError):
        st.fused_seanet_tail(x, *tail)
    with pytest.raises(TypeError):
        st.fused_seanet_tail(torch.zeros((1, 64, 128), device=card, dtype=torch.float16), *tail)


def test_tiny_synthesis_kernels_match_plain(card, monkeypatch):
    # The kernel takes head width 64 (the published model's); tiny_arch has 16.
    arch = dataclasses.replace(synthetic.tiny_arch(), d_model=128, num_heads=2)
    model = load_model_from_tensors(synthetic.build_checkpoint(arch, seed=2), num_heads=arch.num_heads, device=card)
    cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=8)
    kernels.reset_launches()
    a = GPURuntime(model, seed=1, frame_bucket=64, device=card).generate_audio([3, 17, 41], cfg)
    assert da.decode_attention_step.launches == 8 * arch.num_layers
    monkeypatch.setattr(da, "decode_attention_step", da.decode_attention_step_plain)
    b = GPURuntime(model, seed=1, frame_bucket=64, device=card).generate_audio([3, 17, 41], cfg)
    assert np.sqrt(np.mean((a - b) ** 2)) < 1e-5
