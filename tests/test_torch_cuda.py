"""The port's CUDA kernels against their plain versions, on a card.

A CUDA kernel has no interpret mode, so these tests need a GPU and ``nvcc``;
elsewhere they skip. On a card host::

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q

(``--noconftest``: the suite's conftest imports JAX, which a card host
need not have.)
"""

import dataclasses
import tempfile

import numpy as np
import pytest
import torch

from go_pocket_tts_tpu_torch import kernels
from go_pocket_tts_tpu_torch.kernels import batched_decode_attention as bda
from go_pocket_tts_tpu_torch.kernels import decode_attention as da
from go_pocket_tts_tpu_torch.kernels import int4_matmul as i4mm
from go_pocket_tts_tpu_torch.kernels import quantized_matmul as qmm
from go_pocket_tts_tpu_torch.kernels import seanet_tail as st
from go_pocket_tts_tpu_torch.kernels.split_kv import boundary_offsets
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.models.quantize import quantize_kv_rows, quantize_linear
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


# 37 and 40 are not multiples of 16 (a masked tail); 37 is not one of 4
# either, so the int8 row scales take the block's own loads, not bulk copies.
CAPACITIES = (320, 384, 1024, 8192, 40, 37)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap", CAPACITIES)
def test_decode_attention_kernel_at_split_boundaries(card, dtype, cap):
    gen = torch.Generator(device=card).manual_seed(cap)
    n_layers, b, h, d, layer = 2, 1, 16, 64, 1
    cos, sin = (t.to(card) for t in build_rope_tables(8192, d))
    kc, vc = ((torch.randn((n_layers, b, h, cap, d), generator=gen, device=card) * 0.3).to(dtype) for _ in range(2))
    for off in boundary_offsets(cap, b * h):
        q, k_new, v_new = (torch.randn((b, h, 1, d), generator=gen, device=card).to(dtype) for _ in range(3))
        offset = torch.tensor(off, dtype=torch.int32, device=card)
        kk, vk, kp, vp = kc.clone(), vc.clone(), kc.clone(), vc.clone()
        got, _, _ = da.decode_attention_step(q, k_new, kk, vk, v_new, offset, cos, sin, layer)
        want, _, _ = da.decode_attention_step_plain(q, k_new, kp, vp, v_new, offset, cos, sin, layer)
        torch.cuda.synchronize()
        _close(got, want, dtype)
        assert torch.equal(kk, kp) and torch.equal(vk, vp), off  # the appended row, bit for bit


def _lane_offsets(cap: int, pairs: int, b: int, card) -> list:
    """The boundary offsets dealt over ``b`` lanes, lane 0 of every set at
    its last slot."""
    offs = boundary_offsets(cap, pairs)
    sets = []
    for i in range(0, len(offs), b - 1):
        chunk = [cap - 1] + offs[i : i + b - 1]
        sets.append(torch.tensor(chunk + [0] * (b - len(chunk)), dtype=torch.int32, device=card))
    return sets


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("cap", CAPACITIES)
def test_batched_decode_attention_kernels_at_split_boundaries(card, dtype, int8, cap):
    gen = torch.Generator(device=card).manual_seed(cap + int8)
    n_layers, b, h, d, layer = 2, 8, 16, 64, 1
    q = torch.randn((b, h, 1, d), generator=gen, device=card).to(dtype)
    k, v = ((torch.randn((n_layers, b, h, cap, d), generator=gen, device=card) * 0.3).to(dtype) for _ in range(2))
    (kq, ks), (vq, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
    for offsets in _lane_offsets(cap, b * h, b, card):
        if int8:
            got = bda.batched_decode_attention_int8(q, kq, ks, vq, vs, offsets, layer)
            want = bda.batched_decode_attention_int8_plain(q, kq, ks, vq, vs, offsets, layer)
        else:
            got = bda.batched_decode_attention(q, k, v, offsets, layer)
            want = bda.batched_decode_attention_plain(q, k, v, offsets, layer)
        torch.cuda.synchronize()
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("cap", CAPACITIES)
def test_batched_decode_attention_step_kernel(card, dtype, int8, cap):
    """The fused step against its plain version (RoPE, quantize_kv_rows and
    the row scatter as separate ops): the same output within the kernel
    tolerance and, bit for bit, the same cache rows and row scales. q, k_new
    and v_new are views into one QKV projection, as the batched step passes
    them."""
    gen = torch.Generator(device=card).manual_seed(3 * cap + int8)
    n_layers, b, h, d, layer = 2, 8, 16, 64, 1
    cos, sin = (t.to(card) for t in build_rope_tables(8192, d))
    k, v = ((torch.randn((n_layers, b, h, cap, d), generator=gen, device=card) * 0.3).to(dtype) for _ in range(2))
    caches = [*quantize_kv_rows(k), *quantize_kv_rows(v)] if int8 else [k, v]
    for offsets in _lane_offsets(cap, b * h, b, card):
        qkv = torch.randn((b, 1, 3 * h * d), generator=gen, device=card).to(dtype)
        q, k_new, v_new = qkv.reshape(b, 1, 3, h, d).permute(2, 0, 3, 1, 4)
        mine, ref = [c.clone() for c in caches], [c.clone() for c in caches]

        def step(fn, bufs):
            if int8:
                kc, ksc, vc, vsc = bufs
                return fn(q, k_new, v_new, kc, vc, offsets, cos, sin, layer, ksc, vsc)
            return fn(q, k_new, v_new, bufs[0], bufs[1], offsets, cos, sin, layer)

        counter = bda.batched_decode_attention_int8 if int8 else bda.batched_decode_attention
        before = counter.launches
        got = step(bda.batched_decode_attention_step, mine)
        want = step(bda.batched_decode_attention_step_plain, ref)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        _close(got, want, dtype)
        for name, x, y in zip(("k", "k_scale", "v", "v_scale") if int8 else ("k", "v"), mine, ref):
            assert torch.equal(x, y), (name, offsets.tolist())


def test_decode_attention_wrappers_raise_on_misaligned_caches(card):
    buf = torch.zeros(2 * 16 * 64 * 64 + 8, dtype=torch.bfloat16, device=card)
    kc = buf[8:].view(2, 1, 16, 64, 64)  # 16 bytes off: fine; 8 elements of bf16
    vc = buf[4:-4].view(2, 1, 16, 64, 64)  # 8 bytes off: refused
    q = torch.zeros((1, 16, 1, 64), dtype=torch.bfloat16, device=card)
    off = torch.zeros((), dtype=torch.int32, device=card)
    cos, sin = (t.to(card) for t in build_rope_tables(64, 64))
    with pytest.raises(ValueError, match="aligned"):
        da.decode_attention_step(q, q, kc, vc, q, off, cos, sin, 0)
    with pytest.raises(ValueError, match="aligned"):
        bda.batched_decode_attention(q, kc, vc, torch.zeros(1, dtype=torch.int32, device=card), 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
def test_batched_decode_attention_kernels(card, dtype, int8):
    gen = torch.Generator(device=card).manual_seed(7)
    n_layers, b, h, c, d, layer = 3, 8, 16, 384, 64, 1
    q = torch.randn((b, h, 1, d), generator=gen, device=card).to(dtype)
    k, v = ((torch.randn((n_layers, b, h, c, d), generator=gen, device=card) * 0.3).to(dtype) for _ in range(2))
    # Lane offsets: the first and last slot, past the capacity, and random.
    offsets = torch.tensor([0, c - 1, c, 5, 100, 383, 200, 17], dtype=torch.int32, device=card)
    if int8:
        (kq, ks), (vq, vs) = quantize_kv_rows(k), quantize_kv_rows(v)
        fn, before = bda.batched_decode_attention_int8, bda.batched_decode_attention_int8.launches
        got = fn(q, kq, ks, vq, vs, offsets, layer)
        want = bda.batched_decode_attention_int8_plain(q, kq, ks, vq, vs, offsets, layer)
    else:
        fn, before = bda.batched_decode_attention, bda.batched_decode_attention.launches
        got = fn(q, k, v, offsets, layer)
        want = bda.batched_decode_attention_plain(q, k, v, offsets, layer)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(1, 1024, 3072), (8, 1024, 4096), (8, 4096, 1024), (64, 512, 10240), (13, 1024, 1024)])
def test_quantized_matmul_kernel(card, dtype, m, k, n):
    gen = torch.Generator(device=card).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=card).to(dtype)
    w = torch.randint(-127, 128, (k, n), generator=gen, device=card, dtype=torch.int8)
    scale = torch.rand((n,), generator=gen, device=card) * 1e-3
    before = qmm.quantized_matmul.launches
    got = qmm.quantized_matmul(x, w, scale)
    want = qmm.quantized_matmul_plain(x, w, scale)
    torch.cuda.synchronize()
    assert qmm.quantized_matmul.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)  # f32 sums, another order


# Shapes whose plans take every split count 1..8, a shorter last split
# (1408 -> 256: 384, 384, 384, 256 rows), 128-column tiles, and (M = 64,
# float32, K = 8192) staging passes; at M in 1, 8, 13, 64 (one to four
# 16-row tiles).
QMM_PLAN_SHAPES = [(256 * s, 256) for s in range(1, 9)] + [
    (1408, 256),
    (1024, 3072),
    (4096, 1024),
    (512, 10240),
    (256, 17152),
    (8192, 256),
]


def _qmm_inputs(card, dtype, m, k, n, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=card).to(dtype)
    w = torch.randint(-127, 128, (k, n), generator=gen, device=card, dtype=torch.int8)
    scale = torch.rand((n,), generator=gen, device=card) * 1e-3 + 1e-4
    bias = torch.randn((n,), generator=gen, device=card)
    return x, w, scale, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [1, 8, 13, 64])
@pytest.mark.parametrize("k,n", QMM_PLAN_SHAPES)
def test_quantized_matmul_kernel_every_plan_and_epilogue(card, dtype, m, k, n):
    """Kernel 5 against its plain version in each epilogue form: the float32
    product (the Pallas kernel's output), and rounded to x's dtype with and
    without a bias (float32 or bfloat16), as float32 or x's dtype."""
    x, w, scale, bias = _qmm_inputs(card, dtype, m, k, n, m + k + n)
    forms = [
        (None, torch.float32),
        (None, dtype),
        (bias, dtype),
        (bias.to(torch.bfloat16), dtype),
        (bias, torch.float32),
    ]
    for b, out_dtype in forms:
        got = qmm.quantized_matmul(x, w, scale, b, out_dtype)
        want = qmm.quantized_matmul_plain(x, w, scale, b, out_dtype)
        torch.cuda.synchronize()
        assert got.dtype == out_dtype and got.shape == (m, n)
        # The float32 product differs from the plain one only in summation
        # order (2e-4); rounded to bfloat16 the two may sit one bf16
        # rounding apart (1e-2, chip_smoke.KERNEL_TOL).
        rounded = dtype == torch.bfloat16 and (b is not None or out_dtype != torch.float32)
        tol = 1e-2 if rounded else 2e-4
        torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(8, 1024, 4096), (8, 4096, 1024), (64, 1024, 3072), (1, 512, 10240)])
def test_quantized_matmul_kernel_is_deterministic(card, dtype, m, k, n):
    x, w, scale, bias = _qmm_inputs(card, dtype, m, k, n, 11)
    for b, out_dtype in ((None, torch.float32), (bias, dtype)):
        first = qmm.quantized_matmul(x, w, scale, b, out_dtype)
        for _ in range(3):
            assert torch.equal(qmm.quantized_matmul(x, w, scale, b, out_dtype), first)


def test_quantized_matmul_refuses_misaligned_operands(card):
    k, n = 256, 512
    x = torch.zeros((8, k), dtype=torch.bfloat16, device=card)
    scale = torch.ones((n,), device=card)
    buf = torch.zeros(k * n + 16, dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="aligned"):
        qmm.quantized_matmul(x, buf[8 : 8 + k * n].view(k, n), scale)
    w = buf[16 : 16 + k * n].view(k, n)  # 16 bytes off: taken
    qmm.quantized_matmul(x, w, scale)
    xb = torch.zeros(8 * k + 4, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="aligned"):
        qmm.quantized_matmul(xb[4:].view(8, k), w, scale)
    with pytest.raises(TypeError):
        qmm.quantized_matmul(x, w, scale, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        qmm.quantized_matmul(x, w, scale, torch.zeros((n,), dtype=torch.int32, device=card))


def test_int8_linear_is_one_launch(card):
    """apply_linear on a gated int8 linear with a bias, bfloat16 x: exactly
    one kernel on the card (no memset, cast or bias add), and it is kernel 5
    (the one launch its wrapper counts)."""
    from go_pocket_tts_tpu_torch.models.params import apply_linear

    gen = torch.Generator(device=card).manual_seed(4)
    w = torch.randn((1024, 4096), generator=gen, device=card)
    p = quantize_linear({"w": w, "b": torch.randn((4096,), generator=gen, device=card)})
    p["b"] = p["b"].to(torch.bfloat16)
    x = torch.randn((8, 1, 1024), generator=gen, device=card).to(torch.bfloat16)
    want = apply_linear(p, x)  # warm-up: builds and configures the kernel
    before = qmm.quantized_matmul.launches
    got, nodes = _captured_nodes(lambda: apply_linear(p, x))
    assert nodes == [KERNEL_NODE], nodes
    assert qmm.quantized_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (8, 1, 4096) and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_kv_rows_on_card_is_the_cpus(card, dtype):
    """The int8 KV row scale is amax / 127, the IEEE quotient, on either
    device: the card's rows and scales are byte-equal to the CPU's."""
    gen = torch.Generator(device=card).manual_seed(9)
    x = (torch.randn((4, 16, 97, 64), generator=gen, device=card) * 3).to(dtype)
    x[0, 0, :5] = 0  # zero rows: scale 1
    q, s = quantize_kv_rows(x)
    q_cpu, s_cpu = quantize_kv_rows(x.cpu())
    assert torch.equal(q.cpu(), q_cpu) and torch.equal(s.cpu(), s_cpu)
    amax = x.cpu().float().abs().amax(-1).numpy()
    want = np.where(amax > 0, amax / np.float32(127), np.float32(1)).astype(np.float32)
    assert np.array_equal(s_cpu.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "m,k,n", [(1, 1024, 3072), (8, 1024, 4096), (8, 4096, 1024), (64, 512, 10240), (13, 1024, 1024), (8, 384, 768)]
)
def test_int4_matmul_kernel(card, dtype, m, k, n):
    gen = torch.Generator(device=card).manual_seed(m + k + n)
    x = torch.randn((m, k), generator=gen, device=card).to(dtype)
    lin = quantize_linear({"w": torch.randn((k, n), generator=gen, device=card) / k**0.5}, bits=4)
    assert lin["w"].dtype == torch.uint8 and lin["scale"].shape == (k // 128, n)
    before = i4mm.int4_matmul.launches
    got = i4mm.int4_matmul(x, lin["w"], lin["scale"])
    want = i4mm.int4_matmul_plain(x, lin["w"], lin["scale"])
    torch.cuda.synchronize()
    assert i4mm.int4_matmul.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, want, atol=2e-4, rtol=2e-4)  # f32 sums, another order


def test_int4_matmul_kernel_decodes_every_code(card):
    """All 256 bytes, both nibbles over -8..7 (an artifact may hold -8),
    against the plain version, with group scales that differ per group."""
    packed = torch.arange(256, dtype=torch.uint8, device=card).reshape(64, 4).repeat(2, 64)  # [128, 256]
    scale = torch.tensor([[0.5], [2.0]], device=card).expand(2, 256).contiguous()
    x = torch.randn((8, 256), generator=torch.Generator(device=card).manual_seed(3), device=card)
    got = i4mm.int4_matmul(x, packed, scale)
    torch.testing.assert_close(got, i4mm.int4_matmul_plain(x, packed, scale), atol=2e-4, rtol=2e-4)


def test_int4_matmul_raises_outside_its_gate(card):
    x = torch.zeros((8, 256), device=card)
    w = torch.zeros((128, 512), dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="gate"):
        i4mm.int4_matmul(x, w, torch.ones((512,), device=card))  # per-channel int4
    with pytest.raises(ValueError, match="gate"):
        i4mm.int4_matmul(torch.zeros((65, 256), device=card), w, torch.ones((2, 512), device=card))
    with pytest.raises(ValueError, match="aligned"):
        buf = torch.zeros(128 * 512 + 1, dtype=torch.uint8, device=card)
        i4mm.int4_matmul(x, buf[1:].view(128, 512), torch.ones((2, 512), device=card))
    with pytest.raises(TypeError):
        i4mm.int4_matmul(x.half(), w, torch.ones((2, 512), device=card))


def _i4mm_inputs(card, dtype, m, k, n, seed):
    gen = torch.Generator(device=card).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=card).to(dtype)
    # Random bytes: every nibble code, -8 included; every group its own scales.
    w = torch.randint(0, 256, (k // 2, n), generator=gen, device=card, dtype=torch.uint8)
    scale = torch.rand((k // 128, n), generator=gen, device=card) * 1e-3 + 1e-4
    bias = torch.randn((n,), generator=gen, device=card)
    return x, w, scale, bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k,n", QMM_PLAN_SHAPES)
def test_int4_matmul_kernel_every_plan_and_epilogue(card, dtype, k, n):
    """Kernel 6 against its plain version at every plan shape (split counts
    1..8, a shorter last split, 128-column tiles, staging passes), with 1,
    8, 13 and 64 rows, in each epilogue form: the float32 product (the
    Pallas kernel's output), and rounded to x's dtype with and without a
    bias (float32 or bfloat16), as float32 or x's dtype."""
    for m in (1, 8, 13, 64):
        x, w, scale, bias = _i4mm_inputs(card, dtype, m, k, n, m + k + n)
        forms = [
            (None, torch.float32),
            (None, dtype),
            (bias, dtype),
            (bias.to(torch.bfloat16), dtype),
            (bias, torch.float32),
        ]
        for b, out_dtype in forms:
            what = f"M={m} bias={None if b is None else b.dtype} out={out_dtype}"
            before = i4mm.int4_matmul.launches
            got = i4mm.int4_matmul(x, w, scale, b, out_dtype)
            want = i4mm.int4_matmul_plain(x, w, scale, b, out_dtype)
            torch.cuda.synchronize()
            assert i4mm.int4_matmul.launches == before + 1, what
            assert got.dtype == out_dtype and got.shape == (m, n), what
            # The float32 product differs from the plain one only in summation
            # order (2e-4); rounded to bfloat16 the two may sit one bf16
            # rounding apart (1e-2, chip_smoke.KERNEL_TOL).
            rounded = dtype == torch.bfloat16 and (b is not None or out_dtype != torch.float32)
            tol = 1e-2 if rounded else 2e-4
            torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol, msg=lambda e: f"{what}: {e}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_int4_matmul_kernel_decodes_every_code_per_group(card, dtype):
    """All 256 bytes (both nibbles over -8..7) in every group, x one-hot
    rows: each output is one weight code times its group's scale, exact in
    float32 (one nonzero product per sum), over four groups whose scales
    differ; the kernel equals the plain version and the hand-decoded codes
    bit for bit."""
    k, n = 512, 256
    w = torch.arange(256, dtype=torch.uint8, device=card).reshape(64, 4).repeat(4, 64)  # [256, 256]
    scale = (2.0 ** torch.arange(-2, 2, device=card, dtype=torch.float32))[:, None].expand(4, n).contiguous()
    levels = i4mm._depack(w.cpu()).float()
    assert levels.min() == -8 and levels.max() == 7
    eye = torch.eye(k, device=card).to(dtype)
    for r0 in range(0, k, 64):  # 64 rows a call: two calls a group
        x = eye[r0 : r0 + 64].contiguous()
        got = i4mm.int4_matmul(x, w, scale)
        torch.cuda.synchronize()
        assert torch.equal(got, i4mm.int4_matmul_plain(x, w, scale)), r0
        assert torch.equal(got.cpu(), levels[r0 : r0 + 64] * scale[r0 // 128].cpu()), r0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m,k,n", [(8, 1024, 4096), (8, 4096, 1024), (64, 1024, 3072), (1, 512, 10240)])
def test_int4_matmul_kernel_is_deterministic(card, dtype, m, k, n):
    x, w, scale, bias = _i4mm_inputs(card, dtype, m, k, n, 12)
    for b, out_dtype in ((None, torch.float32), (bias, dtype)):
        first = i4mm.int4_matmul(x, w, scale, b, out_dtype)
        for _ in range(3):
            assert torch.equal(i4mm.int4_matmul(x, w, scale, b, out_dtype), first)


def test_int4_matmul_refuses_misaligned_operands(card):
    k, n = 256, 512
    x = torch.zeros((8, k), dtype=torch.bfloat16, device=card)
    scale = torch.ones((k // 128, n), device=card)
    buf = torch.zeros(k // 2 * n + 16, dtype=torch.uint8, device=card)
    with pytest.raises(ValueError, match="aligned"):
        i4mm.int4_matmul(x, buf[8 : 8 + k // 2 * n].view(k // 2, n), scale)
    w = buf[16 : 16 + k // 2 * n].view(k // 2, n)  # 16 bytes off: taken
    i4mm.int4_matmul(x, w, scale)
    xb = torch.zeros(8 * k + 4, dtype=torch.bfloat16, device=card)
    with pytest.raises(ValueError, match="aligned"):
        i4mm.int4_matmul(xb[4:].view(8, k), w, scale)
    sb = torch.zeros(2 * n + 2, device=card)
    with pytest.raises(ValueError, match="aligned"):
        i4mm.int4_matmul(x, w, sb[2:].view(2, n))
    bb = torch.zeros(n + 2, device=card)
    with pytest.raises(ValueError, match="aligned"):
        i4mm.int4_matmul(x, w, scale, bb[2:])
    with pytest.raises(TypeError):
        i4mm.int4_matmul(x, w, scale, out_dtype=torch.float16)
    with pytest.raises(ValueError):
        i4mm.int4_matmul(x, w, scale, torch.zeros((n,), dtype=torch.int32, device=card))


KERNEL_NODE = 0  # CU_GRAPH_NODE_TYPE_KERNEL; memsets are 2, copies 1


def _captured_nodes(fn):
    """fn() captured into a CUDA graph, then replayed: its result and the
    type of each node of the graph. The capture holds every operation fn()
    puts on the stream, kernels, memsets and copies alike, so the count does
    not depend on when a profiler's window opens or on its event buffers."""
    import ctypes

    cuda = ctypes.CDLL("libcuda.so.1")
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
        status, ident, raw = ctypes.c_int(), ctypes.c_uint64(), ctypes.c_void_p()
        deps, n_deps, count = ctypes.c_void_p(), ctypes.c_size_t(), ctypes.c_size_t()
        rc = cuda.cuStreamGetCaptureInfo_v2(
            ctypes.c_void_p(stream.cuda_stream), ctypes.byref(status), ctypes.byref(ident), ctypes.byref(raw),
            ctypes.byref(deps), ctypes.byref(n_deps),
        )
        assert rc == 0 and status.value == 1, (rc, status.value)  # CU_STREAM_CAPTURE_STATUS_ACTIVE
        assert cuda.cuGraphGetNodes(raw, None, ctypes.byref(count)) == 0
        nodes = (ctypes.c_void_p * count.value)()
        assert cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(count)) == 0
        types = []
        for node in nodes:
            kind = ctypes.c_int()
            assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0
            types.append(kind.value)
    graph.replay()
    torch.cuda.synchronize()
    return out.clone(), types


@pytest.mark.parametrize("fused", [False, True])
def test_int4_matmul_is_one_launch(card, fused):
    """One call, float32 or fused (bias, bf16 out): exactly one kernel on the
    card (no memset, cast or bias add), and it is kernel 6 (the one launch
    its wrapper counts)."""
    x, w, scale, bias = _i4mm_inputs(card, torch.bfloat16, 8, 1024, 4096, 13)
    args = (bias, torch.bfloat16) if fused else ()
    want = i4mm.int4_matmul(x, w, scale, *args)  # warm-up: builds and configures the kernel
    before = i4mm.int4_matmul.launches
    got, nodes = _captured_nodes(lambda: i4mm.int4_matmul(x, w, scale, *args))
    assert nodes == [KERNEL_NODE], nodes
    assert i4mm.int4_matmul.launches == before + 1
    assert torch.equal(got, want)


def test_int4_linear_is_one_launch(card):
    """apply_linear on a gated int4 linear with a bias, bfloat16 x: exactly
    one kernel on the card, and it is kernel 6 (the one launch its wrapper
    counts)."""
    from go_pocket_tts_tpu_torch.models.params import apply_linear

    gen = torch.Generator(device=card).manual_seed(5)
    w = torch.randn((1024, 4096), generator=gen, device=card)
    p = quantize_linear({"w": w, "b": torch.randn((4096,), generator=gen, device=card)}, bits=4)
    assert p["w"].dtype == torch.uint8 and p["scale"].shape == (8, 4096)
    p["b"] = p["b"].to(torch.bfloat16)
    x = torch.randn((8, 1, 1024), generator=gen, device=card).to(torch.bfloat16)
    want = apply_linear(p, x)  # warm-up
    before = i4mm.int4_matmul.launches
    got, nodes = _captured_nodes(lambda: apply_linear(p, x))
    assert nodes == [KERNEL_NODE], nodes
    assert i4mm.int4_matmul.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == (8, 1, 4096) and torch.equal(got, want)


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


def test_tiny_batcher_kernels_match_plain(card, monkeypatch):
    """The batcher at its serving knobs on a tiny model whose heads are 64
    wide and whose linears pass the int8 kernel's gate: kernels 4 (int8)
    and 5 launch, and the audio is the plain versions' within the path
    budget."""
    from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher

    arch = dataclasses.replace(synthetic.tiny_arch(), d_model=128, num_heads=2, ffn_dim=256)
    model = load_model_from_tensors(synthetic.build_checkpoint(arch, seed=2), num_heads=arch.num_heads, device=card)
    cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=8)

    def serve():
        batcher = ContinuousBatcher(
            model, slots=2, prompt_capacity=16, max_frames=16, seed=1, quantize=True, kv_quantize=True, device=card
        )
        batcher.start()
        try:
            futs = [batcher.submit([3, 17, 41], cfg), batcher.submit([5, 9, 2, 60, 7], cfg)]
            return [f.result(timeout=120) for f in futs]
        finally:
            batcher.stop()

    kernels.reset_launches()
    got = serve()
    assert bda.batched_decode_attention_int8.launches > 0 and qmm.quantized_matmul.launches > 0
    monkeypatch.setattr(bda, "batched_decode_attention_step", bda.batched_decode_attention_step_plain)
    monkeypatch.setattr(qmm, "quantized_matmul", qmm.quantized_matmul_plain)
    want = serve()
    for g, w in zip(got, want):
        assert g.shape == w.shape == (8 * 1920,)
        assert np.sqrt(np.mean((g - w) ** 2)) < 1e-3


def test_tiny_int4_batcher_kernels_match_plain(card, monkeypatch):
    """The batcher with int4 weights and an int8 KV cache on a tiny model
    whose linears are group-wise and pass the int4 kernel's gate: kernel 6
    launches, and the audio is the plain versions' within the path budget."""
    from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher

    arch = dataclasses.replace(synthetic.tiny_arch(), d_model=256, num_heads=4, ffn_dim=512, flow_dim=256, flow_hidden=256)
    model = load_model_from_tensors(synthetic.build_checkpoint(arch, seed=2), num_heads=arch.num_heads, device=card)
    cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=8)

    def serve():
        batcher = ContinuousBatcher(
            model, slots=2, prompt_capacity=16, max_frames=16, seed=1, quantize=4, kv_quantize=True, device=card
        )
        batcher.start()
        try:
            futs = [batcher.submit([3, 17, 41], cfg), batcher.submit([5, 9, 2, 60, 7], cfg)]
            return [f.result(timeout=120) for f in futs]
        finally:
            batcher.stop()

    kernels.reset_launches()
    got = serve()
    assert i4mm.int4_matmul.launches > 0 and qmm.quantized_matmul.launches == 0
    monkeypatch.setattr(bda, "batched_decode_attention_step", bda.batched_decode_attention_step_plain)
    monkeypatch.setattr(i4mm, "int4_matmul", i4mm.int4_matmul_plain)
    want = serve()
    for g, w in zip(got, want):
        assert g.shape == w.shape == (8 * 1920,)
        assert np.sqrt(np.mean((g - w) ** 2)) < 1e-3


def test_tiny_batched_stream_kernels_match_plain(card, monkeypatch):
    """The float32 batcher streaming two lanes at mixed starts (the second
    admitted a block after the first) at its serving knobs, on a tiny model
    with 64-wide heads and a SEANet at the kernels' widths: kernels 8 (the
    batched stream decode, per-lane starts), 4 (int8) and 5 launch, and the
    streamed PCM is the plain versions' within the path budget."""
    import chip_smoke
    from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher

    arch = dataclasses.replace(
        synthetic.tiny_arch(), d_model=128, num_heads=2, ffn_dim=256, seanet_channels=(32, 256, 128, 64)
    )
    model = load_model_from_tensors(synthetic.build_checkpoint(arch, seed=2), num_heads=arch.num_heads, device=card)
    cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=12)

    def serve():
        batcher = ContinuousBatcher(
            model, slots=2, prompt_capacity=16, max_frames=16, seed=1, steps_per_sync=4, quantize=True,
            kv_quantize=True, device=card,
        )
        batcher.start()
        try:
            first = batcher.submit_stream([3, 17, 41], cfg, timeout=120)
            blocks = [next(first)]
            second = batcher.submit_stream([5, 9, 2, 60, 7], cfg, timeout=120)
            return [np.concatenate(blocks + list(first)), np.concatenate(list(second))]
        finally:
            batcher.stop()

    kernels.reset_launches()
    got = serve()
    assert st.fused_up2_up3_tail.launches > 0
    assert bda.batched_decode_attention_int8.launches > 0 and qmm.quantized_matmul.launches > 0
    monkeypatch.setattr(bda, "batched_decode_attention_step", bda.batched_decode_attention_step_plain)
    monkeypatch.setattr(qmm, "quantized_matmul", qmm.quantized_matmul_plain)
    monkeypatch.setattr(st, "fused_up2_up3_tail_stream", st.fused_up2_up3_tail_stream_plain)
    kernels.reset_launches()
    want = serve()
    assert [fn.launches for fn in kernels.WRAPPERS] == [0] * len(kernels.WRAPPERS)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (12 * 1920,)
        assert np.sqrt(np.mean((g - w) ** 2)) < chip_smoke.PATH_RMS_TOL


def _quantized_linears(node, path=""):
    """(path, linear) for every quantized linear of a parameter tree."""
    if isinstance(node, dict) and "w" in node and "scale" in node:
        yield path, node
    elif isinstance(node, (dict, list)):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for key, value in items:
            yield from _quantized_linears(value, f"{path}.{key}" if path else str(key))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_batcher_drift_starts_at_sum_order(card, bits):
    """Where the float32 quantized batcher's kernels-vs-plain difference
    comes from, with int8 or group-wise int4 weights and an int8 KV cache,
    on chip_smoke.py's seeded real_arch() model and parity request:

    - each linear that passes its kernel's gate at M = 8 differs from its
      plain version by float32 sum order alone, within 1e-5 of the
      output's largest magnitude;
    - the request's first frame of PCM is within one PCM16 step RMS
      (1 / 32767) of the plain versions';
    - the difference grows frame by frame through the AR loop, the whole
      request within chip_smoke's PATH_RMS_TOL.

    Prints each gated linear's error and every frame's RMS (pytest -s)."""
    import chip_smoke
    from go_pocket_tts_tpu_torch.models.quantize import quantize_model_params

    arch, model32 = chip_smoke.build_model(torch.float32)
    gen = torch.Generator(device=card).manual_seed(8)
    if bits == 4:
        fn, plain, gated = i4mm.int4_matmul, i4mm.int4_matmul_plain, lambda k, n, s: i4mm.supports(8, k, n, s)
    else:
        fn, plain, gated = qmm.quantized_matmul, qmm.quantized_matmul_plain, lambda k, n, s: qmm.supports(8, k, n)
    worst, n_gated = 0.0, 0
    with torch.no_grad():
        for path, lin in _quantized_linears(quantize_model_params(model32.params, bits=bits)):
            k, n = lin["w"].shape[0] * (2 if bits == 4 else 1), lin["w"].shape[1]
            if not gated(k, n, tuple(lin["scale"].shape)):
                continue
            x = torch.randn((8, k), generator=gen, device=card)
            want = plain(x, lin["w"], lin["scale"])
            rel = (fn(x, lin["w"], lin["scale"]) - want).abs().max().item() / want.abs().max().item()
            print(f"int{bits} {path} K={k} N={n}: kernel - plain {rel:.3e} of max |y|")
            worst, n_gated = max(worst, rel), n_gated + 1
    print(f"int{bits}: {n_gated} gated linears, worst {worst:.3e} of max |y|")
    assert n_gated > 0 and worst <= 1e-5

    quantize = 4 if bits == 4 else True
    got = chip_smoke.serve_f32(model32, arch, quantize=quantize, kv_quantize=True)
    undo = chip_smoke.plain_versions()
    try:
        want = chip_smoke.serve_f32(model32, arch, quantize=quantize, kv_quantize=True)
    finally:
        undo()
    diff = (got.astype(np.float64) - want).reshape(-1, 1920)
    per_frame = np.sqrt(np.mean(diff**2, axis=1))
    whole = float(np.sqrt(np.mean(diff**2)))
    nz = np.flatnonzero(per_frame)
    growth = (per_frame[nz[-1]] / per_frame[nz[0]]) ** (1 / (nz[-1] - nz[0])) if len(nz) > 1 else float("nan")
    print(f"int{bits} PCM RMS per frame, in PCM16 steps: " + " ".join(f"{r * 32767:.2f}" for r in per_frame))
    print(
        f"int{bits}: whole request {whole:.3e}; first nonzero frame {nz[0] if len(nz) else None}; "
        f"growth {growth:.3f}x a frame from it to the last nonzero"
    )
    assert per_frame[0] <= 1 / 32767
    assert whole < chip_smoke.PATH_RMS_TOL


def _up2_weights(gen, card, dtype):
    """up2 + res2, then up3 + res3 + final conv, at the kernels' widths."""

    def rnd(*shape, scale=0.1):
        return (torch.randn(shape, generator=gen, device=card) * scale).to(dtype)

    wu2 = repack_conv_transpose_kernel(torch.randn((256, 128, 10), generator=gen, device=card) * 0.05).to(dtype)
    wu3 = repack_conv_transpose_kernel(torch.randn((128, 64, 8), generator=gen, device=card) * 0.1).to(dtype)
    up2 = [wu2, rnd(128), rnd(64, 128, 3), rnd(64), rnd(128, 64, 1), rnd(128)]
    rest = [wu3, rnd(64), rnd(32, 64, 3), rnd(32), rnd(64, 32, 1), rnd(64), rnd(1, 64, 7), rnd(1)]
    return up2, up2 + rest


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_up2_kernels(card, dtype):
    """Kernels 7 and 8 at 96 input columns (one latent frame), a length the
    reference gates refuse (they take multiples of 128)."""
    gen = torch.Generator(device=card).manual_seed(4)
    up2, weights = _up2_weights(gen, card, dtype)
    x = (torch.randn((2, 256, 96), generator=gen, device=card) * 0.5).to(dtype)
    assert not st.supports_up2(256, 96, 10) and not st.supports_cascade(256, 96, 10, 8)
    kernels.reset_launches()
    _close(st.fused_up2_res(x, *up2), st.fused_up2_res_plain(x, *up2), dtype)
    _close(st.fused_up2_up3_tail(x, *weights), st.fused_up2_up3_tail_plain(x, *weights), dtype)
    assert st.fused_up2_res.launches == st.fused_up2_up3_tail.launches == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cascade_stream_with_mixed_starts(card, dtype):
    """One block of the streaming cascade on lanes at start 0 (zero halo),
    2 (a halo that reaches before the stream), 96 and 960, against the plain
    streaming version."""
    gen = torch.Generator(device=card).manual_seed(5)
    _, weights = _up2_weights(gen, card, dtype)
    x = (torch.randn((4, 256, 192), generator=gen, device=card) * 0.5).to(dtype)
    halo = (torch.randn((4, 256, st.HALO), generator=gen, device=card) * 0.5).to(dtype)
    halo[0] = 0
    start = torch.tensor([0, 2, 96, 960], dtype=torch.int32, device=card)
    got = st.fused_up2_up3_tail_stream(x, halo, start, *weights)
    _close(got, st.fused_up2_up3_tail_stream_plain(x, halo, start, *weights), dtype)
    # Lane 0 is the whole-sequence function of its block.
    _close(got[:1], st.fused_up2_up3_tail(x[:1].contiguous(), *weights), dtype)


def test_up2_wrappers_raise_on_what_the_kernels_do_not_take(card):
    gen = torch.Generator(device=card).manual_seed(6)
    up2, weights = _up2_weights(gen, card, torch.float32)
    x16 = torch.zeros((1, 256, 96), device=card, dtype=torch.float16)
    with pytest.raises(TypeError):
        st.fused_up2_res(x16, *(w.half() for w in up2))
    with pytest.raises(TypeError):
        st.fused_up2_up3_tail(x16, *(w.half() for w in weights))
    with pytest.raises(ValueError):
        st.fused_up2_res(torch.zeros((1, 256, 100), device=card), *up2)  # not a multiple of 8
    with pytest.raises(ValueError):
        st.fused_up2_up3_tail(torch.zeros((1, 256, 48), device=card), *weights)  # not a multiple of 32
    x = torch.zeros((2, 256, 96), device=card)
    with pytest.raises(ValueError, match="start"):
        st.fused_up2_up3_tail_stream(x, torch.zeros((2, 256, st.HALO), device=card), torch.zeros(2, device=card), *weights)
    with pytest.raises(ValueError):
        st.fused_up2_up3_tail_stream(x, torch.zeros((2, 256, 4), device=card), torch.zeros(2, dtype=torch.int32, device=card), *weights)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("frames", [16, 160, 256])
def test_tensor_core_seanet_kernels(card, dtype, b, frames):
    """Kernels 7 and 2 (bf16 on tensor cores, float32 on CUDA cores) at the
    decode's shapes, x [B,256,96·frames] and [B,128,480·frames], against
    their plain versions, and bit-equal over two calls."""
    gen = torch.Generator(device=card).manual_seed(7 * b + frames)
    up2, weights = _up2_weights(gen, card, dtype)
    tail = weights[6:]
    for kernel, plain, ws, c_in, per_frame in (
        (st.fused_up2_res, st.fused_up2_res_plain, up2, 256, 96),
        (st.fused_seanet_up_tail, st.fused_seanet_up_tail_plain, tail, 128, 480),
    ):
        x = (torch.randn((b, c_in, per_frame * frames), generator=gen, device=card) * 0.5).to(dtype)
        got = kernel(x, *ws)
        _close(got, plain(x, *ws), dtype)
        assert torch.equal(got, kernel(x, *ws))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tensor_core_seanet_kernels_ragged_last_tile(card, dtype):
    """Lengths that end inside a block: kernel 7 at T_in = 1000 (its blocks
    are 32 columns; the wrapper takes multiples of 8), kernel 2 at
    T_in = 1952 (multiples of 32), and the smallest of each."""
    gen = torch.Generator(device=card).manual_seed(8)
    up2, weights = _up2_weights(gen, card, dtype)
    for kernel, plain, ws, c_in, lengths in (
        (st.fused_up2_res, st.fused_up2_res_plain, up2, 256, (1000, 8, 40)),
        (st.fused_seanet_up_tail, st.fused_seanet_up_tail_plain, weights[6:], 128, (1952, 32, 96)),
    ):
        for t_in in lengths:
            x = (torch.randn((2, c_in, t_in), generator=gen, device=card) * 0.5).to(dtype)
            _close(kernel(x, *ws), plain(x, *ws), dtype)


def test_tensor_core_kernels_follow_an_in_place_weight_update(card):
    """The prepared bf16 layouts are cached per weight: an in-place update
    of a weight must reach the next call."""
    gen = torch.Generator(device=card).manual_seed(9)
    up2, weights = _up2_weights(gen, card, torch.bfloat16)
    x7 = (torch.randn((1, 256, 96), generator=gen, device=card) * 0.5).to(torch.bfloat16)
    x2 = (torch.randn((1, 128, 480), generator=gen, device=card) * 0.5).to(torch.bfloat16)
    tail = weights[6:]
    st.fused_up2_res(x7, *up2)  # prepares and caches the layouts
    st.fused_seanet_up_tail(x2, *tail)
    up2[0].mul_(-1.0)
    tail[2].mul_(0.5)
    _close(st.fused_up2_res(x7, *up2), st.fused_up2_res_plain(x7, *up2), torch.bfloat16)
    _close(st.fused_seanet_up_tail(x2, *tail), st.fused_seanet_up_tail_plain(x2, *tail), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("frames", [4, 8, 16, 160])
def test_cascade_kernel(card, dtype, b, frames):
    """Kernel 8 (bf16 on tensor cores, float32 on CUDA cores) whole, x
    [B,256,96·frames], against its plain version, and bit-equal over two
    calls."""
    gen = torch.Generator(device=card).manual_seed(11 * b + frames)
    _, weights = _up2_weights(gen, card, dtype)
    x = (torch.randn((b, 256, 96 * frames), generator=gen, device=card) * 0.5).to(dtype)
    got = st.fused_up2_up3_tail(x, *weights)
    _close(got, st.fused_up2_up3_tail_plain(x, *weights), dtype)
    assert torch.equal(got, st.fused_up2_up3_tail(x, *weights))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cascade_stream_at_eight_lanes_with_mixed_starts(card, dtype):
    """The streaming form at B = 8, lanes at starts 0 to 1537 (five of them
    below the 5-column halo), against the plain streaming version, and
    bit-equal over two calls."""
    gen = torch.Generator(device=card).manual_seed(12)
    _, weights = _up2_weights(gen, card, dtype)
    x = (torch.randn((8, 256, 384), generator=gen, device=card) * 0.5).to(dtype)
    halo = (torch.randn((8, 256, st.HALO), generator=gen, device=card) * 0.5).to(dtype)
    start = torch.tensor([0, 1, 2, 3, 4, 5, 96, 1537], dtype=torch.int32, device=card)
    got = st.fused_up2_up3_tail_stream(x, halo, start, *weights)
    _close(got, st.fused_up2_up3_tail_stream_plain(x, halo, start, *weights), dtype)
    assert torch.equal(got, st.fused_up2_up3_tail_stream(x, halo, start, *weights))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cascade_kernel_ragged_last_block(card, dtype):
    """Lengths that end inside a block (the bf16 kernel's blocks are 14
    input columns; the wrapper takes multiples of 32), whole and streamed."""
    gen = torch.Generator(device=card).manual_seed(13)
    _, weights = _up2_weights(gen, card, dtype)
    for t_in in (32, 160, 416, 1024):
        x = (torch.randn((2, 256, t_in), generator=gen, device=card) * 0.5).to(dtype)
        _close(st.fused_up2_up3_tail(x, *weights), st.fused_up2_up3_tail_plain(x, *weights), dtype)
        halo = (torch.randn((2, 256, st.HALO), generator=gen, device=card) * 0.5).to(dtype)
        start = torch.tensor([3, 700], dtype=torch.int32, device=card)
        _close(st.fused_up2_up3_tail_stream(x, halo, start, *weights),
               st.fused_up2_up3_tail_stream_plain(x, halo, start, *weights), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cascade_streamed_blocks_concatenate_to_the_whole(card, dtype):
    """160 frames streamed in 16-frame blocks, each carrying the last 5
    columns and its start, concatenate to the whole form."""
    gen = torch.Generator(device=card).manual_seed(14)
    _, weights = _up2_weights(gen, card, dtype)
    x = (torch.randn((2, 256, 96 * 160), generator=gen, device=card) * 0.5).to(dtype)
    halo = torch.zeros((2, 256, st.HALO), dtype=dtype, device=card)
    start = torch.zeros((2,), dtype=torch.int32, device=card)
    blocks = []
    for pos in range(0, x.shape[2], 96 * 16):
        xb = x[:, :, pos : pos + 96 * 16].contiguous()
        blocks.append(st.fused_up2_up3_tail_stream(xb, halo, start, *weights))
        halo = torch.cat([halo, xb], dim=2)[:, :, -st.HALO :].contiguous()
        start = start + 96 * 16
    _close(torch.cat(blocks, dim=2), st.fused_up2_up3_tail(x, *weights), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("t", [128, 1920, 128 * 241, 1920 * 160])
def test_seanet_tail_kernel(card, dtype, b, t):
    """Kernel 3 (bf16 on tensor cores, float32 on CUDA cores) at multiples
    of 128 samples, the bf16 kernel's blocks being 152 (so most end
    inside one), against its plain version, and bit-equal over two calls."""
    gen = torch.Generator(device=card).manual_seed(15 * b + t)
    _, weights = _up2_weights(gen, card, dtype)
    tail = weights[8:]
    x = (torch.randn((b, 64, t), generator=gen, device=card) * 0.5).to(dtype)
    got = st.fused_seanet_tail(x, *tail)
    _close(got, st.fused_seanet_tail_plain(x, *tail), dtype)
    assert torch.equal(got, st.fused_seanet_tail(x, *tail))


def test_cascade_and_tail_follow_an_in_place_weight_update(card):
    """Kernels 8 and 3 read cached bf16 layouts: an in-place update of a
    weight must reach the next call."""
    gen = torch.Generator(device=card).manual_seed(16)
    _, weights = _up2_weights(gen, card, torch.bfloat16)
    x8 = (torch.randn((1, 256, 384), generator=gen, device=card) * 0.5).to(torch.bfloat16)
    x3 = (torch.randn((1, 64, 1920), generator=gen, device=card) * 0.5).to(torch.bfloat16)
    tail = weights[8:]
    st.fused_up2_up3_tail(x8, *weights)  # prepares and caches the layouts
    st.fused_seanet_tail(x3, *tail)
    weights[0].mul_(-1.0)  # up2
    weights[6].mul_(0.5)  # up3
    tail[0].mul_(-0.5)  # res3.conv1
    tail[4].mul_(2.0)  # the final conv
    _close(st.fused_up2_up3_tail(x8, *weights), st.fused_up2_up3_tail_plain(x8, *weights), torch.bfloat16)
    _close(st.fused_seanet_tail(x3, *tail), st.fused_seanet_tail_plain(x3, *tail), torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mimi_decode_through_the_tensor_core_kernels(card, dtype, monkeypatch):
    """One whole decode of a SEANet at the kernels' widths in each dtype:
    it launches kernels 7 and 2 once each, and its PCM is within
    chip_smoke.PATH_RMS_TOL (RMS) of the same decode on the plain versions."""
    import chip_smoke

    arch = dataclasses.replace(synthetic.tiny_arch(), seanet_channels=(32, 256, 128, 64))
    model = load_model_from_tensors(
        synthetic.build_checkpoint(arch, seed=3), num_heads=arch.num_heads, device=card, dtype=dtype
    )
    latent = (torch.randn((1, arch.mimi_dim, 16), generator=torch.Generator(device=card).manual_seed(2),
                          device=card) * 0.1).to(dtype)
    kernels.reset_launches()
    with torch.inference_mode():
        got = model.mimi_decode(latent).float()
    assert st.fused_up2_res.launches == 1 and st.fused_seanet_up_tail.launches == 1
    assert st.fused_up2_res.shapes == {(1, 256, 96 * 16): 1}
    monkeypatch.setattr(st, "fused_up2_res", st.fused_up2_res_plain)
    monkeypatch.setattr(st, "fused_seanet_up_tail", st.fused_seanet_up_tail_plain)
    with torch.inference_mode():
        want = model.mimi_decode(latent).float()
    rms = (got - want).pow(2).mean().sqrt().item()
    assert torch.isfinite(got).all() and rms < chip_smoke.PATH_RMS_TOL, rms


def test_stream_decoder_on_card_matches_plain(card, monkeypatch):
    """A SEANet at the kernels' widths on the card: the whole decode runs
    kernel 7 (then kernel 2), the block decoder runs kernel 8, each block
    agrees with the plain run and the blocks with the whole decode."""
    from go_pocket_tts_tpu_torch.models import mimi_stream

    arch = dataclasses.replace(synthetic.tiny_arch(), seanet_channels=(32, 256, 128, 64))
    model = load_model_from_tensors(synthetic.build_checkpoint(arch, seed=3), num_heads=arch.num_heads, device=card)
    params, cfg = model.params["mimi"], model.config.mimi
    latent = torch.randn((1, arch.mimi_dim, 16), generator=torch.Generator(device=card).manual_seed(1), device=card) * 0.1

    def stream():
        state = mimi_stream.init_stream_state(params, cfg, 1, 16 * cfg.steps_per_latent)
        outs, pos = [], 0
        for n in (1, 3, 4, 8):
            pcm, state = mimi_stream.decode_block(params, cfg, state, latent[:, :, pos : pos + n])
            outs.append(pcm)
            pos += n
        return torch.cat(outs, dim=2)

    kernels.reset_launches()
    whole = model.mimi_decode(latent)
    got = stream()
    assert st.fused_up2_res.launches == 1 and st.fused_seanet_up_tail.launches == 1
    assert st.fused_up2_up3_tail.launches == 4
    monkeypatch.setattr(st, "fused_up2_up3_tail_stream", st.fused_up2_up3_tail_stream_plain)
    plain = stream()
    _close(got, plain, torch.float32)
    _close(got, whole, torch.float32)


def test_service_on_card_matches_the_runtime(card, tmp_path):
    """The port's ``Service.from_config`` on the card, bf16, EOS off, on
    ``tiny_arch()`` with the published head width (64) and a SEANet at the
    kernels' widths: ``synthesize`` of three chunks (the pipelined
    ``generate_audio_async`` route) equals ``GPURuntime.generate_audio`` on
    the same chunks' ids, and the frame-streamed ``synthesize_stream``
    equals ``stream_generate`` on them, within chip_smoke.PATH_RMS_TOL;
    kernels 1, 7, 2 and 8 launch."""
    import chip_smoke
    from go_pocket_tts_tpu_torch.config import Config
    from go_pocket_tts_tpu_torch.models.model import load_model
    from go_pocket_tts_tpu_torch.runtime import stream_generate
    from go_pocket_tts_tpu_torch.text import prepare_chunks
    from go_pocket_tts_tpu_torch.tts.service import MAX_TOKENS_PER_CHUNK, Service
    from go_pocket_tts_tpu_torch.utils.safetensors import write_file

    arch = dataclasses.replace(synthetic.tiny_arch(), d_model=1024, num_heads=16, seanet_channels=(32, 256, 128, 64))
    cfg = Config()
    cfg.paths.model_path, cfg.paths.tokenizer_model = str(tmp_path / "model.safetensors"), str(tmp_path / "tok.model")
    write_file(cfg.paths.model_path, synthetic.build_checkpoint(arch, seed=5))
    chip_smoke.write_fixture_tokenizer(cfg.paths.tokenizer_model)
    cfg.runtime.dtype, cfg.runtime.seed = "bfloat16", 1
    cfg.tts.temperature, cfg.tts.eos_threshold = 0.0, 1e9
    svc = Service.from_config(cfg)
    assert svc.runtime.device.type == "cuda" and svc.runtime.dtype == torch.bfloat16
    chunks = prepare_chunks(chip_smoke.SERVICE_TEXT, svc.tokenizer, MAX_TOKENS_PER_CHUNK)
    assert len(chunks) == 3
    kernels.reset_launches()
    audio = svc.synthesize(chip_smoke.SERVICE_TEXT)
    streamed = np.concatenate([c.samples for c in svc.synthesize_stream(chip_smoke.SERVICE_TEXT, frame_streaming=True)])
    launched = (da.decode_attention_step, st.fused_up2_res, st.fused_seanet_up_tail, st.fused_up2_up3_tail)
    assert all(fn.launches > 0 for fn in launched), [fn.launches for fn in launched]

    rt = GPURuntime(load_model(cfg.paths.model_path, device=card), dtype=torch.bfloat16, seed=1, device=card)
    gen_cfgs = [GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=c.max_frames()) for c in chunks]
    want = np.concatenate([rt.generate_audio(c.token_ids, g) for c, g in zip(chunks, gen_cfgs)])
    want_streamed = np.concatenate(
        [b for c, g in zip(chunks, gen_cfgs) for b in stream_generate(rt, c.token_ids, g)]
    )
    assert audio.shape == want.shape == (sum(c.max_frames() for c in chunks) * 1920,)
    assert streamed.shape == want_streamed.shape == audio.shape
    for got, ref in ((audio, want), (streamed, want_streamed)):
        assert np.isfinite(got).all()
        assert np.sqrt(np.mean((got.astype(np.float64) - ref) ** 2)) < chip_smoke.PATH_RMS_TOL


def test_voice_encoder_on_card_matches_cpu_with_tf32_at_default():
    """The float32 Mimi encoder and speaker projection on the card against
    the CPU, the process's TF32 flags at PyTorch's defaults (cuDNN's on):
    the encoder scopes float32 itself and leaves the flags as it found
    them. 1.5 s of audio at the published encoder widths."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the encoder's device path runs only there")
    from go_pocket_tts_tpu_torch.tts.voice_export import VoiceEncoder

    arch = dataclasses.replace(synthetic.real_arch(), num_layers=1, flow_depth=1, n_bins=64)
    tensors = synthetic.build_checkpoint(arch, seed=6)
    samples = (np.random.RandomState(6).randn(36000) * 0.1).astype(np.float32)
    want = VoiceEncoder(tensors, device="cpu").encode_samples(samples, 24000)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = True, False
    try:
        got = VoiceEncoder(tensors, device="cuda").encode_samples(samples, 24000)
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, False)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert got.shape == want.shape == (1, 18, arch.d_model)
    rel = np.sqrt(np.mean((got - want) ** 2)) / np.sqrt(np.mean(want**2))
    assert rel <= 1e-4, rel


def test_staged_generation_on_card_matches_generate_audio(card):
    """``GPURuntime.generate_audio_staged`` on the card, float32 at
    temperature 0, on ``tiny_arch()`` with the published head width and a
    SEANet at the kernels' widths: within one PCM16 step of
    ``generate_audio`` (the one-shot path truncates to int16), every stage
    timed, and kernels 1, 7 and 2 launched by the staged run."""
    arch = dataclasses.replace(synthetic.tiny_arch(), d_model=1024, num_heads=16, seanet_channels=(32, 256, 128, 64))
    model = load_model_from_tensors(synthetic.build_checkpoint(arch, seed=8), num_heads=16, device=card)
    rt = GPURuntime(model, seed=1, device=card)
    cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=24)
    tokens = [3, 17, 41, 9, 22]
    kernels.reset_launches()
    staged, stages = rt.generate_audio_staged(tokens, cfg)
    assert da.decode_attention_step.launches > 0 and st.fused_up2_res.launches > 0 and st.fused_seanet_up_tail.launches > 0
    whole = rt.generate_audio(tokens, cfg)
    assert list(stages) == ["prefill", "ar", "decode"] and all(v > 0 for v in stages.values())
    assert staged.shape == whole.shape == (24 * 1920,) and np.isfinite(staged).all()
    assert np.abs(staged - whole).max() <= 1.0 / 32767 + 1e-6


def test_doctor_card_probes(card):
    """doctor's two card probes on the card: the device with its name and
    power limit, and every kernel library built for sm_90a and loaded."""
    from go_pocket_tts_tpu_torch.cli.doctor import _probe_cuda, _probe_kernels
    from go_pocket_tts_tpu_torch.device import card_line
    from go_pocket_tts_tpu_torch.kernels import build

    backend = _probe_cuda()
    assert torch.cuda.get_device_name(0) in backend and card_line() in backend and "GiB free" in backend
    libs = _probe_kernels("")
    assert "sm_90a" in libs and "release" in libs
    assert all(build._target(name).name in libs for name in build.SOURCES)


def test_microbench_on_card(card, capsys):
    """One microbench run on the card: the card line, then six ops timed
    with CUDA events."""
    from go_pocket_tts_tpu_torch.bench import microbench
    from go_pocket_tts_tpu_torch.device import card_line

    assert microbench.main(["--reps", "3"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"card: {card_line()}") and len(lines) == 7
    assert all(float(line.split(" p50 ")[1].split()[0]) > 0 for line in lines[1:])


def test_kernel_api_on_card_matches_the_runtime(card):
    """``PocketTTSKernel`` (float32, temperature 0, EOS off) from bytes on
    the card, on ``tiny_arch()`` with 16 heads of the published width and a
    SEANet at the kernels' widths: its one-shot WAV within one PCM16 step
    RMS of ``GPURuntime.generate_audio`` on the same chunk, its progress
    route within chip_smoke.PATH_RMS_TOL of it; kernels 1, 7, 2 and 8
    launch."""
    import chip_smoke
    from go_pocket_tts_tpu_torch.kernel import PocketTTSKernel
    from go_pocket_tts_tpu_torch.models.model import load_model_from_store
    from go_pocket_tts_tpu_torch.text import estimate_max_frames, prepare_chunks
    from go_pocket_tts_tpu_torch.text.sentencepiece import load_tokenizer
    from go_pocket_tts_tpu_torch.utils import wav
    from go_pocket_tts_tpu_torch.utils.safetensors import encode_tensors, open_store_from_bytes

    arch = dataclasses.replace(synthetic.tiny_arch(), d_model=1024, num_heads=16, seanet_channels=(32, 256, 128, 64))
    model_bytes = encode_tensors(synthetic.build_checkpoint(arch, seed=9))
    with tempfile.TemporaryDirectory() as tmp:
        chip_smoke.write_fixture_tokenizer(f"{tmp}/tok.model")
        tok_bytes = open(f"{tmp}/tok.model", "rb").read()
        tok = load_tokenizer(f"{tmp}/tok.model")
    k = PocketTTSKernel(seed=1)
    k.load_model(model_bytes, tok_bytes)
    text = chip_smoke.STREAM_TEXTS[0]
    kernels.reset_launches()
    one_shot = wav.decode_wav(k.synthesize(text, temperature=0.0, eos_threshold=1e9))[0]
    calls = []
    streamed = wav.decode_wav(
        k.synthesize(text, temperature=0.0, eos_threshold=1e9, progress=lambda d, t: calls.append((d, t)))
    )[0]
    launched = (da.decode_attention_step, st.fused_up2_res, st.fused_seanet_up_tail, st.fused_up2_up3_tail)
    assert all(fn.launches > 0 for fn in launched), [fn.launches for fn in launched]
    (chunk,) = prepare_chunks(k.normalize(text), tok)
    frames = estimate_max_frames(chunk.num_tokens)
    rt = GPURuntime(load_model_from_store(open_store_from_bytes(model_bytes), device=card), seed=1, device=card)
    want = rt.generate_audio(chunk.token_ids, GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=frames))
    assert one_shot.shape == streamed.shape == want.shape == (frames * 1920,)
    assert calls[-1] == (frames, frames)
    assert np.sqrt(np.mean((one_shot.astype(np.float64) - want) ** 2)) <= 1.0 / 32767
    assert np.sqrt(np.mean((streamed.astype(np.float64) - want) ** 2)) < chip_smoke.PATH_RMS_TOL


def test_torch_oracle_on_card_matches_the_cpu(card):
    """The torch oracle on the card (true float32 whatever the TF32 flags,
    here switched on) against itself on the CPU, at temperature 0.7 (the
    noise is drawn on the CPU, so one seed gives the same noise) and in a
    carried session; within 1e-5 RMS."""
    from go_pocket_tts_tpu_torch.tts.runtime_torch import TorchRuntime
    from go_pocket_tts_tpu_torch.utils.safetensors import encode_tensors, open_store_from_bytes

    arch = synthetic.tiny_arch()
    data = encode_tensors(synthetic.build_checkpoint(arch, seed=10))
    cfg = GenerateConfig(temperature=0.7, eos_threshold=1e9, max_steps=6)
    outs = {}
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for dev in ("cpu", "cuda"):
            rt = TorchRuntime(open_store_from_bytes(data), num_heads=arch.num_heads, seed=2, device=dev)
            one = rt.generate_audio([3, 17, 41], cfg)
            a, cont = rt.generate_audio_session([3, 17], cfg, None)
            b, _ = rt.generate_audio_session([9, 5], cfg, cont)
            outs[dev] = np.concatenate([one, a, b])
        assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == (True, True)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    assert outs["cuda"].shape == outs["cpu"].shape == (18 * 1920,)
    assert np.sqrt(np.mean((outs["cuda"].astype(np.float64) - outs["cpu"]) ** 2)) < 1e-5
