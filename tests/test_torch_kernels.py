"""The plain versions of the port's CUDA kernels against the Pallas kernels
they replace, run in interpret mode on the CPU as tests/test_pallas.py runs
them, on the same NumPy inputs. The CUDA kernels themselves run only on a
card (tests/test_torch_cuda.py and chip_smoke.py)."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from go_pocket_tts_tpu.ops import TOLERANCES
from go_pocket_tts_tpu.ops import build_rope_tables as j_rope_tables
from go_pocket_tts_tpu.ops import repack_conv_transpose_kernel as j_repack
from go_pocket_tts_tpu.models.quantize import quantize_kv_rows as j_quantize_kv_rows
from go_pocket_tts_tpu.models import params as j_params
from go_pocket_tts_tpu.models.quantize import quantize_linear as j_quantize_linear
from go_pocket_tts_tpu.ops.pallas import int4_matmul as j_i4mm
from go_pocket_tts_tpu.ops.pallas import quantized_matmul as j_qmm
from go_pocket_tts_tpu.ops.pallas import seanet_tail as j_st
from go_pocket_tts_tpu.ops.pallas.batched_decode_attention import batched_decode_attention as j_bda
from go_pocket_tts_tpu.ops.pallas.decode_attention import decode_attention_step as j_decode
from go_pocket_tts_tpu_torch import kernels
from go_pocket_tts_tpu_torch.kernels import batched_decode_attention as t_bda
from go_pocket_tts_tpu_torch.kernels import build
from go_pocket_tts_tpu_torch.kernels import decode_attention as t_da
from go_pocket_tts_tpu_torch.kernels import int4_matmul as t_i4mm
from go_pocket_tts_tpu_torch.kernels import quantized_matmul as t_qmm
from go_pocket_tts_tpu_torch.kernels import seanet_tail as t_st
from go_pocket_tts_tpu_torch.kernels.split_k import MAX_SMEM, matmul_plan, smem_bytes
from go_pocket_tts_tpu_torch.kernels.split_kv import boundary_offsets, split_plan
from go_pocket_tts_tpu_torch.models.params import apply_linear as t_apply_linear
from go_pocket_tts_tpu_torch.ops import build_rope_tables as t_rope_tables

ROOT = Path(__file__).resolve().parent.parent
ATOL, RTOL = TOLERANCES["attention"]
CONV_ATOL, CONV_RTOL = TOLERANCES["conv1d"]


def _np(x) -> np.ndarray:
    return np.array(x, np.float32)  # a writable copy


@pytest.mark.parametrize("offset", [0, 5, 31])
@pytest.mark.parametrize("layer", [0, 1])
def test_decode_attention_plain_matches_pallas(offset, layer):
    n_layers, b, h, c, d = 2, 2, 4, 32, 64
    rng = np.random.RandomState(offset + 10 * layer)
    q, k_new, v_new = (rng.randn(b, h, 1, d).astype(np.float32) for _ in range(3))
    k_cache = (rng.randn(n_layers, b, h, c, d) * 0.3).astype(np.float32)
    v_cache = (rng.randn(n_layers, b, h, c, d) * 0.3).astype(np.float32)
    jc, js = j_rope_tables(64, d)
    want, want_k, want_v = j_decode(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(k_cache), jnp.asarray(v_cache),
        jnp.asarray(v_new), jnp.int32(offset), jc, js, layer=layer, interpret=True,
    )
    tc, ts = t_rope_tables(64, d)
    kc, vc = torch.from_numpy(k_cache.copy()), torch.from_numpy(v_cache.copy())
    got, got_k, got_v = t_da.decode_attention_step(
        torch.from_numpy(q), torch.from_numpy(k_new), kc, vc, torch.from_numpy(v_new),
        torch.tensor(offset, dtype=torch.int32), tc, ts, layer,
    )
    assert got_k is kc and got_v is vc  # appended in place
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_k.numpy(), _np(want_k), atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(got_v.numpy(), _np(want_v), atol=ATOL, rtol=RTOL)


def test_decode_attention_plain_bf16_matches_pallas():
    n_layers, b, h, c, d, offset = 1, 1, 2, 16, 64, 9
    rng = np.random.RandomState(3)
    q, k_new, v_new = (rng.randn(b, h, 1, d).astype(np.float32) for _ in range(3))
    caches = [(rng.randn(n_layers, b, h, c, d) * 0.3).astype(np.float32) for _ in range(2)]
    jc, js = j_rope_tables(64, d)
    want, want_k, _ = j_decode(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k_new, caches[0], caches[1], v_new)),
        jnp.int32(offset), jc, js, layer=0, interpret=True,
    )
    tc, ts = t_rope_tables(64, d)
    args = [torch.from_numpy(a).bfloat16() for a in (q, k_new, caches[0], caches[1], v_new)]
    got, got_k, _ = t_da.decode_attention_step(
        *args, torch.tensor(offset, dtype=torch.int32), tc, ts, 0
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(got_k.float().numpy(), _np(want_k), atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("layer", [0, 2])
def test_batched_decode_attention_plain_matches_pallas(int8, layer):
    n_layers, b, h, c, d = 3, 5, 2, 32, 64
    rng = np.random.RandomState(layer + 10 * int8)
    q = rng.randn(b, h, 1, d).astype(np.float32)
    k, v = ((rng.randn(n_layers, b, h, c, d) * 0.3).astype(np.float32) for _ in range(2))
    offsets = np.array([0, c - 1, 7, 18, 1], np.int32)  # first slot, last slot, in between
    if int8:
        (kq, ks), (vq, vs) = j_quantize_kv_rows(jnp.asarray(k)), j_quantize_kv_rows(jnp.asarray(v))
        want = j_bda(jnp.asarray(q), kq, vq, jnp.asarray(offsets), k_scale=ks, v_scale=vs, layer=layer, interpret=True)
        tk, tks, tv, tvs = (torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs))
        got = t_bda.batched_decode_attention_int8(
            torch.from_numpy(q), tk, tks, tv, tvs, torch.from_numpy(offsets), layer
        )
    else:
        want = j_bda(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(offsets), layer=layer, interpret=True)
        got = t_bda.batched_decode_attention(
            torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(offsets), layer
        )
    assert got.shape == (b, h, 1, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=RTOL)


def test_batched_decode_attention_plain_bf16_matches_pallas():
    n_layers, b, h, c, d = 1, 3, 2, 16, 64
    rng = np.random.RandomState(5)
    q = rng.randn(b, h, 1, d).astype(np.float32)
    k, v = ((rng.randn(n_layers, b, h, c, d) * 0.3).astype(np.float32) for _ in range(2))
    offsets = np.array([15, 0, 9], np.int32)
    want = j_bda(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), jnp.asarray(offsets), layer=0, interpret=True)
    got = t_bda.batched_decode_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), torch.from_numpy(offsets), 0
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), atol=1e-2, rtol=1e-2)


# -- the split-KV plan of kernels 1 and 4, and its arithmetic ------------------


@pytest.mark.parametrize("pairs", [16, 128])
@pytest.mark.parametrize("cap", [16, 40, 320, 384, 640, 1024, 8192])
def test_split_plan_covers_the_cache(cap, pairs):
    splits, rows = split_plan(cap, pairs)
    assert 1 <= splits <= 8 and rows % 16 == 0
    # Split s owns [s*rows, min((s+1)*rows, cap)): every row once, none empty.
    owned = [r for s in range(splits) for r in range(s * rows, min((s + 1) * rows, cap))]
    assert owned == list(range(cap))
    assert (splits - 1) * rows < cap <= splits * rows
    # A capacity off the 16-row grid leaves a masked tail in the last split.
    assert (cap - (splits - 1) * rows < rows) == (cap % rows != 0)


def test_split_plan_fills_the_card():
    assert split_plan(320, 16) == (7, 48)  # kernel 1 at B=1: 112 blocks
    assert split_plan(8192, 16) == (8, 1024)
    assert split_plan(384, 128) == (4, 96)  # kernel 4 at B=8, H=16: 512 blocks
    assert split_plan(40, 16) == (3, 16)
    assert split_plan(384, 4096) == (1, 384)
    with pytest.raises(ValueError):
        split_plan(0, 16)


def _split_merge(q, k, v, n, plan, k_scale=None, v_scale=None) -> torch.Tensor:
    """The split-KV kernels' arithmetic, plainly, in float32: per split a
    (max, sum, acc) over its visible rows, then the combine rescaled by
    exp(m_i - m). q [P, D], k/v [P, C, D], n visible rows per pair, scales
    [P, C]."""
    splits, rows = plan
    pairs, _, d = k.shape
    out = torch.zeros(pairs, d)
    for p in range(pairs):
        parts = []
        for s in range(splits):
            s0, s1 = s * rows, min((s + 1) * rows, int(n[p]))
            if s1 <= s0:  # no visible row: m = -inf, l = 0
                continue
            scores = k[p, s0:s1].float() @ q[p].float()
            if k_scale is not None:
                scores = scores * k_scale[p, s0:s1]
            scores = scores / d**0.5
            m = scores.max()
            e = torch.exp(scores - m)
            w = e * v_scale[p, s0:s1] if v_scale is not None else e
            parts.append((m, e.sum(), w @ v[p, s0:s1].float()))
        if parts:
            gm = max(m for m, _, _ in parts)
            gl = sum(l * torch.exp(m - gm) for m, l, _ in parts)
            out[p] = sum(acc * torch.exp(m - gm) for m, _, acc in parts) / gl
    return out


@pytest.mark.parametrize(
    "cap,offset", [(64, o) for o in boundary_offsets(64, 2)] + [(40, o) for o in boundary_offsets(40, 2)]
)
def test_decode_attention_split_merge_matches_plain_and_pallas(cap, offset):
    """Kernel 1's split-and-merge, emulated, against its plain version and the
    Pallas kernel in interpret mode, at both sides of every split boundary
    (C=64: 4 splits of 16; C=40: 3, the last a masked tail of 8), C-1 and
    past the capacity."""
    n_layers, b, h, d, layer = 1, 1, 2, 64, 0
    rng = np.random.RandomState(cap + offset)
    q, k_new, v_new = (rng.randn(b, h, 1, d).astype(np.float32) for _ in range(3))
    caches = [(rng.randn(n_layers, b, h, cap, d) * 0.3).astype(np.float32) for _ in range(2)]
    jc, js = j_rope_tables(128, d)
    want, _, _ = j_decode(
        *(jnp.asarray(a) for a in (q, k_new, caches[0], caches[1], v_new)),
        jnp.int32(offset), jc, js, layer=layer, interpret=True,
    )
    tc, ts = t_rope_tables(128, d)
    kc, vc = (torch.from_numpy(c.copy()) for c in caches)
    got, kc, vc = t_da.decode_attention_step(
        torch.from_numpy(q), torch.from_numpy(k_new), kc, vc, torch.from_numpy(v_new),
        torch.tensor(offset, dtype=torch.int32), tc, ts, layer,
    )
    row = min(max(offset, 0), tc.shape[0] - 1)
    q_r = t_da._rope_dup(torch.from_numpy(q), tc[row : row + 1], ts[row : row + 1]).reshape(b * h, d)
    n = [min(offset, cap - 1) + 1] * (b * h)
    emu = _split_merge(q_r, kc[layer].reshape(b * h, cap, d), vc[layer].reshape(b * h, cap, d), n, split_plan(cap, b * h))
    np.testing.assert_allclose(emu.numpy(), got.reshape(b * h, d).numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(emu.numpy(), _np(want).reshape(b * h, d), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("cap", [64, 40])
def test_batched_decode_attention_split_merge_matches_plain_and_pallas(int8, cap):
    """Kernel 4's split-and-merge, emulated, against both plain versions and
    the Pallas kernel in interpret mode, one lane per boundary offset."""
    h, d, layer = 2, 64, 0
    offsets = np.array(boundary_offsets(cap, 2 * 16), np.int32)
    b = len(offsets)
    assert split_plan(cap, b * h) == split_plan(cap, 2 * 16)
    rng = np.random.RandomState(cap + int8)
    q = rng.randn(b, h, 1, d).astype(np.float32)
    k, v = ((rng.randn(1, b, h, cap, d) * 0.3).astype(np.float32) for _ in range(2))
    n = [min(int(o), cap - 1) + 1 for o in offsets for _ in range(h)]
    plan = split_plan(cap, b * h)
    tq, toffs = torch.from_numpy(q), torch.from_numpy(offsets)
    if int8:
        (kq, ks), (vq, vs) = j_quantize_kv_rows(jnp.asarray(k)), j_quantize_kv_rows(jnp.asarray(v))
        want = j_bda(jnp.asarray(q), kq, vq, jnp.asarray(offsets), k_scale=ks, v_scale=vs, layer=layer, interpret=True)
        tk, tks, tv, tvs = (torch.from_numpy(np.array(a)) for a in (kq, ks, vq, vs))
        got = t_bda.batched_decode_attention_int8(tq, tk, tks, tv, tvs, toffs, layer)
        flat = (tk[layer].reshape(b * h, cap, d), tv[layer].reshape(b * h, cap, d))
        scales = dict(k_scale=tks[layer].reshape(b * h, cap), v_scale=tvs[layer].reshape(b * h, cap))
    else:
        want = j_bda(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(offsets), layer=layer, interpret=True)
        tk, tv = torch.from_numpy(k), torch.from_numpy(v)
        got = t_bda.batched_decode_attention(tq, tk, tv, toffs, layer)
        flat, scales = (tk[layer].reshape(b * h, cap, d), tv[layer].reshape(b * h, cap, d)), {}
    emu = _split_merge(tq.reshape(b * h, d), *flat, n, plan, **scales)
    np.testing.assert_allclose(emu.numpy(), got.reshape(b * h, d).numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(emu.numpy(), _np(want).reshape(b * h, d), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("m,k,n", [(1, 128, 256), (8, 1024, 3072), (64, 512, 10240)])
def test_quantized_matmul_plain_matches_pallas(m, k, n):
    rng = np.random.RandomState(m + n)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randint(-127, 128, size=(k, n)).astype(np.int8)
    scale = ((rng.rand(n) + 0.5) * 0.01).astype(np.float32)
    want = j_qmm.quantized_matmul(jnp.asarray(x), jnp.asarray(w), jnp.asarray(scale), interpret=True)
    got = t_qmm.quantized_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize(
    "m,k,n", [(1, 128, 256), (64, 1024, 4096), (65, 1024, 4096), (8, 32, 1024), (8, 1024, 1), (8, 512, 32), (8, 100, 512)]
)
def test_quantized_matmul_gate_matches_reference(m, k, n):
    assert t_qmm.supports(m, k, n) == j_qmm.supports(m, k, n)


# -- kernel 5's split-K plan, and its fused epilogue ---------------------------


def _qmm_shapes():
    """``chip_smoke.QMM_SHAPES``: (label, K, N) of the gated int8 linears."""
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.QMM_SHAPES


QMM_SHAPES = _qmm_shapes()


@pytest.mark.parametrize("x_bytes", [2, 4])
@pytest.mark.parametrize("m", [1, 8, 13, 64])
@pytest.mark.parametrize("label,k,n", QMM_SHAPES + (("wide", 256, 17152), ("long", 8192, 256), ("uneven", 1408, 256)))
def test_matmul_plan_covers_k_and_fits_the_card(label, k, n, m, x_bytes):
    plan = matmul_plan(m, k, n, x_bytes)
    assert 1 <= plan.splits <= 8 and plan.block_n in (64, 128) and n % plan.block_n == 0
    assert plan.rows_per_split % 128 == 0 and plan.tile_rows % 128 == 0
    assert 0 < plan.tile_rows <= plan.rows_per_split
    # Split s owns rows [s*R, min((s+1)*R, K)): every row once, none empty.
    r = plan.rows_per_split
    owned = [i for s in range(plan.splits) for i in range(s * r, min((s + 1) * r, k))]
    assert owned == list(range(k))
    assert (plan.splits - 1) * r < k <= plan.splits * r
    assert plan.m_tile % 16 == 0 and m <= plan.m_tile < m + 16
    assert n // plan.block_n <= 65535 and smem_bytes(plan, m, x_bytes) <= MAX_SMEM


def test_matmul_plan_fills_the_card():
    assert matmul_plan(8, 1024, 4096, 2)[:3] == (64, 2, 512)  # linear1: 64 tiles x 2
    assert matmul_plan(8, 4096, 1024, 2)[:3] == (64, 8, 512)  # linear2: 16 tiles x 8
    assert matmul_plan(8, 1024, 3072, 2)[:3] == (64, 2, 512)  # in_proj: 96 blocks, not 144 on 132 SMs
    assert matmul_plan(8, 1024, 1024, 2)[:3] == (64, 4, 256)  # out_proj: two copies a split at least
    assert matmul_plan(8, 512, 1024, 2)[:3] == (64, 2, 256)  # flowNet mlp0
    assert matmul_plan(8, 512, 10240, 2)[:3] == (128, 1, 512)  # fused adaLN: 80 tiles, no cluster
    assert matmul_plan(8, 1408, 256, 2)[:3] == (64, 4, 384)  # the last split 256 rows
    assert matmul_plan(8, 256, 17152, 2)[:3] == (128, 1, 256)  # past the SMs: the fewest blocks
    for label, k, n in QMM_SHAPES:
        plan = matmul_plan(8, k, n, 2)
        assert n // plan.block_n * plan.splits <= 132, label
    assert matmul_plan(64, 8192, 256, 4).tile_rows < 1024  # passes where shared memory is short
    with pytest.raises(ValueError):
        matmul_plan(65, 1024, 4096, 2)


@pytest.mark.parametrize("m,k,n", [(1, 1024, 3072), (13, 512, 1024), (64, 8192, 256)])
def test_split_k_sum_matches_plain(m, k, n):
    """The kernel's float32 summation in NumPy: per split, per pass, each
    warp part its k16 steps (round-robin), the parts then the splits added in
    order; equal to the plain version within the float32 budget, so the plan
    and the step assignment cover every row once."""
    rng = np.random.RandomState(k)
    x = rng.randn(m, k).astype(np.float32)
    w = rng.randint(-127, 128, size=(k, n)).astype(np.int8)
    scale = ((rng.rand(n) + 0.5) * 0.01).astype(np.float32)
    plan = matmul_plan(m, k, n, 4)
    parts_per_block = 256 // plan.block_n
    total = np.zeros((m, n), np.float32)
    for s in range(plan.splits):
        k0 = s * plan.rows_per_split
        rows = min(plan.rows_per_split, k - k0)
        parts = np.zeros((parts_per_block, m, n), np.float32)
        for p0 in range(0, rows, plan.tile_rows):
            for step in range(min(plan.tile_rows, rows - p0) // 16):
                lo = k0 + p0 + 16 * step
                parts[step % parts_per_block] += x[:, lo : lo + 16] @ w[lo : lo + 16].astype(np.float32)
        total += parts.sum(axis=0)
    want = t_qmm.quantized_matmul_plain(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale))
    np.testing.assert_allclose(total * scale, want.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("k,n", [(128, 256), (512, 1024)])
def test_quantized_matmul_plain_epilogue_matches_apply_linear(k, n, m, dtype):
    """The fused form (bias, output in the activation dtype) against JAX's
    apply_linear through the Pallas kernel in interpret mode, on int8 params
    with a bias. float32 within the attention budget; bfloat16 within one
    bf16 ulp (2^-7 relative) of the float32 product and of the result: both
    round the float32 product, whose sums run in another order, then add."""
    rng = np.random.RandomState(m * n + k)
    x = rng.randn(m, k).astype(np.float32)
    p = {"w": (rng.randn(k, n) / np.sqrt(k)).astype(np.float32), "b": rng.randn(n).astype(np.float32)}
    jq = j_quantize_linear({key: jnp.asarray(v) for key, v in p.items()})
    tq = {key: torch.from_numpy(np.array(v)) for key, v in jq.items()}
    jx = jnp.asarray(x) if dtype == np.float32 else jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x) if dtype == np.float32 else torch.from_numpy(x).bfloat16()
    previous = j_params._QUANT_BACKEND
    try:
        j_params.set_quantized_matmul_backend("pallas:interpret")
        want = _np(j_params.apply_linear(jq, jx).astype(jnp.float32))
    finally:
        j_params.set_quantized_matmul_backend(previous)
    got = t_qmm.quantized_matmul_plain(tx, tq["w"], tq["scale"], bias=tq["b"], out_dtype=tx.dtype)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    assert torch.equal(t_apply_linear(tq, tx), got)  # the CPU wrapper is the plain version
    if dtype == np.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    else:
        y = t_qmm.quantized_matmul_plain(tx, tq["w"], tq["scale"]).numpy()
        err = np.abs(got.float().numpy() - want)
        assert (err <= 2.0**-7 * (np.abs(y) + np.abs(want))).all(), err.max()


def test_quantized_matmul_plain_out_dtype_and_bias_forms():
    """Without a bias and with a float32 output the plain version is the
    Pallas kernel's product; each other form rounds it to x's dtype first."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(3, 128).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randint(-127, 128, size=(128, 256)).astype(np.int8))
    scale = torch.from_numpy(((rng.rand(256) + 0.5) * 0.01).astype(np.float32))
    b = torch.from_numpy(rng.randn(256).astype(np.float32))
    y = torch.matmul(x.float(), w.float()) * scale
    assert torch.equal(t_qmm.quantized_matmul_plain(x, w, scale), y)
    assert torch.equal(t_qmm.quantized_matmul_plain(x, w, scale, out_dtype=torch.bfloat16), y.bfloat16())
    with_b = y.bfloat16() + b.bfloat16()
    assert torch.equal(t_qmm.quantized_matmul_plain(x, w, scale, b, torch.bfloat16), with_b)
    assert torch.equal(t_qmm.quantized_matmul_plain(x, w, scale, b.bfloat16()), with_b.float())


# The shapes of tests/test_pallas.py's int4 kernel test.
@pytest.mark.parametrize("m,k,n", [(8, 256, 512), (8, 1024, 512), (4, 512, 256), (16, 384, 768), (1, 256, 256)])
def test_int4_matmul_plain_matches_pallas(m, k, n):
    rng = np.random.RandomState(k + n)
    x = rng.randn(m, k).astype(np.float32)
    q = j_quantize_linear({"w": jnp.asarray(rng.randn(k, n).astype(np.float32) / np.sqrt(k))}, bits=4)
    w, scale = _np(q["w"]).astype(np.uint8), _np(q["scale"])
    assert scale.shape == (k // 128, n) and t_i4mm.supports(m, k, n, scale.shape)
    x2 = jnp.moveaxis(jnp.asarray(x).reshape(m, k // 2, 2), -1, 0)  # the reference's even/odd planes
    want = j_i4mm.int4_matmul(x2, jnp.asarray(w), jnp.asarray(scale), interpret=True)
    got = t_i4mm.int4_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(scale))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=1e-4, rtol=1e-4)  # f32 sums, another order


def test_int4_matmul_plain_decodes_every_code():
    """Every byte (both nibbles over -8..7, the artifact's -8 included)
    against a weight decoded by hand; one group, scale 1."""
    packed = np.arange(256, dtype=np.uint8).reshape(64, 4).repeat(64, axis=1)  # [64, 256]
    levels = np.empty((128, 256), np.float32)
    levels[0::2] = (packed & 0x0F).astype(np.int8) - 16 * ((packed & 0x0F) >= 8)
    levels[1::2] = (packed >> 4).astype(np.int8) - 16 * ((packed >> 4) >= 8)
    assert levels.min() == -8 and levels.max() == 7
    x = np.random.RandomState(1).randn(3, 128).astype(np.float32)
    got = t_i4mm.int4_matmul(torch.from_numpy(x), torch.from_numpy(packed), torch.ones((1, 256)))
    np.testing.assert_allclose(got.numpy(), x @ levels, atol=1e-4, rtol=1e-5)


# -- kernel 6 on kernel 5's split-K plan, and its fused epilogue ----------------

PLAN_SHAPES = QMM_SHAPES + (("wide", 256, 17152), ("long", 8192, 256), ("uneven", 1408, 256))

# matmul_plan's int8 plans before it took w_bits: per (K, N), for M in 1, 8,
# 13, 64 and x of 2 then 4 bytes, (block_n, splits, rows_per_split,
# tile_rows, parts_apart).
INT8_PLANS = {
    (1024, 3072): [(64, 2, 512, 512, 1)] * 6 + [(64, 2, 512, 512, 0)] * 2,
    (1024, 1024): [(64, 4, 256, 256, 1)] * 6 + [(64, 4, 256, 256, 0)] * 2,
    (1024, 4096): [(64, 2, 512, 512, 1)] * 6 + [(64, 2, 512, 512, 0)] * 2,
    (4096, 1024): [(64, 8, 512, 512, 1)] * 6 + [(64, 5, 896, 896, 0), (64, 5, 896, 640, 0)],
    (1024, 512): [(64, 4, 256, 256, 1)] * 6 + [(64, 4, 256, 256, 0)] * 2,
    (512, 1024): [(64, 2, 256, 256, 1)] * 6 + [(64, 2, 256, 256, 0)] * 2,
    (512, 10240): [(128, 1, 512, 512, 1)] * 6 + [(128, 1, 512, 512, 0)] * 2,
    (256, 17152): [(128, 1, 256, 256, 1)] * 6 + [(128, 1, 256, 256, 0)] * 2,
    (8192, 256): [(64, 8, 1024, 1024, 1)] + [(64, 8, 1024, 1024, 0)] * 5
    + [(64, 5, 1664, 1152, 0), (64, 5, 1664, 640, 0)],
    (1408, 256): [(64, 4, 384, 384, 1)] * 6 + [(64, 4, 384, 384, 0)] * 2,
}


@pytest.mark.parametrize("label,k,n", PLAN_SHAPES)
def test_matmul_plan_int8_is_unchanged_by_w_bits(label, k, n):
    got = [
        tuple(int(v) for v in matmul_plan(m, k, n, x_bytes, w_bits=8)[:4]) + (int(matmul_plan(m, k, n, x_bytes)[5]),)
        for m in (1, 8, 13, 64)
        for x_bytes in (2, 4)
    ]
    assert got == INT8_PLANS[(k, n)], label
    for m in (1, 8, 13, 64):
        assert matmul_plan(m, k, n, 2, w_bits=8) == matmul_plan(m, k, n, 2)


@pytest.mark.parametrize("m", [1, 8, 13, 64])
@pytest.mark.parametrize("label,k,n", PLAN_SHAPES)
def test_matmul_plan_int4_covers_k_in_whole_groups_and_fits_the_card(label, k, n, m):
    for x_bytes in (2, 4):
        plan = matmul_plan(m, k, n, x_bytes, w_bits=4)
        assert 1 <= plan.splits <= 8 and plan.block_n in (64, 128) and n % plan.block_n == 0
        # Whole 128-row scale groups per split and per staged pass.
        assert plan.rows_per_split % 128 == 0 and plan.tile_rows % 128 == 0
        assert 0 < plan.tile_rows <= min(plan.rows_per_split, 2048)
        r = plan.rows_per_split
        owned = [i for s in range(plan.splits) for i in range(s * r, min((s + 1) * r, k))]
        assert owned == list(range(k))
        assert (plan.splits - 1) * r < k <= plan.splits * r
        assert plan.m_tile % 16 == 0 and m <= plan.m_tile < m + 16
        assert n // plan.block_n <= 65535 and smem_bytes(plan, m, x_bytes, w_bits=4) <= MAX_SMEM
        # Half the weight bytes a row: the grid is int8's, and as many rows fit at once.
        assert plan[:3] == matmul_plan(m, k, n, x_bytes)[:3]
        assert plan.tile_rows >= matmul_plan(m, k, n, x_bytes).tile_rows


@pytest.mark.parametrize("m,k,n", [(1, 1024, 3072), (13, 512, 1024), (64, 8192, 256)])
def test_split_k_int4_sum_matches_plain(m, k, n):
    """Kernel 6's float32 summation in NumPy: per split, per pass, per
    128-row group, each warp part sums its k16 steps (round-robin), times the
    group's scale, into its accumulator; the parts then the splits added in
    order. Equal to the plain version within the float32 budget, so the plan
    covers every row once and every group gets its own scale."""
    rng = np.random.RandomState(k + 1)
    x = rng.randn(m, k).astype(np.float32)
    levels = rng.randint(-8, 8, size=(k, n)).astype(np.int8)
    packed = ((levels[0::2] & 0x0F) | ((levels[1::2] & 0x0F) << 4)).astype(np.uint8)
    scale = ((rng.rand(k // 128, n) + 0.5) * 0.01).astype(np.float32)
    plan = matmul_plan(m, k, n, 4, w_bits=4)
    parts_per_block = 256 // plan.block_n
    total = np.zeros((m, n), np.float32)
    for s in range(plan.splits):
        k0 = s * plan.rows_per_split
        rows = min(plan.rows_per_split, k - k0)
        acc = np.zeros((parts_per_block, m, n), np.float32)
        for p0 in range(0, rows, plan.tile_rows):
            for g0 in range(k0 + p0, k0 + p0 + min(plan.tile_rows, rows - p0), 128):
                part = np.zeros((parts_per_block, m, n), np.float32)
                for step in range(8):
                    lo = g0 + 16 * step
                    part[step % parts_per_block] += x[:, lo : lo + 16] @ levels[lo : lo + 16].astype(np.float32)
                acc += part * scale[g0 // 128]
        total += acc.sum(axis=0)
    want = t_i4mm.int4_matmul_plain(torch.from_numpy(x), torch.from_numpy(packed), torch.from_numpy(scale))
    np.testing.assert_allclose(total, want.numpy(), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
@pytest.mark.parametrize("m", [1, 8])
@pytest.mark.parametrize("k,n", [(256, 256), (512, 1024)])
def test_int4_matmul_plain_epilogue_matches_apply_linear(k, n, m, dtype):
    """The fused form (bias, output in the activation dtype) against JAX's
    apply_linear through the Pallas int4 kernel in interpret mode, on
    group-wise int4 params with a bias. float32 within the attention budget;
    bfloat16 within one bf16 ulp (2^-7 relative) of the float32 product and
    of the result: both round the float32 product, whose sums run in another
    order, then add."""
    rng = np.random.RandomState(m * n + k + 4)
    x = rng.randn(m, k).astype(np.float32)
    p = {"w": (rng.randn(k, n) / np.sqrt(k)).astype(np.float32), "b": rng.randn(n).astype(np.float32)}
    jq = j_quantize_linear({key: jnp.asarray(v) for key, v in p.items()}, bits=4)
    tq = {key: torch.from_numpy(np.array(v)) for key, v in jq.items()}
    assert tq["w"].dtype == torch.uint8 and tuple(tq["scale"].shape) == (k // 128, n)
    jx = jnp.asarray(x) if dtype == np.float32 else jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x) if dtype == np.float32 else torch.from_numpy(x).bfloat16()
    previous = j_params._INT4_VARIANT
    try:
        j_params.set_int4_matmul_variant("pallas:interpret")
        want = _np(j_params.apply_linear(jq, jx).astype(jnp.float32))
    finally:
        j_params.set_int4_matmul_variant(previous)
    got = t_i4mm.int4_matmul_plain(tx, tq["w"], tq["scale"], bias=tq["b"], out_dtype=tx.dtype)
    assert got.dtype == tx.dtype and got.shape == (m, n)
    assert torch.equal(t_apply_linear(tq, tx), got)  # the CPU wrapper is the plain version
    if dtype == np.float32:
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    else:
        y = t_i4mm.int4_matmul_plain(tx, tq["w"], tq["scale"]).numpy()
        err = np.abs(got.float().numpy() - want)
        assert (err <= 2.0**-7 * (np.abs(y) + np.abs(want))).all(), err.max()


def test_int4_matmul_plain_out_dtype_and_bias_forms():
    """Without a bias and with a float32 output the plain version is the
    Pallas kernel's product; each other form rounds it to x's dtype first."""
    rng = np.random.RandomState(6)
    x = torch.from_numpy(rng.randn(3, 256).astype(np.float32)).bfloat16()
    w = torch.from_numpy(rng.randint(0, 256, size=(128, 256)).astype(np.uint8))
    scale = torch.from_numpy(((rng.rand(2, 256) + 0.5) * 0.01).astype(np.float32))
    b = torch.from_numpy(rng.randn(256).astype(np.float32))
    y = t_i4mm.int4_matmul_plain(x, w, scale)
    assert y.dtype == torch.float32
    assert torch.equal(t_i4mm.int4_matmul(x, w, scale), y)
    assert torch.equal(t_i4mm.int4_matmul_plain(x, w, scale, out_dtype=torch.bfloat16), y.bfloat16())
    with_b = y.bfloat16() + b.bfloat16()
    assert torch.equal(t_i4mm.int4_matmul_plain(x, w, scale, b, torch.bfloat16), with_b)
    assert torch.equal(t_i4mm.int4_matmul_plain(x, w, scale, b.bfloat16()), with_b.float())
    assert torch.equal(t_i4mm.int4_matmul(x, w, scale, b, torch.bfloat16), with_b)


@pytest.mark.parametrize(
    "m,k,n,scale_shape",
    [(8, 256, 512, (2, 512)), (64, 1024, 4096, (8, 4096)), (65, 256, 512, (2, 512)), (8, 256, 100, (2, 100)),
     (8, 256, 512, (512,)), (8, 512, 512, (2, 512)), (8, 100, 512, (1, 512)), (8, 128, 256, (1, 256))],
)
def test_int4_matmul_gate_matches_reference(m, k, n, scale_shape):
    assert t_i4mm.supports(m, k, n, scale_shape) == j_i4mm.supports(m, k, n, scale_shape)


def _tail_weights(rng):
    return [
        (rng.randn(*shape) * 0.1).astype(np.float32)
        for shape in ((32, 64, 3), (32,), (64, 32, 1), (64,), (1, 64, 7), (1,))
    ]


@pytest.mark.parametrize("blocks,batch", [(1, 1), (2, 2)])
def test_fused_seanet_up_tail_plain_matches_pallas(blocks, batch):
    rng = np.random.RandomState(blocks + 3 * batch)
    x = (rng.randn(batch, 128, 512 * blocks) * 0.5).astype(np.float32)
    wu = _np(j_repack(jnp.asarray((rng.randn(128, 64, 8) * 0.1).astype(np.float32))))
    bu = (rng.randn(64) * 0.1).astype(np.float32)
    tail = _tail_weights(rng)
    want = j_st.fused_seanet_up_tail(*(jnp.asarray(a) for a in (x, wu, bu, *tail)), interpret=True)
    got = t_st.fused_seanet_up_tail(*(torch.from_numpy(a) for a in (x, wu, bu, *tail)))
    assert got.shape == (batch, 1, 4 * 512 * blocks)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=CONV_ATOL, rtol=CONV_RTOL)


@pytest.mark.parametrize("blocks,batch", [(1, 1), (2, 2)])
def test_fused_seanet_tail_plain_matches_pallas(blocks, batch):
    rng = np.random.RandomState(blocks * 10 + batch)
    x = (rng.randn(batch, 64, 1920 * blocks) * 0.5).astype(np.float32)
    tail = _tail_weights(rng)
    want = j_st.fused_seanet_tail(*(jnp.asarray(a) for a in (x, *tail)), interpret=True)
    got = t_st.fused_seanet_tail(*(torch.from_numpy(a) for a in (x, *tail)))
    assert got.shape == (batch, 1, 1920 * blocks)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=CONV_ATOL, rtol=CONV_RTOL)


@pytest.mark.parametrize("t", [0, 1920, 3840, 2000, 1919 * 2])
def test_tail_gate_matches_reference(t):
    assert t_st.supports(t) == j_st.supports(t)


@pytest.mark.parametrize("c_in,t_in,k", [(128, 512, 8), (128, 1024, 8), (128, 480, 8), (64, 512, 8), (128, 512, 10)])
def test_up_tail_gate_matches_reference(c_in, t_in, k):
    assert t_st.supports_up(c_in, t_in, k) == j_st.supports_up(c_in, t_in, k)


def test_cpu_tensors_take_the_plain_versions_and_count_no_launch():
    kernels.reset_launches()
    rng = np.random.RandomState(0)
    x = torch.from_numpy((rng.randn(1, 64, 1920) * 0.5).astype(np.float32))
    tail = [torch.from_numpy(a) for a in _tail_weights(rng)]
    assert torch.equal(t_st.fused_seanet_tail(x, *tail), t_st.fused_seanet_tail_plain(x, *tail))
    rng_q = torch.from_numpy(rng.randn(2, 128).astype(np.float32))
    w = torch.ones((128, 256), dtype=torch.int8)
    assert torch.equal(t_qmm.quantized_matmul(rng_q, w, torch.ones(256)), t_qmm.quantized_matmul_plain(rng_q, w, torch.ones(256)))
    w4 = torch.full((64, 256), 0x9F, dtype=torch.uint8)
    assert torch.equal(t_i4mm.int4_matmul(rng_q, w4, torch.ones((1, 256))), t_i4mm.int4_matmul_plain(rng_q, w4, torch.ones((1, 256))))
    assert [fn.launches for fn in kernels.WRAPPERS] == [0] * len(kernels.WRAPPERS)


def test_wrappers_and_meta_line_up():
    names = [fn.__name__ for fn in kernels.WRAPPERS]
    assert names == [
        "decode_attention_step",
        "fused_seanet_up_tail",
        "fused_seanet_tail",
        "batched_decode_attention",
        "batched_decode_attention_int8",
        "quantized_matmul",
        "int4_matmul",
        "fused_up2_res",
        "fused_up2_up3_tail",
        "layer_norm",
        "mamba2_step",
        "rms_norm",
    ]
    assert len(kernels.META) == len(kernels.WRAPPERS)
    for meta in kernels.META:
        path, line = meta["replaces"].rsplit(":", 1)
        src = (ROOT / path).read_text(encoding="utf-8").splitlines()
        assert src[int(line) - 1].startswith("def "), meta
        assert (ROOT / meta["source"]).read_text(encoding="utf-8")


def test_build_targets_hash_source_and_flags():
    paths = {name: build._target(name) for name in build.SOURCES}
    assert len(set(paths.values())) == len(build.SOURCES)
    for name, path in paths.items():
        assert path.parent == build.BUILD_DIR and path.name.startswith(f"lib{name}-")
        assert (build.CSRC / f"{name}.cu").exists()
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", "/nonexistent-cuda")
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build._nvcc()


def _up2_inputs(rng, batch, t_in):
    x = (rng.randn(batch, 256, t_in) * 0.5).astype(np.float32)
    wu2 = _np(j_repack(jnp.asarray((rng.randn(256, 128, 10) * 0.05).astype(np.float32))))
    up2 = [wu2] + [
        (rng.randn(*shape) * 0.1).astype(np.float32) for shape in ((128,), (64, 128, 3), (64,), (128, 64, 1), (128,))
    ]
    return x, up2


def _up3_tail_inputs(rng):
    wu3 = _np(j_repack(jnp.asarray((rng.randn(128, 64, 8) * 0.1).astype(np.float32))))
    return [wu3, (rng.randn(64) * 0.1).astype(np.float32)] + _tail_weights(rng)


@pytest.mark.parametrize("blocks,batch", [(1, 1), (2, 2)])
def test_fused_up2_res_plain_matches_pallas(blocks, batch):
    rng = np.random.RandomState(blocks + 7 * batch)
    x, up2 = _up2_inputs(rng, batch, 128 * blocks)
    want = j_st.fused_up2_res(*(jnp.asarray(a) for a in (x, *up2)), interpret=True)
    got = t_st.fused_up2_res(*(torch.from_numpy(a) for a in (x, *up2)))
    assert got.shape == (batch, 128, 5 * 128 * blocks) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _np(want), atol=CONV_ATOL, rtol=CONV_RTOL)


def test_fused_up2_up3_tail_plain_matches_pallas():
    rng = np.random.RandomState(13)
    x, up2 = _up2_inputs(rng, 1, 128)
    rest = _up3_tail_inputs(rng)
    want = j_st.fused_up2_up3_tail(*(jnp.asarray(a) for a in (x, *up2, *rest)), interpret=True)
    got = t_st.fused_up2_up3_tail(*(torch.from_numpy(a) for a in (x, *up2, *rest)))
    assert got.shape == (1, 1, 20 * 128)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=CONV_ATOL, rtol=CONV_RTOL)


def test_fused_up2_up3_tail_plain_matches_xla_chain():
    """Blocks 3, batch 2 against the JAX package's five-stage op chain (the
    reference the Pallas cascade is held to)."""
    import jax

    from go_pocket_tts_tpu.ops.conv import causal_conv1d, conv_transpose1d_trim

    rng = np.random.RandomState(3 + 13 * 2)
    x, up2 = _up2_inputs(rng, 2, 3 * 128)
    rest = _up3_tail_inputs(rng)
    wu2, bu2, w1r2, b1r2, w2r2, b2r2 = (jnp.asarray(a) for a in up2)
    wu3, bu3, w1r3, b1r3, w2r3, b2r3, wf, bf = (jnp.asarray(a) for a in rest)
    y2 = conv_transpose1d_trim(jnp.asarray(x), wu2, bu2, 5, 1)
    h = causal_conv1d(jax.nn.elu(causal_conv1d(jax.nn.elu(y2), w1r2, b1r2)), w2r2, b2r2)
    y3 = conv_transpose1d_trim(jax.nn.elu(y2 + h), wu3, bu3, 4, 1)
    r = causal_conv1d(jax.nn.elu(causal_conv1d(jax.nn.elu(y3), w1r3, b1r3)), w2r3, b2r3)
    want = causal_conv1d(jax.nn.elu(y3 + r), wf, bf)
    got = t_st.fused_up2_up3_tail(*(torch.from_numpy(a) for a in (x, *up2, *rest)))
    assert got.shape == want.shape == (2, 1, 20 * 3 * 128)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=CONV_ATOL, rtol=CONV_RTOL)


def test_fused_up2_up3_tail_stream_concatenates_to_whole():
    """Blocks of 1, 3 and 4 latent frames (96 up2-input columns each) with a
    carried halo and per-lane ``start``: lane 1 joins at the second block
    (start 0, zero halo) beside lane 0 (start 96), so a batch mixes both
    kinds of lane; each lane's blocks concatenate to its whole-sequence
    output."""
    rng = np.random.RandomState(5)
    x, up2 = _up2_inputs(rng, 2, 96 * 8)
    weights = [torch.from_numpy(a) for a in (*up2, *_up3_tail_inputs(rng))]
    xt = torch.from_numpy(x)
    whole = [t_st.fused_up2_up3_tail(xt[i : i + 1], *weights) for i in range(2)]
    halo = torch.zeros((2, 256, t_st.HALO))
    start = torch.zeros((2,), dtype=torch.int32)
    pos = [0, 0]
    outs = [[], []]
    for frames, lanes_live in ((1, (True, False)), (3, (True, True)), (4, (True, True))):
        n = 96 * frames
        blk = torch.stack([xt[i, :, pos[i] : pos[i] + n] for i in range(2)])
        pcm = t_st.fused_up2_up3_tail_stream(blk, halo, start, *weights)
        assert pcm.shape == (2, 1, 20 * n)
        for i, live in enumerate(lanes_live):
            if live:
                outs[i].append(pcm[i : i + 1])
                pos[i] += n
        keep = torch.tensor(lanes_live)
        halo = torch.where(keep[:, None, None], torch.cat([halo, blk], dim=2)[:, :, -t_st.HALO :], halo)
        start = torch.where(keep, start + n, start)
    for i in range(2):
        got = torch.cat(outs[i], dim=2)
        np.testing.assert_allclose(got.numpy(), whole[i][..., : got.shape[-1]].numpy(), atol=1e-5, rtol=1e-5)
    assert pos == [96 * 8, 96 * 7]


@pytest.mark.parametrize("c_in,t_in,k", [(256, 128, 10), (256, 1536, 10), (256, 96, 10), (128, 128, 10), (256, 128, 8), (256, 0, 10)])
def test_up2_gate_matches_reference(c_in, t_in, k):
    assert t_st.supports_up2(c_in, t_in, k) == j_st.supports_up2(c_in, t_in, k)


@pytest.mark.parametrize(
    "c_in,t_in,k2,k3",
    [(256, 128, 10, 8), (256, 384, 10, 8), (256, 96, 10, 8), (128, 128, 10, 8), (256, 128, 8, 8), (256, 128, 10, 10)],
)
def test_cascade_gate_matches_reference(c_in, t_in, k2, k3):
    assert t_st.supports_cascade(c_in, t_in, k2, k3) == j_st.supports_cascade(c_in, t_in, k2, k3)
    # The CUDA cascade's own gate takes every block of whole latent frames.
    assert t_st.supports_stream(c_in, t_in, k2, k3) == (c_in == 256 and (k2, k3) == (10, 8) and t_in % 32 == 0)
