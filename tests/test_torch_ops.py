"""The port's ops (go_pocket_tts_tpu_torch.ops) against the JAX package's,
on the CPU, on the same NumPy inputs; budgets from ``ops.TOLERANCES``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from go_pocket_tts_tpu import ops as jops
from go_pocket_tts_tpu.ops import conv as jconv
from go_pocket_tts_tpu.ops import rope as jrope
from go_pocket_tts_tpu.ops.local_attention import local_windowed_attention as j_local
from go_pocket_tts_tpu_torch import ops as tops
from go_pocket_tts_tpu_torch.ops import conv as tconv
from go_pocket_tts_tpu_torch.ops.local_attention import local_windowed_attention as t_local

TOL = jops.TOLERANCES


def close(got: torch.Tensor, want, kind: str) -> None:
    atol, rtol = TOL[kind]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=rtol)


def rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def test_tolerances_are_the_reference_budgets():
    assert tops.TOLERANCES == jops.TOLERANCES


@pytest.mark.parametrize("name", ["gelu_erf", "silu", "elu"])
def test_activations(name):
    x = rand(np.random.RandomState(0), 4, 33, scale=3.0)
    close(getattr(tops, name)(torch.from_numpy(x)), getattr(jops, name)(jnp.asarray(x)), "linear")


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm(affine):
    rng = np.random.RandomState(1)
    x, w, b = rand(rng, 3, 5, 48, scale=2.0), rand(rng, 48), rand(rng, 48)
    args_t = (torch.from_numpy(w), torch.from_numpy(b)) if affine else ()
    args_j = (jnp.asarray(w), jnp.asarray(b)) if affine else ()
    close(
        tops.layer_norm(torch.from_numpy(x), *args_t, eps=1e-6),
        jops.layer_norm(jnp.asarray(x), *args_j, eps=1e-6),
        "layer_norm",
    )


def test_rms_norm_bessel_and_modulate():
    rng = np.random.RandomState(2)
    x, alpha, shift, scale = rand(rng, 2, 32), rand(rng, 32), rand(rng, 2, 32), rand(rng, 2, 32)
    close(
        tops.rms_norm_bessel(torch.from_numpy(x), torch.from_numpy(alpha)),
        jops.rms_norm_bessel(jnp.asarray(x), jnp.asarray(alpha)),
        "layer_norm",
    )
    close(
        tops.modulate(*(torch.from_numpy(a) for a in (x, shift, scale))),
        jops.modulate(*(jnp.asarray(a) for a in (x, shift, scale))),
        "linear",
    )


def test_rope_tables():
    tc, ts = tops.build_rope_tables(512, 16, 10000.0)
    jc, js = jops.build_rope_tables(512, 16, 10000.0)
    close(tc, jc, "rope")
    close(ts, js, "rope")


@pytest.mark.parametrize("pos", [0, 7, 300])
def test_apply_rope_at_offset(pos):
    x = rand(np.random.RandomState(pos), 1, 2, 5, 16)
    jc, js = jops.build_rope_tables(512, 16)
    tc, ts = tops.build_rope_tables(512, 16)
    want = jops.apply_rope(jnp.asarray(x), jc, js, jnp.int32(pos))
    close(tops.apply_rope(torch.from_numpy(x), tc, ts, torch.tensor(pos, dtype=torch.int32)), want, "rope")
    c, s = tops.rope_rows(tc, ts, pos, 5)
    jrc, jrs = jrope.rope_rows(jc, js, jnp.int32(pos), 5)
    close(c, jrc, "rope")
    close(tops.apply_rope_rows(torch.from_numpy(x), c, s), jrope.apply_rope_rows(jnp.asarray(x), jrc, jrs), "rope")


@pytest.mark.parametrize("context", [None, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_with_positions(context, dtype):
    rng = np.random.RandomState(3)
    q, k, v = rand(rng, 2, 3, 4, 8), rand(rng, 2, 3, 9, 8), rand(rng, 2, 3, 9, 8)
    pos_q = np.array([5, 6, 7, 8], np.int32)
    pos_k = np.array([-1, 0, 1, 2, 3, 4, 5, 6, -1], np.int32)  # -1: unused slots
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = tops.attention_with_positions(
        *(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
        torch.from_numpy(pos_q),
        torch.from_numpy(pos_k),
        context,
    )
    want = jops.attention_with_positions(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), jnp.asarray(pos_q), jnp.asarray(pos_k), context
    )
    assert got.dtype == tdt
    if dtype == "float32":
        close(got, want, "attention")
    else:  # one bf16 rounding of the output apart
        np.testing.assert_allclose(
            got.float().numpy(), np.asarray(want, np.float32), atol=2e-2, rtol=2e-2
        )


def test_attention_fully_masked_rows_are_zero():
    q = torch.ones(1, 1, 2, 4)
    k = v = torch.ones(1, 1, 3, 4)
    out = tops.attention_with_positions(
        q, k, v, torch.tensor([0, 1]), torch.tensor([-1, -1, -1], dtype=torch.int64)
    )
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("t", [512, 768])
def test_local_windowed_attention(t):
    rng = np.random.RandomState(t)
    q, k, v = (rand(rng, 1, 2, t, 8) for _ in range(3))
    got = t_local(*(torch.from_numpy(a) for a in (q, k, v)), 250, 256)
    close(got, j_local(*(jnp.asarray(a) for a in (q, k, v)), 250, 256), "attention")
    pos = torch.arange(t, dtype=torch.int32)
    dense = tops.attention_with_positions(*(torch.from_numpy(a) for a in (q, k, v)), pos, pos, 250)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize(
    "stride,dilation,groups,k", [(1, 1, 1, 7), (1, 2, 1, 3), (2, 1, 1, 4), (1, 1, 4, 3)]
)
def test_causal_conv1d(stride, dilation, groups, k):
    rng = np.random.RandomState(k + stride)
    x, w, b = rand(rng, 2, 8, 40), rand(rng, 12, 8 // groups, k), rand(rng, 12)
    got = tops.causal_conv1d(*(torch.from_numpy(a) for a in (x, w, b)), stride, dilation, groups)
    want = jops.causal_conv1d(*(jnp.asarray(a) for a in (x, w, b)), stride, dilation, groups)
    close(got, want, "conv1d")


def test_conv1d_explicit_padding():
    rng = np.random.RandomState(9)
    x, w = rand(rng, 1, 4, 20), rand(rng, 3, 4, 5)
    got = tops.conv1d(torch.from_numpy(x), torch.from_numpy(w), None, 1, 3, 2)
    close(got, jops.conv1d(jnp.asarray(x), jnp.asarray(w), None, 1, 3, 2), "conv1d")


@pytest.mark.parametrize("groups", [1, 4])
def test_repack_conv_transpose_kernel(groups):
    w = rand(np.random.RandomState(groups), 8, 3, 5)  # [I, O/g, K]
    got = tops.repack_conv_transpose_kernel(torch.from_numpy(w), groups)
    want = jops.repack_conv_transpose_kernel(jnp.asarray(w), groups)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tconv.unpack_conv_transpose_kernel(got, groups)
    np.testing.assert_array_equal(back.numpy(), w)


@pytest.mark.parametrize(
    "c_in,c_out,k,stride,groups",
    [(8, 6, 8, 4, 1), (6, 4, 10, 5, 1), (8, 8, 32, 16, 8), (4, 3, 3, 4, 1)],
)
def test_conv_transpose1d_trim(c_in, c_out, k, stride, groups):
    rng = np.random.RandomState(k)
    x = rand(rng, 2, c_in, 12)
    w = tops.repack_conv_transpose_kernel(torch.from_numpy(rand(rng, c_in, c_out // groups, k)), groups)
    b = rand(rng, c_out)
    got = tops.conv_transpose1d_trim(torch.from_numpy(x), w, torch.from_numpy(b), stride, groups)
    want = jops.conv_transpose1d_trim(jnp.asarray(x), jnp.asarray(w.numpy()), jnp.asarray(b), stride, groups)
    assert got.shape == (2, c_out, 12 * stride)
    close(got, want, "conv_transpose1d")
    if groups == 1:
        phases = tops.conv_transpose1d_phases(torch.from_numpy(x), w, torch.from_numpy(b), stride)
        jphases = jconv.conv_transpose1d_phases(jnp.asarray(x), jnp.asarray(w.numpy()), jnp.asarray(b), stride)
        close(phases, jphases, "conv_transpose1d")


def test_conv_bf16_rounds_like_the_reference():
    rng = np.random.RandomState(11)
    x, w, b = rand(rng, 1, 8, 30), rand(rng, 4, 8, 3), rand(rng, 4)
    got = tops.causal_conv1d(*(torch.from_numpy(a).bfloat16() for a in (x, w, b)))
    want = jops.causal_conv1d(*(jnp.asarray(a, jnp.bfloat16) for a in (x, w, b)))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=1e-2, rtol=1e-2)
