"""The arithmetic of the tensor-core SEANet kernels (kernels 2, 3, 7 and 8
in bfloat16, ``csrc/seanet_mma.cuh``) written as plain torch on the CPU: the
prepared weight layouts, the phase-GEMM form of the transposed convs, the
shifted-read form of the causal convs and the hi/lo split of float32
intermediates, each held against the port's conv ops; and the cache of
prepared layouts. The kernels themselves run in ``tests/test_torch_cuda.py``.
"""

from __future__ import annotations

import gc

import numpy as np
import pytest
import torch

from go_pocket_tts_tpu_torch import kernels
from go_pocket_tts_tpu_torch.kernels import seanet_tail as st
from go_pocket_tts_tpu_torch.ops import causal_conv1d, conv_transpose1d_trim, elu, repack_conv_transpose_kernel


def _rng(seed):
    return np.random.RandomState(seed)


def _t(rng, *shape, scale=1.0):
    return torch.from_numpy((rng.randn(*shape) * scale).astype(np.float32))


def _unfragment(f: torch.Tensor) -> torch.Tensor:
    """Inverse of ``mma_fragments``, element by element from the fragment
    map of ``csrc/mma_sync.cuh`` (a0: row g, cols 2t..; a1: row g+8; a2:
    cols 2t+8..; a3: both)."""
    mt, kt = f.shape[:2]
    a = torch.zeros((16 * mt, 16 * kt), dtype=f.dtype)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for reg in range(4):
            for e in range(2):
                row = g + 8 * (reg % 2)
                col = 2 * t + e + 8 * (reg // 2)
                a[row::16, col::16] = f[:, :, lane, 2 * reg + e]
    return a


def _deinterleave(a: torch.Tensor) -> torch.Tensor:
    """Inverse of ``interleave_k``: physical column 2c + h of each 16 holds
    logical channel c + 8h."""
    m, k = a.shape
    return a.reshape(m, k // 16, 8, 2).transpose(2, 3).reshape(m, k)


def _conv_matrix_of(frags: torch.Tensor) -> torch.Tensor:
    """The logical ``[C_out, k·C_in]`` matrix of a "conv_mma" weight."""
    return _deinterleave(_unfragment(frags))


def _phase_gemm(x, frags, bias, stride, interleaved=False):
    """The kernel's transposed conv: phase s of output ``stride·m + s`` is the
    phase matrix times ``concat(x[:, m-1], x[:, m])`` (``interleaved``: the
    matrices' K in the order of ``interleave_k``, as the cascade's up3)."""
    b, c_in, t = x.shape
    xp = torch.cat([torch.zeros((b, c_in, 1), dtype=x.dtype), x], dim=2)
    taps = torch.cat([xp[:, :, :-1], xp[:, :, 1:]], dim=1)  # [B, 2·C_in, T]
    a = torch.stack([_deinterleave(_unfragment(f)) if interleaved else _unfragment(f) for f in frags])
    y = torch.einsum("sok,bkt->bots", a, taps).reshape(b, a.shape[1], stride * t)
    return y + bias[:, None]


def _hi_lo_phase_gemm(h, frags, bias, stride):
    """The cascade's up3: its float32 input as two bf16 operands against the
    same (K-interleaved) weight."""
    hi, lo = st.split_hi_lo(h)
    return _phase_gemm(hi.float(), frags, bias, stride, True) + _phase_gemm(
        lo.float(), frags, torch.zeros_like(bias), stride, True
    )


def _shifted_matmul(h, a, bias, k):
    """The kernel's causal conv: ``k`` shifted reads of one tile against the
    ``[C_out, k·C_in]`` matrix ``a``."""
    b, c_in, t = h.shape
    hp = torch.cat([torch.zeros((b, c_in, k - 1), dtype=h.dtype), h], dim=2)
    shifted = torch.cat([hp[:, :, d : d + t] for d in range(k)], dim=1)  # [B, k·C_in, T]
    return torch.einsum("ok,bkt->bot", a, shifted) + bias[:, None]


def _shifted_gemm(h, frags, bias, k):
    return _shifted_matmul(h, _conv_matrix_of(frags), bias, k)


def _hi_lo_matmul(h, a, bias, k):
    """A float32 activation as two bf16 operands against the same weight."""
    hi, lo = st.split_hi_lo(h)
    return _shifted_matmul(hi.float(), a, bias, k) + _shifted_matmul(lo.float(), a, torch.zeros_like(bias), k)


def _hi_lo_gemm(h, frags, bias, k):
    return _hi_lo_matmul(h, _conv_matrix_of(frags), bias, k)


@pytest.mark.parametrize("m,k", [(16, 16), (64, 384), (128, 64), (32, 192)])
def test_mma_fragments_round_trip(m, k):
    a = _t(_rng(m + k), m, k)
    f = st.mma_fragments(a)
    assert f.shape == (m // 16, k // 16, 32, 8)
    assert torch.equal(_unfragment(f), a)


def _unfragment_b(f: torch.Tensor) -> torch.Tensor:
    """Inverse of ``mma_b_fragments`` from the map of ``csrc/mma_sync.cuh``
    (b0: rows 2t, 2t+1 of column g; b1: rows 2t+8, 2t+9)."""
    b = torch.zeros((16 * f.shape[0], 8), dtype=f.dtype)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for i, row in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
            b[row::16, g] = f[:, lane, i]
    return b


def test_mma_b_fragments_round_trip():
    b = _t(_rng(1), 448, 8)
    f = st.mma_b_fragments(b)
    assert f.shape == (28, 32, 4)
    assert torch.equal(_unfragment_b(f), b)


def _final_taps(frags: torch.Tensor) -> torch.Tensor:
    """The ``[C, 8]`` matrix of a "final_mma" weight (tap d in column d)."""
    return _deinterleave(_unfragment_b(frags).t()).t()


def test_final_conv_as_b_fragments_is_the_causal_conv():
    """The tensor-core kernels' final k7 conv: the z rows as M against wf's
    taps as the columns of B (column 7 zero) give the per-tap partials
    P[t][d]; output t sums P[t - 6 + d][d]."""
    rng = _rng(2)
    wf, bf, z = _t(rng, 1, 64, 7, scale=0.1), _t(rng, 1, scale=0.1), _t(rng, 2, 64, 40)
    b = _final_taps(st.kernel_weight(wf, "final_mma"))
    assert b.shape == (64, 8) and not b[:, 7].any() and torch.equal(b[:, :7], wf[0])
    p = torch.cat([torch.zeros((2, 6, 8)), z.transpose(1, 2) @ b], dim=1)  # [B, 6 + T, 8]: rows t - 6
    got = sum(p[:, d : d + 40, d] for d in range(7))[:, None, :] + bf[:, None]
    np.testing.assert_allclose(got.numpy(), causal_conv1d(z, wf, bf).numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("stride,c_in,c_out", [(5, 256, 128), (4, 128, 64)])
def test_phase_gemm_is_the_transposed_conv(stride, c_in, c_out):
    rng = _rng(stride)
    wu = repack_conv_transpose_kernel(_t(rng, c_in, c_out, 2 * stride, scale=0.05))
    bu, x = _t(rng, c_out, scale=0.1), _t(rng, 2, c_in, 24, scale=0.5)
    frags = torch.stack([st.mma_fragments(a) for a in st.up_phase_matrices(wu, stride)])
    got = _phase_gemm(x, frags, bu, stride)
    want = conv_transpose1d_trim(x, wu, bu, stride)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("k,c_in,c_out", [(3, 128, 64), (1, 64, 128), (3, 64, 32), (1, 32, 64)])
def test_shifted_gemm_is_the_causal_conv(k, c_in, c_out):
    # Two float32 summation orders over K = k·C_in (up to 384 terms of ~0.1)
    # differ by a few 1e-6; a misplaced weight errs by ~1e-2.
    rng = _rng(k * c_in)
    w, b, h = _t(rng, c_out, c_in, k, scale=0.1), _t(rng, c_out, scale=0.1), _t(rng, 2, c_in, 40)
    got = _shifted_gemm(h, st.kernel_weight(w, "conv_mma"), b, k)
    np.testing.assert_allclose(got.numpy(), causal_conv1d(h, w, b).numpy(), atol=1e-5, rtol=1e-5)


def test_interleave_k_pairs_the_fragment_rows():
    """Logical channels c and c + 8 (one lane's rows g, g + 8) sit side by
    side, within each 16; the inverse restores the matrix."""
    a = torch.arange(2 * 48, dtype=torch.float32).reshape(2, 48)
    p = st.interleave_k(a)
    for grp in range(3):
        for c in range(8):
            assert p[0, 16 * grp + 2 * c] == a[0, 16 * grp + c]
            assert p[0, 16 * grp + 2 * c + 1] == a[0, 16 * grp + c + 8]
    assert torch.equal(_deinterleave(p), a)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 1e3])
def test_hi_lo_split_carries_float32(scale):
    v = _t(_rng(7), 4096, scale=scale)
    hi, lo = st.split_hi_lo(v)
    assert hi.dtype == lo.dtype == torch.bfloat16
    rel = ((hi.float() + lo.float()) - v).abs() / v.abs()
    assert rel.max().item() <= 2.0**-16
    # hi alone is a bf16 rounding, ~2^-9 relative: the pair is what keeps float32.
    assert (hi.float() - v).abs().max().item() > ((hi.float() + lo.float()) - v).abs().max().item()


def _elu_mma(v: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernels' ELU (``csrc/seanet_mma.cuh``) in float32:
    ``v`` above 0, ``exp(v) - 1`` below (expm1 without its care near 0)."""
    return torch.where(v > 0, v, torch.exp(v) - 1)


def test_kernel_elu_is_float32_elu_in_absolute_terms():
    v = torch.linspace(-20.0, 4.0, 240001, dtype=torch.float32)
    err = (_elu_mma(v).double() - elu(v.double())).abs()
    # ~1 float32 ulp of 1 near 0 (the card's __expf adds ~2 more): far below
    # the 2^-17 that the hi/lo pair keeps of the values ELU feeds (~1e-1).
    assert err.max().item() <= 2.5e-7


def _bf16_exact(t):
    return t.to(torch.bfloat16).float()


def test_up2_res_arithmetic_matches_plain():
    """Kernel 7's bfloat16 arithmetic end to end, in float32 on bf16 values:
    up2 as phase GEMMs on the bf16 input (exact operands), res2 on the hi/lo
    pairs of elu(y) and h1, all against ``fused_up2_res_plain``."""
    rng = _rng(11)
    wu = _bf16_exact(repack_conv_transpose_kernel(_t(rng, 256, 128, 10, scale=0.05)))
    bu, w1, b1 = _bf16_exact(_t(rng, 128, scale=0.1)), _bf16_exact(_t(rng, 64, 128, 3, scale=0.1)), _bf16_exact(_t(rng, 64, scale=0.1))
    w2, b2 = _bf16_exact(_t(rng, 128, 64, 1, scale=0.1)), _bf16_exact(_t(rng, 128, scale=0.1))
    x = _bf16_exact(_t(rng, 2, 256, 16, scale=0.5))
    y = _phase_gemm(x, st.kernel_weight(wu, "up2_mma"), bu, 5)
    h1 = elu(_hi_lo_gemm(elu(y), st.kernel_weight(w1, "conv_mma"), b1, 3))
    got = elu(y + _hi_lo_gemm(h1, st.kernel_weight(w2, "conv_mma"), b2, 1))
    want = st.fused_up2_res_plain(x, wu, bu, w1, b1, w2, b2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


def test_up_tail_arithmetic_matches_plain():
    """Kernel 2's bfloat16 arithmetic end to end (up3 phase GEMMs; res3 and
    the final k7 conv, from its B fragments, on hi/lo pairs) against
    ``fused_seanet_up_tail_plain``."""
    rng = _rng(12)
    wu = _bf16_exact(repack_conv_transpose_kernel(_t(rng, 128, 64, 8, scale=0.1)))
    ws = [_bf16_exact(_t(rng, *s, scale=0.1)) for s in ((64,), (32, 64, 3), (32,), (64, 32, 1), (64,), (1, 64, 7), (1,))]
    bu, w1, b1, w2, b2, wf, bf = ws
    x = _bf16_exact(_t(rng, 2, 128, 32, scale=0.5))
    y = _phase_gemm(x, st.kernel_weight(wu, "up3_mma"), bu, 4)
    h1 = elu(_hi_lo_gemm(elu(y), st.kernel_weight(w1, "conv_mma"), b1, 3))
    z = elu(y + _hi_lo_gemm(h1, st.kernel_weight(w2, "conv_mma"), b2, 1))
    wf_row = _final_taps(st.kernel_weight(wf, "final_mma"))[:, :7].t().reshape(1, -1)  # [1, 7·64]
    got = _hi_lo_matmul(z, wf_row, bf, 7)
    want = st.fused_seanet_up_tail_plain(x, wu, bu, w1, b1, w2, b2, wf, bf)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


def test_interleaved_phase_gemm_is_the_transposed_conv():
    """The cascade's up3 layout: the phase matrices with K interleaved as
    res2's output channels are, undone, give the transposed conv."""
    rng = _rng(14)
    wu = repack_conv_transpose_kernel(_t(rng, 128, 64, 8, scale=0.1))
    bu, x = _t(rng, 64, scale=0.1), _t(rng, 2, 128, 24, scale=0.5)
    frags = st.kernel_weight(wu, "up3_mma_il")
    assert frags.shape == (4, 4, 16, 32, 8)
    assert not torch.equal(frags, st.kernel_weight(wu, "up3_mma"))
    got = _phase_gemm(x, frags, bu, 4, interleaved=True)
    np.testing.assert_allclose(got.numpy(), conv_transpose1d_trim(x, wu, bu, 4).numpy(), atol=1e-6, rtol=1e-6)


def _cascade_weights(rng):
    """up2 + res2, up3 + res3 + final conv at the kernels' widths, bf16-exact."""
    wu2 = _bf16_exact(repack_conv_transpose_kernel(_t(rng, 256, 128, 10, scale=0.05)))
    wu3 = _bf16_exact(repack_conv_transpose_kernel(_t(rng, 128, 64, 8, scale=0.1)))
    shapes = ((128,), (64, 128, 3), (64,), (128, 64, 1), (128,))
    up2 = [wu2] + [_bf16_exact(_t(rng, *s_, scale=0.1)) for s_ in shapes]
    rest = [wu3] + [_bf16_exact(_t(rng, *s_, scale=0.1)) for s_ in ((64,),) + st._TAIL_SHAPES]
    return up2 + rest


def _tail_from_y(y, w1, b1, w2, b2, wf, bf, z_live=None):
    """res3, ELU and the final conv as kernels 2, 3 and 8 compute them from
    y (float32): hi/lo operands, wf from its B fragments; z zeroed where
    ``z_live`` is False."""
    h1 = elu(_hi_lo_gemm(elu(y), st.kernel_weight(w1, "conv_mma"), b1, 3))
    z = elu(y + _hi_lo_gemm(h1, st.kernel_weight(w2, "conv_mma"), b2, 1))
    if z_live is not None:
        z = torch.where(z_live, z, torch.zeros_like(z))
    wf_row = _final_taps(st.kernel_weight(wf, "final_mma"))[:, :7].t().reshape(1, -1)  # [1, 7·64]
    return _hi_lo_matmul(z, wf_row, bf, 7)


def _cascade_chain(xe, ws, a_abs0):
    """Kernel 8's bfloat16 arithmetic over a sequence xe whose column 0 is
    absolute column ``a_abs0`` [B]: up2 phase GEMMs on the exact bf16 input,
    res2 on hi/lo pairs, up3 phase GEMMs on the hi/lo pair of res2's output
    (K interleaved), res3 and the final conv; y2, h, y3 and z zero before
    absolute position 0, as the kernel masks them."""
    wu2, bu2, w1r2, b1r2, w2r2, b2r2, wu3, bu3, *tail = ws
    y2 = _phase_gemm(xe, st.kernel_weight(wu2, "up2_mma"), bu2, 5)
    u_live = (5 * a_abs0[:, None, None] + torch.arange(y2.shape[2])) >= 0
    y2 = torch.where(u_live, y2, torch.zeros_like(y2))
    h1 = elu(_hi_lo_gemm(elu(y2), st.kernel_weight(w1r2, "conv_mma"), b1r2, 3))
    h = elu(y2 + _hi_lo_gemm(h1, st.kernel_weight(w2r2, "conv_mma"), b2r2, 1))
    h = torch.where(u_live, h, torch.zeros_like(h))
    y3 = _hi_lo_phase_gemm(h, st.kernel_weight(wu3, "up3_mma_il"), bu3, 4)
    t_live = (20 * a_abs0[:, None, None] + torch.arange(y3.shape[2])) >= 0
    y3 = torch.where(t_live, y3, torch.zeros_like(y3))
    return _tail_from_y(y3, *tail, z_live=t_live)


# Six hi/lo stages in a chain (res2's two, up3, res3's two, the final conv),
# each ~2^-17 relative, on outputs up to ~8: ~3e-5 apart from the plain
# float32 chain (4e-6 with exact float32 operands); a misplaced weight,
# shift or mask errs by 1e-2 or more.
_CASCADE_ATOL = 1e-4


def test_cascade_arithmetic_matches_plain():
    """Kernel 8's bfloat16 arithmetic end to end (no rounding between its
    stages: res2's output enters up3 as a hi/lo pair) against
    ``fused_up2_up3_tail_plain``."""
    rng = _rng(15)
    ws = _cascade_weights(rng)
    x = _bf16_exact(_t(rng, 2, 256, 16, scale=0.5))
    got = _cascade_chain(x, ws, torch.zeros(2, dtype=torch.int64))
    want = st.fused_up2_up3_tail_plain(x, *ws)
    assert got.shape == want.shape == (2, 1, 320)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=_CASCADE_ATOL, rtol=2e-5)


def test_cascade_stream_arithmetic_at_mixed_starts():
    """The same chain over a streamed block: column a < 0 of a lane at
    ``start`` is ``halo[:, 5 + a]`` where ``start + a >= 0`` and zero
    otherwise (the tile loader's rule), every mask at the absolute
    position; lanes at starts 0, 2 (a halo reaching before the stream), 96
    and 960 against ``fused_up2_up3_tail_stream_plain``."""
    rng = _rng(16)
    ws = _cascade_weights(rng)
    x = _bf16_exact(_t(rng, 4, 256, 16, scale=0.5))
    halo = _bf16_exact(_t(rng, 4, 256, st.HALO, scale=0.5))
    halo[0] = 0
    start = torch.tensor([0, 2, 96, 960], dtype=torch.int32)
    a = torch.arange(-st.HALO, 0)
    kept = (start[:, None] + a) >= 0  # [B, 5]
    xe = torch.cat([torch.where(kept[:, None, :], halo, torch.zeros_like(halo)), x], dim=2)
    got = _cascade_chain(xe, ws, start.long() - st.HALO)[:, :, 20 * st.HALO :]
    want = st.fused_up2_up3_tail_stream_plain(x, halo, start, *ws)
    assert got.shape == want.shape == (4, 1, 320)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=_CASCADE_ATOL, rtol=2e-5)


def test_seanet_tail_arithmetic_matches_plain():
    """Kernel 3's bfloat16 arithmetic: y = x exact in bf16, then kernel 2's
    res3 and final-conv stages, against ``fused_seanet_tail_plain``."""
    rng = _rng(17)
    tail = [_bf16_exact(_t(rng, *s_, scale=0.1)) for s_ in st._TAIL_SHAPES]
    x = _bf16_exact(_t(rng, 2, 64, 96, scale=0.5))
    got = _tail_from_y(x, *tail)
    want = st.fused_seanet_tail_plain(x, *tail)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize(
    "layout,shape",
    [("up2_mma", (128, 256, 10)), ("up3_mma", (64, 128, 8)), ("conv_mma", (64, 128, 3)), ("simt", (64, 128, 3)),
     ("simt_k1", (128, 64, 1)), ("up3_mma_il", (64, 128, 8)), ("final_mma", (1, 64, 7))],
)
def test_kernel_weight_is_cached_until_modified_in_place(layout, shape):
    w = _t(_rng(3), *shape)
    first = st.kernel_weight(w, layout)
    assert st.kernel_weight(w, layout) is first  # prepared once
    w.mul_(2.0)  # an in-place update bumps the version counter
    second = st.kernel_weight(w, layout)
    assert second is not first
    assert torch.equal(second, st._LAYOUTS[layout](w))
    assert torch.equal(second, 2.0 * first)


def test_kernel_weight_forgets_a_dead_weight():
    w = _t(_rng(4), 64, 128, 3)
    st.kernel_weight(w, "conv_mma")
    key = ("conv_mma", w.data_ptr(), tuple(w.shape), w.dtype, w.device)
    assert key in st._PREPARED
    del w
    gc.collect()
    assert key not in st._PREPARED


def test_kernel_weight_tells_apart_two_weights_of_one_shape():
    rng = _rng(5)
    a, b = _t(rng, 64, 32, 1), _t(rng, 64, 32, 1)
    assert not torch.equal(st.kernel_weight(a, "conv_mma"), st.kernel_weight(b, "conv_mma"))
    assert torch.equal(_conv_matrix_of(st.kernel_weight(b, "conv_mma")), b[:, :, 0])


def test_reset_launches_empties_the_shape_counts():
    st.fused_up2_res.shapes[(1, 256, 96)] = 3
    st.fused_seanet_up_tail.shapes[(1, 128, 480)] = 1
    kernels.reset_launches()
    for fn in (st.fused_seanet_up_tail, st.fused_seanet_tail, st.fused_up2_res, st.fused_up2_up3_tail):
        assert fn.launches == 0 and fn.shapes == {}
