"""The fused LayerNorm kernel's wrapper (``kernels/layer_norm.py``) on the
CPU: its plain version against the JAX package's ``layer_norm`` and
``modulate``, its launch plan and row addressing, and the model code's
routing of every norm through it where the kernels are on. The CUDA kernel
runs only on a card (tests/test_torch_cuda.py and chip_smoke.py)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from go_pocket_tts_tpu import ops as jops
from go_pocket_tts_tpu_torch import kernels
from go_pocket_tts_tpu_torch.kernels import layer_norm as lnk
from go_pocket_tts_tpu_torch.models import flow_lm as flm
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.flow_net import precompute_fused_adaln, precompute_time_cond
from go_pocket_tts_tpu_torch.models.flow_transformer import init_kv_cache
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors, with_kernels
from go_pocket_tts_tpu_torch.ops import TOLERANCES

ATOL, RTOL = TOLERANCES["layer_norm"]
BF16_ULP = 2.0**-7  # bf16's spacing relative to the value, at most


def _inputs(rng, rows, d, dtype, affine, mod, transposed=False):
    """x (a transposed view of a [1, d, rows] array when ``transposed``), its
    weight and bias in ``dtype`` (as the loader casts them) or None, and
    shift and scale as column chunks of one [rows, 3·d] array (as the
    flowNet slices its adaLN projection) or None."""
    if transposed:
        x = torch.from_numpy((rng.randn(1, d, rows) * 2.0 + 0.5).astype(np.float32)).to(dtype).transpose(1, 2)
    else:
        x = torch.from_numpy((rng.randn(rows, d) * 2.0 + 0.5).astype(np.float32)).to(dtype)
    w = b = shift = scale = None
    if affine:
        w = torch.from_numpy((rng.randn(d) * 0.5 + 1.0).astype(np.float32)).to(dtype)
        b = torch.from_numpy((rng.randn(d) * 0.1).astype(np.float32)).to(dtype)
    if mod:
        ada = torch.from_numpy((rng.randn(x.shape[-2], 3 * d) * 0.3).astype(np.float32)).to(dtype)
        if transposed:
            ada = ada[None]
        shift, scale = ada[..., :d], ada[..., 2 * d :]
    return x, w, b, shift, scale


def _np(t):
    return None if t is None else t.float().numpy()


@pytest.mark.parametrize("mod", [False, True])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cpu_tensors_take_the_plain_version_and_launch_nothing(dtype, affine, mod):
    kernels.reset_launches()
    x, w, b, shift, scale = _inputs(np.random.RandomState(3), 5, 64, dtype, affine, mod)
    got = lnk.layer_norm(x, w, b, 1e-6, shift, scale)
    assert torch.equal(got, lnk.layer_norm_plain(x, w, b, 1e-6, shift, scale))
    assert lnk.layer_norm.launches == 0


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("mod", [False, True])
@pytest.mark.parametrize("affine", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [512, 1024])
def test_plain_version_matches_the_reference(d, dtype, affine, mod, transposed):
    """Against the JAX package's ``layer_norm`` (then ``modulate``) on the
    same values; in bf16 both round the float32 result once, so beyond the
    budget a value may sit one bf16 step apart where the two float32 row
    sums straddle a rounding boundary."""
    x, w, b, shift, scale = _inputs(np.random.RandomState(d), 12, d, dtype, affine, mod, transposed)
    got = lnk.layer_norm(x, w, b, 1e-5, shift, scale)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    j = [None if t is None else jnp.asarray(_np(t)).astype(jdt) for t in (x, w, b, shift, scale)]
    want = jops.layer_norm(j[0], j[1], j[2], 1e-5)
    if mod:
        want = jops.modulate(want, j[3], j[4])
    assert got.dtype == dtype and tuple(got.shape) == tuple(want.shape)
    rtol = RTOL if dtype == torch.float32 else RTOL + BF16_ULP
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=ATOL, rtol=rtol)


@pytest.mark.parametrize(
    "d,vec,adjacent,want",
    [
        (1024, 8, True, (8, 128, 1, 0)),  # the AR step and the prefills, bf16: one 16-byte load a thread
        (512, 8, True, (8, 64, 1, 0)),  # the flowNet
        (1024, 4, True, (4, 256, 1, 0)),  # float32
        (512, 8, False, (1, 256, 0, 16)),  # the Mimi transformer's transposed view
        (1024, 1, False, (1, 256, 0, 8)),
        (1000, 1, True, (1, 256, 4, 0)),  # unaligned: one element at a time
        (8192, 1, True, (1, 256, 32, 0)),  # the widest row
        (8192, 8, True, (8, 256, 4, 0)),
        (48, 8, True, (8, 32, 1, 0)),
    ],
)
def test_launch_plan(d, vec, adjacent, want):
    plan = lnk.launch_plan(d, vec, adjacent)
    assert tuple(plan) == want
    if plan.tile:
        assert plan.tile <= 32 and plan.tile * (d + 1) * 4 <= lnk.TILE_SMEM
    else:
        # Every element has a thread, a thread holds at most 32 floats, and
        # the chunk counts are the kernel's instantiations.
        assert plan.tpr * plan.chunks * plan.vec >= d and plan.chunks * plan.vec <= 32
        assert plan.chunks in (1, 2, 4, 8, 16, 32) and plan.tpr % 32 == 0 and plan.tpr <= lnk.THREADS


@pytest.mark.parametrize("d,vec", [(0, 8), (8193, 1), (1001, 8)])
def test_launch_plan_refuses_what_the_kernel_does_not_take(d, vec):
    with pytest.raises(ValueError):
        lnk.launch_plan(d, vec)


def _views():
    base = torch.arange(2 * 3 * 5 * 4, dtype=torch.float32).reshape(2, 3, 5, 4)
    ada = torch.arange(6 * 40, dtype=torch.float32).reshape(6, 40)
    return {
        "contiguous 3-d": base[0],
        "contiguous 4-d": base,
        "transposed": base[0].transpose(0, 1),
        "batch of transposed": base[:, 0].transpose(1, 2),
        "column chunk": ada[:, 8:16],
        "single row": ada[2:3, 8:16],
        "broadcast rows": torch.broadcast_to(ada[0, :8], (3, 8)),
        "unfoldable": base.transpose(1, 2)[:, :, ::2],
    }


@pytest.mark.parametrize("name", list(_views()))
def test_rows_address_every_row(name):
    """``_rows``'s (rows, inner, s_outer, s_inner) gives row r's first
    element at (r // inner)·s_outer + (r % inner)·s_inner, rows in the
    leading dims' order; a view whose leading dims do not fold into two
    gives None (the wrapper then copies it)."""
    t = _views()[name]
    rows = lnk._rows(t)
    if name == "unfoldable":
        assert rows is None
        return
    n, inner, s_outer, s_inner = rows
    firsts = t[..., 0].reshape(-1)  # row-major over the leading dims
    assert n == firsts.numel()
    storage = t.as_strided((t.untyped_storage().nbytes() // 4,), (1,), 0)
    for r in range(n):
        assert storage[t.storage_offset() + (r // inner) * s_outer + (r % inner) * s_inner] == firsts[r]


# -- the call sites --------------------------------------------------------------

ARCH = synthetic.tiny_arch()


@pytest.fixture(scope="module")
def model():
    return load_model_from_tensors(synthetic.build_checkpoint(ARCH, seed=7), num_heads=ARCH.num_heads, device="cpu")


@pytest.fixture
def calls(monkeypatch):
    """Counts the model code's calls of the kernel wrapper (run plain)."""
    n = {"calls": 0}

    def counting(*args, **kw):
        n["calls"] += 1
        return lnk.layer_norm_plain(*args, **kw)

    monkeypatch.setattr(lnk, "layer_norm", counting)
    return n


# Per AR step: two norms a transformer layer, the output norm, and one a
# flowNet block plus the final layer's (each with its modulate).
NORMS_A_STEP = 2 * ARCH.num_layers + 1 + ARCH.flow_depth + 1


@pytest.mark.parametrize("on", [True, False])
def test_ar_step_norms_route_by_the_kernel_flag(model, calls, on):
    m = model if on else with_kernels(model, False)
    flow, cfg = m.params["flow_lm"], m.config.flow_lm
    cache = init_kv_cache(cfg.transformer, 1, 16)
    frame = torch.full((1, 1, ARCH.latent_dim), float("nan"))
    noise = torch.zeros(1, ARCH.latent_dim)
    fused, time_cond = precompute_fused_adaln(flow["flow_net"]), precompute_time_cond(flow["flow_net"], 1)
    for _ in range(3):
        cache, frame, _ = flm.ar_core(flow, cfg, cache, frame, noise, 1, time_cond, fused)
    assert calls["calls"] == (3 * NORMS_A_STEP if on else 0)


@pytest.mark.parametrize("on", [True, False])
def test_batched_step_and_mimi_norms_route_by_the_kernel_flag(model, calls, on):
    from go_pocket_tts_tpu_torch.parallel import batching

    m = model if on else with_kernels(model, False)
    flow, cfg = m.params["flow_lm"], m.config.flow_lm
    state = batching.make_batched_state(cfg, 2, 16, 8, 4, torch.float32, kv_quantize=True, device="cpu")
    fused, time_cond = precompute_fused_adaln(flow["flow_net"]), precompute_time_cond(flow["flow_net"], 1)
    batching._ar_step_body(flow, cfg, state, torch.zeros(2, ARCH.latent_dim), 1, time_cond, fused)
    assert calls["calls"] == (NORMS_A_STEP if on else 0)
    calls["calls"] = 0
    m.mimi_decode(m.latent_to_mimi(torch.zeros(1, 2, ARCH.latent_dim)))
    assert calls["calls"] == (2 * ARCH.mimi_layers if on else 0)


def test_the_routing_keeps_the_models_output(model):
    """Kernels on and off give the same frames on the CPU (both plain)."""
    outs = []
    for m in (model, with_kernels(model, False)):
        flow, cfg = m.params["flow_lm"], m.config.flow_lm
        cache = init_kv_cache(cfg.transformer, 1, 16)
        frame = torch.full((1, 1, ARCH.latent_dim), float("nan"))
        noise = torch.from_numpy(np.random.RandomState(1).randn(1, ARCH.latent_dim).astype(np.float32))
        for _ in range(2):
            cache, frame, eos = flm.ar_core(flow, cfg, cache, frame, noise)
        outs.append((frame, eos))
    assert all(torch.equal(a, b) for a, b in zip(*outs))

