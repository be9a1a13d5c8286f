"""INT8 quantization of the port against the JAX package: the quantizers,
the int8 ``apply_linear`` (against both of the reference's backends), the
quantized adaLN concat, and a quantized tree carried across by
``params_from_jax``; same NumPy inputs on both sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from go_pocket_tts_tpu.models import flow_net as j_fnet
from go_pocket_tts_tpu.models import params as j_params
from go_pocket_tts_tpu.models import quantize as j_quant
from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.ops import TOLERANCES
from go_pocket_tts_tpu.utils.safetensors import encode_tensors, open_store_from_bytes
from go_pocket_tts_tpu_torch.convert import params_from_jax
from go_pocket_tts_tpu_torch.models import flow_net as t_fnet
from go_pocket_tts_tpu_torch.models import quantize as t_quant
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.models.params import apply_linear, tree_map
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime

ARCH = synthetic.tiny_arch()
ATOL, RTOL = TOLERANCES["linear"]


def _np(x) -> np.ndarray:
    return np.array(x)


@pytest.fixture(scope="module")
def models():
    jm = load_model_from_store(
        open_store_from_bytes(encode_tensors(j_syn.build_checkpoint(ARCH, seed=21))),
        num_heads=ARCH.num_heads,
    )
    tm = load_model_from_tensors(synthetic.build_checkpoint(ARCH, seed=21), num_heads=ARCH.num_heads, device="cpu")
    return jm, tm


@pytest.mark.parametrize("shape", [(2, 3, 5, 16), (4, 64)])
def test_quantize_kv_rows_matches_reference(shape):
    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * 0.7).astype(np.float32)
    row = (0,) * (x.ndim - 1)
    x[row] = 0.0  # a zero row keeps scale 1 and stays zero
    want_q, want_s = j_quant.quantize_kv_rows(jnp.asarray(x))
    got_q, got_s = t_quant.quantize_kv_rows(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), _np(want_q))
    np.testing.assert_allclose(got_s.numpy(), _np(want_s), rtol=1e-7, atol=0)
    assert got_s[row].item() == 1.0 and got_q[row].eq(0).all()


def test_quantize_kv_rows_rounds_half_to_even():
    x = torch.tensor([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]])
    q, s = t_quant.quantize_kv_rows(x)
    assert s.item() == 1.0 and q.tolist() == [[127, 0, 2, 2, 0, -2]]
    want_q, _ = j_quant.quantize_kv_rows(jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(q.numpy(), _np(want_q))


@pytest.mark.parametrize("k,n,bias", [(64, 48, True), (128, 256, False)])
def test_quantize_linear_matches_reference(k, n, bias):
    rng = np.random.RandomState(k + n)
    p = {"w": (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)}
    p["w"][:, 3] = 0.0  # a zero column keeps scale 1
    if bias:
        p["b"] = rng.randn(n).astype(np.float32)
    want = j_quant.quantize_linear({key: jnp.asarray(v) for key, v in p.items()}, bits=8)
    got = t_quant.quantize_linear({key: torch.from_numpy(v) for key, v in p.items()}, bits=8)
    assert sorted(got) == sorted(want) and t_quant.is_quantized(got)
    np.testing.assert_array_equal(got["w"].numpy(), _np(want["w"]))
    np.testing.assert_allclose(got["scale"].numpy(), _np(want["scale"]), rtol=1e-7, atol=0)
    np.testing.assert_allclose(
        t_quant.dequantize_weight(got).numpy(), _np(j_quant.dequantize_weight(want)), rtol=1e-7, atol=0
    )


def test_bits_4_is_not_ported_and_other_widths_are_refused():
    """Widths other than 8 and 4 are refused; ``bits=4`` now gives the
    packed int4 form (``tests/test_torch_int4.py`` holds it against the
    reference)."""
    p = {"w": torch.ones(4, 4)}
    q4 = t_quant.quantize_linear(p, bits=4)
    assert q4["w"].dtype == torch.uint8 and tuple(q4["w"].shape) == (2, 4)
    assert t_quant.quantize_model_params({"lin": p}, bits=4)["lin"]["w"].dtype == torch.uint8
    for fn in (t_quant.quantize_linear, t_quant.quantize_model_params):
        with pytest.raises(ValueError, match="8 or 4"):
            fn(p, bits=6)


def test_quantize_model_params_matches_reference(models):
    jm, tm = models
    want = j_quant.quantize_model_params(jm.params)
    got = t_quant.quantize_model_params(tm.params)
    leaves = {}

    def collect(path, leaf):
        leaves[".".join(path)] = leaf
        return leaf

    tree_map(collect, got)
    want_leaves = {
        ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(want)[0]
    }
    assert set(leaves) == set(want_leaves)
    n_int8 = 0
    for name, leaf in leaves.items():
        ref = want_leaves[name]
        if leaf.dtype == torch.int8:
            n_int8 += 1
            assert ref.dtype == jnp.int8, name
            np.testing.assert_array_equal(leaf.numpy(), _np(ref), err_msg=name)
        else:
            assert leaf.dtype == torch.float32 and ref.dtype == jnp.float32, name
            np.testing.assert_allclose(leaf.numpy(), _np(ref), rtol=1e-6, atol=1e-7, err_msg=name)
    assert n_int8 > 10
    # The gather table and the once-per-utterance projector stay float.
    assert got["flow_lm"]["conditioner_embed"].dtype == torch.float32
    assert got["latent_to_mimi"]["w"].dtype == torch.float32


@pytest.mark.parametrize("backend", ["xla", "pallas:interpret"])
@pytest.mark.parametrize("m,k,n", [(1, 128, 256), (8, 1024, 3072), (64, 512, 10240), (3, 64, 48), (128, 128, 256)])
def test_int8_apply_linear_matches_reference(backend, m, k, n):
    rng = np.random.RandomState(m + k)
    x = rng.randn(m, k).astype(np.float32)
    p = {"w": (rng.randn(k, n) / np.sqrt(k)).astype(np.float32), "b": rng.randn(n).astype(np.float32)}
    jq = j_quant.quantize_linear({key: jnp.asarray(v) for key, v in p.items()})
    tq = t_quant.quantize_linear({key: torch.from_numpy(v) for key, v in p.items()})
    previous = j_params._QUANT_BACKEND
    try:
        j_params.set_quantized_matmul_backend(backend)
        want = j_params.apply_linear(jq, jnp.asarray(x))
    finally:
        j_params.set_quantized_matmul_backend(previous)
    got = apply_linear(tq, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=RTOL)


def test_int8_apply_linear_bf16_keeps_the_activation_dtype():
    rng = np.random.RandomState(2)
    tq = t_quant.quantize_linear({"w": torch.from_numpy(rng.randn(128, 256).astype(np.float32)), "b": torch.ones(256)})
    x = torch.from_numpy(rng.randn(2, 4, 128).astype(np.float32)).bfloat16()
    got = apply_linear(tq, x)
    want = (torch.matmul(x.float(), tq["w"].float()) * tq["scale"]).bfloat16() + torch.ones(256).bfloat16()
    assert got.dtype == torch.bfloat16 and got.shape == (2, 4, 256)
    torch.testing.assert_close(got, want, atol=0, rtol=0)


def test_quantized_fused_adaln_matches_reference(models):
    jm, tm = models
    jf = j_quant.quantize_model_params(jm.params)["flow_lm"]["flow_net"]
    tf = t_quant.quantize_model_params(tm.params)["flow_lm"]["flow_net"]
    want, got = j_fnet.precompute_fused_adaln(jf), t_fnet.precompute_fused_adaln(tf)
    assert got["w"].dtype == torch.int8 and sorted(got) == sorted(want)
    for key in ("w", "scale", "b"):
        np.testing.assert_allclose(got[key].float().numpy(), _np(want[key]).astype(np.float32), rtol=1e-7, atol=0)
    # Mixed forms: the quantized sources are dequantized, the concat is float.
    jf["res_blocks"][0]["adaln"] = jm.params["flow_lm"]["flow_net"]["res_blocks"][0]["adaln"]
    tf["res_blocks"][0]["adaln"] = tm.params["flow_lm"]["flow_net"]["res_blocks"][0]["adaln"]
    want, got = j_fnet.precompute_fused_adaln(jf), t_fnet.precompute_fused_adaln(tf)
    assert "scale" not in got and got["w"].dtype == torch.float32
    np.testing.assert_allclose(got["w"].numpy(), _np(want["w"]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantized_tree_crosses_params_from_jax(models, dtype):
    jm, tm = models
    jq = jax.tree_util.tree_map(np.asarray, j_quant.quantize_model_params(jm.params))
    got = params_from_jax(jq, device="cpu", dtype=dtype)
    mine = t_quant.quantize_model_params(tm.params)
    layer = got["flow_lm"]["transformer"]["layers"][1]["linear1"]
    assert layer["w"].dtype == torch.int8 and layer["scale"].dtype == torch.float32
    np.testing.assert_array_equal(layer["w"].numpy(), mine["flow_lm"]["transformer"]["layers"][1]["linear1"]["w"].numpy())
    eos = got["flow_lm"]["out_eos"]
    assert eos["w"].dtype == torch.int8 and eos["b"].dtype == dtype
    # cast_params (via PocketTTSModel.to) leaves int8 int8 and scales float32.
    cast = tm.to("cpu", torch.bfloat16)
    assert cast.params["flow_lm"]["bos_emb"].dtype == torch.bfloat16
    qcast = type(tm)(mine, tm.config).to("cpu", torch.bfloat16)
    ff = qcast.params["flow_lm"]["flow_net"]["res_blocks"][0]["mlp0"]
    assert (ff["w"].dtype, ff["scale"].dtype, ff["b"].dtype) == (torch.int8, torch.float32, torch.bfloat16)


def test_quantized_single_runtime_matches_reference(models):
    from go_pocket_tts_tpu.runtime import GenerateConfig as JConfig
    from go_pocket_tts_tpu.runtime import TPURuntime

    jm, tm = models
    kw = dict(temperature=0.0, eos_threshold=1e9, max_steps=6)
    want = TPURuntime(jm, seed=1, frame_bucket=64, quantize=True).generate_audio([3, 17, 41], JConfig(**kw))
    rt = GPURuntime(tm, seed=1, frame_bucket=64, device="cpu", quantize=True)
    assert rt.model.params["flow_lm"]["transformer"]["layers"][0]["in_proj"]["w"].dtype == torch.int8
    got = rt.generate_audio([3, 17, 41], GenerateConfig(**kw))
    assert len(got) == len(want) == 6 * 1920
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-3)
