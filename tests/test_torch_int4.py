"""INT4 serving of the port against the JAX package: the int4 quantizer and
nibble packing, the int4 ``apply_linear``, the fused adaLN concat, the
safetensors writer and reader, the pre-quantized exporter and loader, and
whole requests through ``GPURuntime(quantize=4)`` and the int4 + int8-KV
``ContinuousBatcher``; the same NumPy inputs on both sides.

``tiny_arch()`` has input dims of at most 128, so all its int4 is
per-channel; ``WIDE`` keeps its depth and widens the FlowLM and flowNet so
that the AR step's linears are group-wise and pass the kernel's gate."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import ml_dtypes

from go_pocket_tts_tpu.model_assets import quantize_export as j_export
from go_pocket_tts_tpu.models import flow_net as j_fnet
from go_pocket_tts_tpu.models import params as j_params
from go_pocket_tts_tpu.models import quantize as j_quant
from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.ops import TOLERANCES
from go_pocket_tts_tpu.parallel import ContinuousBatcher as JBatcher
from go_pocket_tts_tpu.runtime import GenerateConfig as JConfig
from go_pocket_tts_tpu.runtime import TPURuntime
from go_pocket_tts_tpu.utils import safetensors as j_st
from go_pocket_tts_tpu_torch.model_assets import quantize_export as t_export
from go_pocket_tts_tpu_torch.models import flow_net as t_fnet
from go_pocket_tts_tpu_torch.models import quantize as t_quant
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import PocketTTSModel, load_model, load_model_from_tensors
from go_pocket_tts_tpu_torch.models.params import apply_linear, tree_map
from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime
from go_pocket_tts_tpu_torch.utils import safetensors as t_st

WIDE = dict(d_model=256, ffn_dim=512, flow_dim=256, flow_hidden=256)
ARCH = dataclasses.replace(synthetic.tiny_arch(), **WIDE)
J_ARCH = dataclasses.replace(j_syn.tiny_arch(), **WIDE)
SEED = 31
ATOL, RTOL = TOLERANCES["linear"]
# Whole requests at float32 and temperature 0 (atol, rtol): the budgets the
# int8 slice holds its weights and its int8 KV cache to
# (tests/test_torch_quantize.py, tests/test_torch_batching.py).
REQUEST_TOL = (1e-4, 1e-3)
KV_REQUEST_TOL = (5e-3, 1e-2)


def _np(x) -> np.ndarray:
    return np.array(x)


@pytest.fixture(scope="module")
def checkpoint():
    return synthetic.build_checkpoint(ARCH, seed=SEED)


@pytest.fixture(scope="module")
def models(checkpoint):
    jm = load_model_from_store(j_st.open_store_from_bytes(j_st.encode_tensors(checkpoint)), num_heads=ARCH.num_heads)
    tm = load_model_from_tensors(checkpoint, num_heads=ARCH.num_heads, device="cpu")
    return jm, tm


def _leaves(tree) -> dict:
    out = {}

    def collect(path, leaf):
        out[".".join(path)] = leaf
        return leaf

    tree_map(collect, tree)
    return out


def _jax_leaves(tree) -> dict:
    return {
        ".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): leaf
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
    }


# RoPE tables are rebuilt by torch's CPU cos, which takes its vector or its
# scalar path depending on how the work splits over threads: two builds in
# one process may differ by a few float32 ulps (≤ 2e-6 absolute).
ROPE_ATOL = 1e-5


def _assert_trees_equal(a, b) -> None:
    """Leaf for leaf: same dtype and the same values (RoPE tables within
    ROPE_ATOL)."""
    la, lb = _leaves(a), _leaves(b)
    assert set(la) == set(lb)
    for name, x in la.items():
        assert x.dtype == lb[name].dtype, name
        if "rope_" in name:
            torch.testing.assert_close(x, lb[name], atol=ROPE_ATOL, rtol=0, msg=name)
        else:
            assert torch.equal(x, lb[name]), name


# -- quantizer and packing --------------------------------------------------------


@pytest.mark.parametrize(
    "k,n,form",
    [(256, 384, "grouped"), (1024, 256, "grouped"), (128, 256, "per-channel"), (96, 48, "per-channel"), (97, 40, "int8")],
)
def test_quantize_linear_int4_matches_reference(k, n, form):
    rng = np.random.RandomState(k + n)
    p = {"w": (rng.randn(k, n) / np.sqrt(k)).astype(np.float32), "b": rng.randn(n).astype(np.float32)}
    p["w"][:, 3] = 0.0  # a zero column (and, grouped, zero groups) keeps scale 1
    want = j_quant.quantize_linear({key: jnp.asarray(v) for key, v in p.items()}, bits=4)
    got = t_quant.quantize_linear({key: torch.from_numpy(v) for key, v in p.items()}, bits=4)
    assert sorted(got) == sorted(want) and t_quant.is_quantized(got)
    want_dtype = {"grouped": torch.uint8, "per-channel": torch.uint8, "int8": torch.int8}[form]
    assert got["w"].dtype == want_dtype and t_quant.is_int4_packed(got) == (want_dtype == torch.uint8)
    assert got["scale"].ndim == (2 if form == "grouped" else 1)
    np.testing.assert_array_equal(got["w"].numpy(), _np(want["w"]))
    np.testing.assert_allclose(got["scale"].numpy(), _np(want["scale"]), rtol=1e-7, atol=0)
    assert torch.all(got["scale"][..., 3] == 1.0)
    np.testing.assert_allclose(
        t_quant.dequantize_weight(got).numpy(), _np(j_quant.dequantize_weight(want)), rtol=1e-7, atol=0
    )


def test_int4_levels_round_half_to_even_and_clip_at_7():
    w = torch.tensor([[7.0], [0.5], [1.5], [2.5], [-0.5], [-3.5], [6.5], [-7.0]])
    got = t_quant.quantize_linear({"w": w}, bits=4)
    assert got["scale"].tolist() == [1.0]
    levels = t_quant.depack_int4_pairs(got["w"]).reshape(8).tolist()
    assert levels == [7, 0, 2, 2, 0, -4, 6, -7]
    np.testing.assert_array_equal(got["w"].numpy(), _np(j_quant.quantize_linear({"w": jnp.asarray(w.numpy())}, bits=4)["w"]))


def test_nibble_packing_matches_reference_on_every_code():
    codes = np.arange(-8, 8, dtype=np.int8)
    low, high = np.meshgrid(codes, codes, indexing="ij")
    q = np.stack([low.ravel(), high.ravel()], axis=1).reshape(512, 1)  # every (row 2i, row 2i+1) pair
    q = np.ascontiguousarray(np.repeat(q, 3, axis=1))
    packed = t_quant.pack_int4_rows(torch.from_numpy(q))
    np.testing.assert_array_equal(packed.numpy(), _np(j_quant.pack_int4_rows(jnp.asarray(q))))
    assert sorted(set(packed[:, 0].tolist())) == list(range(256))  # all 256 bytes
    pairs = t_quant.depack_int4_pairs(packed)
    np.testing.assert_array_equal(pairs.numpy(), _np(j_quant.depack_int4_pairs(jnp.asarray(packed.numpy()))))
    np.testing.assert_array_equal(pairs.reshape(512, 3).numpy(), q)
    # The disk format pairs along the last axis of [out, in].
    disk = t_st.pack_nibbles(q.T)
    np.testing.assert_array_equal(disk, j_st.pack_nibbles(q.T))
    np.testing.assert_array_equal(disk.T, packed.numpy())
    np.testing.assert_array_equal(t_st.unpack_nibbles(disk), j_st.unpack_nibbles(disk))
    np.testing.assert_array_equal(t_st.unpack_nibbles(disk), q.T)
    with pytest.raises(ValueError):
        t_st.pack_nibbles(np.zeros((2, 3), np.int8))


def test_quantize_model_params_int4_matches_reference(models):
    jm, tm = models
    got = _leaves(t_quant.quantize_model_params(tm.params, bits=4))
    want = _jax_leaves(j_quant.quantize_model_params(jm.params, bits=4))
    assert set(got) == set(want)
    counts = {"uint8": 0, "grouped": 0, "int8": 0}
    for name, leaf in got.items():
        ref = want[name]
        if leaf.dtype in (torch.uint8, torch.int8):
            counts["uint8" if leaf.dtype == torch.uint8 else "int8"] += 1
            assert str(leaf.dtype).replace("torch.", "") == str(ref.dtype), name
            np.testing.assert_array_equal(leaf.numpy(), _np(ref), err_msg=name)
        elif name.endswith(".scale"):
            counts["grouped"] += leaf.ndim == 2
            np.testing.assert_allclose(leaf.numpy(), _np(ref), rtol=1e-7, atol=0, err_msg=name)
        elif "rope_" in name:  # each package's own float32 cos/sin
            np.testing.assert_allclose(leaf.numpy(), _np(ref), rtol=0, atol=ROPE_ATOL, err_msg=name)
        else:
            np.testing.assert_allclose(leaf.numpy(), _np(ref), rtol=1e-6, atol=1e-7, err_msg=name)
    # WIDE: FlowLM and flowNet linears are group-wise; the rest per-channel.
    assert counts["uint8"] > 20 and counts["grouped"] >= 4 * ARCH.num_layers + 3 * ARCH.flow_depth
    assert counts["int8"] == 0  # no odd input dim here
    assert t_quant.model_quantized_bits(t_quant.quantize_model_params(tm.params, bits=4)) == 4
    assert t_quant.model_quantized_bits(t_quant.quantize_model_params(tm.params, bits=8)) == 8
    assert t_quant.model_quantized_bits(tm.params) is None


# -- the int4 linear --------------------------------------------------------------


@pytest.mark.parametrize(
    "m,k,n",
    [(1, 256, 512), (8, 1024, 768), (40, 256, 512), (4, 96, 48), (3, 256, 1), (2, 128, 256), (5, 32, 256)],
)
def test_int4_apply_linear_matches_reference_split(m, k, n):
    """Lead dims (2, m): gated shapes (the kernel's plain version), M over
    64, per-channel int4, the N=1 EOS head and narrow inputs take the split
    product; all against the reference's default "split" variant."""
    rng = np.random.RandomState(m + k + n)
    x = rng.randn(2, m, k).astype(np.float32)
    p = {"w": (rng.randn(k, n) / np.sqrt(k)).astype(np.float32), "b": rng.randn(n).astype(np.float32)}
    jq = j_quant.quantize_linear({key: jnp.asarray(v) for key, v in p.items()}, bits=4)
    tq = t_quant.quantize_linear({key: torch.from_numpy(v) for key, v in p.items()}, bits=4)
    previous = j_params._INT4_VARIANT
    try:
        j_params.set_int4_matmul_variant("split")
        want = j_params.apply_linear(jq, jnp.asarray(x))
    finally:
        j_params.set_int4_matmul_variant(previous)
    got = apply_linear(tq, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, m, n)
    np.testing.assert_allclose(got.numpy(), _np(want), atol=ATOL, rtol=RTOL)


def test_int4_apply_linear_bf16_keeps_the_activation_dtype():
    rng = np.random.RandomState(4)
    tq = t_quant.quantize_linear({"w": torch.from_numpy(rng.randn(256, 512).astype(np.float32)), "b": torch.ones(512)}, bits=4)
    x = torch.from_numpy(rng.randn(2, 4, 256).astype(np.float32)).bfloat16()
    got = apply_linear(tq, x)
    want = (x.float().reshape(8, 256) @ t_quant.dequantize_weight(tq)).reshape(2, 4, 512)
    assert got.dtype == torch.bfloat16 and got.shape == (2, 4, 512)
    # Cast to bf16 and the bias added in bf16: one bf16 rounding each.
    torch.testing.assert_close(got.float(), want + 1.0, atol=2e-2, rtol=2e-2)


def test_a_quantized_weight_never_takes_the_float_branch():
    w = torch.zeros((64, 16), dtype=torch.uint8)
    with pytest.raises(ValueError, match="without a scale"):
        apply_linear({"w": w}, torch.ones(2, 128))


def test_int4_fused_adaln_matches_reference(models):
    jm, tm = models
    jf = j_quant.quantize_model_params(jm.params, bits=4)["flow_lm"]["flow_net"]
    tf = t_quant.quantize_model_params(tm.params, bits=4)["flow_lm"]["flow_net"]
    want, got = j_fnet.precompute_fused_adaln(jf), t_fnet.precompute_fused_adaln(tf)
    n_out = (3 * ARCH.flow_depth + 2) * ARCH.flow_dim
    assert got["w"].dtype == torch.uint8 and tuple(got["w"].shape) == (ARCH.flow_dim // 2, n_out)
    assert tuple(got["scale"].shape) == (ARCH.flow_dim // 128, n_out)  # scales join on the last axis
    np.testing.assert_array_equal(got["w"].numpy(), _np(want["w"]))
    np.testing.assert_array_equal(got["scale"].numpy(), _np(want["scale"]))
    np.testing.assert_allclose(got["b"].numpy(), _np(want["b"]), rtol=1e-7, atol=0)
    # Mixed forms (an int8 source among int4 ones): dequantized, float concat.
    jf["final_adaln"] = j_quant.quantize_linear(jm.params["flow_lm"]["flow_net"]["final_adaln"], bits=8)
    tf["final_adaln"] = t_quant.quantize_linear(tm.params["flow_lm"]["flow_net"]["final_adaln"], bits=8)
    want, got = j_fnet.precompute_fused_adaln(jf), t_fnet.precompute_fused_adaln(tf)
    assert "scale" not in got and got["w"].dtype == torch.float32
    np.testing.assert_allclose(got["w"].numpy(), _np(want["w"]), rtol=1e-6, atol=1e-7)


# -- safetensors --------------------------------------------------------------------


def _mixed_tensors():
    rng = np.random.RandomState(8)
    return {
        "f": rng.randn(3, 5).astype(np.float32),
        "i64": np.arange(6, dtype=np.int64).reshape(2, 3),
        "q": np.arange(-8, 8, dtype=np.int8).reshape(4, 4),
        "p": np.arange(256, dtype=np.uint8).reshape(16, 16),
        "s": np.float32(2.5) * np.ones((), np.float32),
    }


def test_writer_is_byte_equal_and_reads_back_through_the_reference():
    tensors = _mixed_tensors()
    meta = {"pockettts.quantize": "int4-g128", "n": "3"}
    data = t_st.encode_tensors(tensors, metadata=meta)
    assert data == j_st.encode_tensors(tensors, metadata=meta)
    store = j_st.open_store_from_bytes(data)
    assert store.metadata == meta
    assert [store.dtype(n) for n in ("f", "i64", "q", "p", "s")] == ["F32", "I64", "I8", "U8", "F32"]
    for name, arr in tensors.items():
        assert store.tensor(name).dtype == arr.dtype
        np.testing.assert_array_equal(store.tensor(name), arr)
    # And the other way round: the reference writer's bytes through the port's reader.
    back = t_st.load_bytes(j_st.encode_tensors(tensors, metadata=meta))
    assert list(back) == list(tensors)
    for name, arr in tensors.items():
        assert back[name].dtype == arr.dtype and back[name].shape == arr.shape
        np.testing.assert_array_equal(back[name], arr)


def test_bf16_writer_rounds_to_nearest_even_as_the_reference():
    rng = np.random.RandomState(9)
    one = np.float32(1.0)
    ties = np.array([one + 2.0**-8, one + 3 * 2.0**-8, -(one + 2.0**-8), 2.0**-130, -(2.0**-133)], np.float32)
    extremes = np.array([0.0, -0.0, np.inf, -np.inf, 3.3895e38, 1e-40], np.float32)
    values = np.concatenate([ties, extremes, (rng.randn(200) * 10.0 ** rng.randint(-8, 8, 200)).astype(np.float32)])
    want = j_st.encode_tensors({"b": values.astype(ml_dtypes.bfloat16)})
    got = t_st.encode_tensors({"b": t_export.to_bf16(values)})
    assert got == want
    back = t_st.load_bytes(got)["b"]
    np.testing.assert_array_equal(back, values.astype(ml_dtypes.bfloat16).astype(np.float32))
    assert back[0] == 1.0 and back[1] == one + 2.0**-6  # the two ties went to even


def test_read_header_metadata(tmp_path):
    path = tmp_path / "m.safetensors"
    t_st.write_file(path, {"a": np.zeros((2, 2), np.float32)}, metadata={"pockettts.quantize": "int4-g128"})
    assert t_st.read_header_metadata(path) == {"pockettts.quantize": "int4-g128"}
    assert j_st.read_header_metadata(path) == {"pockettts.quantize": "int4-g128"}
    t_st.write_file(path, {"a": np.zeros((2,), np.float32)})
    assert t_st.read_header_metadata(path) == {}
    with pytest.raises(t_st.SafetensorsError):
        t_st.load_bytes(b"\x00" * 4)


# -- the exporter and the pre-quantized loader ---------------------------------------


@pytest.mark.parametrize("float_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("bits", [8, 4])
def test_export_is_byte_equal_to_the_reference(checkpoint, bits, float_dtype):
    store = j_st.open_store_from_bytes(j_st.encode_tensors(checkpoint, metadata={"source": "synthetic"}))
    want, want_meta, want_q = j_export.build_quantized_checkpoint(
        store, bits, num_heads=ARCH.num_heads, float_dtype=float_dtype
    )
    got, got_meta, got_q = t_export.build_quantized_checkpoint(
        checkpoint, bits, num_heads=ARCH.num_heads, float_dtype=float_dtype, metadata={"source": "synthetic"}
    )
    assert got_q == want_q and len(got_q) > 20
    assert got_meta == want_meta and got_meta[t_export.QUANT_METADATA_KEY] == ("int8" if bits == 8 else "int4-g128")
    assert list(got) == list(want)
    assert t_st.encode_tensors(got, metadata=got_meta) == j_st.encode_tensors(want, metadata=want_meta)
    assert t_export.linear_weight_names(checkpoint, num_heads=ARCH.num_heads) == j_export.linear_weight_names(
        store, num_heads=ARCH.num_heads
    )


@pytest.mark.parametrize("bits", [8, 4])
def test_export_is_idempotent(checkpoint, bits):
    tensors, meta, quantized = t_export.build_quantized_checkpoint(checkpoint, bits, num_heads=ARCH.num_heads)
    data = t_st.encode_tensors(tensors, metadata=meta)
    again, meta2, quantized2 = t_export.build_quantized_checkpoint(
        t_st.load_bytes(data), bits, num_heads=ARCH.num_heads, metadata=meta
    )
    assert quantized and quantized2 == []  # already-quantized tensors pass through
    assert t_st.encode_tensors(again, metadata=meta2) == data
    # An int8 artifact exported again as int4 quantizes nothing and keeps its stamp.
    if bits == 8:
        _, meta3, quantized3 = t_export.build_quantized_checkpoint(
            t_st.load_bytes(data), 4, num_heads=ARCH.num_heads, metadata=meta
        )
        assert quantized3 == [] and meta3[t_export.QUANT_METADATA_KEY] == "int8"


@pytest.mark.parametrize("bits,k", [(8, 96), (4, 256), (4, 96), (4, 97)])
def test_quantize_weight_np_matches_load_time_quantization(bits, k):
    rng = np.random.RandomState(3)
    w = (rng.randn(24, k) / 7).astype(np.float32)  # [out, in]
    stored, scale = t_export.quantize_weight_np(w, bits)
    want_s, want_scale = j_export.quantize_weight_np(w, bits)
    np.testing.assert_array_equal(stored, want_s)
    np.testing.assert_array_equal(scale, want_scale)
    runtime = t_quant.quantize_linear({"w": torch.from_numpy(np.ascontiguousarray(w.T))}, bits=bits)
    assert stored.dtype == (np.int8 if bits == 8 or k % 2 else np.uint8)  # an odd k falls back to int8
    np.testing.assert_array_equal(stored.T, runtime["w"].numpy())
    np.testing.assert_array_equal(scale, runtime["scale"].numpy())
    np.testing.assert_allclose(
        t_export.dequantize_weight_np(stored, scale), t_quant.dequantize_weight(runtime).numpy().T, rtol=0, atol=0
    )
    np.testing.assert_array_equal(t_export.dequantize_weight_np(stored, scale), j_export.dequantize_weight_np(stored, scale))


@pytest.mark.parametrize("bits", [8, 4])
def test_prequantized_load_equals_load_time_quantization(checkpoint, models, bits, tmp_path):
    jm, tm = models
    tensors, meta, _ = t_export.build_quantized_checkpoint(checkpoint, bits, num_heads=ARCH.num_heads)
    path = tmp_path / "q.safetensors"
    t_st.write_file(path, tensors, metadata=meta)
    pre = load_model(str(path), num_heads=ARCH.num_heads, device="cpu")
    _assert_trees_equal(pre.params, t_quant.quantize_model_params(tm.params, bits=bits))
    # The reference's loader builds the same quantized leaves from the same file.
    jpre = _jax_leaves(load_model_from_store(j_st.open_store(path), num_heads=ARCH.num_heads).params)
    for name, leaf in _leaves(pre.params).items():
        if not leaf.is_floating_point() or name.endswith(".scale"):
            np.testing.assert_array_equal(leaf.numpy(), _np(jpre[name]), err_msg=name)
    # Quantizing the loaded tree again changes nothing.
    _assert_trees_equal(t_quant.quantize_model_params(pre.params, bits=4), pre.params)


def test_cast_leaves_packed_weights_and_group_scales_alone(checkpoint):
    tensors, meta, _ = t_export.build_quantized_checkpoint(checkpoint, 4, num_heads=ARCH.num_heads)
    model = load_model_from_tensors(t_st.load_bytes(t_st.encode_tensors(tensors, metadata=meta)), num_heads=ARCH.num_heads, device="cpu")
    cast = model.to("cpu", torch.bfloat16)
    lin = cast.params["flow_lm"]["transformer"]["layers"][0]["linear1"]
    assert (lin["w"].dtype, lin["scale"].dtype, lin["scale"].ndim) == (torch.uint8, torch.float32, 2)
    assert torch.equal(lin["w"], model.params["flow_lm"]["transformer"]["layers"][0]["linear1"]["w"])
    eos = cast.params["flow_lm"]["out_eos"]
    assert eos["w"].dtype == torch.uint8 and eos["b"].dtype == torch.bfloat16
    assert cast.params["flow_lm"]["bos_emb"].dtype == torch.bfloat16


# -- whole requests -------------------------------------------------------------------


def test_int4_single_runtime_matches_reference(models, checkpoint, tmp_path):
    jm, tm = models
    kw = dict(temperature=0.0, eos_threshold=1e9, max_steps=6)
    want = TPURuntime(jm, seed=1, frame_bucket=64, quantize=4).generate_audio([3, 17, 41], JConfig(**kw))
    rt = GPURuntime(tm, seed=1, frame_bucket=64, device="cpu", quantize=4)
    assert rt.model.params["flow_lm"]["transformer"]["layers"][0]["in_proj"]["w"].dtype == torch.uint8
    got = rt.generate_audio([3, 17, 41], GenerateConfig(**kw))
    assert len(got) == len(want) == 6 * 1920
    np.testing.assert_allclose(got, want, atol=REQUEST_TOL[0], rtol=REQUEST_TOL[1])
    # Served from the exported artifact: the same audio, sample for sample.
    tensors, meta, _ = t_export.build_quantized_checkpoint(checkpoint, 4, num_heads=ARCH.num_heads)
    path = tmp_path / "int4.safetensors"
    t_st.write_file(path, tensors, metadata=meta)
    pre = load_model(str(path), num_heads=ARCH.num_heads, device="cpu")
    assert isinstance(pre, PocketTTSModel)
    from_artifact = GPURuntime(pre, seed=1, frame_bucket=64, device="cpu", quantize=4).generate_audio(
        [3, 17, 41], GenerateConfig(**kw)
    )
    np.testing.assert_array_equal(from_artifact, got)


def test_int4_int8kv_batcher_matches_reference_batcher(models):
    jm, tm = models
    requests = (([5, 9, 2], 4), ([7, 1, 4, 8, 11, 13, 2], 6))
    common = dict(slots=2, prompt_capacity=64, max_frames=64, seed=3, quantize=4, kv_quantize=True)
    jb = JBatcher(jm, **common)
    jb.start()
    try:
        jf = [jb.submit(t, JConfig(temperature=0.0, eos_threshold=1e9, max_steps=n)) for t, n in requests]
        want = [f.result(timeout=300) for f in jf]
    finally:
        jb.stop()
    tb = ContinuousBatcher(tm, device="cpu", **common)
    assert tb._fused_ada["w"].dtype == torch.uint8 and tb._fused_ada["scale"].ndim == 2
    tb.start()
    try:
        tf = [tb.submit(t, GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=n)) for t, n in requests]
        got = [f.result(timeout=300) for f in tf]
    finally:
        tb.stop()
    for (tokens, n), g, w in zip(requests, got, want):
        assert g.dtype == np.float32 and len(g) == len(w) == n * 1920
        np.testing.assert_allclose(g, w, atol=KV_REQUEST_TOL[0], rtol=KV_REQUEST_TOL[1])
