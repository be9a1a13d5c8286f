"""The port's safetensors ``Store`` against the JAX package's: the same
payloads parsed to the same names, metadata, shapes, dtypes and bits, the
same refusals of malformed payloads with the same messages, the key mapper,
the header-only reads, and ``load_model_from_store`` against ``load_model``
and the JAX package's loader."""

import json
import struct

import numpy as np
import pytest
import torch

import ml_dtypes

from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store as j_load_model_from_store
from go_pocket_tts_tpu.utils import safetensors as j_st
from go_pocket_tts_tpu_torch.model_assets.quantize_export import build_quantized_checkpoint, reencode_tensor
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model, load_model_from_store, load_model_from_tensors
from go_pocket_tts_tpu_torch.models.params import tree_map
from go_pocket_tts_tpu_torch.utils import safetensors as t_st

ARCH = synthetic.tiny_arch()
SEED = 12


@pytest.fixture(scope="module")
def payloads():
    """Four payloads written by the port: the float checkpoint, its bf16
    re-encode, its int4 artifact, and a voice model state with F16 and I64
    tensors (the last through the JAX writer, which takes float16)."""
    tensors = synthetic.build_checkpoint(ARCH, seed=SEED)
    bf16 = {name: reencode_tensor(tensors, name, "bf16") for name in sorted(tensors)}
    q4, meta, _ = build_quantized_checkpoint(tensors, 4, num_heads=ARCH.num_heads)
    rng = np.random.RandomState(SEED)
    state = {
        "transformer.layers.0.self_attn/cache": rng.randn(2, 1, 3, ARCH.num_heads, 4).astype(np.float32),
        "transformer.layers.0.self_attn/offset": np.array([3], np.int64),
    }
    f16 = j_st.encode_tensors(state)
    header_len = struct.unpack_from("<Q", f16)[0]
    header = json.loads(f16[8 : 8 + header_len])
    # Re-tag the cache as F16 (half the bytes): the reference writer has no F16.
    cache = state["transformer.layers.0.self_attn/cache"].astype("<f2").tobytes()
    header["transformer.layers.0.self_attn/cache"] = {"dtype": "F16", "shape": [2, 1, 3, ARCH.num_heads, 4], "data_offsets": [0, len(cache)]}
    header["transformer.layers.0.self_attn/offset"]["data_offsets"] = [len(cache), len(cache) + 8]
    hb = json.dumps(header).encode()
    f16 = struct.pack("<Q", len(hb)) + hb + cache + np.array([3], "<i8").tobytes()
    return {
        "float": t_st.encode_tensors(tensors, metadata={"source": "synthetic"}),
        "bf16": t_st.encode_tensors(bf16),
        "int4": t_st.encode_tensors(q4, metadata=meta),
        "f16_i64": f16,
    }


@pytest.mark.parametrize("kind", ["float", "bf16", "int4", "f16_i64"])
def test_store_matches_the_reference_store(payloads, kind):
    data = payloads[kind]
    j, t = j_st.Store(data), t_st.Store(data)
    assert t.names() == j.names() and len(t) == len(j.names())
    assert dict(t.metadata) == dict(j.metadata)
    for name in j.names():
        assert t.has(name) and name in t
        assert t.shape(name) == j.shape(name) and t.dtype(name) == j.dtype(name)
        for got, want in ((t.tensor(name), j.tensor(name)), (t.tensor_f32(name), j.tensor_f32(name))):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tobytes() == want.tobytes(), name
        assert t[name].tobytes() == j.tensor(name).tobytes()
    # load_bytes: every tensor, in header order, as the Store decodes it.
    loaded = t_st.load_bytes(data)
    assert list(loaded) == list(t) and sorted(loaded) == j.names()
    assert all(loaded[n].tobytes() == j.tensor(n).tobytes() for n in loaded)
    assert not t.has("missing")
    with pytest.raises(KeyError, match="not found"):
        t.tensor("missing")


def _payload(header: dict, data: bytes = b"") -> bytes:
    raw = json.dumps(header).encode()
    return struct.pack("<Q", len(raw)) + raw + data


def _entry(dtype="F32", shape=(2,), offsets=(0, 8)):
    return {"dtype": dtype, "shape": list(shape), "data_offsets": list(offsets)}


MALFORMED = {
    "too_short": b"\x00" * 4,
    "header_over_limit": struct.pack("<Q", 100 * 1024 * 1024 + 1) + b"{}",
    "header_past_payload": struct.pack("<Q", 64) + b"{}",
    "bad_json": struct.pack("<Q", 5) + b"{nope",
    "not_an_object": _payload([1, 2]),
    "entry_not_an_object": _payload({"a": 3}),
    "bad_dtype": _payload({"a": _entry(dtype="Q7")}, b"\x00" * 8),
    "bad_shape": _payload({"a": {"dtype": "F32", "shape": [-1], "data_offsets": [0, 4]}}, b"\x00" * 8),
    "bad_offsets": _payload({"a": {"dtype": "F32", "shape": [2], "data_offsets": [0]}}, b"\x00" * 8),
    "range_not_the_shape": _payload({"a": _entry(offsets=(0, 12))}, b"\x00" * 12),
    "offsets_past_payload": _payload({"a": _entry(offsets=(8, 16))}, b"\x00" * 8),
}


@pytest.mark.parametrize("case", list(MALFORMED))
def test_malformed_payloads_raise_the_same_error(case):
    data = MALFORMED[case]
    with pytest.raises(j_st.SafetensorsError) as want:
        j_st.Store(data)
    with pytest.raises(t_st.SafetensorsError) as got:
        t_st.Store(data)
    assert str(got.value) == str(want.value)
    with pytest.raises(t_st.SafetensorsError):
        t_st.load_bytes(data)


def test_key_mapper_and_strict_remap():
    data = t_st.encode_tensors(
        {"a.w": np.ones(2, np.float32), "b.w": np.zeros(3, np.float32), "drop.me": np.ones(1, np.float32)}
    )

    def rename(name):
        return name.replace(".w", ".weight"), not name.startswith("drop")

    def merge(name):
        return "same", True

    for mapper, strict in ((rename, False), (rename, True), (merge, False)):
        j, t = j_st.Store(data, key_mapper=mapper, strict_remap=strict), t_st.Store(data, key_mapper=mapper, strict_remap=strict)
        assert t.names() == j.names()
        assert all(t.tensor(n).tobytes() == j.tensor(n).tobytes() for n in j.names())
    assert t_st.Store(data, key_mapper=rename).names() == ["a.weight", "b.weight"]
    for mapper, message in ((merge, "duplicate name"), (lambda n: (n, False), "removed every tensor")):
        with pytest.raises(j_st.SafetensorsError) as want:
            j_st.Store(data, key_mapper=mapper, strict_remap=True)
        with pytest.raises(t_st.SafetensorsError, match=message) as got:
            t_st.Store(data, key_mapper=mapper, strict_remap=True)
        assert str(got.value) == str(want.value)


def test_header_reads_and_model_key_validation(tmp_path, payloads):
    path = tmp_path / "m.safetensors"
    path.write_bytes(payloads["int4"])
    assert t_st.read_header(path) == j_st.read_header(path)
    assert t_st.read_header_metadata(path) == j_st.read_header_metadata(path) == {"pockettts.quantize": "int4-g128"}
    assert t_st.REQUIRED_MODEL_KEYS == j_st.REQUIRED_MODEL_KEYS
    t_st.validate_model_keys(path)
    stripped = tmp_path / "s.safetensors"
    t_st.write_file(stripped, {"flow_lm.bos_emb": np.zeros(8, np.float32)})
    with pytest.raises(j_st.SafetensorsError) as want:
        j_st.validate_model_keys(stripped)
    with pytest.raises(t_st.SafetensorsError, match="missing required tensors") as got:
        t_st.validate_model_keys(stripped)
    assert str(got.value) == str(want.value)
    short = tmp_path / "short.safetensors"
    short.write_bytes(b"\x01")
    with pytest.raises(t_st.SafetensorsError, match="too small"):
        t_st.read_header(short)
    with pytest.raises(t_st.SafetensorsError, match="truncated"):
        short.write_bytes(struct.pack("<Q", 10) + b"{}")
        t_st.read_header(short)
    assert t_st.open_store(path).names() == t_st.open_store_from_bytes(payloads["int4"]).names()


def _leaves(tree) -> dict:
    out = {}

    def collect(path, leaf):
        out[".".join(path)] = leaf
        return leaf

    tree_map(collect, tree)
    return out


# RoPE tables are rebuilt by torch's CPU cos on each load, which may take a
# vector or a scalar path: two builds differ by a few float32 ulps.
ROPE_ATOL = 1e-5


@pytest.mark.parametrize("kind", ["float", "int4"])
def test_load_model_from_store_is_load_model(tmp_path, payloads, kind):
    path = tmp_path / "m.safetensors"
    path.write_bytes(payloads[kind])
    from_store = load_model_from_store(t_st.open_store(path), num_heads=ARCH.num_heads, device="cpu")
    from_file = load_model(str(path), num_heads=ARCH.num_heads, device="cpu")
    from_tensors = load_model_from_tensors(t_st.load_file(path), num_heads=ARCH.num_heads, device="cpu")
    assert from_store.config == from_file.config == from_tensors.config
    a, b, c = _leaves(from_store.params), _leaves(from_file.params), _leaves(from_tensors.params)
    assert set(a) == set(b) == set(c)
    for name, x in a.items():
        atol = ROPE_ATOL if "rope" in name else 0.0
        for other in (b[name], c[name]):
            assert x.dtype == other.dtype, name
            torch.testing.assert_close(x, other, atol=atol, rtol=0)
    if kind == "float":
        # The JAX loader reads the same store to the same config and leaves.
        jm = j_load_model_from_store(j_st.Store(payloads[kind]), num_heads=ARCH.num_heads)
        assert from_store.config.flow_lm.d_model == jm.config.flow_lm.d_model == ARCH.d_model
        bos = np.asarray(jm.params["flow_lm"]["bos_emb"])
        assert np.array_equal(a["flow_lm.bos_emb"].numpy(), bos)


def test_bf16_reencode_reads_back_as_the_reference_writes_it():
    """A bf16 re-encode written by the port equals the JAX writer's bytes
    for the same values (``ml_dtypes`` there, ``torch.bfloat16`` here)."""
    x = np.random.RandomState(SEED).randn(5, 3).astype(np.float32)
    want = j_st.encode_tensors({"x": x.astype(ml_dtypes.bfloat16)})
    got = t_st.encode_tensors({"x": torch.from_numpy(x).to(torch.bfloat16)})
    assert got == want
    assert t_st.Store(got).tensor("x").tobytes() == j_st.Store(want).tensor("x").tobytes()
