"""The port's device meshes (``parallel/mesh.py``) and its tensor-parallel
transformer step against the JAX package's, on ``tiny_arch()`` (4 heads,
so tp=2 divides it): each mesh function's shapes and placement, the fused
QKV's head-major split rebuilt into the whole weight, the int8 and int4
scale splits, the refusals, and one batched AR step at dp=2 and at tp=2
against the JAX ``_batched_ar_step`` under ``dp_mesh``/``dp_tp_mesh`` on
its virtual CPU devices (float32, ``atol=1e-5``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.parallel import batching as j_batching
from go_pocket_tts_tpu.parallel import mesh as j_mesh
from go_pocket_tts_tpu.utils.safetensors import encode_tensors, open_store_from_bytes
from go_pocket_tts_tpu_torch.models import flow_lm as flm
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.models.quantize import quantize_model_params
from go_pocket_tts_tpu_torch.parallel import (
    dp_mesh,
    dp_tp_mesh,
    replicate_params,
    shard_batch,
    shard_params_tp,
    shard_state,
    shard_state_tp,
)
from go_pocket_tts_tpu_torch.parallel import batching as t_batching

ARCH = synthetic.tiny_arch()
# Widened so that every int4 linear is group-wise (tests/test_torch_int4.py).
WIDE = dataclasses.replace(ARCH, d_model=256, ffn_dim=512, flow_dim=256, flow_hidden=256)
SEED = 55
CPU = torch.device("cpu")
SLOTS, CAP = 8, 32


@pytest.fixture(scope="module")
def models():
    jm = load_model_from_store(
        open_store_from_bytes(encode_tensors(j_syn.build_checkpoint(ARCH, seed=SEED))),
        num_heads=ARCH.num_heads,
    )
    tm = load_model_from_tensors(synthetic.build_checkpoint(ARCH, seed=SEED), num_heads=ARCH.num_heads, device="cpu")
    return jm, tm


def _state_np(tcfg, latent):
    """The reference test's random live state (``tests/test_batching.py``)."""
    rng = np.random.RandomState(0)
    shape = (tcfg.num_layers, SLOTS, tcfg.num_heads, CAP, tcfg.head_dim)
    return {
        "cache": {
            "k": rng.randn(*shape).astype(np.float32) * 0.1,
            "v": rng.randn(*shape).astype(np.float32) * 0.1,
            "offset": rng.randint(1, 5, size=SLOTS).astype(np.int32),
        },
        "frame": rng.randn(SLOTS, 1, latent).astype(np.float32),
        "frames": np.zeros((SLOTS, 16, latent), np.float32),
        "n_frames": np.zeros((SLOTS,), np.int32),
        "countdown": np.full((SLOTS,), -1, np.int32),
        "done": np.zeros((SLOTS,), bool),
        "active": np.ones((SLOTS,), bool),
        "max_steps": np.full((SLOTS,), 10, np.int32),
        "eos_threshold": np.full((SLOTS,), 1e9, np.float32),
        "frames_after_eos": np.full((SLOTS,), 3, np.int32),
        "sigma": np.zeros((SLOTS,), np.float32),
    }


def _tree(fn, tree):
    return {k: _tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


# -- meshes -------------------------------------------------------------------


def test_mesh_shapes_and_placement():
    m = dp_mesh(4, device="cpu")
    assert m.axis_names == ("dp",) and m.shape == {"dp": 4} and (m.dp, m.tp) == (4, 1)
    assert m.devices == ((CPU,),) * 4
    m = dp_tp_mesh(2, 2, device="cpu")
    assert m.axis_names == ("dp", "tp") and dict(m.shape) == {"dp": 2, "tp": 2}
    assert m.devices == ((CPU, CPU), (CPU, CPU))
    # Explicit devices, repeats allowed: the form the one-card run takes.
    m = dp_tp_mesh(1, 3, devices=["cpu"] * 3)
    assert m.shape == {"dp": 1, "tp": 3} and m.devices == ((CPU,) * 3,)
    assert dp_mesh(devices=["cpu", "cpu"]).shape == {"dp": 2}
    with pytest.raises(ValueError, match="3 devices given for 4 ranks"):
        dp_tp_mesh(2, 2, devices=["cpu"] * 3)


@pytest.mark.parametrize("have", [0, 1])
def test_meshes_refuse_more_cards_than_the_host_has(monkeypatch, have):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: have)
    with pytest.raises(ValueError, match=f"requested 2 devices but only {have} available"):
        dp_mesh(2)
    with pytest.raises(ValueError, match=f"requested 4 devices but only {have} available"):
        dp_tp_mesh(2, 2)


def test_replicate_params_and_shard_batch():
    tree = {"a": torch.arange(8.0).reshape(4, 2), "b": {"c": torch.tensor(3.0)}}
    rows = replicate_params(tree, dp_mesh(2, device="cpu"))
    assert len(rows) == 2 and all(r["a"] is tree["a"] for r in rows)  # same device: shared
    parts = shard_batch(tree, dp_mesh(2, device="cpu"))
    np.testing.assert_array_equal(torch.cat([p["a"] for p in parts]).numpy(), tree["a"].numpy())
    assert all(p["a"].shape == (2, 2) and float(p["b"]["c"]) == 3.0 for p in parts)
    with pytest.raises(ValueError, match="does not split 3 ways"):
        shard_batch(tree, dp_mesh(3, device="cpu"))


@pytest.mark.parametrize("kv_quantize", [False, True])
def test_shard_state_splits_lanes_and_heads(models, kv_quantize):
    _, tm = models
    fcfg = tm.config.flow_lm
    state = t_batching.make_batched_state(fcfg, SLOTS, CAP, 16, 4, torch.float32, kv_quantize=kv_quantize, device="cpu")
    for key in state["cache"]:
        state["cache"][key].copy_(torch.randn(state["cache"][key].shape).to(state["cache"][key].dtype))
    parts = shard_state(state, dp_mesh(2, device="cpu"))
    for key, whole in state["cache"].items():
        axis = 0 if key == "offset" else 1
        np.testing.assert_array_equal(torch.cat([p["cache"][key] for p in parts], dim=axis).numpy(), whole.numpy())
    assert all(p["frames"].shape[0] == SLOTS // 2 for p in parts)
    parts = shard_state_tp(state, dp_tp_mesh(2, 2, device="cpu"))
    for key, whole in state["cache"].items():
        if key == "offset":
            continue
        rows = [torch.cat([r[key] for r in p["cache"]["ranks"]], dim=2) for p in parts]
        np.testing.assert_array_equal(torch.cat(rows, dim=1).numpy(), whole.numpy())
        assert parts[0]["cache"]["ranks"][0][key].shape[2] == ARCH.num_heads // 2
    # Every replica owns its buffers: none aliases the whole state.
    assert parts[0]["cache"]["ranks"][0]["k"].data_ptr() != state["cache"]["k"].data_ptr()


def test_divisibility_refusals(models):
    _, tm = models
    fcfg = tm.config.flow_lm
    state = t_batching.make_batched_state(fcfg, 3, CAP, 16, 4, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="3 slots do not split over dp=2"):
        shard_state(state, dp_mesh(2, device="cpu"))
    state = t_batching.make_batched_state(fcfg, 4, CAP, 16, 4, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="num_heads 4 does not split over tp=3"):
        shard_state_tp(state, dp_tp_mesh(1, 3, device="cpu"))
    with pytest.raises(ValueError, match="num_heads 4 does not split over tp=3"):
        shard_params_tp(tm.params, dp_tp_mesh(1, 3, device="cpu"), ARCH.num_heads)
    # An FFN width that tp does not divide.
    flow = dict(tm.params["flow_lm"])
    layers = [dict(layer) for layer in flow["transformer"]["layers"]]
    layers[0]["linear1"] = {"w": layers[0]["linear1"]["w"][:, :126]}
    flow["transformer"] = {**flow["transformer"], "layers": layers}
    with pytest.raises(ValueError, match="ffn_dim 126 does not split over tp=4"):
        shard_params_tp(flow, dp_tp_mesh(1, 4, device="cpu"), ARCH.num_heads)
    # A transformer linear with a bias.
    layers[0]["linear1"] = {**tm.params["flow_lm"]["transformer"]["layers"][0]["linear1"], "b": torch.zeros(128)}
    with pytest.raises(ValueError, match="carries no bias"):
        shard_params_tp(flow, dp_tp_mesh(1, 2, device="cpu"), ARCH.num_heads)
    with pytest.raises(ValueError, match="slots do not split over dp=2"):
        t_batching.ContinuousBatcher(tm, slots=3, mesh=dp_mesh(2, device="cpu"))


def _rebuilt(ranks, name, i):
    return [r["layers"][i][name] for r in ranks]


@pytest.mark.parametrize("bits", [0, 8, 4])
def test_shard_params_tp_rebuilds_every_linear(models, bits):
    """Rank r's in_proj columns are its heads' from each of q, k and v;
    rebuilt, every linear is the whole weight bit for bit, int8 scales
    follow the columns and stay whole under the row split, int4 group
    scales follow the columns and split their groups under the row split."""
    _, tm = models
    arch = synthetic.tiny_arch()
    params = tm.params
    if bits == 4:
        arch = WIDE
        params = load_model_from_tensors(synthetic.build_checkpoint(arch, seed=SEED), num_heads=4, device="cpu").params
    if bits:
        params = quantize_model_params(params, bits=bits)
    tp = 2
    (row,) = shard_params_tp(params, dp_tp_mesh(1, tp, device="cpu"), arch.num_heads)
    ranks = row["flow_lm"]["transformer"]["ranks"]
    assert len(ranks) == tp and row["flow_lm"]["flow_net"] is not None and "mimi" in row
    whole = params["flow_lm"]["transformer"]["layers"]
    d = arch.d_model
    for i, layer in enumerate(whole):
        for name in ("in_proj", "linear1"):
            shards = _rebuilt(ranks, name, i)
            for key, full in layer[name].items():
                if name == "in_proj":
                    w = d // tp
                    parts = [s[key][..., p * w : (p + 1) * w] for p in range(3) for s in shards]
                else:
                    parts = [s[key] for s in shards]
                np.testing.assert_array_equal(torch.cat(parts, dim=-1).numpy(), full.numpy())
        for name in ("out_proj", "linear2"):
            shards = _rebuilt(ranks, name, i)
            full = layer[name]
            np.testing.assert_array_equal(torch.cat([s["w"] for s in shards]).numpy(), full["w"].numpy())
            if "scale" in full:
                if full["scale"].ndim == 2:
                    assert shards[0]["scale"].shape[0] == full["scale"].shape[0] // tp
                    np.testing.assert_array_equal(torch.cat([s["scale"] for s in shards]).numpy(), full["scale"].numpy())
                else:
                    for s in shards:
                        np.testing.assert_array_equal(s["scale"].numpy(), full["scale"].numpy())
    if bits == 4:
        assert whole[0]["out_proj"]["scale"].ndim == 2  # group-wise, the split this case is for


def test_int4_group_scales_refuse_a_partial_group(models):
    arch = WIDE
    params = quantize_model_params(
        load_model_from_tensors(synthetic.build_checkpoint(arch, seed=SEED), num_heads=4, device="cpu").params, bits=4
    )
    with pytest.raises(ValueError, match="group scales"):  # out_proj: 2 groups over 4 ranks
        shard_params_tp(params, dp_tp_mesh(1, 4, device="cpu"), 4)


# -- one batched AR step against the reference's meshes -----------------------


def _jax_step(jm, state, mesh_kind):
    flow, cfg = jm.params["flow_lm"], jm.config.flow_lm
    need = 4 if mesh_kind == "dp_tp" else 2
    if len(jax.devices()) < need:
        pytest.skip(f"needs {need} virtual CPU devices (tests/conftest.py makes 8)")
    jstate = _tree(jnp.asarray, state)
    noise = jnp.zeros((SLOTS, cfg.latent_dim), jnp.float32)
    if mesh_kind == "dp":
        mesh = j_mesh.dp_mesh(2)
        flow, jstate = j_mesh.replicate_params(flow, mesh), j_mesh.shard_state(jstate, mesh)
    else:
        mesh = j_mesh.dp_tp_mesh(2, 2)
        flow, jstate = j_mesh.shard_params_tp(flow, mesh), j_mesh.shard_state_tp(jstate, mesh)
    return j_batching._batched_ar_step(flow, cfg, jstate, j_mesh.shard_batch(noise, mesh), 1)


@pytest.mark.parametrize("mesh_kind", ["dp", "dp_tp"])
def test_batched_step_over_a_mesh_matches_the_reference(models, mesh_kind):
    jm, tm = models
    cfg = tm.config.flow_lm
    state = _state_np(cfg.transformer, cfg.latent_dim)
    want = _jax_step(jm, state, mesh_kind)

    whole = _tree(torch.from_numpy, state)
    if mesh_kind == "dp":
        mesh = dp_mesh(2, device="cpu")
        rows, states = replicate_params(tm.params["flow_lm"], mesh), shard_state(whole, mesh)
    else:
        mesh = dp_tp_mesh(2, 2, device="cpu")
        rows, states = shard_params_tp(tm.params["flow_lm"], mesh, ARCH.num_heads), shard_state_tp(whole, mesh)
    outs = []
    with torch.no_grad():
        for flow, st in zip(rows, states):
            noise = torch.zeros((SLOTS // 2, cfg.latent_dim))
            tc = flm.fnet.precompute_time_cond(flow["flow_net"], 1)
            ada = flm.fnet.precompute_fused_adaln(flow["flow_net"])
            outs.append(t_batching._ar_step_body(flow, cfg, st, noise, 1, tc, ada))
    frame = torch.cat([o["frame"] for o in outs]).numpy()
    np.testing.assert_allclose(frame, np.asarray(want["frame"]), atol=1e-5)
    offsets = torch.cat([o["cache"]["offset"] for o in outs]).numpy()
    np.testing.assert_array_equal(offsets, np.asarray(want["cache"]["offset"]))
    for key in ("k", "v"):
        parts = [o["cache"][key] if mesh_kind == "dp" else torch.cat([r[key] for r in o["cache"]["ranks"]], dim=2) for o in outs]
        np.testing.assert_allclose(torch.cat(parts, dim=1).numpy(), np.asarray(want["cache"][key]), atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_tp_step_matches_the_unsharded_step(bits):
    """A tp=2 step of int8 or group-wise int4 weights with an int8 KV cache
    (the serving knobs) against the port's unsharded step, float32."""
    arch = WIDE
    model = load_model_from_tensors(synthetic.build_checkpoint(arch, seed=SEED), num_heads=4, device="cpu")
    flow = quantize_model_params(model.params, bits=bits)["flow_lm"]
    cfg = model.config.flow_lm
    state = t_batching.make_batched_state(cfg, 4, CAP, 16, 4, torch.float32, kv_quantize=True, device="cpu")
    gen = torch.Generator().manual_seed(1)
    for key in ("k", "v"):
        state["cache"][key].copy_(torch.randint(-100, 100, state["cache"][key].shape, generator=gen).to(torch.int8))
        state["cache"][f"{key}_scale"].copy_(torch.rand(state["cache"][f"{key}_scale"].shape, generator=gen) * 0.01)
    state["cache"]["offset"].copy_(torch.tensor([1, 5, 9, 3], dtype=torch.int32))
    state["frame"].copy_(torch.randn(state["frame"].shape, generator=gen))
    state["active"].fill_(True)
    state["max_steps"].fill_(10)
    state["eos_threshold"].fill_(1e9)
    (tp_state,) = shard_state_tp(state, dp_tp_mesh(1, 2, device="cpu"))
    (tp_flow,) = shard_params_tp(flow, dp_tp_mesh(1, 2, device="cpu"), 4)
    noise = torch.zeros((4, cfg.latent_dim))
    with torch.no_grad():
        tc = flm.fnet.precompute_time_cond(flow["flow_net"], 1)
        ada = flm.fnet.precompute_fused_adaln(flow["flow_net"])
        got = t_batching._ar_step_body(tp_flow, cfg, tp_state, noise, 1, tc, ada)
        want = t_batching._ar_step_body(flow, cfg, state, noise, 1, tc, ada)
    np.testing.assert_allclose(got["frame"].numpy(), want["frame"].numpy(), atol=1e-5)
    # The step's new rows come from column products of another width, so
    # their float32 sums may round apart: a scale by an ulp, a level by one.
    for key in ("k", "v"):
        joined = torch.cat([r[key] for r in got["cache"]["ranks"]], dim=2)
        assert (joined.int() - want["cache"][key].int()).abs().max() <= 1
        scales = torch.cat([r[f"{key}_scale"] for r in got["cache"]["ranks"]], dim=2)
        np.testing.assert_allclose(scales.numpy(), want["cache"][f"{key}_scale"].numpy(), rtol=1e-6)
