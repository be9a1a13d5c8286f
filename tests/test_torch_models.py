"""The port's model modules (go_pocket_tts_tpu_torch.models) against the JAX
package's, on the CPU, on one synthetic checkpoint loaded by both."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from go_pocket_tts_tpu.models import flow_lm as j_flm
from go_pocket_tts_tpu.models import flow_net as j_fnet
from go_pocket_tts_tpu.models import flow_transformer as j_ftr
from go_pocket_tts_tpu.models import mimi as j_mimi
from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.ops import TOLERANCES
from go_pocket_tts_tpu.utils.safetensors import encode_tensors, open_store_from_bytes
from go_pocket_tts_tpu_torch.convert import params_from_jax
from go_pocket_tts_tpu_torch.kernels import seanet_tail as t_st
from go_pocket_tts_tpu_torch.models import flow_lm as t_flm
from go_pocket_tts_tpu_torch.models import flow_net as t_fnet
from go_pocket_tts_tpu_torch.models import flow_transformer as t_ftr
from go_pocket_tts_tpu_torch.models import mimi as t_mimi
from go_pocket_tts_tpu_torch.models import synthetic as t_syn
from go_pocket_tts_tpu_torch.models.model import KEEP_F32, load_model_from_tensors
from go_pocket_tts_tpu_torch.models.params import tree_map
from go_pocket_tts_tpu_torch.utils import safetensors as t_st_io

ARCH = t_syn.tiny_arch()
SEED = 21
ATOL, RTOL = TOLERANCES["linear"]
DERIVED = ("rope_cos", "rope_sin", "latent_to_mimi")  # computed at load, not read


def jax_model(arch=ARCH, seed=SEED):
    tensors = j_syn.build_checkpoint(arch, seed=seed)
    return load_model_from_store(open_store_from_bytes(encode_tensors(tensors)), num_heads=arch.num_heads)


@pytest.fixture(scope="module")
def models():
    jm = jax_model()
    tm = load_model_from_tensors(t_syn.build_checkpoint(ARCH, seed=SEED), num_heads=ARCH.num_heads, device="cpu")
    return jm, tm


def close(got: torch.Tensor, want, atol=ATOL, rtol=RTOL) -> None:
    np.testing.assert_allclose(got.float().numpy(), np.array(want, np.float32), atol=atol, rtol=rtol)


def leaves(tree):
    out = {}
    tree_map(lambda path, leaf: out.__setitem__(".".join(path), leaf), tree)
    return out


@pytest.mark.parametrize("arch", [ARCH, dataclasses.replace(ARCH, seanet_channels=(32, 32, 128, 64))])
def test_synthetic_checkpoint_matches_reference(arch):
    mine = t_syn.build_checkpoint(arch, seed=3)
    ref = j_syn.build_checkpoint(arch, seed=3)
    assert set(mine) <= set(ref)
    for name, arr in mine.items():
        np.testing.assert_array_equal(arr, ref[name], err_msg=name)


def test_params_from_jax_matches_loader(models):
    jm, tm = models
    converted = leaves(params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params), device="cpu"))
    loaded = leaves(tm.params)
    assert converted.keys() == loaded.keys()
    for name, leaf in loaded.items():
        assert converted[name].dtype == leaf.dtype == torch.float32, name
        if any(part in DERIVED for part in name.split(".")):
            # Computed at load by each framework's own trig / matmul.
            close(converted[name], leaf.numpy(), atol=1e-6, rtol=1e-6)
        else:
            assert torch.equal(converted[name], leaf), name


def test_params_from_jax_bf16_keeps_f32_leaves(models):
    jm, tm = models
    converted = leaves(
        params_from_jax(jax.tree_util.tree_map(np.asarray, jm.astype(jnp.bfloat16).params), device="cpu", dtype=torch.bfloat16)
    )
    cast = leaves(tm.to("cpu", torch.bfloat16).params)
    for name, leaf in cast.items():
        keep = any(part in KEEP_F32 for part in name.split("."))
        assert leaf.dtype == (torch.float32 if keep else torch.bfloat16), name
        if not any(part in DERIVED for part in name.split(".")):
            assert torch.equal(converted[name].to(leaf.dtype), leaf), name


def test_transformer_prefill_then_steps(models):
    jm, tm = models
    jcfg, tcfg = jm.config.flow_lm.transformer, tm.config.flow_lm.transformer
    jp, tp = jm.params["flow_lm"]["transformer"], tm.params["flow_lm"]["transformer"]
    rng = np.random.RandomState(0)
    x = rng.randn(1, 8, ARCH.d_model).astype(np.float32)
    jcache = j_ftr.init_kv_cache(jcfg, 1, 32)
    tcache = t_ftr.init_kv_cache(tcfg, 1, 32)
    jy, jcache = j_ftr.transformer_forward_cached(jp, jcfg, jcache, jnp.asarray(x), jnp.int32(5))
    ty, tcache = t_ftr.transformer_forward_cached(tp, tcfg, tcache, torch.from_numpy(x), 5)
    close(ty, jy, *TOLERANCES["attention"])
    for _ in range(3):
        step = rng.randn(1, 1, ARCH.d_model).astype(np.float32)
        jy, jcache = j_ftr.transformer_forward_cached(jp, jcfg, jcache, jnp.asarray(step))
        ty, tcache = t_ftr.transformer_forward_cached(tp, tcfg, tcache, torch.from_numpy(step))
        close(ty, jy, *TOLERANCES["attention"])
    assert int(tcache["offset"]) == int(jcache["offset"]) == 8
    assert tcache["offset"].dtype == torch.int32
    for key in ("k", "v"):
        close(tcache[key], jcache[key], *TOLERANCES["attention"])


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("hoisted", [True, False])
def test_lsd_decode(models, steps, hoisted):
    jm, tm = models
    jp, tp = jm.params["flow_lm"]["flow_net"], tm.params["flow_lm"]["flow_net"]
    rng = np.random.RandomState(steps)
    cond = rng.randn(2, ARCH.d_model).astype(np.float32)
    x0 = rng.randn(2, ARCH.latent_dim).astype(np.float32)
    j_extra = (j_fnet.precompute_time_cond(jp, steps), j_fnet.precompute_fused_adaln(jp)) if hoisted else ()
    t_extra = (t_fnet.precompute_time_cond(tp, steps), t_fnet.precompute_fused_adaln(tp)) if hoisted else ()
    if hoisted:
        close(t_extra[0], j_extra[0])
        close(t_extra[1]["w"], j_extra[1]["w"], 0, 0)
        close(t_extra[1]["b"], j_extra[1]["b"], 0, 0)
    want = j_fnet.lsd_decode(jp, jnp.asarray(cond), jnp.asarray(x0), steps, *j_extra)
    got = t_fnet.lsd_decode(tp, torch.from_numpy(cond), torch.from_numpy(x0), steps, *t_extra)
    close(got, want)


def test_flow_lm_prompt_and_ar_core(models):
    jm, tm = models
    jp, tp = jm.params["flow_lm"], tm.params["flow_lm"]
    jcfg, tcfg = jm.config.flow_lm, tm.config.flow_lm
    tokens = np.array([[3, 17, 41, 9, 0, 0, 0, 0]], np.int64)
    jemb = j_flm.text_embeddings(jp, jnp.asarray(tokens, jnp.int32))
    temb = t_flm.text_embeddings(tp, torch.from_numpy(tokens))
    close(temb, jemb, 0, 0)
    jcache = j_flm.prompt(jp, jcfg, j_ftr.init_kv_cache(jcfg.transformer, 1, 64), jemb, jnp.int32(4))
    tcache = t_flm.prompt(tp, tcfg, t_ftr.init_kv_cache(tcfg.transformer, 1, 64), temb, 4)
    rng = np.random.RandomState(7)
    frame = np.full((1, 1, ARCH.latent_dim), np.nan, np.float32)  # BOS sentinel
    for _ in range(3):
        noise = (rng.randn(1, ARCH.latent_dim) * 0.5).astype(np.float32)
        jcache, jframe, jeos = j_flm.ar_core(jp, jcfg, jcache, jnp.asarray(frame), jnp.asarray(noise))
        tcache, tframe, teos = t_flm.ar_core(tp, tcfg, tcache, torch.from_numpy(frame), torch.from_numpy(noise))
        close(tframe, jframe, *TOLERANCES["attention"])
        close(teos, jeos, *TOLERANCES["attention"])
        frame = np.array(jframe, np.float32)
    assert int(tcache["offset"]) == 7


def test_latent_to_mimi(models):
    jm, tm = models
    latent = np.random.RandomState(1).randn(2, 5, ARCH.latent_dim).astype(np.float32)
    close(tm.latent_to_mimi(torch.from_numpy(latent)), jm.latent_to_mimi(jnp.asarray(latent)))
    mimi_latent = np.random.RandomState(2).randn(1, ARCH.latent_dim, 4).astype(np.float32)
    close(
        t_mimi.quantizer_project(tm.params["mimi"], torch.from_numpy(mimi_latent)),
        j_mimi.quantizer_project(jm.params["mimi"], jnp.asarray(mimi_latent)),
    )


@pytest.mark.parametrize("frames", [3])
def test_mimi_decode_tiny(models, frames):
    jm, tm = models
    latent = np.random.RandomState(frames).randn(1, ARCH.mimi_dim, frames).astype(np.float32) * 0.3
    want = j_mimi.mimi_decode(jm.params["mimi"], jm.config.mimi, jnp.asarray(latent))
    got = t_mimi.mimi_decode(tm.params["mimi"], tm.config.mimi, torch.from_numpy(latent))
    assert got.shape == (1, 1, 1920 * frames)
    close(got, want, *TOLERANCES["conv1d"])


def test_mimi_decode_takes_the_fused_up_tail(monkeypatch):
    """Under an arch whose SEANet tail hits the kernel gate, both packages
    take the fused up3 tail (the JAX one in interpret mode) and agree."""
    arch = dataclasses.replace(ARCH, seanet_channels=(32, 32, 128, 64))
    jm = jax_model(arch, seed=4)
    tm = load_model_from_tensors(t_syn.build_checkpoint(arch, seed=4), num_heads=arch.num_heads, device="cpu")
    latent = np.random.RandomState(0).randn(1, arch.mimi_dim, 32).astype(np.float32) * 0.3
    calls = []
    real = t_st.fused_seanet_up_tail
    monkeypatch.setattr(t_st, "fused_seanet_up_tail", lambda *a: calls.append(a[0].shape) or real(*a))
    got = t_mimi.mimi_decode(tm.params["mimi"], tm.config.mimi, torch.from_numpy(latent))
    assert calls == [torch.Size([1, 128, 32 * 480])]
    cfg = dataclasses.replace(jm.config.mimi, use_pallas=True)
    want = j_mimi.mimi_decode(jm.params["mimi"], cfg, jnp.asarray(latent))
    close(got, want, *TOLERANCES["conv1d"])


def test_mimi_decode_fallback_tail_matches_reference():
    """15 frames: the pre-up3 length (7200) misses the up-tail gate, so the
    port decodes through up3 and the fused post-up3 tail."""
    arch = dataclasses.replace(ARCH, seanet_channels=(32, 32, 128, 64))
    jm = jax_model(arch, seed=6)
    tm = load_model_from_tensors(t_syn.build_checkpoint(arch, seed=6), num_heads=arch.num_heads, device="cpu")
    latent = np.random.RandomState(3).randn(1, arch.mimi_dim, 15).astype(np.float32) * 0.3
    want = j_mimi.mimi_decode(jm.params["mimi"], jm.config.mimi, jnp.asarray(latent))
    got = t_mimi.mimi_decode(tm.params["mimi"], tm.config.mimi, torch.from_numpy(latent))
    close(got, want, *TOLERANCES["conv1d"])


def test_model_cast_keeps_f32_leaves(models):
    _, tm = models
    cast = tm.to("cpu", torch.bfloat16)
    assert cast.dtype == torch.bfloat16 and cast.device == torch.device("cpu")
    assert cast.params["flow_lm"]["transformer"]["rope_cos"].dtype == torch.float32
    assert cast.params["latent_to_mimi"]["w"].dtype == torch.float32
    assert cast.params["mimi"]["up3"]["w"].dtype == torch.bfloat16
    assert tm.dtype == torch.float32  # the original is untouched


def test_safetensors_reader_reads_the_reference_encoding(tmp_path):
    tensors = t_syn.build_checkpoint(ARCH, seed=2)
    path = tmp_path / "model.safetensors"
    path.write_bytes(encode_tensors(tensors))
    decoded = t_st_io.load_file(path)
    assert decoded.keys() == tensors.keys()
    for name, arr in tensors.items():  # the reference encoder stores F32
        np.testing.assert_array_equal(decoded[name], arr.astype(np.float32))
    with pytest.raises(t_st_io.SafetensorsError):
        t_st_io.load_bytes(b"\x00" * 4)


def test_mimi_decode_takes_the_up2_kernel(monkeypatch):
    """Under a SEANet whose up2 stage has the kernel's widths (256 → 128),
    the port's decode runs ``fused_up2_res`` (then the fused up3 tail) and
    matches the JAX package's decode, which runs the same stages as ops."""
    arch = dataclasses.replace(ARCH, seanet_channels=(32, 256, 128, 64))
    jm = jax_model(arch, seed=5)
    tm = load_model_from_tensors(t_syn.build_checkpoint(arch, seed=5), num_heads=arch.num_heads, device="cpu")
    latent = np.random.RandomState(4).randn(1, arch.mimi_dim, 32).astype(np.float32) * 0.3
    calls = []
    real = t_st.fused_up2_res
    monkeypatch.setattr(t_st, "fused_up2_res", lambda *a: calls.append(a[0].shape) or real(*a))
    got = t_mimi.mimi_decode(tm.params["mimi"], tm.config.mimi, torch.from_numpy(latent))
    assert calls == [torch.Size([1, 256, 32 * 96])]
    want = j_mimi.mimi_decode(jm.params["mimi"], jm.config.mimi, jnp.asarray(latent))
    assert got.shape == (1, 1, 32 * 1920)
    close(got, want, *TOLERANCES["conv1d"])
