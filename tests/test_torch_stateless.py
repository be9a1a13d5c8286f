"""The port's stateless forward and its helpers against the JAX package's, on
the CPU: ``flow_lm.flow_main``, ``flow_transformer.transformer_forward_stateless``,
``flow_net.flow_direction`` and ``flow_lm.sample_noise``. The same NumPy
inputs go through both, within ``ops.TOLERANCES``; ``flow_main``'s last hidden
also matches the port's own cached path (a prefill, then one step per frame)."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from go_pocket_tts_tpu.models import flow_lm as j_flm
from go_pocket_tts_tpu.models import flow_net as j_fnet
from go_pocket_tts_tpu.models import flow_transformer as j_ftr
from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.utils.safetensors import encode_tensors, open_store_from_bytes
from go_pocket_tts_tpu_torch.models import flow_lm as t_flm
from go_pocket_tts_tpu_torch.models import flow_net as t_fnet
from go_pocket_tts_tpu_torch.models import flow_transformer as t_ftr
from go_pocket_tts_tpu_torch.models import synthetic as t_syn
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.ops import TOLERANCES

ARCH = t_syn.tiny_arch()
SEED = 31


@pytest.fixture(scope="module")
def models():
    jm = load_model_from_store(
        open_store_from_bytes(encode_tensors(j_syn.build_checkpoint(ARCH, seed=SEED))), num_heads=ARCH.num_heads
    )
    tm = load_model_from_tensors(t_syn.build_checkpoint(ARCH, seed=SEED), num_heads=ARCH.num_heads, device="cpu")
    return jm, tm


def close(got: torch.Tensor, want, tol: str) -> None:
    atol, rtol = TOLERANCES[tol]
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=atol, rtol=rtol)


def _frames(rng, t: int, bos_first: bool = True) -> np.ndarray:
    seq = rng.randn(2, t, ARCH.latent_dim).astype(np.float32)
    if bos_first:
        seq[:, 0] = np.nan
    return seq


@pytest.mark.parametrize("t", [1, 5])
def test_transformer_forward_stateless(models, t):
    jm, tm = models
    x = np.random.RandomState(t).randn(2, t, ARCH.d_model).astype(np.float32)
    want = j_ftr.transformer_forward_stateless(
        jm.params["flow_lm"]["transformer"], jm.config.flow_lm.transformer, jnp.asarray(x)
    )
    got = t_ftr.transformer_forward_stateless(
        tm.params["flow_lm"]["transformer"], tm.config.flow_lm.transformer, torch.from_numpy(x)
    )
    close(got, want, "attention")


def test_transformer_forward_stateless_windowed(models):
    """With a ``context`` window (Mimi's attention form) keys older than
    the window drop out, as in the reference."""
    import dataclasses

    jm, tm = models
    x = np.random.RandomState(3).randn(1, 12, ARCH.d_model).astype(np.float32)
    jcfg = dataclasses.replace(jm.config.flow_lm.transformer, context=4)
    tcfg = dataclasses.replace(tm.config.flow_lm.transformer, context=4)
    want = j_ftr.transformer_forward_stateless(jm.params["flow_lm"]["transformer"], jcfg, jnp.asarray(x))
    got = t_ftr.transformer_forward_stateless(tm.params["flow_lm"]["transformer"], tcfg, torch.from_numpy(x))
    close(got, want, "attention")
    full = t_ftr.transformer_forward_stateless(
        tm.params["flow_lm"]["transformer"], tm.config.flow_lm.transformer, torch.from_numpy(x)
    )
    assert not torch.allclose(got[:, -1], full[:, -1], atol=1e-5)


@pytest.mark.parametrize("t", [1, 4])
def test_flow_main_matches_reference(models, t):
    jm, tm = models
    rng = np.random.RandomState(10 + t)
    seq = _frames(rng, t)
    emb = rng.randn(2, 3, ARCH.d_model).astype(np.float32)
    j_last, j_eos = j_flm.flow_main(jm.params["flow_lm"], jm.config.flow_lm, jnp.asarray(seq), jnp.asarray(emb))
    t_last, t_eos = t_flm.flow_main(tm.params["flow_lm"], tm.config.flow_lm, torch.from_numpy(seq), torch.from_numpy(emb))
    assert tuple(t_last.shape) == (2, ARCH.d_model) and tuple(t_eos.shape) == (2,)
    close(t_last, j_last, "attention")
    close(t_eos, j_eos, "attention")


def test_flow_main_matches_the_cached_path(models):
    """The stateless resequence equals a prefill of the text, then one
    cached step per frame: the last step's hidden and EOS logit."""
    _jm, tm = models
    flow, cfg = tm.params["flow_lm"], tm.config.flow_lm
    rng = np.random.RandomState(5)
    seq = torch.from_numpy(_frames(rng, 6)[:1])
    ids = torch.tensor([[3, 17, 41, 9]])
    emb = t_flm.text_embeddings(flow, ids)
    with torch.inference_mode():
        want_last, want_eos = t_flm.flow_main(flow, cfg, seq, emb)
        cache = t_ftr.init_kv_cache(cfg.transformer, batch=1, capacity=16)
        cache = t_flm.prompt(flow, cfg, cache, emb)
        for i in range(seq.shape[1]):
            frame = t_flm._replace_nan_with_bos(seq[:, i : i + 1], flow["bos_emb"])
            x = t_flm.apply_linear(flow["input_linear"], frame)
            y, cache = t_ftr.transformer_forward_cached(flow["transformer"], cfg.transformer, cache, x)
        last, eos = t_flm._hidden_and_eos(flow, y)
    np.testing.assert_allclose(last.numpy(), want_last.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(eos.numpy(), want_eos.numpy(), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s,t", [(0.0, 1.0), (0.25, 0.5)])
def test_flow_direction(models, s, t):
    jm, tm = models
    rng = np.random.RandomState(int(s * 100) + 1)
    c = rng.randn(3, ARCH.d_model).astype(np.float32)
    x = rng.randn(3, ARCH.latent_dim).astype(np.float32)
    ss = np.full((3, 1), s, np.float32)
    tt = np.full((3, 1), t, np.float32)
    want = j_fnet.flow_direction(jm.params["flow_lm"]["flow_net"], *(jnp.asarray(a) for a in (c, ss, tt, x)))
    got = t_fnet.flow_direction(tm.params["flow_lm"]["flow_net"], *(torch.from_numpy(a) for a in (c, ss, tt, x)))
    close(got, want, "linear")


def test_lsd_decode_is_euler_over_flow_direction(models):
    """One Euler step of ``lsd_decode`` (the serving path's fused adaLN)
    equals ``x + flow_direction(c, 0, 1, x)``."""
    _jm, tm = models
    fnet = tm.params["flow_lm"]["flow_net"]
    rng = np.random.RandomState(2)
    c = torch.from_numpy(rng.randn(2, ARCH.d_model).astype(np.float32))
    x = torch.from_numpy(rng.randn(2, ARCH.latent_dim).astype(np.float32))
    want = x + t_fnet.flow_direction(fnet, c, torch.zeros(2, 1), torch.ones(2, 1), x)
    np.testing.assert_allclose(t_fnet.lsd_decode(fnet, c, x, 1).numpy(), want.numpy(), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("temperature", [0.0, -1.0, 0.7])
def test_sample_noise(temperature):
    gen = torch.Generator().manual_seed(7)
    noise = t_flm.sample_noise(gen, 4096, ARCH.latent_dim, temperature)
    assert tuple(noise.shape) == (4096, ARCH.latent_dim) and noise.dtype == torch.float32
    assert noise.device == gen.device
    if temperature <= 0:
        assert bool((noise == 0).all())
    else:
        sigma = math.sqrt(temperature)
        assert abs(float(noise.std()) - sigma) < 0.03 * sigma
        assert abs(float(noise.mean())) < 0.03 * sigma
    # The JAX function's contract on the same arguments: shape, dtype, zeros.
    ref = j_flm.sample_noise(jax.random.PRNGKey(7), 4, ARCH.latent_dim, temperature)
    assert ref.shape == (4, ARCH.latent_dim) and ref.dtype == jnp.float32
    assert bool((np.asarray(ref) == 0).all()) == (temperature <= 0)


def test_new_functions_are_exported():
    assert "flow_main" in t_flm.__all__ and "sample_noise" in t_flm.__all__
    assert "transformer_forward_stateless" in t_ftr.__all__
    assert "flow_direction" in t_fnet.__all__
