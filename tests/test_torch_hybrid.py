"""The hybrid Mamba-2 / attention backbone (``models/hybrid_backbone.py``)
on the single runtime, at a tiny size on the CPU (kernels on their plain
versions), against the benchmark's plain reference
(``benchmark/references/pockettts_granite_hybrid.py``, loaded by path): its
frames, the padded prompt's state, streamed against one-shot frames, the
step's recurrence, the setup span and the routes it refuses."""

import dataclasses
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from go_pocket_tts_tpu_torch import kernels, tracing
from go_pocket_tts_tpu_torch.kernels import mamba2_step as m2k
from go_pocket_tts_tpu_torch.kernels import rms_norm as rmsk
from go_pocket_tts_tpu_torch.models import flow_lm as flm
from go_pocket_tts_tpu_torch.models import hybrid_backbone as hyb
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher
from go_pocket_tts_tpu_torch.parallel.mesh import dp_tp_mesh, shard_params_tp
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime, stream_generate, stream_generate_session

REF_PATH = Path(__file__).resolve().parent.parent / "benchmark" / "references" / "pockettts_granite_hybrid.py"
SEED = 11
FRAMES = 12
TOKENS = [5, 17, 3, 40, 22, 9, 61]


def _reference_module():
    spec = importlib.util.spec_from_file_location("hybrid_reference_under_test", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _reference_module()


def _arch():
    """d 64: three Mamba-2 layers and one attention layer (4 heads over 2
    KV heads, q scale 1/16 · √16 = 1/4), 8 Mamba heads of 16, state 16;
    ``tiny_arch()``'s flowNet and Mimi (with the 8 heads the port's Mimi
    always runs)."""
    t = synthetic.tiny_arch()
    return {
        "hidden_size": 64, "num_attention_heads": 4, "num_key_value_heads": 2, "shared_intermediate_size": 96,
        "layer_types": ["mamba", "mamba", "attention", "mamba"], "mamba_n_heads": 8, "mamba_d_head": 16,
        "mamba_d_state": 16, "mamba_n_groups": 1, "mamba_d_conv": 4, "embedding_multiplier": 12.0,
        "residual_multiplier": 0.22, "attention_multiplier": 0.0625, "rms_norm_eps": 1e-5,
        "d_model": 64, "num_heads": 4, "n_bins": t.n_bins, "latent_dim": t.latent_dim, "flow_dim": t.flow_dim,
        "flow_depth": t.flow_depth, "flow_hidden": t.flow_hidden, "freq_half": t.freq_half, "te_hidden": t.te_hidden,
        "mimi_dim": t.mimi_dim, "mimi_layers": t.mimi_layers, "mimi_heads": 8, "mimi_ffn": t.mimi_ffn,
        "mimi_context": 250, "upsample_stride": t.upsample_stride, "upsample_kernel": t.upsample_kernel,
        "seanet_channels": list(t.seanet_channels), "seanet_strides": list(t.seanet_strides),
        "seanet_kernel_init": t.seanet_kernel_init, "seanet_kernel_final": t.seanet_kernel_final,
        "system": {"kind": "runtime", "dtype": "float32", "quantize": False},
    }


def _weights(arch, seed=SEED):
    """The reference layout's leaves, drawn by kind with numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, shape, kind, scale, offset in REF.leaf_specs(arch):
        if kind == "n":
            v = offset + scale * rng.standard_normal(shape)
        elif kind == "u":
            v = offset + scale * rng.random(shape)
        elif kind == "e":
            v = np.exp(scale * rng.random(shape))
        else:
            v = np.full(shape, offset)
        out[name] = torch.from_numpy(v.astype(np.float32))
    return out


@pytest.fixture(scope="module")
def setup():
    arch = _arch()
    weights = _weights(arch)
    model = load_model_from_tensors(weights, num_heads=arch["num_heads"], device="cpu")
    ref = REF.PocketTTSReference(weights, arch)
    return arch, weights, model, ref


def _rel_rms(got, want):
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).pow(2).mean().sqrt() / want.pow(2).mean().sqrt())


def _frames(rt, run):
    """The frames each ``_ar_loop`` call of ``run()`` returned, joined."""
    seen = []
    orig = rt._ar_loop

    def ar_loop(*args, **kwargs):
        frames, n, carry = orig(*args, **kwargs)
        seen.append(frames[0, : int(n[0])].clone())
        return frames, n, carry

    rt._ar_loop = ar_loop
    try:
        run()
    finally:
        rt._ar_loop = orig
    return torch.cat(seen)


def test_loader_reads_the_hybrid_from_the_checkpoint_keys(setup):
    arch, _, model, _ = setup
    cfg = model.config.flow_lm.transformer
    assert flm.is_hybrid(model.config.flow_lm)
    assert cfg.kinds == tuple(arch["layer_types"])
    assert (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (4, 2, 16)
    assert (cfg.mamba_heads, cfg.mamba_head_dim, cfg.d_state, cfg.mamba_groups) == (8, 16, 16, 1)
    assert cfg.embedding_multiplier == 12.0 and cfg.rms_norm_eps == pytest.approx(1e-5)
    cache = flm.init_cache(model.config.flow_lm, 1, 80, torch.bfloat16)
    assert tuple(cache) == hyb.CACHE_KEYS
    assert tuple(cache["k"].shape) == (1, 1, 4, 80, 16) and tuple(cache["conv"].shape) == (3, 1, 160, 3)
    assert cache["ssm"].dtype == torch.float32 and tuple(cache["ssm"].shape) == (3, 1, 8, 16, 16)
    assert hyb.state_bytes(cfg, 1, torch.bfloat16) == 3 * 160 * 3 * 2 + 3 * 8 * 16 * 16 * 4
    bf16 = model.to("cpu", torch.bfloat16).params["flow_lm"]["transformer"]["layers"][0]
    assert all(t.dtype == torch.float32 for t in bf16["f32"].values())
    assert bf16["in_proj"]["w"].dtype == torch.bfloat16


def test_frames_match_the_reference(setup):
    """Temperature 0, float32: the served frames against the reference's
    teacher-forced and free-running frames over 12 frames, within 1e-5
    relative RMS (float32 sums in other orders; the reference's quadratic
    form against the port's chunked scan and step)."""
    _, _, model, ref = setup
    rt = GPURuntime(model, device="cpu", seed=SEED)
    cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=FRAMES)
    frames = _frames(rt, lambda: rt.generate_audio(TOKENS, cfg))
    assert frames.shape[0] == FRAMES
    assert _rel_rms(frames, ref.teacher_frames(TOKENS, frames)) < 1e-5
    assert _rel_rms(frames, ref.frames(TOKENS, FRAMES)) < 1e-5


def test_padded_prompt_leaves_the_unpadded_state(setup):
    """A prompt padded to its bucket (16 rows, 7 real) leaves the conv and
    SSM states, the offset and the KV rows of the unpadded prompt."""
    _, _, model, _ = setup
    flow, fcfg = model.params["flow_lm"], model.config.flow_lm
    ids = torch.tensor([TOKENS + [0] * (16 - len(TOKENS))])
    emb = flm.text_embeddings(flow, ids)
    with torch.no_grad():
        padded = flm.prompt(flow, fcfg, flm.init_cache(fcfg, 1, 64), emb, torch.tensor(len(TOKENS), dtype=torch.int32))
        exact = flm.prompt(flow, fcfg, flm.init_cache(fcfg, 1, 64), emb[:, : len(TOKENS)])
    assert int(padded["offset"]) == int(exact["offset"]) == len(TOKENS)
    for key in ("conv", "ssm"):
        torch.testing.assert_close(padded[key], exact[key], rtol=1e-6, atol=1e-6)
    for key in ("k", "v"):
        torch.testing.assert_close(padded[key][..., : len(TOKENS), :], exact[key][..., : len(TOKENS), :])


@pytest.mark.parametrize("chunk", [1, 3, 4, 16])
def test_chunked_scan_matches_one_chunk(chunk):
    """The SSD scan in chunks (state passed between them, from a non-zero
    initial state) against one chunk over the whole sequence."""
    gen = torch.Generator().manual_seed(chunk)
    b, t, h, p, g, n = 2, 13, 4, 3, 2, 5
    x = torch.randn(b, t, h, p, generator=gen)
    dt = torch.rand(b, t, h, generator=gen) * 0.5
    a = -torch.rand(h, generator=gen) * 4
    bm, cm = torch.randn(b, t, g, n, generator=gen), torch.randn(b, t, g, n, generator=gen)
    h0 = torch.randn(b, h, p, n, generator=gen)
    y, final = hyb.ssd_scan(x, dt, a, bm, cm, h0, chunk=chunk)
    y1, final1 = hyb.ssd_scan(x, dt, a, bm, cm, h0, chunk=t)
    torch.testing.assert_close(y, y1, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(final, final1, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("route", ["step", "prompt"])
def test_mixer_matches_the_reference_recurrence(setup, route):
    """A Mamba layer's mixer, one step at a time through the step kernel's
    plain version or as one prompt through the chunked scan, against the
    reference's quadratic form over the whole sequence."""
    arch, _, model, ref = setup
    fcfg = model.config.flow_lm
    layer = model.params["flow_lm"]["transformer"]["layers"][1]
    gen = torch.Generator().manual_seed(3)
    h = torch.randn(1, 10, arch["hidden_size"], generator=gen)
    cache = flm.init_cache(fcfg, 1, 16)
    with torch.no_grad():
        if route == "step":
            got = torch.cat([hyb._mamba(layer, fcfg.transformer, cache, 1, h[:, t : t + 1], 1) for t in range(10)], 1)
        else:
            got = hyb._mamba(layer, fcfg.transformer, cache, 1, h, 10)
        want = ref._mamba("flow_lm.backbone.layers.1", h) * arch["residual_multiplier"]
    torch.testing.assert_close(got, want, rtol=2e-5, atol=2e-5)


def test_step_kernel_plain_version_against_its_recurrence():
    """The step kernel's plain version on a state of 2 groups, step by step,
    against the recurrence written out per head and per state row."""
    gen = torch.Generator().manual_seed(5)
    b, heads, p, n, g = 2, 4, 3, 5, 2
    d_inner, conv_dim = heads * p, heads * p + 2 * g * n
    conv_w, conv_b = torch.randn(conv_dim, 4, generator=gen), torch.randn(conv_dim, generator=gen)
    dt_bias, a, d = torch.randn(heads, generator=gen), -torch.rand(heads, generator=gen) * 3, torch.randn(heads, generator=gen)
    conv_state, ssm = torch.zeros(b, conv_dim, 3), torch.zeros(b, heads, p, n)
    past = torch.zeros(b, conv_dim, 3)
    h_ref = torch.zeros(b, heads, p, n, dtype=torch.float64)
    for _ in range(6):
        zx = torch.randn(b, 2 * d_inner + 2 * g * n + heads, generator=gen)
        y = m2k.mamba2_step_plain(zx, conv_state, conv_w, conv_b, dt_bias, a, d, ssm, g)
        z, xbc, dt = zx.double().split([d_inner, conv_dim, heads], -1)
        window = torch.cat([past.double(), xbc[..., None]], -1)
        conv = torch.nn.functional.silu((window * conv_w.double()).sum(-1) + conv_b.double())
        past = window[..., 1:].float()
        x, bm, cm = conv.split([d_inner, g * n, g * n], -1)
        dt = torch.nn.functional.softplus(dt + dt_bias.double())
        want = torch.empty(b, d_inner, dtype=torch.float64)
        for bb in range(b):
            for hh in range(heads):
                grp = hh // (heads // g)
                for pp in range(p):
                    xv = x[bb, hh * p + pp]
                    h_ref[bb, hh, pp] = (torch.exp(dt[bb, hh] * a[hh]) * h_ref[bb, hh, pp]
                                         + dt[bb, hh] * xv * bm[bb, grp * n : (grp + 1) * n])
                    yv = h_ref[bb, hh, pp] @ cm[bb, grp * n : (grp + 1) * n] + d[hh] * xv
                    want[bb, hh * p + pp] = yv * torch.nn.functional.silu(z[bb, hh * p + pp])
        torch.testing.assert_close(y.double(), want, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(ssm.double(), h_ref, rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(conv_state, past)


def test_streamed_frames_equal_one_shot_frames(setup):
    """At temperature 0.7, two runtimes of one seed: the streamed segments
    (4, 8 frames) carry the states as the one-shot loop does."""
    _, _, model, _ = setup
    cfg = GenerateConfig(temperature=0.7, eos_threshold=1e9, max_steps=FRAMES)
    one, two = GPURuntime(model, device="cpu", seed=SEED), GPURuntime(model, device="cpu", seed=SEED)
    oneshot = _frames(one, lambda: one.generate_audio(TOKENS, cfg))
    streamed = _frames(two, lambda: [blk for blk in stream_generate(two, TOKENS, cfg)])
    torch.testing.assert_close(streamed, oneshot, rtol=1e-6, atol=1e-6)


def test_setup_span_carries_state_bytes_and_the_step_runs_the_wrapper(setup, monkeypatch):
    _, _, model, _ = setup
    calls = []
    orig = m2k.mamba2_step

    def counted(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(m2k, "mamba2_step", counted)
    rt = GPURuntime(model, device="cpu", seed=SEED)
    tracing.reset()
    tracing.enable()
    try:
        [blk for blk in stream_generate(rt, TOKENS, GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=6))]
    finally:
        tracing.disable()
    setups = [s for s in tracing.spans() if s.name == "setup"]
    assert [s.attrs["state_bytes"] for s in setups] == [hyb.state_bytes(model.config.flow_lm.transformer, 1, torch.float32)]
    assert len(calls) == 6 * 3  # every AR step, every Mamba layer


# The backbone's norms as it computed them before they went through the
# wrapper: RMSNorm over the last dim, and the gated norm over each group.
def _rms_norm_eager(x, w, eps, dtype):
    xf = x.float()
    return (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * w).to(dtype)


def _gated_norm_eager(y, w, groups, eps, dtype):
    g = y.reshape(*y.shape[:-1], groups, -1)
    g = g * torch.rsqrt(g.square().mean(-1, keepdim=True) + eps)
    return (g.reshape(y.shape) * w).to(dtype)


@pytest.mark.parametrize("case", ["input_bf16", "input_f32", "gated_g1", "gated_g2", "gated_g4"])
def test_rms_norm_plain_is_the_backbones_arithmetic(setup, case):
    """The wrapper's plain version, bit for bit, is the backbone's eager
    norm: the layer norms at d_model (bf16 in and out, float32 in and out),
    and the gated norm of the float32 ``y`` at d_inner into bf16 over 1, 2
    and 4 groups."""
    _, _, model, _ = setup
    cfg = model.config.flow_lm.transformer
    gen = torch.Generator().manual_seed(len(case))
    eps = cfg.rms_norm_eps
    if case.startswith("input"):
        dtype = torch.bfloat16 if case == "input_bf16" else torch.float32
        x = (torch.randn(2, 7, cfg.d_model, generator=gen) * 3 + 0.5).to(dtype)
        w = torch.rand(cfg.d_model, generator=gen) + 0.5
        got, want = rmsk.rms_norm(x, w, eps, dtype), _rms_norm_eager(x, w, eps, dtype)
    else:
        groups = int(case[-1])
        y = torch.randn(2, 7, cfg.d_inner, generator=gen) * 2
        w = torch.rand(cfg.d_inner, generator=gen) + 0.5
        got = rmsk.rms_norm(y, w, eps, torch.bfloat16, groups)
        want = _gated_norm_eager(y, w, groups, eps, torch.bfloat16)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("rows", [7, 1])
def test_every_norm_of_a_prefill_and_a_step_goes_through_the_wrapper(setup, monkeypatch, rows, use_kernels):
    """A prefill (7 rows) and an AR step (1 row) each call the RMS wrapper
    2·L + L_mamba times with the kernels on, each call with what the CUDA
    kernel takes, and never with them off; the output is the same either
    way on the CPU."""
    _, _, model, _ = setup
    flow, fcfg = model.params["flow_lm"], model.config.flow_lm
    cfg = fcfg.transformer
    calls = []
    orig = rmsk.rms_norm

    def counted(x, weight, eps, out_dtype, groups=1):
        rmsk._check(x, weight, out_dtype, groups)  # what the CUDA kernel takes
        calls.append(1)
        return orig(x, weight, eps, out_dtype, groups)

    monkeypatch.setattr(rmsk, "rms_norm", counted)
    x = torch.randn(1, rows, cfg.d_model, generator=torch.Generator().manual_seed(rows))
    with torch.no_grad():
        want = hyb.forward_cached(flow["transformer"], cfg, flm.init_cache(fcfg, 1, 16), x)[0]
        calls.clear()
        run_cfg = dataclasses.replace(cfg, use_kernels=use_kernels)
        got = hyb.forward_cached(flow["transformer"], run_cfg, flm.init_cache(fcfg, 1, 16), x)[0]
    assert len(calls) == (2 * cfg.num_layers + cfg.mamba_layers if use_kernels else 0)
    assert torch.equal(got, want)


def test_rms_norm_wrapper_takes_the_plain_version_on_the_cpu_and_checks_what_the_kernel_takes():
    kernels.reset_launches()
    x, w = torch.randn(3, 64).bfloat16(), torch.rand(64)
    assert torch.equal(rmsk.rms_norm(x, w, 1e-5, torch.bfloat16), rmsk.rms_norm_plain(x, w, 1e-5, torch.bfloat16))
    assert rmsk.rms_norm.launches == 0
    assert rmsk._check(x, w, torch.bfloat16, 2) == 32
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        rmsk._check(x.half(), w, torch.bfloat16, 1)
    with pytest.raises(TypeError, match="out_dtype"):
        rmsk._check(x, w, torch.float16, 1)
    with pytest.raises(ValueError, match="groups"):
        rmsk._check(x, w, torch.bfloat16, 3)
    with pytest.raises(ValueError, match="groups"):
        rmsk._check(torch.zeros(1, 2 * 8192 + 16), torch.zeros(2 * 8192 + 16), torch.bfloat16, 2)
    with pytest.raises(ValueError, match="contiguous"):
        rmsk._check(torch.randn(64, 3).T, w, torch.bfloat16, 1)
    with pytest.raises(ValueError, match="weight"):
        rmsk._check(x, torch.rand(32), torch.bfloat16, 1)


def _voice_state():
    return {"transformer.layers.0.self_attn": {"cache": np.zeros((2, 1, 4, 4, 16), np.float32), "offset": np.zeros(1)}}


@pytest.mark.parametrize("route", ["session", "stream_session", "voice_embedding", "voice_state", "quantize",
                                   "batcher", "dp_tp_batcher", "tp_shard"])
def test_refused_routes_name_themselves(setup, route):
    from go_pocket_tts_tpu_torch.utils.safetensors import VoiceModelState

    _, _, model, _ = setup
    cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=4)
    names = {"session": "continuity session", "stream_session": "continuity session", "voice_embedding": "voice",
             "voice_state": "voice", "quantize": "quantize", "batcher": "continuous batcher",
             "dp_tp_batcher": "dp/tp mesh", "tp_shard": "tensor-parallel mesh"}
    with pytest.raises(NotImplementedError, match=names[route]):
        if route == "quantize":
            GPURuntime(model, device="cpu", quantize=True)
        elif route == "batcher":
            ContinuousBatcher(model, slots=2, device="cpu")
        elif route == "dp_tp_batcher":
            ContinuousBatcher(model, slots=2, mesh=dp_tp_mesh(1, 2, device="cpu"))
        elif route == "tp_shard":
            shard_params_tp(model.params, dp_tp_mesh(1, 2, device="cpu"), 4)
        else:
            rt = GPURuntime(model, device="cpu")
            if route == "session":
                rt.generate_audio_session(TOKENS, cfg)
            elif route == "stream_session":
                blocks, _ = stream_generate_session(rt, TOKENS, cfg)
                list(blocks)
            elif route == "voice_embedding":
                rt.generate_audio(TOKENS, GenerateConfig(max_steps=4, voice_embedding=np.zeros((1, 3, 64), np.float32)))
            else:
                rt.generate_audio(TOKENS, GenerateConfig(max_steps=4, voice_model_state=VoiceModelState(_voice_state())))


def test_reference_counts(setup):
    """The reference's operation and byte counts at granite-4.0-h-micro's
    widths: 2.986 B backbone parameters, the step kernel's least bytes."""
    import json

    cfg = json.loads((REF_PATH.parent.parent / "configs" / "pockettts-granite-4.0-h-micro-bf16.json").read_text())
    backbone = sum(math.prod(s) for name, s, *_ in REF.leaf_specs(cfg) if name.startswith("flow_lm.backbone.layers"))
    assert backbone == 2_985_873_152
    assert REF.mamba2_step_bytes(cfg) == 4_324_224
    step = REF.frame_step_flops(cfg, 100)
    assert 2 * 2.9e9 < step < 2 * 3.1e9
    assert 20 * 2 * 2.9e9 < REF.prefill_flops(cfg, 20) < 20 * 2 * 3.05e9
