"""The reference's kernel and precision switches in the port: the
``runtime.pallas`` and ``runtime.matmul_precision`` settings against the
JAX config's parsing, ``set_quantized_matmul_backend`` and
``set_int4_matmul_variant`` against the reference's, the Mimi env override,
and ``pallas=False``, which reaches no kernel wrapper (so no launch counter
moves on the card) and gives today's PCM on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

from go_pocket_tts_tpu import config as j_config
from go_pocket_tts_tpu.cli.main import build_parser as j_parser
from go_pocket_tts_tpu.models import params as j_params
from go_pocket_tts_tpu.tts.service import Service as JService
from go_pocket_tts_tpu_torch import config as t_config
from go_pocket_tts_tpu_torch.cli.main import build_parser as t_parser
from go_pocket_tts_tpu_torch.kernels import batched_decode_attention as bda
from go_pocket_tts_tpu_torch.kernels import decode_attention, int4_matmul, quantized_matmul, seanet_tail
from go_pocket_tts_tpu_torch.models import params as t_params
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import auto_pallas_mimi, load_model_from_tensors
from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime
from go_pocket_tts_tpu_torch.runtime.streaming import stream_generate
from go_pocket_tts_tpu_torch.tts.service import Service
from go_pocket_tts_tpu_torch.utils.safetensors import write_file
from torch_fixtures import tokenizer_bytes

# Wide enough that every kernel's gate takes the path's shapes: group-wise
# int4 and the matmul gates (d_model 256), the SEANet kernels' widths.
ARCH = dataclasses.replace(
    synthetic.tiny_arch(), d_model=256, ffn_dim=512, flow_dim=256, flow_hidden=256, seanet_channels=(32, 256, 128, 64)
)
SPIED = (
    (decode_attention, "decode_attention_step"),
    (bda, "batched_decode_attention_step"),
    (quantized_matmul, "quantized_matmul"),
    (int4_matmul, "int4_matmul"),
    (seanet_tail, "fused_up2_res"),
    (seanet_tail, "fused_seanet_up_tail"),
    (seanet_tail, "fused_seanet_tail"),
    (seanet_tail, "fused_up2_up3_tail_stream"),
)


@pytest.fixture(scope="module")
def model():
    return load_model_from_tensors(synthetic.build_checkpoint(ARCH, seed=55), num_heads=ARCH.num_heads, device="cpu")


@pytest.fixture
def calls(monkeypatch):
    """Calls of every kernel wrapper, by name."""
    counts = {}
    for module, name in SPIED:

        def spy(*args, _fn=getattr(module, name), _name=name, **kwargs):
            counts[_name] = counts.get(_name, 0) + 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)
    return counts


def _cfg(**kw):
    return GenerateConfig(**{"temperature": 0.0, "eos_threshold": 1e9, "max_steps": 6, **kw})


def _single(model, pallas):
    rt = GPURuntime(model, seed=1, frame_bucket=64, device="cpu", quantize=8, pallas=pallas)
    return [rt.generate_audio([5, 9, 2], _cfg()), np.concatenate(list(stream_generate(rt, [7, 1, 4], _cfg())))]


def _batcher(model, pallas):
    b = ContinuousBatcher(
        model, slots=2, prompt_capacity=64, max_frames=64, seed=3, device="cpu", quantize=4, kv_quantize=True, pallas=pallas
    )
    b.start()
    try:
        fut = b.submit([5, 9, 2], _cfg())
        return [np.concatenate(list(b.submit_stream([7, 1, 4], _cfg(), timeout=120))), fut.result(timeout=120)]
    finally:
        b.stop()


PATHS = {
    "single": (_single, {"decode_attention_step", "quantized_matmul", "fused_up2_res", "fused_up2_up3_tail_stream"}),
    "batcher": (_batcher, {"batched_decode_attention_step", "int4_matmul", "fused_up2_res", "fused_up2_up3_tail_stream"}),
}


@pytest.fixture(scope="module")
def with_kernels(model):
    """Each path's PCM with every kernel wrapper on (auto)."""
    return {name: run(model, None) for name, (run, _) in PATHS.items()}


@pytest.mark.parametrize("path", list(PATHS))
def test_pallas_off_reaches_no_kernel_and_keeps_the_pcm(model, calls, with_kernels, path):
    run, wrappers = PATHS[path]
    on = run(model, True)
    assert wrappers <= set(calls), calls
    assert {"fused_seanet_up_tail", "fused_seanet_tail"} & set(calls)
    calls.clear()
    off = run(model, False)
    assert calls == {}
    for a, b, c in zip(off, on, with_kernels[path]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_pallas_env_and_runtime_flags(model, monkeypatch):
    rt = GPURuntime(model, device="cpu", pallas=False)
    assert not rt.kernels and not rt.model.config.flow_lm.transformer.use_kernels and not rt.model.config.mimi.use_kernels
    assert GPURuntime(model, device="cpu").kernels and rt.model.params is model.params
    monkeypatch.setenv("POCKETTTS_PALLAS", "0")
    assert not GPURuntime(model, device="cpu").kernels
    assert GPURuntime(model, device="cpu", pallas=True).kernels
    monkeypatch.setenv("POCKETTTS_PALLAS", "1")
    assert GPURuntime(model, device="cpu").kernels


@pytest.mark.parametrize("env,want", [("0", False), ("1", True), ("", True), ("maybe", True)])
def test_pallas_mimi_env_override(model, monkeypatch, env, want):
    monkeypatch.setenv("POCKETTTS_PALLAS_MIMI", env)
    assert auto_pallas_mimi(model).config.mimi.use_kernels is want
    assert auto_pallas_mimi(model).config.flow_lm is model.config.flow_lm


# -- the module-level backends ------------------------------------------------

QUANT = ["xla", "pallas", "pallas:interpret", "xla:x", "mxu", "", "PALLAS"]
INT4 = ["split", "dequant", "pallas", "pallas:interpret", "dequant:y", "fast", "", "Split"]


def _accepts(setter, value) -> bool:
    try:
        setter(value)
    except ValueError:
        return False
    return True


@pytest.mark.parametrize("value", QUANT)
def test_quantized_matmul_backend_accepts_what_the_reference_does(value):
    j_prev, t_prev = j_params._QUANT_BACKEND, t_params._QUANT_BACKEND
    try:
        assert _accepts(t_params.set_quantized_matmul_backend, value) == _accepts(j_params.set_quantized_matmul_backend, value)
    finally:
        j_params._QUANT_BACKEND, t_params._QUANT_BACKEND = j_prev, t_prev


@pytest.mark.parametrize("value", INT4)
def test_int4_matmul_variant_accepts_what_the_reference_does(value):
    j_prev, t_prev = j_params._INT4_VARIANT, t_params._INT4_VARIANT
    try:
        assert _accepts(t_params.set_int4_matmul_variant, value) == _accepts(j_params.set_int4_matmul_variant, value)
    finally:
        j_params._INT4_VARIANT, t_params._INT4_VARIANT = j_prev, t_prev


@pytest.mark.parametrize("bits", [8, 4])
def test_backends_route_the_linears(model, calls, bits):
    """``"pallas"`` reaches the kernel wrapper; ``"xla"``/``"split"``,
    ``:interpret`` and the thread's scope reach none, with the same product;
    ``"dequant"`` is one product on the dequantized weight."""
    from go_pocket_tts_tpu_torch.models.quantize import dequantize_weight, quantize_linear

    lin = quantize_linear({"w": model.params["flow_lm"]["transformer"]["layers"][0]["linear1"]["w"]}, bits=bits)
    x = torch.randn(4, lin["w"].shape[0] * (2 if bits == 4 else 1), generator=torch.Generator().manual_seed(0))
    name = "quantized_matmul" if bits == 8 else "int4_matmul"
    plain = ("xla", "split")
    want = t_params.apply_linear(lin, x)
    assert calls.pop(name) == 1
    for quant, int4 in (plain, ("pallas:interpret", "pallas:interpret")):
        with t_params.matmul_backends(quant, int4):
            np.testing.assert_array_equal(t_params.apply_linear(lin, x).numpy(), want.numpy())
    prev = t_params._QUANT_BACKEND, t_params._INT4_VARIANT
    try:
        t_params.set_quantized_matmul_backend("xla")
        t_params.set_int4_matmul_variant("dequant")
        got = t_params.apply_linear(lin, x)
    finally:
        t_params._QUANT_BACKEND, t_params._INT4_VARIANT = prev
    assert calls == {}
    if bits == 8:
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    else:
        np.testing.assert_allclose(got.numpy(), (x @ dequantize_weight(lin)).numpy(), atol=1e-5)


def test_partial_products_refuse_a_bias():
    lin = {"w": torch.randn(8, 4), "b": torch.randn(4)}
    x = torch.randn(2, 8).bfloat16()
    with pytest.raises(ValueError, match="bias"):
        t_params.apply_linear(lin, x, out_dtype=torch.float32)
    del lin["b"]
    got = t_params.apply_linear(lin, x, out_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), (x.float() @ lin["w"].bfloat16().float()).numpy(), rtol=1e-6)


# -- matmul precision ---------------------------------------------------------


def test_matmul_precision_defaults_and_scopes(model):
    assert GPURuntime(model, device="cpu").matmul_precision == "highest"
    assert GPURuntime(model, device="cpu", dtype=torch.bfloat16).matmul_precision == "default"
    with pytest.raises(ValueError, match="matmul_precision 'fastest'"):
        GPURuntime(model, device="cpu", matmul_precision="fastest")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    seen = {}
    for precision in ("highest", "high", "default"):
        rt = GPURuntime(model, device="cpu", matmul_precision=precision)
        with rt._compute():
            seen[precision] = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
    assert seen == {"highest": (False, False), "high": (True, True), "default": flags}
    want = GPURuntime(model, seed=1, frame_bucket=64, device="cpu").generate_audio([5, 9, 2], _cfg())
    got = GPURuntime(model, seed=1, frame_bucket=64, device="cpu", matmul_precision="high").generate_audio([5, 9, 2], _cfg())
    np.testing.assert_array_equal(got, want)  # no TF32 on the CPU


# -- parsing against the JAX config -------------------------------------------

LAYERS = {
    "env": ({"POCKETTTS_RUNTIME_PALLAS": "off", "POCKETTTS_RUNTIME_MATMUL_PRECISION": "high"}, [], None),
    "flags": ({}, ["--runtime-pallas", "on", "--runtime-matmul-precision", "highest"], None),
    "file": ({}, [], '{"runtime": {"pallas": "0", "matmul_precision": "default"}}'),
    "flags_over_env": (
        {"POCKETTTS_RUNTIME_PALLAS": "off", "POCKETTTS_RUNTIME_MATMUL_PRECISION": "high"},
        ["--runtime-pallas", "auto", "--runtime-matmul-precision", "default"],
        None,
    ),
}


@pytest.mark.parametrize("layer", list(LAYERS))
def test_pallas_and_matmul_precision_parse_as_the_reference(layer, monkeypatch, tmp_path):
    env, argv, file_text = LAYERS[layer]
    monkeypatch.chdir(tmp_path)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if file_text:
        (tmp_path / "pockettts.json").write_text(file_text)
    got = []
    for parser, mod in ((t_parser(), t_config), (j_parser(), j_config)):
        args = parser.parse_args(["synth", *argv])
        cfg = mod.load_config(args)
        got.append((cfg.runtime.pallas, cfg.runtime.matmul_precision, sorted(cfg.user_set)))
    assert got[0] == got[1]


@pytest.fixture(scope="module")
def fixture_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("switch_fixtures")
    write_file(d / "model.safetensors", synthetic.build_checkpoint(synthetic.tiny_arch(), seed=55))
    (d / "tokenizer.model").write_bytes(tokenizer_bytes())
    return str(d / "model.safetensors"), str(d / "tokenizer.model")


def _service_cfg(mod, files, **runtime):
    cfg = mod.Config()
    cfg.paths.model_path, cfg.paths.tokenizer_model = files
    cfg.tts.temperature, cfg.tts.eos_threshold, cfg.tts.max_steps = 0.0, 1e9, 2
    if mod is t_config:
        cfg.runtime.device = "cpu"
    for k, v in runtime.items():
        setattr(cfg.runtime, k, v)
    return cfg


def test_a_bad_kernel_switch_is_refused_as_the_reference_refuses_it(fixture_files):
    messages = []
    for mod, service in ((t_config, Service), (j_config, JService)):
        with pytest.raises(ValueError) as err:
            service.from_config(_service_cfg(mod, fixture_files, pallas="sometimes"))
        messages.append(str(err.value))
    assert messages[0] == messages[1] == "--runtime-pallas must be auto, on, or off (got 'sometimes')"


@pytest.mark.parametrize("value,kernels", [("auto", True), ("ON", True), ("1", True), (" off ", False), ("false", False), ("0", False)])
def test_service_passes_the_kernel_switch(fixture_files, value, kernels):
    svc = Service.from_config(_service_cfg(t_config, fixture_files, pallas=value, matmul_precision="high"))
    try:
        assert svc.runtime.kernels is kernels and svc.runtime.matmul_precision == "high"
        assert svc.runtime.model.config.mimi.use_kernels is kernels
    finally:
        svc.close()
