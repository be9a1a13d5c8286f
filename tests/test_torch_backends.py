"""The port's ``torch`` and ``cli`` backends against the JAX package's, on the
CPU: the torch oracle (``tts.runtime_torch``) against the JAX oracle within
1e-6 RMS and against the port's ``GPURuntime`` within the 1e-3 oracle budget;
``build_passthrough_args``, ``CLIRuntime`` through ``Service.from_config``,
``synth --tts-arg``, ``doctor``'s binary probe and the server over a stub
``pocket-tts`` executable written into ``tmp_path``; and the backend names."""

import dataclasses
import json
import stat
import sys
import urllib.request

import numpy as np
import pytest
import torch

from go_pocket_tts_tpu import config as j_cfg
from go_pocket_tts_tpu.cli.doctor import run_doctor as j_run_doctor
from go_pocket_tts_tpu.cli.main import main as j_main
from go_pocket_tts_tpu.runtime import GenerateConfig as JGenerateConfig
from go_pocket_tts_tpu.tts import runtime_cli as j_cli
from go_pocket_tts_tpu.tts.runtime_torch import TorchRuntime as JTorchRuntime
from go_pocket_tts_tpu.tts.service import Service as JService
from go_pocket_tts_tpu.utils import safetensors as j_st
from go_pocket_tts_tpu_torch import config as t_cfg
from go_pocket_tts_tpu_torch.cli.doctor import run_doctor
from go_pocket_tts_tpu_torch.cli.main import main
from go_pocket_tts_tpu_torch.model_assets.quantize_export import build_quantized_checkpoint
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime
from go_pocket_tts_tpu_torch.server import Server
from go_pocket_tts_tpu_torch.tts import runtime_cli as t_cli
from go_pocket_tts_tpu_torch.tts.parity import rms_delta
from go_pocket_tts_tpu_torch.tts.runtime_torch import TorchRuntime
from go_pocket_tts_tpu_torch.tts.service import Service
from go_pocket_tts_tpu_torch.utils import safetensors as t_st
from go_pocket_tts_tpu_torch.utils import wav
from torch_fixtures import ONE_CHUNK, THREE_CHUNKS, tokenizer_bytes, voice_files

ARCH = synthetic.tiny_arch()
SEED = 17
TOKENS = [3, 17, 41, 9]


@pytest.fixture(scope="module")
def ckpt():
    return t_st.encode_tensors(synthetic.build_checkpoint(ARCH, seed=SEED))


def _oracles(data: bytes, seed: int = 1):
    return (
        JTorchRuntime(j_st.open_store_from_bytes(data), num_heads=ARCH.num_heads, seed=seed),
        TorchRuntime(t_st.open_store_from_bytes(data), num_heads=ARCH.num_heads, seed=seed, device="cpu"),
    )


def _cfgs(**kw):
    base = dict(temperature=0.7, eos_threshold=1e9, max_steps=5)
    base.update(kw)
    return JGenerateConfig(**base), GenerateConfig(**base)


# -- the torch oracle ------------------------------------------------------------


def test_torch_runtime_matches_the_jax_oracle(ckpt):
    """Same seed, same CPU generator: the noise and the audio agree at
    temperature 0.7; ``mimi_timing`` too."""
    j, t = _oracles(ckpt)
    assert t.mimi_timing() == j.mimi_timing()
    jc, tc = _cfgs()
    for _ in range(2):
        want, got = j.generate_audio(TOKENS, jc), t.generate_audio(TOKENS, tc)
        assert got.dtype == np.float32 and got.shape == want.shape == (5 * 1920,)
        assert rms_delta(got, want) < 1e-6


def test_torch_runtime_session_matches_the_jax_oracle(ckpt):
    j, t = _oracles(ckpt)
    jc, tc = _cfgs(temperature=0.0)
    jcont = tcont = None
    for chunk in ([3, 17, 41], [9, 5]):
        want, jcont = j.generate_audio_session(chunk, jc, jcont)
        got, tcont = t.generate_audio_session(chunk, tc, tcont)
        assert rms_delta(got, want) < 1e-6 and tcont.pos == jcont.pos
    assert all(k.device == torch.device("cpu") for pair in tcont.kv for k in pair)
    fresh, _ = t.generate_audio_session([9, 5], tc, None)
    assert rms_delta(fresh, got) > 1e-4  # the carried state conditions chunk 2


@pytest.mark.parametrize("kind", ["embedding", "model_state"])
def test_torch_runtime_voiced_matches_the_jax_oracle(ckpt, tmp_path, kind):
    path = voice_files(tmp_path)[kind]
    j, t = _oracles(ckpt)
    if kind == "embedding":
        jc, tc = _cfgs(temperature=0.0, voice_embedding=j_st.load_voice_embedding(path))
        tc.voice_embedding = t_st.load_voice_embedding(path)
    else:
        jc, tc = _cfgs(temperature=0.0, voice_model_state=j_st.load_voice_model_state(path))
        tc.voice_model_state = t_st.load_voice_model_state(path)
    got = t.generate_audio(TOKENS, tc)
    assert rms_delta(got, j.generate_audio(TOKENS, jc)) < 1e-6
    assert rms_delta(got, t.generate_audio(TOKENS, _cfgs(temperature=0.0)[1])) > 1e-4


def test_torch_runtime_encode_voice_matches_the_jax_oracle(ckpt):
    j, t = _oracles(ckpt)
    samples = (np.random.RandomState(2).randn(7680) * 0.1).astype(np.float32)
    want, got = j.encode_voice(samples), t.encode_voice(samples)
    assert got.dtype == np.float32 and got.shape == want.shape and got.shape[-1] == ARCH.d_model
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_torch_runtime_reads_a_prequantized_artifact(tmp_path):
    """An int8 artifact (``model export --quantize int8``): both oracles
    dequantize the same weights."""
    tensors, meta, quantized = build_quantized_checkpoint(
        synthetic.build_checkpoint(ARCH, seed=SEED), 8, num_heads=ARCH.num_heads
    )
    assert quantized
    path = tmp_path / "int8.safetensors"
    t_st.write_file(path, tensors, metadata=meta)
    jc, tc = _cfgs(temperature=0.0)
    want = JTorchRuntime.from_checkpoint(str(path), num_heads=ARCH.num_heads, seed=1).generate_audio(TOKENS, jc)
    got = TorchRuntime.from_checkpoint(str(path), num_heads=ARCH.num_heads, seed=1, device="cpu").generate_audio(TOKENS, tc)
    assert rms_delta(got, want) < 1e-6


def test_torch_runtime_against_the_gpu_runtime(ckpt):
    """The oracle budget (BASELINE.md): the independent engine and the
    port's engine (the kernels' plain versions on the CPU) within 1e-3 RMS
    at temperature 0, plain and carried over two chunks."""
    model = load_model_from_tensors(t_st.open_store_from_bytes(ckpt), num_heads=ARCH.num_heads, device="cpu")
    gpu = GPURuntime(model, seed=1, frame_bucket=64, device="cpu")
    _, oracle = _oracles(ckpt)
    cfg = _cfgs(temperature=0.0)[1]
    assert rms_delta(oracle.generate_audio(TOKENS, cfg), gpu.generate_audio(TOKENS, cfg)) < 1e-3
    gcont = ocont = None
    for chunk in ([3, 17, 41], [9, 5]):
        want, gcont = gpu.generate_audio_session(chunk, cfg, gcont)
        got, ocont = oracle.generate_audio_session(chunk, cfg, ocont)
        assert got.shape == want.shape and rms_delta(got, want) < 1e-3


def test_torch_runtime_defaults_to_cuda_and_raises_without_it(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert "cuda" in TorchRuntime.__init__.__defaults__
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchRuntime(t_st.open_store_from_bytes(ckpt), num_heads=ARCH.num_heads)


def test_torch_backend_through_service_matches_the_jax_one(ckpt, tmp_path):
    """``Service.from_config(backend="torch")`` of both packages on the same
    files, three chunks at temperature 0."""
    (tmp_path / "model.safetensors").write_bytes(ckpt)
    (tmp_path / "tokenizer.model").write_bytes(tokenizer_bytes())
    services = []
    for mod in (j_cfg, t_cfg):
        cfg = mod.Config()
        cfg.paths.model_path = str(tmp_path / "model.safetensors")
        cfg.paths.tokenizer_model = str(tmp_path / "tokenizer.model")
        cfg.tts.backend, cfg.tts.temperature, cfg.tts.eos_threshold, cfg.tts.max_steps = "torch-cpu", 0.0, 1e9, 4
        cfg.runtime.seed = 3
        if mod is t_cfg:
            cfg.runtime.device = "cpu"
        services.append((JService if mod is j_cfg else Service).from_config(cfg))
    (js, ts) = services
    try:
        assert isinstance(ts.runtime, TorchRuntime)
        got, want = ts.synthesize(THREE_CHUNKS), js.synthesize(THREE_CHUNKS)
        assert got.shape == want.shape and rms_delta(got, want) < 1e-6
        got, want = ts.synthesize(ONE_CHUNK, continuity=True), js.synthesize(ONE_CHUNK, continuity=True)
        assert rms_delta(got, want) < 1e-6
    finally:
        js.close()
        ts.close()


# -- the cli backend ---------------------------------------------------------------


PASSTHROUGH = {
    "plain": ["temp=0.5", "lsd=2"],
    "blank": ["", "  ", "k = v "],
    "prefixed": ["--flag=1", "-f=2", "x="],
    "no_equals": ["novalue"],
    "empty_key": [" =1"],
}


def _outcome(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # noqa: BLE001 - compared across packages
        return (type(exc).__name__, str(exc))


@pytest.mark.parametrize("case", sorted(PASSTHROUGH))
def test_build_passthrough_args(case):
    items = PASSTHROUGH[case]
    want = _outcome(j_cli.build_passthrough_args, items)
    assert _outcome(t_cli.build_passthrough_args, items) == want
    assert want[0] == ("ValueError" if case in ("no_equals", "empty_key") else "ok")


STUB_PCM = (np.sin(np.arange(4800) / 7.0) * 0.25).astype(np.float32)


@pytest.fixture
def stub(tmp_path):
    """A ``pocket-tts`` executable: it appends its argv to ``argv.jsonl``,
    prints its version for ``--version``, fails for the text ``fail`` and
    otherwise writes a fixed WAV to stdout."""
    (tmp_path / "out.wav").write_bytes(wav.encode_wav(STUB_PCM))
    exe = tmp_path / "pocket-tts"
    exe.write_text(
        f"#!{sys.executable}\n"
        "import json, os, sys\n"
        "here = os.path.dirname(os.path.abspath(__file__))\n"
        "with open(os.path.join(here, 'argv.jsonl'), 'a') as f:\n"
        "    f.write(json.dumps(sys.argv[1:]) + '\\n')\n"
        "if sys.argv[1:] == ['--version']:\n"
        "    print('pocket-tts 1.2.3'); sys.exit(0)\n"
        "if 'fail' in sys.argv:\n"
        "    sys.stderr.write('synthesis failed: bad text'); sys.exit(3)\n"
        "sys.stdout.buffer.write(open(os.path.join(here, 'out.wav'), 'rb').read())\n"
    )
    exe.chmod(exe.stat().st_mode | stat.S_IXUSR)
    return exe


def _argv(stub):
    path = stub.parent / "argv.jsonl"
    lines = path.read_text().splitlines() if path.exists() else []
    path.unlink(missing_ok=True)
    return [json.loads(line) for line in lines]


def _cli_config(mod, stub, **tts):
    cfg = mod.Config()
    cfg.tts.backend, cfg.tts.cli_path = "cli", str(stub)
    cfg.paths.tokenizer_model = "/nonexistent/tokenizer.model"  # the cli backend reads none
    for k, v in tts.items():
        setattr(cfg.tts, k, v)
    return cfg


@pytest.mark.parametrize(
    "tts", [{}, {"quiet": False, "cli_args": ["temp=0.5", "--lsd=2"], "cli_config_path": "c.yaml"}], ids=["plain", "options"]
)
def test_cli_backend_through_service_matches_the_jax_one(stub, tts):
    js = JService.from_config(_cli_config(j_cfg, stub, **tts))
    want, j_argv = js.synthesize("Hello world.", "v.safetensors"), _argv(stub)
    ts = Service.from_config(_cli_config(t_cfg, stub, **tts))
    got, t_argv = ts.synthesize("Hello world.", "v.safetensors"), _argv(stub)
    assert ts.tokenizer is None and ts.estimate_total_frames("Hello world.") == 0
    assert t_argv == j_argv and len(t_argv) == 1 and t_argv[0][:5] == ["generate", "--text", "Hello world.", "--output-path", "-"]
    np.testing.assert_array_equal(got, want)
    assert got.shape == STUB_PCM.shape
    chunks = list(ts.synthesize_stream("Hello world."))
    assert [(c.chunk_index, c.final) for c in chunks] == [(0, True)]
    for svc in (js, ts):
        assert _outcome(svc.synthesize, "fail")[0] == "RuntimeError"
    assert str(_outcome(ts.synthesize, "fail")[1]) == str(_outcome(js.synthesize, "fail")[1])
    js.close()
    ts.close()


def test_cli_backend_needs_no_card(stub, monkeypatch):
    """The cli backend runs nothing on the card: it is built, and answers,
    with CUDA unavailable and the config's device at its default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    svc = Service.from_config(_cli_config(t_cfg, stub))
    assert svc.synthesize("hi").shape == STUB_PCM.shape


def test_server_answers_through_the_cli_backend(stub):
    svc = Service.from_config(_cli_config(t_cfg, stub))
    srv = Server(svc, listen_addr="127.0.0.1:0")
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        for path in ("/tts", "/tts/stream"):
            req = urllib.request.Request(base + path, data=json.dumps({"text": "hello"}).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                pcm, rate = wav.decode_wav(r.read())
            assert rate == 24000 and pcm.shape == STUB_PCM.shape, path
    finally:
        srv.shutdown()
        svc.close()


@pytest.fixture
def cli_env(tmp_path, monkeypatch, stub):
    monkeypatch.chdir(tmp_path)
    for key in ("POCKETTTS_PLATFORM", "POCKETTTS_BACKEND", "POCKETTTS_TTS_CLI_PATH"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("POCKETTTS_RUNTIME_COMPILE_CACHE_DIR", "")
    return tmp_path


def test_synth_tts_arg_writes_the_jax_clis_bytes(cli_env, stub):
    args = ["synth", "--backend", "cli", "--tts-cli-path", str(stub), "--tts-quiet", "false",
            "--tts-cli-config-path", "c.yaml", "--text", "hello world", "--tts-arg", "k=v", "--tts-arg=--x=1"]
    assert j_main(args + ["--out", "jax.wav"]) == 0
    j_argv = _argv(stub)
    assert main(args + ["--out", "port.wav"]) == 0
    t_argv = _argv(stub)
    assert (cli_env / "port.wav").read_bytes() == (cli_env / "jax.wav").read_bytes()
    assert t_argv == j_argv and len(t_argv) == 1
    assert t_argv[0][-4:] == ["--config", "c.yaml", "--k=v", "--x=1"] and "--quiet" not in t_argv[0]


@pytest.mark.parametrize(
    "extra", [["--backend", "torch", "--tts-arg", "k=v"], ["--backend", "cli", "--tts-arg", "novalue"]], ids=["not_cli", "bad_item"]
)
def test_synth_tts_arg_refusals_match_the_jax_cli(cli_env, stub, capsys, extra):
    args = ["synth", "--tts-cli-path", str(stub), "--text", "hello", "--out", "x.wav", *extra]
    j_rc = j_main(args)
    j_err = capsys.readouterr().err
    t_rc = main(args)
    t_err = capsys.readouterr().err
    assert t_rc == j_rc == 2 and t_err == j_err and t_err.startswith("error:")
    assert not (cli_env / "x.wav").exists() and _argv(stub) == []


@pytest.mark.parametrize("which", ["stub", "missing"])
def test_doctor_probes_the_cli_binary_as_the_jax_one(stub, tmp_path, which):
    exe = str(stub) if which == "stub" else str(tmp_path / "no-such-binary")
    lines = []
    for mod, run, probes in (
        (j_cfg, j_run_doctor, dict(jax_probe=lambda: "x", native_probe=lambda: "x", tokenizer_probe=lambda p: (True, ""))),
        (t_cfg, run_doctor, dict(cuda_probe=lambda: "x", kernels_probe=lambda d: "x", native_probe=lambda: "x",
                                 tokenizer_probe=lambda p: (True, ""))),
    ):
        cfg = _cli_config(mod, exe)
        cfg.runtime.compile_cache_dir = str(tmp_path / "cache")
        res = run(cfg, **probes)
        lines.append([line for line in res.lines if "pocket-tts binary" in line])
    assert lines[1] == lines[0] and len(lines[1]) == 1
    assert lines[1][0] == ("✓ pocket-tts binary — pocket-tts 1.2.3" if which == "stub" else lines[0][0])
    assert lines[1][0].startswith("✓" if which == "stub" else "✗")


def test_doctor_has_no_cli_probe_on_other_backends(tmp_path):
    cfg = t_cfg.Config()
    cfg.runtime.compile_cache_dir = str(tmp_path / "cache")
    res = run_doctor(cfg, cuda_probe=lambda: "x", kernels_probe=lambda d: "x", native_probe=lambda: "x",
                     tokenizer_probe=lambda p: (True, ""))
    assert not any("pocket-tts binary" in line for line in res.lines)


# -- names -------------------------------------------------------------------------


# The JAX engine's names and the port's: the only difference between the
# packages' alias tables.
ENGINE_NAMES = {"tpu": "gpu", "jax": "cuda"}


def test_normalize_backend_maps_every_alias_as_the_jax_one():
    j_aliases = dict(j_cfg._BACKEND_ALIASES)
    t_aliases = dict(t_cfg._BACKEND_ALIASES)
    assert {ENGINE_NAMES.get(k, k) for k in j_aliases} == set(t_aliases)
    for name, target in j_aliases.items():
        port_name = ENGINE_NAMES.get(name, name)
        want = "gpu" if target == j_cfg.BACKEND_TPU else target
        assert t_cfg.normalize_backend(port_name) == want
        assert t_cfg.normalize_backend(f" {port_name.upper()} ") == want
    assert (t_cfg.BACKEND_TORCH, t_cfg.BACKEND_CLI) == (j_cfg.BACKEND_TORCH, j_cfg.BACKEND_CLI)
    for name in ENGINE_NAMES:
        with pytest.raises(ValueError, match="unsupported backend"):
            t_cfg.normalize_backend(name)


def test_cli_options_parse_as_the_jax_ones(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("POCKETTTS_TTS_QUIET", "false")
    from go_pocket_tts_tpu.cli.main import build_parser as j_parser
    from go_pocket_tts_tpu_torch.cli.main import build_parser

    args = ["synth", "--tts-cli-path", "/bin/pt", "--tts-cli-config-path", "c.toml", "--tts-arg", "a=b"]
    j = j_cfg.load_config(j_parser().parse_args(args))
    t = t_cfg.load_config(build_parser().parse_args(args))
    fields = ("cli_path", "cli_args", "quiet", "cli_config_path")
    assert {f: getattr(t.tts, f) for f in fields} == {f: getattr(j.tts, f) for f in fields}
    assert dataclasses.asdict(t_cfg.TTSConfig())["quiet"] is True
    assert build_parser().parse_args(args).tts_arg == ["a=b"]
