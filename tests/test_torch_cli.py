"""The port's config and CLI against the JAX package's: defaults, the env,
file and flag layers and their precedence, ``apply_serving_autotune``,
backend names, ``synth`` on the CPU against the JAX CLI's, ``serve`` and
``health``, the refusal of synthesis with no CUDA and no
``POCKETTTS_PLATFORM=cpu``, and the parser of every other subcommand
against the JAX CLI's."""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

from go_pocket_tts_tpu import config as j_cfg
from go_pocket_tts_tpu.cli.main import build_parser as j_parser
from go_pocket_tts_tpu.cli.main import main as j_main
from go_pocket_tts_tpu_torch.tts.parity import rms_delta
from go_pocket_tts_tpu_torch import config as t_cfg
from go_pocket_tts_tpu_torch.cli.main import build_parser, main
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.utils import wav
from go_pocket_tts_tpu_torch.utils.safetensors import write_file

ROOT = Path(__file__).resolve().parent.parent
SECTIONS = ("paths", "runtime", "server", "tts")
# The JAX package's field the port does not parse (XLA's matmul
# precision), and the one it adds (where the runtimes run; set by the CLI
# from POCKETTTS_PLATFORM).
NOT_PARSED = {
    "runtime": {"matmul_precision"},
}
ADDED = {"runtime": {"device"}}
DIFFERENT_DEFAULTS = {("runtime", "compile_cache_dir"), ("tts", "backend")}


def _shared(cfg, section):
    """The section's fields both packages parse, with the same default."""
    skip = NOT_PARSED.get(section, set()) | ADDED.get(section, set())
    values = dataclasses.asdict(getattr(cfg, section))
    return {k: v for k, v in values.items() if k not in skip and (section, k) not in DIFFERENT_DEFAULTS}


@pytest.mark.parametrize("section", SECTIONS)
def test_config_fields_and_defaults_match(section, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    j, t = j_cfg.load_config(), t_cfg.load_config()
    j_fields = {f.name for f in dataclasses.fields(getattr(j, section))}
    t_fields = {f.name for f in dataclasses.fields(getattr(t, section))}
    assert t_fields == (j_fields - NOT_PARSED.get(section, set())) | ADDED.get(section, set())
    assert _shared(t, section) == _shared(j, section)
    assert t.log_level == j.log_level
    assert (t.runtime.device, t.runtime.compile_cache_dir, t.tts.backend) == ("cuda", "", "gpu")


ENV = {
    "POCKETTTS_TEMPERATURE": "0.5",
    "POCKETTTS_WORKERS": "7",
    "POCKETTTS_MAX_STEPS": "256",
    "POCKETTTS_RUNTIME_DTYPE": "bfloat16",
    "POCKETTTS_RUNTIME_BATCH_SLOTS": "8",
    "POCKETTTS_RUNTIME_KV_QUANTIZE": "yes",
    "POCKETTTS_RUNTIME_STEPS_PER_SYNC_BURST": "0",
    "POCKETTTS_CONTINUITY": "true",
    "POCKETTTS_PATHS_MODEL_PATH": "m.safetensors",
    "POCKETTTS_SERVER_LISTEN_ADDR": "127.0.0.1:9",
    "POCKETTTS_LOG_LEVEL": "debug",
    "POCKETTTS_RUNTIME_SEED": "not-a-number",  # ignored by both
}

FILES = {
    "pockettts.yaml": "tts:\n  temperature: 0.3\n  max_steps: 99\nserver:\n  workers: 9\nruntime:\n  frame_bucket: 512\n",
    "pockettts.json": json.dumps({"tts": {"temperature": 0.2}, "runtime": {"quantize": "true"}, "log_level": "warn"}),
    "pockettts.toml": "[tts]\nlsd_decode_steps = 4\n[server]\nmax_text_bytes = 100\n",
}

FLAGS = ["--temperature", "0.9", "--runtime-batch-slots", "4", "--runtime-quantize", "false", "--max-steps", "12",
         "--continuity", "on", "--workers", "3", "--log-level", "error"]


def _both(args=(), config_file=None):
    j_args = j_parser().parse_args(["serve", *args])
    t_args = build_parser().parse_args(["serve", *args])
    return j_cfg.load_config(j_args, config_file), t_cfg.load_config(t_args, config_file)


def _assert_same(j, t):
    for section in SECTIONS:
        assert _shared(t, section) == _shared(j, section), section
    assert t.log_level == j.log_level
    assert t.user_set == j.user_set
    assert t.tts.max_steps_user_set == j.tts.max_steps_user_set


@pytest.mark.parametrize("layers", ["env", "file", "file+env", "file+env+flags", "flags"])
@pytest.mark.parametrize("file_name", list(FILES))
def test_config_layers_and_precedence_match(layers, file_name, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    if "file" in layers:
        (tmp_path / file_name).write_text(FILES[file_name])
    if "env" in layers:
        for k, v in ENV.items():
            monkeypatch.setenv(k, v)
    j, t = _both(FLAGS if "flags" in layers else ())
    _assert_same(j, t)


def test_explicit_config_file_and_malformed_file(tmp_path):
    good = tmp_path / "c.json"
    good.write_text(json.dumps({"tts": {"temperature": 0.1}, "server": {"workers": 5}}))
    _assert_same(*_both(("--config", str(good))))
    bad = tmp_path / "bad.yaml"
    bad.write_text("tts:\n  temperature: [unclosed")
    for mod in (j_cfg, t_cfg):
        with pytest.raises(ValueError):
            mod.load_config(config_file=str(bad))


AUTOTUNE = {
    "defaults": ["--runtime-batch-slots", "8"],
    "quantize_off": ["--runtime-batch-slots", "8", "--runtime-quantize", "false"],
    "int4_bits": ["--runtime-batch-slots", "8", "--runtime-quantize-bits", "4"],
    "int4_on": ["--runtime-batch-slots", "8", "--runtime-quantize", "true", "--runtime-quantize-bits", "4"],
    "burst_set": ["--runtime-batch-slots", "8", "--runtime-steps-per-sync-burst", "0"],
    "off": ["--runtime-batch-slots", "8", "--runtime-autotune", "false"],
    "single": [],
}


@pytest.mark.parametrize("case", list(AUTOTUNE))
def test_serving_autotune_matches(case, monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    j, t = _both(AUTOTUNE[case])
    assert t_cfg.apply_serving_autotune(t) == j_cfg.apply_serving_autotune(j)
    _assert_same(j, t)
    assert t_cfg.AUTOTUNE_BURST_STEPS == j_cfg.AUTOTUNE_BURST_STEPS


@pytest.mark.parametrize("name", ["", "gpu", "cuda", "native", "native-safetensors", " CUDA "])
def test_backend_aliases(name):
    assert t_cfg.normalize_backend(name) == "gpu"


@pytest.mark.parametrize("name", ["torch", "torch-cpu", "native-onnx", "cli"])
def test_unported_backends_are_refused_by_name(name):
    """The reference's other backends, ported since: each name maps as the
    JAX package maps it; the JAX engine's own name is still refused."""
    assert t_cfg.normalize_backend(name) == j_cfg.normalize_backend(name)
    with pytest.raises(ValueError, match="unsupported backend"):
        t_cfg.normalize_backend("tpu")


# -- the CLI -------------------------------------------------------------------


def _tokenizer_bytes() -> bytes:
    from go_pocket_tts_tpu_torch.text.sentencepiece import SentencePieceModel

    m = SentencePieceModel()
    pieces = [("<unk>", 0.0, 2)] + [(w, -1.0, 1) for w in "▁hello ▁world ▁the ▁quick ▁brown ▁fox .".split()]
    for p, s, t in pieces + [(c, -6.0, 1) for c in "abcdefghijklmnopqrstuvwxyz▁"]:
        m.pieces.append(p)
        m.scores.append(s)
        m.types.append(t)
    return m.serialize()


@pytest.fixture
def synth_env(tmp_path, monkeypatch):
    arch = synthetic.tiny_arch()
    write_file(tmp_path / "model.safetensors", synthetic.build_checkpoint(arch, seed=3))
    (tmp_path / "tokenizer.model").write_bytes(_tokenizer_bytes())
    env = {
        "POCKETTTS_PATHS_MODEL_PATH": str(tmp_path / "model.safetensors"),
        "POCKETTTS_PATHS_TOKENIZER_MODEL": str(tmp_path / "tokenizer.model"),
        "POCKETTTS_MAX_STEPS": "4",
        "POCKETTTS_EOS_THRESHOLD": "1000000",
        "POCKETTTS_TEMPERATURE": "0",
        "POCKETTTS_RUNTIME_SEED": "7",
        "POCKETTTS_RUNTIME_COMPILE_CACHE_DIR": "",  # the JAX CLI's persistent cache: off
    }
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    monkeypatch.delenv("POCKETTTS_PLATFORM", raising=False)
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("fmt", ["wav", "flac"])
def test_synth_on_the_cpu_matches_the_jax_cli(synth_env, monkeypatch, fmt):
    from go_pocket_tts_tpu_torch.utils.flac import decode_flac

    text = "hello world. the quick brown fox."
    assert j_main(["synth", "--text", text, "--out", f"jax.{fmt}", "--dc-block", "--fade-in-ms", "5"]) == 0
    monkeypatch.setenv("POCKETTTS_PLATFORM", "cpu")
    assert main(["synth", "--text", text, "--out", f"port.{fmt}", "--dc-block", "--fade-in-ms", "5"]) == 0

    def read(name):
        data = (synth_env / name).read_bytes()
        if fmt == "flac":
            pcm, rate = decode_flac(data)
            return pcm.astype(np.float32) / 32767.0, rate
        return wav.decode_wav(data)

    (got, rate), (want, _) = read(f"port.{fmt}"), read(f"jax.{fmt}")
    assert rate == 24000 and got.shape == want.shape == (4 * 1920,)
    assert rms_delta(got, want) < 1e-3


def test_synth_to_stdout(synth_env, monkeypatch, capsysbinary):
    monkeypatch.setenv("POCKETTTS_PLATFORM", "cpu")
    assert main(["synth", "--text", "hello", "--out", "-"]) == 0
    assert capsysbinary.readouterr().out[:4] == b"RIFF"


def test_synth_without_text_exits_2(synth_env, monkeypatch, capsys):
    monkeypatch.setenv("POCKETTTS_PLATFORM", "cpu")
    monkeypatch.setattr(sys, "stdin", open(os.devnull))
    assert main(["synth", "--text", "", "--out", "x.wav"]) == 2
    assert "--text is required" in capsys.readouterr().err


def _run_cli(args, env, timeout=120):
    return subprocess.run(
        [sys.executable, "-m", "go_pocket_tts_tpu_torch", *args],
        cwd=ROOT,
        env={**env, "PYTHONPATH": str(ROOT)},
        capture_output=True,
        text=True,
        timeout=timeout,
    )


def test_synth_without_cuda_and_without_the_cpu_pin_fails(synth_env):
    """No fallback: with POCKETTTS_PLATFORM unset on a host without CUDA
    the CLI exits non-zero and writes nothing."""
    env = {k: v for k, v in os.environ.items() if k != "POCKETTTS_PLATFORM"}
    out = synth_env / "never.wav"
    proc = _run_cli(["synth", "--text", "hello", "--out", str(out)], env)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
    assert not out.exists()
    proc = _run_cli(["synth", "--text", "hello", "--out", str(out)], {**env, "POCKETTTS_PLATFORM": "tpu"})
    assert proc.returncode == 2 and "POCKETTTS_PLATFORM" in proc.stderr


@pytest.mark.parametrize("platform,device", [("cpu", "cpu"), ("", "cuda"), ("gpu", "cuda"), ("CUDA", "cuda")])
def test_platform_maps_onto_the_device(monkeypatch, platform, device):
    from go_pocket_tts_tpu_torch.cli.main import platform_device

    monkeypatch.setenv("POCKETTTS_PLATFORM", platform)
    assert platform_device() == device


def _subparsers(parser):
    return next(a for a in parser._actions if a.__class__.__name__ == "_SubParsersAction").choices


def _options(parser, register_flags) -> dict:
    """The parser's own options (less the shared config flags, which each
    package registers from its own config: the port parses fewer), each
    with its default, whether it is required and its choices."""
    import argparse

    shared = argparse.ArgumentParser(add_help=False)
    register_flags(shared)
    common = {s for a in shared._actions for s in a.option_strings}
    return {
        tuple(a.option_strings): (a.dest, a.default, a.required, a.choices)
        for a in parser._actions
        if a.option_strings and not set(a.option_strings) & common
    }


# The tool subcommands (benchmarks, diagnostics, assets): each parses as the
# JAX one does.
TOOL_COMMANDS = ("bench", "stageprof", "doctor", "model", "voice")


@pytest.mark.parametrize("command", TOOL_COMMANDS)
def test_tool_subcommands_parse_as_the_jax_cli(command, capsys):
    with pytest.raises(SystemExit) as exit_:
        main([command, "--help"])
    assert exit_.value.code == 0
    assert "usage:" in capsys.readouterr().out
    pairs = [(_subparsers(build_parser())[command], _subparsers(j_parser())[command])]
    if command in ("model", "voice"):
        t_children, j_children = _subparsers(pairs[0][0]), _subparsers(pairs[0][1])
        assert list(t_children) == list(j_children)
        pairs += [(child, j_children[name]) for name, child in t_children.items()]
    for t_sub, j_sub in pairs:
        assert _options(t_sub, t_cfg.register_flags) == _options(j_sub, j_cfg.register_flags), t_sub.prog


def test_serve_answers_and_drains_on_sigterm(synth_env):
    """``serve`` on the CPU: /health answers, POST /tts returns a WAV,
    ``health`` probes it, SIGTERM ends it with exit 0."""
    env = {**os.environ, "POCKETTTS_PLATFORM": "cpu", "POCKETTTS_SERVER_LISTEN_ADDR": "127.0.0.1:0"}
    # Listen on a free port chosen here, so the test knows where to send.
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env["POCKETTTS_SERVER_LISTEN_ADDR"] = f"127.0.0.1:{port}"
    proc = subprocess.Popen(
        [sys.executable, "-m", "go_pocket_tts_tpu_torch", "serve"],
        cwd=ROOT,
        env={**env, "PYTHONPATH": str(ROOT)},
        stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE,
        text=True,
    )
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                with urllib.request.urlopen(f"{base}/health", timeout=2) as r:
                    assert json.loads(r.read())["status"] == "ok"
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()
                assert time.monotonic() < deadline, "server did not come up"
                time.sleep(0.2)
        req = urllib.request.Request(f"{base}/tts", data=json.dumps({"text": "hello"}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            pcm, rate = wav.decode_wav(r.read())
        assert rate == 24000 and pcm.shape == (4 * 1920,)
        assert main(["health", "--url", base]) == 0
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    assert rc == 0


def test_health_fails_without_a_server(capsys):
    assert main(["health", "--url", "http://127.0.0.1:9"]) == 1
    assert "error:" in capsys.readouterr().err
