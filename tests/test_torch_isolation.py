"""The port stands alone: it imports neither ``jax`` nor the JAX package,
synthesizes with both unimportable, and never drops to the CPU on its own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from go_pocket_tts_tpu_torch import DEFAULT_DEVICE, resolve_device
from go_pocket_tts_tpu_torch.convert import params_from_jax
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.bench import microbench
from go_pocket_tts_tpu_torch.model_assets.verify import verify_native_model
from go_pocket_tts_tpu_torch.models.model import load_model, load_model_from_store, load_model_from_tensors
from go_pocket_tts_tpu_torch.parallel import BatcherRuntime, ContinuousBatcher
from go_pocket_tts_tpu_torch.parallel.batching import make_batched_state
from go_pocket_tts_tpu_torch.runtime import GPURuntime
from go_pocket_tts_tpu_torch.tts.voice_export import VoiceEncoder, export_voice_embedding, export_voice_model_state
from go_pocket_tts_tpu_torch.tts.voice_upload import VoiceUploader

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "go_pocket_tts_tpu")

_SCRIPT = r"""
import sys

class _Block:
    def find_spec(self, name, path=None, target=None):
        root = name.split(".")[0]
        if root in ("jax", "jaxlib", "go_pocket_tts_tpu"):
            raise ImportError(f"{name} is blocked in this test")
        return None

sys.meta_path.insert(0, _Block())

import numpy as np
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime
import go_pocket_tts_tpu_torch.convert, go_pocket_tts_tpu_torch.kernels.build

arch = synthetic.tiny_arch()
model = load_model_from_tensors(synthetic.build_checkpoint(arch, seed=4), num_heads=arch.num_heads, device="cpu")
audio = GPURuntime(model, seed=1, frame_bucket=64, device="cpu").generate_audio(
    [3, 17, 41], GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=4)
)
assert audio.shape == (4 * 1920,) and np.isfinite(audio).all(), audio.shape
from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher
batcher = ContinuousBatcher(model, slots=2, prompt_capacity=16, max_frames=16, seed=1, device="cpu",
                            quantize=True, kv_quantize=True)
batcher.start()
try:
    served = batcher.generate([3, 17, 41], GenerateConfig(temperature=0.7, eos_threshold=1e9, max_steps=3))
finally:
    batcher.stop()
assert served.shape == (3 * 1920,) and np.isfinite(served).all(), served.shape
assert not any(m.split(".")[0] in ("jax", "jaxlib", "go_pocket_tts_tpu") for m in sys.modules)
print("NO-JAX-OK", len(audio), len(served))
"""


_INT4_SCRIPT = _SCRIPT[: _SCRIPT.index("import numpy as np")] + r"""
import dataclasses, os, tempfile
import numpy as np
from go_pocket_tts_tpu_torch.model_assets.quantize_export import build_quantized_checkpoint
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model
from go_pocket_tts_tpu_torch.models.quantize import model_quantized_bits
from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime
from go_pocket_tts_tpu_torch.utils.safetensors import read_header_metadata, write_file

arch = dataclasses.replace(synthetic.tiny_arch(), d_model=256, ffn_dim=512, flow_dim=256, flow_hidden=256)
tensors, meta, quantized = build_quantized_checkpoint(synthetic.build_checkpoint(arch, seed=4), 4, num_heads=arch.num_heads)
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "int4.safetensors")
    write_file(path, tensors, metadata=meta)
    assert read_header_metadata(path)["pockettts.quantize"] == "int4-g128"
    model = load_model(path, num_heads=arch.num_heads, device="cpu")
assert model_quantized_bits(model.params) == 4
cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=3)
audio = GPURuntime(model, seed=1, frame_bucket=64, device="cpu").generate_audio([3, 17, 41], cfg)
batcher = ContinuousBatcher(model, slots=2, prompt_capacity=16, max_frames=16, seed=1, device="cpu", kv_quantize=True)
batcher.start()
try:
    served = batcher.generate([3, 17, 41], cfg)
finally:
    batcher.stop()
assert audio.shape == served.shape == (3 * 1920,) and np.isfinite(served).all()
assert not any(m.split(".")[0] in ("jax", "jaxlib", "go_pocket_tts_tpu") for m in sys.modules)
print("NO-JAX-INT4-OK", len(quantized))
"""


_STREAM_SCRIPT = _SCRIPT[: _SCRIPT.index("import numpy as np")] + r"""
import os, tempfile
import numpy as np
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.runtime import GenerateConfig, GPURuntime, stream_generate, stream_generate_session
from go_pocket_tts_tpu_torch.utils.safetensors import load_voice_embedding, load_voice_model_state, write_file

arch = synthetic.tiny_arch()
model = load_model_from_tensors(synthetic.build_checkpoint(arch, seed=4), num_heads=arch.num_heads, device="cpu")
rt = GPURuntime(model, seed=1, frame_bucket=64, device="cpu")
cfg = GenerateConfig(temperature=0.7, eos_threshold=1e9, max_steps=6)
blocks = list(stream_generate(rt, [3, 17, 41], cfg))
assert [len(b) for b in blocks] == [4 * 1920, 2 * 1920], [len(b) for b in blocks]
cont = None
for chunk in ([3, 17, 41], [5, 9]):
    blocks, next_state = stream_generate_session(rt, chunk, cfg, cont)
    assert sum(len(b) for b in blocks) == 6 * 1920
    cont = next_state()
audio, cont = rt.generate_audio_session([7, 1], cfg, cont)
assert audio.shape == (6 * 1920,) and cont.used_ub == 3 + 6 + 2 + 6 + 2 + 6, cont.used_ub
rng = np.random.RandomState(0)
head_dim = arch.d_model // arch.num_heads
state = {}
for i in range(arch.num_layers):
    state[f"transformer.layers.{i}.self_attn/cache"] = rng.randn(2, 1, 5, arch.num_heads, head_dim).astype(np.float32)
    state[f"transformer.layers.{i}.self_attn/offset"] = np.array([5.0], np.float32)
with tempfile.TemporaryDirectory() as tmp:
    write_file(os.path.join(tmp, "emb.safetensors"), {"audio_prompt": rng.randn(4, arch.d_model).astype(np.float32)})
    write_file(os.path.join(tmp, "state.safetensors"), state)
    voices = [
        GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=3, voice_embedding=load_voice_embedding(os.path.join(tmp, "emb.safetensors"))),
        GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=3, voice_model_state=load_voice_model_state(os.path.join(tmp, "state.safetensors"))),
    ]
for vcfg in voices:
    voiced = rt.generate_audio([3, 17, 41], vcfg)
    assert voiced.shape == (3 * 1920,) and np.isfinite(voiced).all()
from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher
batcher = ContinuousBatcher(model, slots=2, prompt_capacity=32, max_frames=16, seed=1, device="cpu", steps_per_sync=2)
batcher.start()
try:
    blocks = list(batcher.submit_stream([3, 17, 41], cfg))
    assert [len(b) for b in blocks] == [2 * 1920] * 3, [len(b) for b in blocks]
    for vcfg in voices:
        assert batcher.generate([3, 17, 41], vcfg).shape == (3 * 1920,)
    cont = None
    for chunk in ([3, 17, 41], [5, 9]):
        audio, cont = batcher.generate_session(chunk, cfg, cont)
        assert audio.shape == (6 * 1920,) and int(cont.offset[0]) > 0
finally:
    batcher.stop()
assert not any(m.split(".")[0] in ("jax", "jaxlib", "go_pocket_tts_tpu") for m in sys.modules)
print("NO-JAX-STREAM-OK")
"""


_ENTRY_SCRIPT = _SCRIPT[: _SCRIPT.index("import numpy as np")] + r"""
import importlib, io, json, os, pkgutil, tempfile, urllib.request
from contextlib import redirect_stdout
import go_pocket_tts_tpu_torch as pkg

for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    if mod.name != "go_pocket_tts_tpu_torch.__main__":
        importlib.import_module(mod.name)
from go_pocket_tts_tpu_torch.cli.main import main
from go_pocket_tts_tpu_torch.config import Config
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.server import Server
from go_pocket_tts_tpu_torch.text.sentencepiece import SentencePieceModel
from go_pocket_tts_tpu_torch.tts.service import Service
from go_pocket_tts_tpu_torch.utils.safetensors import write_file
from go_pocket_tts_tpu_torch.utils.wav import decode_wav

with tempfile.TemporaryDirectory() as tmp:
    model_path, tok_path = os.path.join(tmp, "model.safetensors"), os.path.join(tmp, "tokenizer.model")
    write_file(model_path, synthetic.build_checkpoint(synthetic.tiny_arch(), seed=4))
    sp = SentencePieceModel()
    for piece in ["<unk>"] + list("abcdefghijklmnopqrstuvwxyz▁"):
        sp.pieces.append(piece); sp.scores.append(-1.0); sp.types.append(2 if piece == "<unk>" else 1)
    open(tok_path, "wb").write(sp.serialize())
    cfg = Config()
    cfg.paths.model_path, cfg.paths.tokenizer_model, cfg.runtime.device = model_path, tok_path, "cpu"
    cfg.tts.eos_threshold, cfg.tts.max_steps = 1e9, 3
    svc = Service.from_config(cfg)
    assert svc.synthesize("hello world").shape == (3 * 1920,)
    srv = Server(svc, listen_addr="127.0.0.1:0")
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        for path in ("/tts", "/tts/stream"):
            req = urllib.request.Request(base + path, data=json.dumps({"text": "hello"}).encode(), method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                assert decode_wav(r.read())[0].shape == (3 * 1920,), path
        assert json.loads(urllib.request.urlopen(base + "/health", timeout=10).read())["status"] == "ok"
    finally:
        srv.shutdown()
    os.environ.update(POCKETTTS_PLATFORM="cpu", POCKETTTS_PATHS_MODEL_PATH=model_path,
                      POCKETTTS_PATHS_TOKENIZER_MODEL=tok_path, POCKETTTS_MAX_STEPS="2")
    out = os.path.join(tmp, "out.wav")
    assert main(["synth", "--text", "hello", "--out", out]) == 0
    assert decode_wav(open(out, "rb").read())[0].shape == (2 * 1920,)
assert not any(m.split(".")[0] in ("jax", "jaxlib", "go_pocket_tts_tpu") for m in sys.modules)
print("NO-JAX-ENTRY-OK")
"""


_CLONE_SCRIPT = _SCRIPT[: _SCRIPT.index("import numpy as np")] + r"""
import base64, json, os, tempfile, urllib.request
from contextlib import redirect_stdout
import io
import numpy as np
from go_pocket_tts_tpu_torch.cli.main import main
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.runtime import GPURuntime
from go_pocket_tts_tpu_torch.server import Server
from go_pocket_tts_tpu_torch.tts.service import Service
from go_pocket_tts_tpu_torch.tts.voice_export import VoiceEncoder, export_voice_embedding, export_voice_model_state
from go_pocket_tts_tpu_torch.tts.voice_upload import VoiceUploader
from go_pocket_tts_tpu_torch.tts.voices import VoiceManager
from go_pocket_tts_tpu_torch.config import TTSConfig
from go_pocket_tts_tpu_torch.utils.safetensors import inspect_voice_file, write_file
from go_pocket_tts_tpu_torch.utils.wav import decode_wav, encode_wav

class Words:
    def encode(self, s):
        return [len(w) for w in s.split()]

arch = synthetic.tiny_arch()
tensors = synthetic.build_checkpoint(arch, seed=4)
speaker = encode_wav((np.random.RandomState(0).randn(12000) * 0.1).astype(np.float32))
emb = VoiceEncoder(tensors, device="cpu").encode_wav_bytes(speaker, pad_to_bucket=True)
assert emb.shape == (1, 6, arch.d_model) and np.isfinite(emb).all(), emb.shape
with tempfile.TemporaryDirectory() as tmp:
    model_path, wav_path = os.path.join(tmp, "model.safetensors"), os.path.join(tmp, "speaker.wav")
    write_file(model_path, tensors)
    open(wav_path, "wb").write(speaker)
    export_voice_embedding(model_path, wav_path, os.path.join(tmp, "e.safetensors"), device="cpu")
    assert export_voice_model_state(model_path, wav_path, os.path.join(tmp, "s.safetensors"), num_heads=arch.num_heads, device="cpu") == 6
    assert inspect_voice_file(os.path.join(tmp, "s.safetensors")) == "model_state"
    model = load_model_from_tensors(tensors, num_heads=arch.num_heads, device="cpu")
    svc = Service(GPURuntime(model, seed=1, frame_bucket=64, device="cpu"), Words(),
                  TTSConfig(temperature=0.0, eos_threshold=1e9, max_steps=3))
    voices = VoiceManager.in_memory(tmp)
    uploader = VoiceUploader(model_path, os.path.join(tmp, "voices"), voices, service=svc, device="cpu")
    srv = Server(svc, voices, listen_addr="127.0.0.1:0", voice_uploader=uploader)
    srv.start()
    try:
        base = f"http://127.0.0.1:{srv.port}"
        body = json.dumps({"id": "v", "audio": base64.b64encode(speaker).decode()}).encode()
        with urllib.request.urlopen(urllib.request.Request(base + "/voices", data=body, method="POST"), timeout=120) as r:
            assert json.loads(r.read())["voice"]["prewarmed"] is True
        req = urllib.request.Request(base + "/tts", data=json.dumps({"text": "a b", "voice": "v"}).encode(), method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            assert decode_wav(r.read())[0].shape == (3 * 1920,)
    finally:
        srv.shutdown()
    os.environ.update(POCKETTTS_PLATFORM="cpu", POCKETTTS_PATHS_MODEL_PATH=model_path)
    with redirect_stdout(io.StringIO()) as out:
        assert main(["export-voice", "--input", wav_path, "--output", os.path.join(tmp, "c.safetensors")]) == 0
    assert json.loads(out.getvalue().splitlines()[0])["frames"] == 6
assert not any(m.split(".")[0] in ("jax", "jaxlib", "go_pocket_tts_tpu") for m in sys.modules)
print("NO-JAX-CLONE-OK")
"""


_TOOLS_SCRIPT = _SCRIPT[: _SCRIPT.index("import numpy as np")] + r"""
import io, json, os, tempfile
from contextlib import redirect_stdout
from go_pocket_tts_tpu_torch.cli.main import main
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.text.sentencepiece import SentencePieceModel
from go_pocket_tts_tpu_torch.utils.safetensors import write_file

with tempfile.TemporaryDirectory() as tmp:
    model_path, tok_path = os.path.join(tmp, "model.safetensors"), os.path.join(tmp, "tokenizer.model")
    write_file(model_path, synthetic.build_checkpoint(synthetic.tiny_arch(), seed=4))
    sp = SentencePieceModel()
    for piece in ["<unk>"] + list("abcdefghijklmnopqrstuvwxyz▁"):
        sp.pieces.append(piece); sp.scores.append(-1.0); sp.types.append(2 if piece == "<unk>" else 1)
    open(tok_path, "wb").write(sp.serialize())
    os.environ.update(POCKETTTS_PLATFORM="cpu", POCKETTTS_PATHS_MODEL_PATH=model_path,
                      POCKETTTS_PATHS_TOKENIZER_MODEL=tok_path, POCKETTTS_MAX_STEPS="2",
                      POCKETTTS_EOS_THRESHOLD="1e9", POCKETTTS_RUNTIME_SEED="3")
    with redirect_stdout(io.StringIO()) as out:
        assert main(["bench", "--text", "hello", "--runs", "1", "--json"]) == 0
    runs = json.loads(out.getvalue())["runs"]
    assert [r["audio_seconds"] for r in runs] == [0.16, 0.16], runs
    with redirect_stdout(io.StringIO()) as out:
        assert main(["model", "verify"]) == 0
    assert "✓ model smoke load: d_model=64" in out.getvalue().splitlines(), out.getvalue()
assert not any(m.split(".")[0] in ("jax", "jaxlib", "go_pocket_tts_tpu") for m in sys.modules)
print("NO-JAX-TOOLS-OK")
"""

_KERNEL_SCRIPT = _SCRIPT[: _SCRIPT.index("import numpy as np")] + r"""
import os, subprocess, tempfile
import numpy as np
from go_pocket_tts_tpu_torch.kernel import PocketTTSKernel
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model
from go_pocket_tts_tpu_torch.runtime import GenerateConfig
from go_pocket_tts_tpu_torch.text.sentencepiece import SentencePieceModel
from go_pocket_tts_tpu_torch.tts.parity import rms_delta, snapshot_pcm
from go_pocket_tts_tpu_torch.tts.parity_fixture import load_fixture, verify_fixture
from go_pocket_tts_tpu_torch.tts.runtime_cli import CLIRuntime, build_passthrough_args
from go_pocket_tts_tpu_torch.tts.runtime_torch import TorchRuntime
from go_pocket_tts_tpu_torch.utils.safetensors import encode_tensors, write_file
from go_pocket_tts_tpu_torch.utils.wav import decode_wav

arch = synthetic.tiny_arch()
tensors = synthetic.build_checkpoint(arch, seed=4)
sp = SentencePieceModel()
for piece in ["<unk>"] + list("abcdefghijklmnopqrstuvwxyz▁"):
    sp.pieces.append(piece); sp.scores.append(-1.0); sp.types.append(2 if piece == "<unk>" else 1)
kernel = PocketTTSKernel(seed=1, device="cpu")
kernel.load_model(encode_tensors(tensors), sp.serialize())
calls = []
pcm, rate = decode_wav(kernel.synthesize("hi", temperature=0.0, eos_threshold=-1e9, progress=lambda d, t: calls.append((d, t))))
assert rate == 24000 and len(pcm) > 0 and calls[-1] == (len(pcm) // 1920,) * 2, calls
with tempfile.TemporaryDirectory() as tmp:
    path = os.path.join(tmp, "model.safetensors")
    write_file(path, tensors)
    oracle = TorchRuntime.from_checkpoint(path, num_heads=arch.num_heads, seed=1, device="cpu")
    audio = oracle.generate_audio([3, 17, 41], GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=3))
    assert audio.shape == (3 * 1920,) and snapshot_pcm("torch", audio).num_samples == 3 * 1920
    out = os.path.join(tmp, "fx.json")
    subprocess.run([sys.executable, "scripts/torch_dump_parity.py", "--model", path, "--num-heads", str(arch.num_heads),
                    "--device", "cpu", "--mimi-frames", "1", "--output", out], check=True, capture_output=True)
    reports = verify_fixture(load_model(path, num_heads=arch.num_heads, device="cpu"), load_fixture(out))
    assert reports and all(r.passed for r in reports), reports
assert build_passthrough_args(["k=v"]) == ["--k=v"] and CLIRuntime().cli_path == "pocket-tts"
assert not any(m.split(".")[0] in ("jax", "jaxlib", "go_pocket_tts_tpu") for m in sys.modules)
print("NO-JAX-KERNEL-OK")
"""


def _run_blocked(script: str) -> str:
    proc = subprocess.run(
        [sys.executable, "-c", script],
        cwd=ROOT,
        capture_output=True,
        text=True,
        timeout=300,
        # One CPU thread: the tiny tensors gain nothing from more, and the
        # suite's other worker processes share the cores.
        env={**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"},
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout


def test_port_synthesizes_with_jax_blocked():
    assert "NO-JAX-OK" in _run_blocked(_SCRIPT)


def test_port_serves_an_int4_artifact_with_jax_blocked():
    """Export an int4 artifact, write it, load it and serve it on both
    runtimes, with jax and the JAX package unimportable."""
    assert "NO-JAX-INT4-OK" in _run_blocked(_INT4_SCRIPT)


def test_port_streams_runs_sessions_and_takes_a_voice_with_jax_blocked():
    """Frame streaming, a streamed and a plain session, and both kinds of
    voice file (written, loaded and conditioned on), on the single runtime
    and through the continuous batcher (a streamed, a voiced and a session
    request), with jax and the JAX package unimportable."""
    assert "NO-JAX-STREAM-OK" in _run_blocked(_STREAM_SCRIPT)


def test_port_serves_text_with_jax_blocked():
    """Every module of the port imports, and ``Service``, the HTTP server
    and the CLI's ``synth`` run on the CPU, with jax and the JAX package
    unimportable."""
    assert "NO-JAX-ENTRY-OK" in _run_blocked(_ENTRY_SCRIPT)


def test_port_benches_and_verifies_with_jax_blocked():
    """``bench`` and ``model verify`` (its smoke load on the CPU) through the
    CLI, with jax and the JAX package unimportable."""
    assert "NO-JAX-TOOLS-OK" in _run_blocked(_TOOLS_SCRIPT)


def test_port_clones_a_voice_with_jax_blocked():
    """The Mimi encoder, both export formats, ``POST /voices`` through the
    server (prewarmed, then served by ``POST /tts``) and the CLI's
    ``export-voice``, with jax and the JAX package unimportable."""
    assert "NO-JAX-CLONE-OK" in _run_blocked(_CLONE_SCRIPT)


def test_port_kernel_api_oracle_and_parity_with_jax_blocked():
    """``PocketTTSKernel.synthesize`` with progress, the torch oracle, the
    cli runtime's helpers, the parity harness and a fixture written by
    ``scripts/torch_dump_parity.py`` and replayed by ``verify_fixture``,
    with jax and the JAX package unimportable."""
    assert "NO-JAX-KERNEL-OK" in _run_blocked(_KERNEL_SCRIPT)


PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in (ROOT / "go_pocket_tts_tpu_torch").rglob("*.py"))


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(encoding="utf-8"), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize(
    "path",
    PORT_FILES
    + ["chip_smoke.py", "scripts/torch_profile.py", "scripts/torch_profile_batched.py"]
    + ["scripts/time_up2_kernels.py", "scripts/time_decode_attention.py", "scripts/time_quantized_matmul.py"]
    + ["scripts/torch_dump_parity.py", "scripts/torch_mesh_drift.py"],
)
def test_no_jax_imports(path):
    bad = [root for root in _imported_roots(ROOT / path) if root in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_scan_covers_every_port_package():
    packages = {Path(p).parts[1] for p in PORT_FILES if len(Path(p).parts) > 2}
    assert {"bench", "cli", "kernels", "model_assets", "models", "native", "ops", "parallel", "runtime", "server",
            "text", "tts", "utils"} <= packages
    assert "go_pocket_tts_tpu_torch/parallel/batching.py" in PORT_FILES
    for module in ("kernel.py", "tts/runtime_torch.py", "tts/runtime_cli.py", "tts/parity.py", "tts/parity_fixture.py"):
        assert f"go_pocket_tts_tpu_torch/{module}" in PORT_FILES


def test_default_device_is_cuda():
    assert DEFAULT_DEVICE == "cuda"
    for fn in (
        GPURuntime.__init__,
        ContinuousBatcher.__init__,
        BatcherRuntime.__init__,
        make_batched_state,
        load_model_from_tensors,
        params_from_jax,
        VoiceEncoder.__init__,
        VoiceUploader.__init__,
        export_voice_embedding,
        export_voice_model_state,
        load_model,
        load_model_from_store,
        verify_native_model,
    ):
        assert fn.__defaults__ is not None and "cuda" in fn.__defaults__, fn
    from go_pocket_tts_tpu_torch.cli.doctor import run_doctor
    from go_pocket_tts_tpu_torch.config import Config, RuntimeConfig, normalize_backend
    from go_pocket_tts_tpu_torch.kernel import PocketTTSKernel
    from go_pocket_tts_tpu_torch.tts.runtime_torch import TorchRuntime

    for fn in (PocketTTSKernel.__init__, TorchRuntime.__init__):
        assert fn.__defaults__ is not None and "cuda" in fn.__defaults__, fn
    assert RuntimeConfig().device == "cuda"
    # Every backend reads the one device setting: doctor's config and the
    # backends' configs all default to the card.
    for backend in ("gpu", "torch", "cli"):
        cfg = Config()
        cfg.tts.backend = backend
        assert normalize_backend(cfg.tts.backend) == backend and cfg.runtime.device == "cuda"
    assert Config().tts.backend == "gpu"
    if not torch.cuda.is_available():
        # doctor probes the card with its default probe and reports its
        # absence; it does not check the CPU in its place.
        res = run_doctor(Config(), kernels_probe=lambda d: "x", native_probe=lambda: "x")
        assert res.lines[0].startswith("✗ cuda backend — no CUDA device"), res.lines[0]
    assert microbench.DEFAULT_DEVICE == "cuda"


def test_entry_points_raise_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arch = synthetic.tiny_arch()
    tensors = synthetic.build_checkpoint(arch, seed=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model_from_tensors(tensors, num_heads=arch.num_heads)
    model = load_model_from_tensors(tensors, num_heads=arch.num_heads, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GPURuntime(model)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatcher(model, slots=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_jax({"w": model.params["mimi"]["up3"]["w"].numpy()})
    from go_pocket_tts_tpu_torch.utils.safetensors import open_store_from_bytes, encode_tensors

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model_from_store(open_store_from_bytes(encode_tensors(tensors)), num_heads=arch.num_heads)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        microbench.main(["--reps", "1"])
    # model verify's smoke load on the default device fails as a check, with
    # no load on the CPU.
    (tmp_path / "m.safetensors").write_bytes(encode_tensors(tensors))
    res = verify_native_model(str(tmp_path / "m.safetensors"))
    assert not res.ok and res.failures[0].startswith("✗ model smoke load") and "CUDA is not available" in res.failures[0]
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
