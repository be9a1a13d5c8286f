"""The port's parity harness (``tts.parity``) and parity-fixture tier
(``tts.parity_fixture``, ``scripts/torch_dump_parity.py``) against the JAX
package's, on the CPU: the same reports, equal PCM16 sha256, byte-equal
snapshot JSON, and a torch-oracle fixture replayed by both packages'
``verify_fixture`` with the same verdicts."""

import dataclasses
import importlib.util
import json
import os
import types

import numpy as np
import pytest

from go_pocket_tts_tpu.models.model import load_model_from_store as j_load_model
from go_pocket_tts_tpu.tts import parity as j_parity
from go_pocket_tts_tpu.tts import parity_fixture as j_pf
from go_pocket_tts_tpu.tts.runtime_torch import TorchRuntime as JTorchRuntime
from go_pocket_tts_tpu.tts.service import Service as JService
from go_pocket_tts_tpu.utils.safetensors import open_store_from_bytes as j_store
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.runtime import GPURuntime
from go_pocket_tts_tpu_torch.tts import parity as t_parity
from go_pocket_tts_tpu_torch.tts import parity_fixture as t_pf
from go_pocket_tts_tpu_torch.tts.runtime_torch import TorchRuntime
from go_pocket_tts_tpu_torch.tts.service import Service
from go_pocket_tts_tpu_torch.utils.safetensors import encode_tensors, open_store_from_bytes

from torch_fixtures import ONE_CHUNK, tokenizer_bytes, tts_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = synthetic.tiny_arch()
SEED = 11


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_all_names_ported():
    assert t_parity.__all__ == j_parity.__all__
    for name in j_pf.__all__:
        assert hasattr(t_pf, name)
    assert (t_pf.HIDDEN_TOL, t_pf.CONV_TOL, t_pf.DECONV_TOL) == (j_pf.HIDDEN_TOL, j_pf.CONV_TOL, j_pf.DECONV_TOL)


_rng = np.random.RandomState(0)
_A = _rng.randn(4, 5).astype(np.float32)
COMPARE = {
    "equal": (_A, _A.copy(), {}),
    "within": (_A + 1e-5, _A, {}),
    "beyond": (_A + 1e-2, _A, {}),
    "loose": (_A + 1e-2, _A, {"atol": 2e-2, "rtol": 0.0}),
    "shape": (_A, _A[:, :4], {}),
    "empty": (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.float32), {}),
    "zeros_want": (_A, np.zeros_like(_A), {}),
}


@pytest.mark.parametrize("case", sorted(COMPARE))
def test_compare_tensor(case):
    got, want, kw = COMPARE[case]
    j = j_parity.compare_tensor(case, got, want, **kw)
    t = t_parity.compare_tensor(case, got, want, **kw)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


PCM = {
    "ramp": np.linspace(-1.2, 1.2, 4801, dtype=np.float32),
    "noise": (np.random.RandomState(3).randn(1920) * 0.3).astype(np.float32),
    "empty": np.zeros(0, np.float32),
}


@pytest.mark.parametrize("case", sorted(PCM))
def test_snapshot_pcm_and_rms_delta(case):
    x = PCM[case]
    j = j_parity.snapshot_pcm("b", x, num_chunks=2)
    t = t_parity.snapshot_pcm("b", x, num_chunks=2)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for other in PCM.values():
        assert t_parity.rms_delta(x, other) == j_parity.rms_delta(x, other)


class _FixedService:
    """A service stub whose stream yields fixed PCM chunks."""

    def __init__(self, chunks):
        self.chunks = chunks
        self.closed = False

    def synthesize_stream(self, text, voice_path=""):
        for i, c in enumerate(self.chunks):
            yield types.SimpleNamespace(samples=c, chunk_index=i, final=i == len(self.chunks) - 1)

    def close(self):
        self.closed = True


def test_run_parity_case_and_snapshot_json_are_byte_equal(tmp_path):
    chunks = {"a": [PCM["ramp"], PCM["noise"]], "b": [PCM["noise"]], "c": []}
    made = []

    def factory(name):
        def make():
            made.append(_FixedService(chunks[name]))
            return made[-1]

        return make

    j = j_parity.run_parity_case({n: factory(n) for n in chunks}, "text")
    t = t_parity.run_parity_case({n: factory(n) for n in chunks}, "text")
    assert {k: dataclasses.asdict(v) for k, v in t.items()} == {k: dataclasses.asdict(v) for k, v in j.items()}
    assert all(s.closed for s in made)
    j_parity.save_snapshots(str(tmp_path / "j.json"), j)
    t_parity.save_snapshots(str(tmp_path / "t.json"), t)
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    assert t_parity.load_snapshots(str(tmp_path / "j.json")) == t
    assert j_parity.load_snapshots(str(tmp_path / "t.json")) == j


@pytest.fixture(scope="module")
def ckpt():
    return encode_tensors(synthetic.build_checkpoint(ARCH, seed=SEED))


def test_run_parity_case_over_real_backends(ckpt, tmp_path):
    """The port's gpu (CPU plain versions) and torch oracle services on one
    text at temperature 0: the oracle's snapshot equals the JAX oracle's
    (same sha256), the gpu engine's is within the 1e-3 RMS budget of it."""
    from go_pocket_tts_tpu.config import TTSConfig as JTTSConfig
    from go_pocket_tts_tpu.text.sentencepiece import load_tokenizer_from_bytes as j_tok
    from go_pocket_tts_tpu_torch import config as t_config
    from go_pocket_tts_tpu_torch.text.sentencepiece import load_tokenizer_from_bytes as t_tok

    tok = tokenizer_bytes()
    model = load_model_from_tensors(synthetic.build_checkpoint(ARCH, seed=SEED), num_heads=ARCH.num_heads, device="cpu")
    pcm = {}

    def keep(name, svc):
        inner = svc.synthesize_stream

        def stream(*a, **kw):
            chunks = list(inner(*a, **kw))
            pcm[name] = np.concatenate([c.samples for c in chunks])
            return iter(chunks)

        svc.synthesize_stream = stream
        return svc

    snaps = t_parity.run_parity_case(
        {
            "gpu": lambda: keep("gpu", Service(GPURuntime(model, seed=1, frame_bucket=64, device="cpu"), t_tok(tok),
                                               tts_config(t_config.TTSConfig))),
            "torch": lambda: keep("torch", Service(TorchRuntime(open_store_from_bytes(ckpt), num_heads=ARCH.num_heads,
                                                                seed=1, device="cpu"), t_tok(tok),
                                                   tts_config(t_config.TTSConfig))),
        },
        ONE_CHUNK,
    )
    want = j_parity.run_parity_case(
        {"torch": lambda: JService(JTorchRuntime(j_store(ckpt), num_heads=ARCH.num_heads, seed=1), j_tok(tok),
                                   tts_config(JTTSConfig))},
        ONE_CHUNK,
    )
    assert dataclasses.asdict(snaps["torch"]) == dataclasses.asdict(want["torch"])
    assert snaps["gpu"].num_samples == snaps["torch"].num_samples > 0
    assert t_parity.rms_delta(pcm["gpu"], pcm["torch"]) < 1e-3
    t_parity.save_snapshots(str(tmp_path / "s.json"), snaps)
    assert t_parity.load_snapshots(str(tmp_path / "s.json")) == snaps


# -- the fixture tier --------------------------------------------------------------


@pytest.fixture(scope="module")
def fixture_files(ckpt, tmp_path_factory):
    """A fixture from the JAX package's torch-oracle producer
    (``scripts/dump_parity.py``) on the tiny checkpoint, and the port's
    producer's on the same checkpoint."""
    root = tmp_path_factory.mktemp("parity_fx")
    model = root / "model.safetensors"
    model.write_bytes(ckpt)
    args = types.SimpleNamespace(model=str(model), num_heads=ARCH.num_heads, flow_tokens="1,2,3", mimi_frames="1,2")
    j_fx = _script("dump_parity").dump_from_torch_oracle(args)
    (root / "jax.json").write_text(json.dumps(j_fx))
    assert _script("torch_dump_parity").main(
        ["--model", str(model), "--num-heads", str(ARCH.num_heads), "--flow-tokens", "1,2,3", "--mimi-frames",
         "1,2", "--device", "cpu", "--output", str(root / "port.json")]
    ) == 0
    return str(model), str(root / "jax.json"), str(root / "port.json")


def _tensors(fx: dict):
    out = {}
    flow = fx["flow_lm_prefill_step"]
    for key, val in flow.items():
        out[f"flow/{key}"] = val
    for case in fx["mimi"]:
        for key, val in case.items():
            out[f"{case['name']}/{key}"] = val
    return out


def test_port_producer_writes_the_reference_fixture(fixture_files):
    _model, j_path, t_path = fixture_files
    j_fx, t_fx = json.load(open(j_path)), json.load(open(t_path))
    assert t_fx["source"]["producer"] == j_fx["source"]["producer"] == "torch-oracle"
    jt, tt = _tensors(j_fx), _tensors(t_fx)
    assert sorted(tt) == sorted(jt)
    for key, want in jt.items():
        got = tt[key]
        if isinstance(want, dict):
            assert got["shape"] == want["shape"], key
            np.testing.assert_allclose(got["data"], want["data"], atol=1e-6, rtol=0, err_msg=key)
        else:
            assert got == want, key


def test_verify_fixture_matches_the_reference(fixture_files):
    model_path, j_path, t_path = fixture_files
    data = open(model_path, "rb").read()
    jm = j_load_model(j_store(data), num_heads=ARCH.num_heads)
    tm = load_model_from_tensors(open_store_from_bytes(data), num_heads=ARCH.num_heads, device="cpu")
    j_reports = j_pf.verify_fixture(jm, j_pf.load_fixture(j_path))
    for path in (j_path, t_path):
        t_reports = t_pf.verify_fixture(tm, t_pf.load_fixture(path))
        assert [(r.name, r.shape_match, r.passed) for r in t_reports] == [
            (r.name, r.shape_match, r.passed) for r in j_reports
        ]
        assert len(t_reports) == 2 + 2 + 2 * 2 and all(r.passed for r in t_reports), t_reports
        for t, j in zip(t_reports, j_reports):
            assert abs(t.max_abs_err - j.max_abs_err) < 1e-5, (t, j)


def test_verify_fixture_detects_divergence(fixture_files, tmp_path):
    """A perturbed fixture fails in the port as in the reference."""
    model_path, j_path, _ = fixture_files
    raw = json.load(open(j_path))
    raw["flow_lm_prefill_step"]["step_last_hidden"]["data"] = [
        v + 0.05 for v in raw["flow_lm_prefill_step"]["step_last_hidden"]["data"]
    ]
    raw["flow_lm_prefill_step"]["step_layer_offsets"] = [99] * ARCH.num_layers
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(raw))
    tm = load_model_from_tensors(open_store_from_bytes(open(model_path, "rb").read()), num_heads=ARCH.num_heads,
                                 device="cpu")
    failing = {r.name for r in t_pf.verify_fixture(tm, t_pf.load_fixture(str(bad))) if not r.passed}
    assert failing == {"flow_lm_step_last_hidden", "flow_step_layer_offsets"}
