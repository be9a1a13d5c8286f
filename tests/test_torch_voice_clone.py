"""Voice cloning in the port against the JAX package, on the CPU at
``tiny_arch()``: the synthetic checkpoint's encoder tensors, the Mimi
encoder (at the embedding and the latent, on the dense and the blocked
attention route), ``VoiceEncoder.encode_samples`` (24 and 16 kHz, padded
and not), its limits, both export formats, ``VoiceUploader``, ``POST
/voices`` on both servers with a voiced ``POST /tts`` after it, and the
CLI's ``export-voice``. Tolerances: ``ops.TOLERANCES["conv1d"]`` for
encodes and exports, 1e-3 RMS for PCM."""

import base64
import http.client
import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from go_pocket_tts_tpu.cli.main import main as j_main
from go_pocket_tts_tpu.config import TTSConfig as JTTSConfig
from go_pocket_tts_tpu.models import mimi_encoder as j_enc
from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.runtime import TPURuntime
from go_pocket_tts_tpu.server import Server as JServer
from go_pocket_tts_tpu.tts import voice_export as j_export
from go_pocket_tts_tpu.tts import voice_upload as j_upload
from go_pocket_tts_tpu.tts.parity import rms_delta
from go_pocket_tts_tpu.tts.service import Service as JService
from go_pocket_tts_tpu.tts.voices import VoiceManager as JVoiceManager
from go_pocket_tts_tpu.utils.safetensors import open_store_from_bytes
from go_pocket_tts_tpu_torch.cli.main import main
from go_pocket_tts_tpu_torch.config import TTSConfig
from go_pocket_tts_tpu_torch.convert import params_from_jax
from go_pocket_tts_tpu_torch.models import mimi_encoder as t_enc
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.mimi import load_mimi
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.models.params import VarBuilder, tree_map
from go_pocket_tts_tpu_torch.ops import TOLERANCES
from go_pocket_tts_tpu_torch.runtime import GPURuntime
from go_pocket_tts_tpu_torch.server import Server
from go_pocket_tts_tpu_torch.tts import voice_export as t_export
from go_pocket_tts_tpu_torch.tts import voice_upload as t_upload
from go_pocket_tts_tpu_torch.tts.service import Service
from go_pocket_tts_tpu_torch.tts.voices import VoiceManager
from go_pocket_tts_tpu_torch.utils import wav
from go_pocket_tts_tpu_torch.utils.safetensors import (
    VoiceFileKind,
    inspect_voice_file,
    load_file,
    load_voice_embedding,
    load_voice_model_state,
    write_file,
)

ROOT = Path(__file__).resolve().parent.parent
ARCH = synthetic.tiny_arch()
SEED = 44
ATOL, RTOL = TOLERANCES["conv1d"]
RMS_BUDGET = 1e-3  # PCM parity (BASELINE.md)
SPF = 1920  # samples per latent frame at 24 kHz
NO_ENCODER = ("mimi.encoder", "mimi.downsample", "condition_provider")


def close(got, want, atol=ATOL, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def clip(seconds: float, rate: int = 24000, seed: int = 0) -> np.ndarray:
    return (np.random.RandomState(seed).randn(int(seconds * rate)) * 0.1).astype(np.float32)


def wav_bytes(seconds: float, rate: int = 24000, seed: int = 0) -> bytes:
    return wav.encode_wav(clip(seconds, rate, seed), rate)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The seeded checkpoint: its tensors, file and the JAX store over it."""
    tensors = synthetic.build_checkpoint(ARCH, seed=SEED)
    path = tmp_path_factory.mktemp("ckpt") / "model.safetensors"
    write_file(path, tensors)
    return tensors, str(path), open_store_from_bytes(path.read_bytes())


@pytest.fixture(scope="module")
def encoders(ckpt):
    tensors, _, store = ckpt
    return j_export.VoiceEncoder(store), t_export.VoiceEncoder(tensors, device="cpu")


# -- the synthetic checkpoint ---------------------------------------------------


@pytest.mark.parametrize("arch", [ARCH, synthetic.SynthArch(**{**ARCH.__dict__, "seanet_channels": (32, 256, 128, 64)})],
                         ids=["tiny", "tiny_wide_seanet"])
def test_synthetic_checkpoint_is_the_references_bit_for_bit(arch):
    mine, ref = synthetic.build_checkpoint(arch, seed=3), j_syn.build_checkpoint(arch, seed=3)
    assert list(mine) == list(ref)
    assert "condition_provider.conditioners.speaker_wavs.output_proj.weight" in mine
    for name, arr in mine.items():
        assert arr.dtype == ref[name].dtype, name
        np.testing.assert_array_equal(arr, ref[name], err_msg=name)
    assert synthetic.build_checkpoint_bytes(arch, seed=3) == j_syn.build_checkpoint_bytes(arch, seed=3)


# -- the encoder ------------------------------------------------------------------


def test_params_from_jax_carries_the_encoder_tree(encoders):
    j, t = encoders
    converted, loaded = {}, {}
    tree_map(lambda path, leaf: converted.__setitem__(".".join(path), leaf),
             params_from_jax(jax.tree_util.tree_map(np.asarray, j.encoder), device="cpu"))
    tree_map(lambda path, leaf: loaded.__setitem__(".".join(path), leaf), t.encoder)
    assert converted.keys() == loaded.keys()
    for name, leaf in loaded.items():
        assert converted[name].dtype == leaf.dtype == torch.float32, name
        if "rope" in name:  # built by each framework's own trig
            torch.testing.assert_close(converted[name], leaf, atol=1e-6, rtol=1e-6)
        else:
            assert torch.equal(converted[name], leaf), name


# 1024 steps at 200 Hz (the 64-frame bucket) take the blocked local
# attention; 200 steps (1 s) the dense route. The JAX encoder is dense.
@pytest.mark.parametrize("samples", [64 * SPF, 24000], ids=["steps1024_blocked", "steps200_dense"])
@pytest.mark.parametrize("to_latent", [False, True], ids=["embedding", "latent"])
def test_mimi_encode_matches_reference(encoders, samples, to_latent):
    j, t = encoders
    pcm = clip(samples / 24000, seed=1)[None, None, :]
    want = np.asarray(j_enc.mimi_encode(j.encoder, j.cfg, jnp.asarray(pcm), to_latent=to_latent))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, j.encoder), device="cpu")
    with torch.inference_mode():
        got = t_enc.mimi_encode(params, t.cfg, torch.from_numpy(pcm), to_latent=to_latent)
    dim = ARCH.latent_dim if to_latent else ARCH.mimi_dim
    assert got.shape == (1, dim, samples // SPF)
    close(got, want)


def test_encoder_absent_gives_none(ckpt):
    tensors = {k: v for k, v in ckpt[0].items() if not k.startswith(NO_ENCODER)}
    vb = VarBuilder(tensors)
    _, cfg = load_mimi(vb)
    assert t_enc.load_mimi_encoder(vb, cfg) is None
    assert t_enc.load_speaker_projection(vb) is None
    with pytest.raises(ValueError, match="no Mimi encoder"):
        t_export.VoiceEncoder(tensors, device="cpu")


@pytest.mark.parametrize("rate", [24000, 16000])
@pytest.mark.parametrize("pad", [False, True], ids=["unpadded", "padded"])
def test_encode_samples_matches_reference(encoders, rate, pad):
    j, t = encoders
    samples = clip(1.0, rate, seed=2)
    want = j.encode_samples(samples, rate, pad_to_bucket=pad)
    got = t.encode_samples(samples, rate, pad_to_bucket=pad)
    assert got.dtype == np.float32 and got.shape == (1, 12, ARCH.d_model)
    close(got, want)


def test_padded_encode_keeps_the_unpadded_frames(encoders):
    _, t = encoders
    samples = clip(1.0, seed=3)
    padded, unpadded = (t.encode_samples(samples, 24000, pad_to_bucket=p) for p in (True, False))
    np.testing.assert_allclose(padded, unpadded, atol=1e-5, rtol=0)


def test_a_clip_a_bucket_long_with_a_remainder_encodes(encoders):
    """64 frames and 100 samples pad to the 64-frame bucket: the samples
    past the last whole frame reach no kept frame, so they are dropped. The
    reference copies them into the padded buffer, which is too short, and
    raises; the port returns the unpadded encode's frames."""
    j, t = encoders
    samples = clip((64 * SPF + 100) / 24000, seed=4)
    with pytest.raises(ValueError, match="broadcast"):
        j.encode_samples(samples, 24000, pad_to_bucket=True)
    got = t.encode_samples(samples, 24000, pad_to_bucket=True)
    assert got.shape == (1, 64, ARCH.d_model)
    np.testing.assert_allclose(got, t.encode_samples(samples, 24000), atol=1e-5, rtol=0)


@pytest.mark.parametrize("pad", [False, True], ids=["unpadded", "padded"])
def test_sub_frame_audio_raises(encoders, pad):
    j, t = encoders
    samples = np.zeros(SPF - 1, np.float32)
    with pytest.raises(ValueError, match="shorter than one latent frame"):
        t.encode_samples(samples, 24000, pad_to_bucket=pad)
    if pad:
        with pytest.raises(ValueError, match="shorter than one latent frame"):
            j.encode_samples(samples, 24000, pad_to_bucket=True)


@pytest.mark.parametrize("pad", [False, True], ids=["unpadded", "padded"])
def test_audio_past_512_frames_raises_before_the_encode(encoders, monkeypatch, pad):
    """513 frames (41.04 s) need 8208 RoPE positions of the 8192 the
    encoder has: refused with the limit named, before any encode."""
    _, t = encoders
    assert t.max_frames == 512 and t.encoder["transformer"]["rope_cos"].shape[0] == t_enc.ROPE_ROWS == 8192

    def no_encode(*a, **k):
        raise AssertionError("encoded past the limit")

    monkeypatch.setattr(t_enc, "mimi_encode", no_encode)
    with pytest.raises(ValueError, match=r"limit of 512 frames \(40\.96 s\)"):
        t.encode_samples(np.zeros(513 * SPF, np.float32), 24000, pad_to_bucket=pad)


def test_mimi_encode_refuses_more_steps_than_its_table(encoders):
    _, t = encoders
    with pytest.raises(ValueError, match="position table covers 8192"):
        t_enc.mimi_encode(t.encoder, t.cfg, torch.zeros(1, 1, 8193 * 120))


def test_voice_encoder_on_the_default_device_raises_without_cuda(ckpt, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_export.VoiceEncoder(ckpt[0])


# -- export ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def speaker_wav(tmp_path_factory):
    path = tmp_path_factory.mktemp("speaker") / "speaker.wav"
    path.write_bytes(wav_bytes(1.0, seed=5))
    return str(path)


def test_export_embedding_matches_reference(ckpt, speaker_wav, tmp_path):
    _, model_path, _ = ckpt
    want = j_export.export_voice_embedding(model_path, speaker_wav, str(tmp_path / "j.safetensors"))
    got = t_export.export_voice_embedding(model_path, speaker_wav, str(tmp_path / "t.safetensors"), device="cpu")
    close(got, want)
    assert inspect_voice_file(tmp_path / "t.safetensors") == VoiceFileKind.EMBEDDING
    assert list(load_file(tmp_path / "t.safetensors")) == list(load_file(tmp_path / "j.safetensors")) == ["audio_prompt"]
    close(load_voice_embedding(tmp_path / "t.safetensors"), want)


def test_export_model_state_matches_reference(ckpt, speaker_wav, tmp_path):
    _, model_path, _ = ckpt
    j_path, t_path = str(tmp_path / "j.safetensors"), str(tmp_path / "t.safetensors")
    want = j_export.export_voice_model_state(model_path, speaker_wav, j_path, num_heads=ARCH.num_heads)
    got = t_export.export_voice_model_state(model_path, speaker_wav, t_path, num_heads=ARCH.num_heads, device="cpu")
    assert got == want == 12
    assert inspect_voice_file(t_path) == VoiceFileKind.MODEL_STATE
    j_tensors, t_tensors = load_file(j_path), load_file(t_path)
    assert list(t_tensors) == list(j_tensors)
    head_dim = ARCH.d_model // ARCH.num_heads
    for name, arr in t_tensors.items():
        if name.endswith("/cache"):
            # Time-major [2, B, T, H, Dh]: a transposition keeps the shape
            # only where it is wrong in values, which the comparison sees.
            assert arr.shape == (2, 1, 12, ARCH.num_heads, head_dim), name
        close(arr, j_tensors[name])
    state = load_voice_model_state(t_path)
    assert {float(m["offset"][0]) for m in state.modules.values()} == {12.0}


def test_model_state_voice_conditions_as_the_embedding_does(ckpt, speaker_wav, tmp_path):
    """The exported model state is the prefill of the exported embedding:
    synthesis conditioned on either gives the same audio."""
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig

    tensors, model_path, _ = ckpt
    emb = t_export.export_voice_embedding(model_path, speaker_wav, str(tmp_path / "e.safetensors"), device="cpu")
    t_export.export_voice_model_state(model_path, speaker_wav, str(tmp_path / "s.safetensors"),
                                      num_heads=ARCH.num_heads, device="cpu")
    rt = GPURuntime(load_model_from_tensors(tensors, num_heads=ARCH.num_heads, device="cpu"), seed=1,
                    frame_bucket=64, device="cpu")
    cfg = dict(temperature=0.0, eos_threshold=1e9, max_steps=4)
    by_emb = rt.generate_audio([3, 17, 41], GenerateConfig(voice_embedding=emb, **cfg))
    by_state = rt.generate_audio(
        [3, 17, 41], GenerateConfig(voice_model_state=load_voice_model_state(tmp_path / "s.safetensors"), **cfg)
    )
    assert rms_delta(by_state, by_emb) < RMS_BUDGET
    assert rms_delta(by_emb, rt.generate_audio([3, 17, 41], GenerateConfig(**cfg))) > 1e-4


# -- VoiceUploader ----------------------------------------------------------------------


def _uploaders(model_path, tmp_path, **kw):
    """The JAX uploader and the port's over in-memory voice managers of
    their own directories."""
    j = j_upload.VoiceUploader(model_path, str(tmp_path / "j"), JVoiceManager.in_memory(str(tmp_path)), **kw)
    t = t_upload.VoiceUploader(model_path, str(tmp_path / "t"), VoiceManager.in_memory(str(tmp_path)), device="cpu",
                               **kw)
    return j, t


def _record(rec):
    return {k: v for k, v in rec.items() if k != "path"}


def test_uploader_flow_matches_reference(ckpt, tmp_path):
    j, t = _uploaders(ckpt[1], tmp_path)
    data = wav_bytes(0.5, seed=6)
    want, got = j.upload("narrator", data, license="test"), t.upload("narrator", data, license="test")
    assert _record(got) == _record(want) == {"id": "narrator", "license": "test", "frames": 6, "prewarmed": False}
    assert os.path.isabs(got["path"]) and t.voices.resolve_path("narrator") == got["path"]
    close(load_voice_embedding(got["path"]), load_voice_embedding(want["path"]))


def test_uploader_duplicate_matches_reference(ckpt, tmp_path):
    j, t = _uploaders(ckpt[1], tmp_path)
    data = wav_bytes(0.2, seed=7)
    for up, dup in ((j, j_upload.DuplicateVoice), (t, t_upload.DuplicateVoice)):
        up.upload("v", data)
        with pytest.raises(dup, match="duplicate voice id 'v'"):
            up.upload("v", data)


def test_uploader_rejects_bad_input_as_the_reference(ckpt, tmp_path):
    j, t = _uploaders(ckpt[1], tmp_path, max_audio_bytes=10_000)
    for up in (j, t):
        for bad_id in ("", "../evil", "a/b", "x" * 65, ".hidden"):
            with pytest.raises(ValueError, match="voice id"):
                up.upload(bad_id, wav_bytes(0.1))
        with pytest.raises(ValueError, match="maximum size of 10000 bytes"):
            up.upload("big", wav_bytes(1.0))
        with pytest.raises(ValueError):
            up.upload("garbage", b"not a wav file at all")
        assert up.voices.list_voices() == []


def test_uploader_without_encoder_weights_is_a_server_error(ckpt, tmp_path):
    tensors = {k: v for k, v in ckpt[0].items() if not k.startswith(NO_ENCODER)}
    path = tmp_path / "novc.safetensors"
    write_file(path, tensors)
    j, t = _uploaders(str(path), tmp_path)
    for up in (j, t):
        with pytest.raises(RuntimeError, match="no Mimi encoder"):
            up.upload("v", wav_bytes(0.2))


def test_upload_resolves_with_a_manifest_elsewhere(ckpt, tmp_path, monkeypatch):
    """A relative upload directory and a manifest in another directory: the
    uploader registers the absolute path, so the voice resolves."""
    home = tmp_path / "manifest_home"
    home.mkdir()
    (home / "manifest.json").write_text(json.dumps({"voices": []}))
    mgr = VoiceManager(str(home / "manifest.json"))
    (tmp_path / "cwd").mkdir()
    monkeypatch.chdir(tmp_path / "cwd")
    t_upload.VoiceUploader(ckpt[1], "uploads", mgr, device="cpu").upload("rel", wav_bytes(0.2))
    assert os.path.exists(mgr.resolve_path("rel"))


def test_uploader_prewarms_through_the_service(ckpt, tmp_path):
    warmed = []

    class _Service:
        def prewarm_voice(self, path):
            warmed.append(path)
            return True

    up = t_upload.VoiceUploader(ckpt[1], str(tmp_path), VoiceManager.in_memory(), service=_Service(), device="cpu")
    rec = up.upload("warm", wav_bytes(0.2))
    assert rec["prewarmed"] is True and warmed == [rec["path"]]


# -- POST /voices -------------------------------------------------------------------------


class _WordTokenizer:
    def encode(self, s):
        return [sum(map(ord, w)) % ARCH.n_bins for w in s.split()]


MAX_AUDIO = 4 << 20  # room for a 41 s clip's WAV


@pytest.fixture(scope="module")
def upload_servers(ckpt, tmp_path_factory):
    """The JAX server and the port's, each over its own Service (single
    runtime, float32, temperature 0) and uploader."""
    tensors, model_path, store = ckpt
    tmp = tmp_path_factory.mktemp("upload")
    tts = dict(temperature=0.0, eos_threshold=1e9, max_steps=4)
    jm = load_model_from_store(store, num_heads=ARCH.num_heads)
    tm = load_model_from_tensors(tensors, num_heads=ARCH.num_heads, device="cpu")
    j_svc = JService(TPURuntime(jm, seed=11, frame_bucket=64), _WordTokenizer(), JTTSConfig(**tts))
    t_svc = Service(GPURuntime(tm, seed=11, frame_bucket=64, device="cpu"), _WordTokenizer(), TTSConfig(**tts))
    j_mgr, t_mgr = JVoiceManager.in_memory(str(tmp)), VoiceManager.in_memory(str(tmp))
    j_up = j_upload.VoiceUploader(model_path, str(tmp / "j"), j_mgr, service=j_svc, max_audio_bytes=MAX_AUDIO, prewarm=False)
    t_up = t_upload.VoiceUploader(model_path, str(tmp / "t"), t_mgr, service=t_svc, max_audio_bytes=MAX_AUDIO,
                                  prewarm=False, device="cpu")
    pair = [
        JServer(j_svc, j_mgr, listen_addr="127.0.0.1:0", request_timeout=120, voice_uploader=j_up),
        Server(t_svc, t_mgr, listen_addr="127.0.0.1:0", request_timeout=120, voice_uploader=t_up),
    ]
    for srv in pair:
        srv.start()
    yield pair
    for srv in pair:
        srv.shutdown()


def _request(port, method, path, body=None, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _both(pair, *args, **kw):
    return [_request(srv.port, *args, **kw) for srv in pair]


def test_post_voices_round_trip_then_voiced_tts_matches(upload_servers):
    audio = base64.b64encode(wav_bytes(0.5, seed=8)).decode()
    (j_status, j_body), (t_status, t_body) = _both(upload_servers, "POST", "/voices", {"id": "cloned", "audio": audio})
    assert t_status == j_status == 200
    assert _record(json.loads(t_body)["voice"]) == _record(json.loads(j_body)["voice"])
    (_, j_list), (_, t_list) = _both(upload_servers, "GET", "/voices")
    assert [v["id"] for v in json.loads(t_list)["voices"]] == [v["id"] for v in json.loads(j_list)["voices"]] == ["cloned"]
    (j_status, j_pcm), (t_status, t_pcm) = _both(upload_servers, "POST", "/tts", {"text": "hello there", "voice": "cloned"})
    assert t_status == j_status == 200
    got, want = wav.decode_wav(t_pcm)[0], wav.decode_wav(j_pcm)[0]
    assert got.shape == want.shape == (4 * SPF,)
    assert rms_delta(got, want) < RMS_BUDGET
    (_, plain), = _both(upload_servers[1:], "POST", "/tts", {"text": "hello there"})
    assert rms_delta(got, wav.decode_wav(plain)[0]) > 1e-4
    (j_status, j_body), (t_status, t_body) = _both(upload_servers, "POST", "/voices", {"id": "cloned", "audio": audio})
    assert t_status == j_status == 409 and json.loads(t_body) == json.loads(j_body)
    (_, j_stats), (_, t_stats) = _both(upload_servers, "GET", "/stats")
    assert json.loads(t_stats)["voices_uploaded_total"] == json.loads(j_stats)["voices_uploaded_total"] == 1


ERRORS = {
    "bad_base64_400": ({"id": "v1", "audio": "!!notb64!!"}, 400),
    "no_audio_400": ({"id": "v1"}, 400),
    "bad_id_400": ({"id": "../evil", "audio": base64.b64encode(b"RIFF").decode()}, 400),
    "audio_not_string_400": ({"id": "v1", "audio": 7}, 400),
    "not_a_wav_400": ({"id": "v1", "audio": base64.b64encode(b"not a wav").decode()}, 400),
    "invalid_json_400": (b"{nope", 400),
    "non_object_400": ([1, 2], 400),
    "empty_body_400": (b"", 400),
    "content_length_413": ({"id": "v1", "audio": "A" * (MAX_AUDIO * 4 // 3 + 8192)}, 413),
    "decoded_size_413": ({"id": "v1", "audio": base64.b64encode(b"\0" * (MAX_AUDIO + 3000)).decode()}, 413),
}


@pytest.mark.parametrize("case", list(ERRORS))
def test_post_voices_errors_match_reference(upload_servers, case):
    body, status = ERRORS[case]
    (j_status, j_body), (t_status, t_body) = _both(upload_servers, "POST", "/voices", body)
    assert t_status == j_status == status
    assert json.loads(t_body) == json.loads(j_body)


def test_post_voices_past_the_encoder_limit_is_400(upload_servers):
    """41.04 s: the port refuses it before the encode, naming the limit
    (the reference fails in the encode, HTTP 500; not run here)."""
    audio = base64.b64encode(wav.encode_wav(np.zeros(513 * SPF, np.float32))).decode()
    status, body = _request(upload_servers[1].port, "POST", "/voices", {"id": "too-long", "audio": audio})
    assert status == 400 and "limit of 512 frames (40.96 s)" in json.loads(body)["error"]


# -- the CLI ---------------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["embedding", "model-state"])
def test_cli_export_voice_matches_the_jax_cli(ckpt, speaker_wav, tmp_path, monkeypatch, capsys, fmt):
    monkeypatch.setenv("POCKETTTS_PATHS_MODEL_PATH", ckpt[1])
    monkeypatch.chdir(tmp_path)
    args = ["export-voice", "--audio", speaker_wav, "--format", fmt, "--voice-id", "spk"]
    assert j_main(args + ["--out", "j.safetensors"]) == 0
    want = capsys.readouterr().out.splitlines()
    monkeypatch.setenv("POCKETTTS_PLATFORM", "cpu")
    assert main(args + ["--out", "t.safetensors"]) == 0
    got = capsys.readouterr().out.splitlines()
    assert [line.replace("t.safetensors", "X") for line in got] == [line.replace("j.safetensors", "X") for line in want]
    assert json.loads(got[0])["frames"] == 12
    j_tensors, t_tensors = load_file("j.safetensors"), load_file("t.safetensors")
    assert list(t_tensors) == list(j_tensors)
    for name, arr in t_tensors.items():
        close(arr, j_tensors[name])


def test_cli_export_voice_without_cuda_fails(ckpt, speaker_wav, tmp_path, monkeypatch):
    monkeypatch.setenv("POCKETTTS_PATHS_MODEL_PATH", ckpt[1])
    monkeypatch.delenv("POCKETTTS_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "never.safetensors"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["export-voice", "--input", speaker_wav, "--output", str(out)])
    assert not out.exists()


def test_serve_with_voice_upload_dir_clones_and_serves(ckpt, tmp_path):
    """``serve --voice-upload-dir`` on the CPU: POST /voices answers 200,
    GET /voices lists the voice, POST /tts serves it; SIGTERM ends it."""
    from torch_fixtures import tokenizer_bytes

    (tmp_path / "tokenizer.model").write_bytes(tokenizer_bytes())
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = {
        **os.environ,
        "PYTHONPATH": str(ROOT),
        "POCKETTTS_PLATFORM": "cpu",
        "POCKETTTS_PATHS_MODEL_PATH": ckpt[1],
        "POCKETTTS_PATHS_TOKENIZER_MODEL": str(tmp_path / "tokenizer.model"),
        "POCKETTTS_MAX_STEPS": "3",
        "POCKETTTS_EOS_THRESHOLD": "1000000",
    }
    proc = subprocess.Popen(
        [sys.executable, "-m", "go_pocket_tts_tpu_torch", "serve", "--server-listen-addr", f"127.0.0.1:{port}",
         "--voice-upload-dir", str(tmp_path / "voices")],
        cwd=tmp_path, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
    )
    base = f"http://127.0.0.1:{port}"
    try:
        deadline = time.monotonic() + 90
        while True:
            try:
                urllib.request.urlopen(f"{base}/health", timeout=2).close()
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()
                assert time.monotonic() < deadline, "server did not come up"
                time.sleep(0.2)
        audio = base64.b64encode(wav_bytes(0.3, seed=9)).decode()
        status, body = _request(port, "POST", "/voices", {"id": "cli-voice", "audio": audio})
        assert status == 200 and json.loads(body)["voice"]["prewarmed"] is False
        assert (tmp_path / "voices" / "cli-voice.safetensors").exists()
        status, body = _request(port, "GET", "/voices")
        assert [v["id"] for v in json.loads(body)["voices"]] == ["cli-voice"]
        status, body = _request(port, "POST", "/tts", {"text": "hello", "voice": "cli-voice"})
        assert status == 200 and wav.decode_wav(body)[0].shape == (3 * SPF,)
    finally:
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=30)
    assert rc == 0
