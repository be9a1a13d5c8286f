"""The port's continuous batcher over dp and dp×tp meshes against the JAX
package's over the same meshes (``tests/test_batching.py``'s mesh tests),
on ``tiny_arch()`` at temperature 0: dp=4, dp=2 with tp=2, and dp=2 with
int8 KV and int4 weights (float32; ``atol=1e-4, rtol=1e-3``, int8 KV
``5e-3, 1e-2``). Also a session and a streamed lane under a mesh, against
the unsharded batcher; ``Service.from_config`` with dp=2 and tp=2; and the
idle engine's wake-up, which admits a burst in its submitted order."""

import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.parallel import ContinuousBatcher as JBatcher
from go_pocket_tts_tpu.parallel import mesh as j_mesh
from go_pocket_tts_tpu.runtime import GenerateConfig as JConfig
from go_pocket_tts_tpu.utils.safetensors import encode_tensors, open_store_from_bytes
from go_pocket_tts_tpu_torch import config as t_config
from go_pocket_tts_tpu_torch.model_assets.quantize_export import build_quantized_checkpoint
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher, dp_mesh, dp_tp_mesh
from go_pocket_tts_tpu_torch.runtime import GenerateConfig
from go_pocket_tts_tpu_torch.tts.service import Service
from go_pocket_tts_tpu_torch.utils.safetensors import write_file
from torch_fixtures import tokenizer_bytes

ARCH = synthetic.tiny_arch()
SEED = 55
TOKENS = ([5, 9, 2], [7, 1, 4, 8], [11, 3], [2, 6, 9, 12, 4])
# (JAX mesh, port mesh, int4 artifact, batcher knobs, slots, (atol, rtol))
MESHES = {
    "dp4": (lambda: j_mesh.dp_mesh(4), lambda: dp_mesh(4, device="cpu"), False, {}, 4, (1e-4, 1e-3)),
    "dp2_tp2": (lambda: j_mesh.dp_tp_mesh(2, 2), lambda: dp_tp_mesh(2, 2, device="cpu"), False, {}, 4, (1e-4, 1e-3)),
    "dp2_kv8_int4": (
        lambda: j_mesh.dp_mesh(2),
        lambda: dp_mesh(2, device="cpu"),
        True,
        {"kv_quantize": True},
        2,
        (5e-3, 1e-2),
    ),
}


def _both(tensors):
    jm = load_model_from_store(open_store_from_bytes(encode_tensors(tensors)), num_heads=ARCH.num_heads)
    return jm, load_model_from_tensors(tensors, num_heads=ARCH.num_heads, device="cpu")


@pytest.fixture(scope="module")
def models():
    return _both(synthetic.build_checkpoint(ARCH, seed=SEED))


@pytest.fixture(scope="module")
def int4_models():
    """Both packages' models from one int4 artifact (the port's exporter,
    byte-equal to the reference's): neither quantizes at load."""
    tensors, _meta, _names = build_quantized_checkpoint(synthetic.build_checkpoint(ARCH, seed=SEED), 4, ARCH.num_heads)
    return _both(tensors)


def _cfg(mod_cfg, **kw):
    return mod_cfg(**{"temperature": 0.0, "eos_threshold": 1e9, "max_steps": 4, **kw})


def _serve(batcher, cfg, tokens):
    batcher.start()
    try:
        futs = [batcher.submit(t, cfg) for t in tokens]
        return [f.result(timeout=300) for f in futs]
    finally:
        batcher.stop()


@pytest.mark.parametrize("name", list(MESHES))
def test_batcher_over_a_mesh_matches_the_reference(request, name):
    j_make, t_make, int4, knobs, slots, (atol, rtol) = MESHES[name]
    jm, tm = request.getfixturevalue("int4_models" if int4 else "models")
    need = 4 if slots == 4 else 2
    if len(jax.devices()) < need:
        pytest.skip(f"needs {need} virtual CPU devices (tests/conftest.py makes 8)")
    tokens = TOKENS[:slots]
    common = dict(slots=slots, prompt_capacity=64, max_frames=64, seed=3, **knobs)
    want = _serve(JBatcher(jm, mesh=j_make(), **common), _cfg(JConfig), tokens)
    batcher = ContinuousBatcher(tm, mesh=t_make(), device="cpu", **common)
    assert dict(batcher.mesh.shape) == dict(j_make().shape)
    got = _serve(batcher, _cfg(GenerateConfig), tokens)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def unsharded(models):
    """The unsharded port batcher's plain, streamed and session outputs, by
    KV-cache kind (made once each)."""
    _, tm = models
    made = {}

    def outputs(kv_quantize):
        if kv_quantize not in made:
            made[kv_quantize] = _session_and_stream(
                ContinuousBatcher(tm, slots=4, prompt_capacity=64, max_frames=64, seed=3, device="cpu", kv_quantize=kv_quantize)
            )
        return made[kv_quantize]

    return outputs


def _session_and_stream(batcher):
    cfg = _cfg(GenerateConfig, max_steps=6)
    batcher.start()
    try:
        plain = batcher.submit(TOKENS[1], cfg)
        blocks = list(batcher.submit_stream(TOKENS[0], cfg, timeout=120))
        first, cont = batcher.generate_session(TOKENS[2], cfg, None, timeout=120)
        stream, next_state = batcher.stream_session(TOKENS[3], cfg, cont, timeout=120)
        second = np.concatenate(list(stream))
        third, _ = batcher.generate_session(TOKENS[0], cfg, next_state(), timeout=120)
        return [plain.result(timeout=120), np.concatenate(blocks), first, second, third]
    finally:
        batcher.stop()


@pytest.mark.parametrize("kv_quantize", [False, True])
def test_session_and_stream_over_a_dp_tp_mesh(models, unsharded, kv_quantize):
    """A streamed lane and a three-chunk session (plain, streamed, plain)
    over dp=2 × tp=2: each snapshot gathers the heads onto the replica's
    rank 0 and resumes on whichever replica admits the next chunk."""
    _, tm = models
    batcher = ContinuousBatcher(
        tm, slots=4, prompt_capacity=64, max_frames=64, seed=3, device="cpu",
        mesh=dp_tp_mesh(2, 2, device="cpu"), kv_quantize=kv_quantize,
    )
    got = _session_and_stream(batcher)
    atol, rtol = (5e-3, 1e-2) if kv_quantize else (1e-4, 1e-3)
    for g, w in zip(got, unsharded(kv_quantize)):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol)


def test_service_from_config_builds_the_mesh(tmp_path):
    """``--runtime-dp 2 --runtime-tp 2`` reaches the batcher as a (dp, tp)
    mesh (the reference's ``test_service_runtime_tp_config_builds_mesh``)."""
    write_file(tmp_path / "model.safetensors", synthetic.build_checkpoint(ARCH, seed=SEED))
    (tmp_path / "tokenizer.model").write_bytes(tokenizer_bytes())
    cfg = t_config.Config()
    cfg.paths.model_path = str(tmp_path / "model.safetensors")
    cfg.paths.tokenizer_model = str(tmp_path / "tokenizer.model")
    cfg.runtime.device = "cpu"
    cfg.runtime.batch_slots = cfg.runtime.dp_devices = cfg.runtime.tp_devices = 2
    cfg.runtime.seed = 3
    cfg.tts.temperature, cfg.tts.eos_threshold, cfg.tts.max_steps = 0.0, 1e9, 4
    svc = Service.from_config(cfg)
    try:
        mesh = svc.runtime.batcher.mesh
        assert mesh is not None and dict(mesh.shape) == {"dp": 2, "tp": 2}
        assert len(svc.runtime.batcher._replicas) == 2
        pcm = svc.synthesize("hello world")
    finally:
        svc.close()
    assert pcm.shape == (4 * 1920,) and np.isfinite(pcm).all()


@pytest.mark.parametrize("mesh", [None, "dp2"])
def test_a_burst_is_admitted_in_its_order(models, mesh):
    """An idle engine woken by a burst admits its first request in the first
    wave (the reference takes the waking request off the queue and puts it
    back behind the rest). The submitting thread keeps the interpreter
    until the whole burst is queued."""
    _, tm = models
    kw = {"mesh": dp_mesh(2, device="cpu")} if mesh else {}
    batcher = ContinuousBatcher(tm, slots=2, prompt_capacity=64, max_frames=64, seed=3, device="cpu", **kw)
    order, lock = [], threading.Lock()
    for engine in batcher._engines():
        attach = engine._attach_request

        def record(slot, req, attach=attach):
            with lock:
                order.append(req)
            attach(slot, req)

        engine._attach_request = record
    cfg = _cfg(GenerateConfig)
    batcher.start()
    interval = sys.getswitchinterval()
    try:
        time.sleep(0.2)  # the engines are idle, waiting
        sys.setswitchinterval(1.0)
        futs = [batcher.submit(TOKENS[i % 4], cfg) for i in range(4)]
        first = futs[0]
        first.result(timeout=120)
        sys.setswitchinterval(interval)
        for f in futs:
            f.result(timeout=120)
    finally:
        sys.setswitchinterval(interval)
        batcher.stop()
    assert len(order) == 4
    assert first in [req.future for req in order[:2]]
