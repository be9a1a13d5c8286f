"""Fixtures shared by the port's Service, batcher-session and server tests
(a helper module, not a test file): the synthetic tokenizer and texts, the
Service's config at temperature 0, voice files of both kinds, and the JAX
and port models and batcher services on one seeded ``tiny_arch()``
checkpoint."""

import contextlib

import numpy as np

from go_pocket_tts_tpu.config import TTSConfig as JTTSConfig
from go_pocket_tts_tpu.models import synthetic as j_syn
from go_pocket_tts_tpu.models.model import load_model_from_store
from go_pocket_tts_tpu.parallel import BatcherRuntime as JBatcherRuntime
from go_pocket_tts_tpu.text.sentencepiece import SentencePieceModel, load_tokenizer_from_bytes as j_tokenizer
from go_pocket_tts_tpu.tts.service import Service as JService
from go_pocket_tts_tpu.utils.safetensors import encode_tensors, open_store_from_bytes, write_file
from go_pocket_tts_tpu_torch import config as t_config
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
from go_pocket_tts_tpu_torch.parallel import BatcherRuntime
from go_pocket_tts_tpu_torch.text.sentencepiece import load_tokenizer_from_bytes as t_tokenizer
from go_pocket_tts_tpu_torch.tts.service import Service

ARCH = synthetic.tiny_arch()
STEPS = 6  # frames per chunk: one 4-frame stream block, then 2
ONE_CHUNK = "Hello world, the quick fox."
THREE_CHUNKS = (
    "The quick brown fox jumps over the sleepy dog. Hello world, the brown fox sings a song. "
    "The quick fox walks home to the brown den."
)


def tokenizer_bytes() -> bytes:
    """The verify skill's synthetic tokenizer (35 pieces, below n_bins)."""
    m = SentencePieceModel()
    pieces = [("<unk>", 0.0, 2)] + [(w, -1.0, 1) for w in "▁hello ▁world ▁the ▁quick ▁brown ▁fox .".split()]
    for p, s, t in pieces + [(c, -6.0, 1) for c in "abcdefghijklmnopqrstuvwxyz▁"]:
        m.pieces.append(p)
        m.scores.append(s)
        m.types.append(t)
    return m.serialize()


def tts_config(mod_cfg, **kw):
    """Either package's ``TTSConfig`` at temperature 0, EOS off, ``STEPS``
    frames a chunk, updated by ``kw``."""
    base = dict(temperature=0.0, eos_threshold=1e9, max_steps=STEPS)
    base.update(kw)
    return mod_cfg(**base)


def run_stream(svc, text, **kw):
    """A service's ``synthesize_stream``: its chunk layout and its PCM."""
    chunks = list(svc.synthesize_stream(text, **kw))
    layout = [(c.chunk_index, c.final, len(c.samples)) for c in chunks]
    return layout, np.concatenate([c.samples for c in chunks])


def voice_files(tmp_path):
    """An embedding voice and a model-state voice for ``ARCH``, written
    under ``tmp_path``."""
    rng = np.random.RandomState(4)
    head_dim = ARCH.d_model // ARCH.num_heads
    emb = tmp_path / "emb.safetensors"
    write_file(emb, {"audio_prompt": (rng.randn(5, ARCH.d_model) * 0.1).astype(np.float32)})
    state = tmp_path / "state.safetensors"
    tensors = {}
    for i in range(ARCH.num_layers):
        tensors[f"transformer.layers.{i}.self_attn/cache"] = (
            rng.randn(2, 1, 6, ARCH.num_heads, head_dim) * 0.2
        ).astype(np.float32)
        tensors[f"transformer.layers.{i}.self_attn/offset"] = np.array([6.0], np.float32)
    write_file(state, tensors)
    return {"embedding": str(emb), "model_state": str(state)}


def build_models(seed: int = 55):
    """The JAX package's model and the port's, from the same seeded
    ``tiny_arch()`` checkpoint."""
    jm = load_model_from_store(
        open_store_from_bytes(encode_tensors(j_syn.build_checkpoint(ARCH, seed=seed))), num_heads=ARCH.num_heads
    )
    tm = load_model_from_tensors(synthetic.build_checkpoint(ARCH, seed=seed), num_heads=ARCH.num_heads, device="cpu")
    return jm, tm


@contextlib.contextmanager
def service_pair(models):
    """The JAX Service over the JAX BatcherRuntime and the port's over its
    own, both at 2 slots and 4-frame blocks."""
    jm, tm = models
    data = tokenizer_bytes()
    jrt = JBatcherRuntime(jm, slots=2, seed=1, prompt_capacity=64, steps_per_sync=4)
    trt = BatcherRuntime(tm, slots=2, seed=1, prompt_capacity=64, steps_per_sync=4, device="cpu")
    try:
        yield JService(jrt, j_tokenizer(data), tts_config(JTTSConfig)), Service(trt, t_tokenizer(data), tts_config(t_config.TTSConfig))
    finally:
        jrt.close()
        trt.close()
