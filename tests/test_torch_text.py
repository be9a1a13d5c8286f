"""The port's text front end against the JAX package's on the same inputs:
normalization, sentence splitting and chunking, ``prepare_text``,
``prepare_chunks``, the SentencePiece model's bytes and ids on both
backends, and the precompiled-charsmap cases of tests/test_charsmap.py."""

import pytest

from go_pocket_tts_tpu import text as J
from go_pocket_tts_tpu.text import charsmap as j_charsmap
from go_pocket_tts_tpu.text import sentencepiece as j_sp
from go_pocket_tts_tpu_torch import text as T
from go_pocket_tts_tpu_torch.text import charsmap as t_charsmap
from go_pocket_tts_tpu_torch.text import sentencepiece as t_sp

try:
    import tokenizers  # noqa: F401

    HAVE_HF = True
except ImportError:  # pragma: no cover
    HAVE_HF = False

TEXTS = [
    "hello world",
    "  hello\r\nworld\r!  ",
    "hello world how are you today",
    "one  two\nthree\r\nfour  five",
    "is this a question for you?",
    "Hello there. How are you? Fine!",
    "Hello... world",
    "One. two",
    "The quick brown fox jumps over the sleepy dog. Hello world, the brown fox sings a song. "
    "The quick fox walks home to the brown den.",
    " ".join(["word"] * 60) + ". " + " ".join(["more"] * 60) + ".",
    "émigré café, naïve — déjà vu…",
]


def _fixture_pieces():
    """The verify skill's synthetic tokenizer: seven word pieces and the
    lower-case letters."""
    return (
        [("<unk>", 0.0, 2)]
        + [(w, -1.0, 1) for w in "▁hello ▁world ▁the ▁quick ▁brown ▁fox .".split()]
        + [(c, -6.0, 1) for c in "abcdefghijklmnopqrstuvwxyz▁"]
    )


def _model(sp_module, pieces=None, charsmap: bytes = b""):
    m = sp_module.SentencePieceModel()
    for p, s, t in pieces or _fixture_pieces():
        m.pieces.append(p)
        m.scores.append(s)
        m.types.append(t)
    m.precompiled_charsmap = charsmap
    return m


class _WordTokenizer:
    def encode(self, s):
        return [sum(map(ord, w)) % 1000 for w in s.split()]


@pytest.mark.parametrize("text", TEXTS + ["   \n ", ""])
def test_normalize_prepare_and_split_match(text):
    if text.strip():
        assert T.normalize(text) == J.normalize(text)
    else:
        with pytest.raises(J.EmptyTextError):
            J.normalize(text)
        with pytest.raises(T.EmptyTextError):
            T.normalize(text)
    assert T.prepare_text(text) == J.prepare_text(text)
    assert T.split_sentences(text) == J.split_sentences(text)
    for budget in (0, 11, 40, 220):
        assert T.chunk_by_sentence(text, budget) == J.chunk_by_sentence(text, budget)


@pytest.mark.parametrize("tokens", list(range(0, 60, 7)) + [50, 3])
@pytest.mark.parametrize("rate", [12.5, 25.0, 0.0, float("nan")])
def test_estimate_max_frames_matches(tokens, rate):
    assert T.estimate_max_frames(tokens, rate) == J.estimate_max_frames(tokens, rate)


def test_runtime_uses_the_one_estimate():
    from go_pocket_tts_tpu_torch.parallel import batching
    from go_pocket_tts_tpu_torch.runtime import generate

    assert generate.estimate_max_frames is T.estimate_max_frames
    assert batching.estimate_max_frames is T.estimate_max_frames


def _chunks(mod, text, tok, budget):
    return [
        (c.text, list(c.token_ids), c.num_tokens, c.num_words, c.frames_after_eos(), c.max_frames())
        for c in mod.prepare_chunks(text, tok, budget)
    ]


@pytest.mark.parametrize("text", [t for t in TEXTS if t.strip()])
@pytest.mark.parametrize("budget", [6, 50])
def test_prepare_chunks_match_with_the_fixture_tokenizer(text, budget):
    data = _model(j_sp).serialize()
    j_tok = j_sp.load_tokenizer_from_bytes(data, backend="pure")
    t_tok = t_sp.load_tokenizer_from_bytes(data, backend="pure")
    assert _chunks(T, text, t_tok, budget) == _chunks(J, text, j_tok, budget)
    assert _chunks(T, text, _WordTokenizer(), budget) == _chunks(J, text, _WordTokenizer(), budget)


def test_prepare_chunks_empty_raises_alike():
    for mod in (J, T):
        with pytest.raises(ValueError):
            mod.prepare_chunks("   ", _WordTokenizer())


def test_model_bytes_and_parse_match():
    j_bytes = _model(j_sp).serialize()
    t_bytes = _model(t_sp).serialize()
    assert t_bytes == j_bytes
    parsed = t_sp.SentencePieceModel.parse(j_bytes)
    assert parsed.pieces == [p for p, _, _ in _fixture_pieces()]
    assert parsed.serialize() == j_bytes


@pytest.mark.parametrize("backend", ["pure", "hf", "auto"])
def test_fixture_tokenizer_ids_match(backend):
    if backend == "hf" and not HAVE_HF:
        pytest.skip("the tokenizers package is absent")
    data = _model(j_sp).serialize()
    j_tok = j_sp.load_tokenizer_from_bytes(data, backend=backend)
    t_tok = t_sp.load_tokenizer_from_bytes(data, backend=backend)
    for text in TEXTS:
        assert t_tok.encode(text) == j_tok.encode(text), text
        ids = t_tok.encode(text)
        assert t_tok.decode(ids) == j_tok.decode(ids)
    assert t_tok.vocab_size == j_tok.vocab_size


# -- the precompiled charsmap (the cases of tests/test_charsmap.py) -----------

_SMALL_MAP = {
    "Ａ": "A",
    "ﬁ": "fi",
    "…": "...",
    "²": "2",
    "ｶ": "カ",
    "​": "",
    "①": "1",
    "Ⅳ": "IV",
    "㎒": "MHz",
    "ñ": "ñ",
}

_CORPUS = [
    "hello world",
    "Ａﬁ…², plain",
    "ｶ①Ⅳ㎒",
    "mix Ａ and ﬁ x",
    " lead and trail ",
    "zero​width gone",
    "ñ stays ñ",
    "ASCII only 123 !?",
    "",
    "emoji 🎉 passthrough",
    "日本語テキスト и кириллица",
]


@pytest.mark.parametrize("which", ["small", "nfkc"])
def test_charsmap_blob_and_normalize_match(which):
    if which == "small":
        j_blob, t_blob = j_charsmap.build_charsmap(_SMALL_MAP), t_charsmap.build_charsmap(_SMALL_MAP)
    else:
        j_blob, t_blob = j_charsmap.nfkc_charsmap(), t_charsmap.nfkc_charsmap()
    assert t_blob == j_blob
    j_cm, t_cm = j_charsmap.PrecompiledCharsmap(j_blob), t_charsmap.PrecompiledCharsmap(t_blob)
    for text in _CORPUS:
        assert t_cm.normalize(text) == j_cm.normalize(text), text
    empty = t_charsmap.PrecompiledCharsmap(t_charsmap.build_charsmap({}))
    assert all(empty.normalize(text) == text for text in _CORPUS)


def test_charsmap_bad_blobs_raise_alike():
    for blob in (b"\x01\x02\x03", b"\xff\xff\xff\x7f rest", b"\x06\x00\x00\x00abcdef", b"\x00\x00\x00\x00"):
        with pytest.raises(ValueError):
            j_charsmap.PrecompiledCharsmap(blob)
        with pytest.raises(ValueError):
            t_charsmap.PrecompiledCharsmap(blob)


@pytest.mark.parametrize("backend", ["pure", "hf"])
def test_tokenizer_through_a_charsmap_model_matches(backend):
    if backend == "hf" and not HAVE_HF:
        pytest.skip("the tokenizers package is absent")
    pieces = _fixture_pieces() + [(c, -6.5, 1) for c in "AIVMHz0123456789fi"]
    data = _model(j_sp, pieces, j_charsmap.build_charsmap(_SMALL_MAP)).serialize()
    j_tok = j_sp.load_tokenizer_from_bytes(data, backend=backend)
    t_tok = t_sp.load_tokenizer_from_bytes(data, backend=backend)
    assert t_tok.charsmap_error == j_tok.charsmap_error is None
    for text in _CORPUS + TEXTS:
        assert t_tok.encode(text) == j_tok.encode(text), text
