"""SentencePiece UNIGRAM tokenizer without the `sentencepiece` C library.

The reference vendors a Go SentencePiece encoder over ``tokenizer.model``
(`internal/tokenizer/sentencepiece.go:13-46`). Here the same capability is
built from first principles:

- a minimal protobuf wire-format reader for the SentencePiece ``ModelProto``
  (pieces + scores + types, trainer/normalizer specs) — no generated code
- a fast backend bridging to HuggingFace ``tokenizers`` (Rust): ``Unigram``
  model + ``Precompiled`` charsmap normalizer + ``Metaspace`` pre-tokenizer,
  the same construction `transformers` uses for SPM conversion
- a pure-Python Viterbi UNIGRAM encoder fallback with byte-fallback support
  and an exact precompiled-charsmap normalizer (darts-clone trie reader,
  ``text/charsmap.py``); NFKC approximation only if the blob fails to parse

Both backends implement ``encode(text) -> List[int]`` (the contract
`internal/text/prepare.go:14-16` consumes) and ``decode``.
"""

from __future__ import annotations

import logging
import struct
import unicodedata
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

log = logging.getLogger("pockettts.tokenizer")

__all__ = ["SentencePieceModel", "SentencePieceTokenizer", "load_tokenizer"]

_SPACE = "▁"  # ▁


# -- protobuf wire reader ---------------------------------------------------


def _read_varint(data: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("sentencepiece: truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("sentencepiece: varint too long")


def _iter_fields(data: bytes) -> Iterator[Tuple[int, int, bytes | int]]:
    """Yield (field_number, wire_type, value) over a protobuf message."""
    pos = 0
    while pos < len(data):
        tag, pos = _read_varint(data, pos)
        fieldno, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            val, pos = _read_varint(data, pos)
            yield fieldno, wire, val
        elif wire == 1:  # fixed64
            if len(data) - pos < 8:
                raise ValueError("sentencepiece: truncated fixed64 field")
            val = data[pos : pos + 8]
            pos += 8
            yield fieldno, wire, val
        elif wire == 2:  # length-delimited
            ln, pos = _read_varint(data, pos)
            if ln > len(data) - pos:
                raise ValueError("sentencepiece: truncated length-delimited field")
            val = data[pos : pos + ln]
            pos += ln
            yield fieldno, wire, val
        elif wire == 5:  # fixed32
            if len(data) - pos < 4:
                raise ValueError("sentencepiece: truncated fixed32 field")
            val = data[pos : pos + 4]
            pos += 4
            yield fieldno, wire, val
        else:
            raise ValueError(f"sentencepiece: unsupported wire type {wire}")


# Piece types (sentencepiece_model.proto SentencePiece.Type).
_TYPE_NORMAL = 1
_TYPE_UNKNOWN = 2
_TYPE_CONTROL = 3
_TYPE_USER_DEFINED = 4
_TYPE_UNUSED = 5
_TYPE_BYTE = 6


@dataclass
class SentencePieceModel:
    """Parsed ModelProto content."""

    pieces: List[str] = field(default_factory=list)
    scores: List[float] = field(default_factory=list)
    types: List[int] = field(default_factory=list)
    unk_id: int = 0
    byte_fallback: bool = False
    precompiled_charsmap: bytes = b""
    add_dummy_prefix: bool = True
    remove_extra_whitespaces: bool = True
    escape_whitespaces: bool = True

    @classmethod
    def parse(cls, data: bytes) -> "SentencePieceModel":
        model = cls()
        saw_unk = False
        for fieldno, wire, val in _iter_fields(data):
            if fieldno == 1 and wire == 2:  # SentencePiece
                piece, score, ptype = "", 0.0, _TYPE_NORMAL
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 1 and w2 == 2:
                        try:
                            piece = v2.decode("utf-8")
                        except UnicodeDecodeError as exc:
                            raise ValueError(
                                "sentencepiece: piece is not valid UTF-8"
                            ) from exc
                    elif f2 == 2 and w2 == 5:
                        (score,) = struct.unpack("<f", v2)
                    elif f2 == 3 and w2 == 0:
                        ptype = v2
                if ptype == _TYPE_UNKNOWN and not saw_unk:
                    model.unk_id = len(model.pieces)
                    saw_unk = True
                model.pieces.append(piece)
                model.scores.append(score)
                model.types.append(ptype)
            elif fieldno == 2 and wire == 2:  # TrainerSpec
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 35 and w2 == 0:  # byte_fallback
                        model.byte_fallback = bool(v2)
                    elif f2 == 40 and w2 == 0:  # unk_id
                        # Range-checked AFTER the loop: TrainerSpec may
                        # precede the pieces in the wire stream.
                        model.unk_id = v2
            elif fieldno == 3 and wire == 2:  # NormalizerSpec
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 2 and w2 == 2:
                        model.precompiled_charsmap = v2
                    elif f2 == 3 and w2 == 0:
                        model.add_dummy_prefix = bool(v2)
                    elif f2 == 4 and w2 == 0:
                        model.remove_extra_whitespaces = bool(v2)
                    elif f2 == 5 and w2 == 0:
                        model.escape_whitespaces = bool(v2)
        if not model.pieces:
            raise ValueError("sentencepiece: model contains no pieces")
        if not 0 <= model.unk_id < len(model.pieces):
            # Untrusted input contract (tests/test_fuzz.py): an out-of-range
            # unk_id would otherwise escape later as a non-ValueError from
            # the HF backend, or silently gather a wrong embedding row.
            raise ValueError(
                f"sentencepiece: unk_id {model.unk_id} out of range "
                f"(0..{len(model.pieces) - 1})"
            )
        return model

    # -- serialization (for building synthetic test/tooling models) --------

    def serialize(self) -> bytes:
        def varint(v: int) -> bytes:
            out = b""
            while True:
                b7 = v & 0x7F
                v >>= 7
                if v:
                    out += bytes([b7 | 0x80])
                else:
                    return out + bytes([b7])

        def ld(fieldno: int, payload: bytes) -> bytes:
            return varint((fieldno << 3) | 2) + varint(len(payload)) + payload

        def vint(fieldno: int, v: int) -> bytes:
            return varint(fieldno << 3) + varint(v)

        out = b""
        for piece, score, ptype in zip(self.pieces, self.scores, self.types):
            body = ld(1, piece.encode("utf-8"))
            body += varint((2 << 3) | 5) + struct.pack("<f", score)
            body += vint(3, ptype)
            out += ld(1, body)
        trainer = vint(35, int(self.byte_fallback)) + vint(40, self.unk_id)
        out += ld(2, trainer)
        norm = (
            (ld(2, self.precompiled_charsmap) if self.precompiled_charsmap else b"")
            + vint(3, int(self.add_dummy_prefix))
            + vint(4, int(self.remove_extra_whitespaces))
            + vint(5, int(self.escape_whitespaces))
        )
        out += ld(3, norm)
        return out


# -- encoders ---------------------------------------------------------------


class _PureViterbi:
    """Pure-Python UNIGRAM Viterbi encoder.

    Normalization applies the model's precompiled charsmap exactly
    (sentencepiece ``NormalizePrefix`` longest-match semantics via
    ``text/charsmap.py``); when the model carries no charsmap — or the blob
    fails to parse — it falls back to ``unicodedata`` NFKC (exact for the
    ASCII inputs the TTS front-end produces after ``prepare_text``).
    """

    def __init__(self, model: SentencePieceModel) -> None:
        self.m = model
        self.charsmap = None
        self.charsmap_error: Optional[str] = None
        if model.precompiled_charsmap:
            try:
                from go_pocket_tts_tpu_torch.text.charsmap import PrecompiledCharsmap

                self.charsmap = PrecompiledCharsmap(model.precompiled_charsmap)
            except ValueError as exc:
                self.charsmap_error = str(exc)
        self.piece_to_id: Dict[str, int] = {}
        for i, (piece, ptype) in enumerate(zip(model.pieces, model.types)):
            if ptype in (_TYPE_NORMAL, _TYPE_USER_DEFINED) and piece not in self.piece_to_id:
                self.piece_to_id[piece] = i
        self.byte_ids: Dict[int, int] = {}
        for i, (piece, ptype) in enumerate(zip(model.pieces, model.types)):
            if ptype == _TYPE_BYTE:
                try:
                    self.byte_ids[int(piece[1:-1], 16)] = i
                except ValueError:
                    pass
        self.max_piece_len = max((len(p) for p in self.piece_to_id), default=1)
        self.min_score = min(model.scores) if model.scores else 0.0
        self.unk_score = self.min_score - 10.0

    def normalize(self, text: str) -> str:
        if self.charsmap is not None:
            s = self.charsmap.normalize(text)
        else:
            s = unicodedata.normalize("NFKC", text)
        if self.m.remove_extra_whitespaces:
            s = " ".join(x for x in s.split(" ") if x != "") if s.strip(" ") else ""
            # preserve a completely-whitespace string as empty
        if self.m.add_dummy_prefix and s:
            s = " " + s
        if self.m.escape_whitespaces:
            s = s.replace(" ", _SPACE)
        return s

    def encode(self, text: str) -> List[int]:
        s = self.normalize(text)
        n = len(s)
        if n == 0:
            return []
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: List[Optional[Tuple[int, int]]] = [None] * (n + 1)  # (start, id)
        best[0] = 0.0
        for end in range(1, n + 1):
            lo = max(0, end - self.max_piece_len)
            for start in range(lo, end):
                if best[start] == NEG:
                    continue
                sub = s[start:end]
                pid = self.piece_to_id.get(sub)
                if pid is not None:
                    sc = best[start] + self.m.scores[pid]
                    if sc > best[end]:
                        best[end] = sc
                        back[end] = (start, pid)
            # unknown single char fallback
            start = end - 1
            if best[start] != NEG:
                sc = best[start] + self.unk_score
                if sc > best[end]:
                    best[end] = sc
                    back[end] = (start, -1)  # -1 = unknown char marker

        # Walk back, fusing byte-fallback/unk.
        out_rev: List[int] = []
        pos = n
        while pos > 0:
            start, pid = back[pos]
            if pid >= 0:
                out_rev.append(pid)
            else:
                ch = s[start:pos]
                if self.m.byte_fallback and self.byte_ids:
                    for b in reversed(ch.encode("utf-8")):
                        out_rev.append(self.byte_ids.get(b, self.m.unk_id))
                else:
                    out_rev.append(self.m.unk_id)
            pos = start
        return list(reversed(out_rev))

    def decode(self, ids: List[int]) -> str:
        parts: List[bytes] = []
        for i in ids:
            if 0 <= i < len(self.m.pieces):
                if self.m.types[i] == _TYPE_BYTE:
                    parts.append(bytes([int(self.m.pieces[i][1:-1], 16)]))
                elif self.m.types[i] in (_TYPE_NORMAL, _TYPE_USER_DEFINED):
                    parts.append(self.m.pieces[i].encode("utf-8"))
        text = b"".join(parts).decode("utf-8", errors="replace")
        text = text.replace(_SPACE, " ")
        return text[1:] if text.startswith(" ") else text


def _build_hf_backend(model: SentencePieceModel):
    """HF `tokenizers` bridge (same construction as transformers' SpmConverter)."""
    try:
        from tokenizers import Regex, Tokenizer, decoders, models, normalizers, pre_tokenizers
    except ImportError:
        return None
    try:
        vocab = list(zip(model.pieces, model.scores))
        tok = Tokenizer(
            models.Unigram(vocab, unk_id=model.unk_id, byte_fallback=model.byte_fallback)
        )
        norms = []
        if model.precompiled_charsmap:
            norms.append(normalizers.Precompiled(model.precompiled_charsmap))
        else:
            norms.append(normalizers.NFKC())
        if model.remove_extra_whitespaces:
            norms.append(normalizers.Replace(Regex(" {2,}"), " "))
            norms.append(normalizers.Strip())
        tok.normalizer = normalizers.Sequence(norms)
        prepend = "always" if model.add_dummy_prefix else "never"
        tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement=_SPACE, prepend_scheme=prepend)
        tok.decoder = decoders.Metaspace(replacement=_SPACE, prepend_scheme=prepend)
        return tok
    except Exception:  # pragma: no cover - tokenizers API drift
        return None


class SentencePieceTokenizer:
    """UNIGRAM tokenizer facade over the fast (HF) or pure backend.

    ``backend``: "auto" (HF when available), "hf", or "pure".
    """

    def __init__(self, model: SentencePieceModel, backend: str = "auto") -> None:
        self.model = model
        self._pure = _PureViterbi(model)
        self._hf = None
        if backend in ("auto", "hf"):
            self._hf = _build_hf_backend(model)
            if backend == "hf" and self._hf is None:
                raise RuntimeError("tokenizers (HF) backend unavailable")
        self.backend = "hf" if self._hf is not None else "pure"
        if self.backend == "pure" and self._pure.charsmap_error is not None:
            # The model carries a precompiled charsmap the pure reader could
            # not parse, so normalization degrades to the NFKC approximation
            # — exact for ASCII, possibly divergent elsewhere. Wrong token
            # IDs mean wrong speech with no error, so shout.
            log.warning(
                "sentencepiece: precompiled charsmap failed to parse (%s); "
                "pure fallback approximates it with NFKC (exact only for "
                "ASCII). Install `tokenizers` for exact normalization.",
                self._pure.charsmap_error,
            )

    @property
    def vocab_size(self) -> int:
        return len(self.model.pieces)

    @property
    def charsmap_error(self) -> Optional[str]:
        """Parse error of the model's precompiled charsmap, if any (the pure
        backend then approximates normalization with NFKC)."""
        return self._pure.charsmap_error

    def encode(self, text: str) -> List[int]:
        if not text:
            return []
        if self._hf is not None:
            return list(self._hf.encode(text).ids)
        return self._pure.encode(text)

    def decode(self, ids: List[int]) -> str:
        return self._pure.decode(list(ids))

    def piece_to_id(self, piece: str) -> Optional[int]:
        try:
            return self.model.pieces.index(piece)
        except ValueError:
            return None


def load_tokenizer(path: str, backend: str = "auto") -> SentencePieceTokenizer:
    """Load ``tokenizer.model`` from disk (the reference loads the same file,
    `internal/tokenizer/sentencepiece.go:19-30`)."""
    with open(path, "rb") as f:
        data = f.read()
    return SentencePieceTokenizer(SentencePieceModel.parse(data), backend=backend)


def load_tokenizer_from_bytes(data: bytes, backend: str = "auto") -> SentencePieceTokenizer:
    """Bytes loader (WASM-kernel capability analogue,
    `internal/tokenizer/sentencepiece_bytes.go:14-40`)."""
    return SentencePieceTokenizer(SentencePieceModel.parse(data), backend=backend)
