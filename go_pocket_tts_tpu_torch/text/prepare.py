"""Text preparation and token-budget chunking.

These are behavioural contracts with golden tests in the reference
(`internal/text/prepare.go`); every quirk is intentional:

- :func:`prepare_text` (prepare.go:66-100): whitespace collapse → capitalize
  first rune → append ``.`` if the text ends alphanumeric → pad **8 leading
  spaces** when the word count is < 5 (upstream PocketTTS quirk).
- :func:`prepare_chunks` (prepare.go:105-185): sentence split on ``.!?`` →
  greedy grouping under a token budget, **re-tokenizing the joined candidate**
  each time → per-chunk metadata.
- :func:`estimate_max_frames` (prepare.go:38-48): upstream
  ``_estimate_max_gen_len``: ``ceil((tokens/3 + 2) * frame_rate)``.
- :meth:`ChunkMetadata.frames_after_eos` (prepare.go:53-59): 5 if ≤4 words
  else 3 (base 3/1 + 2).
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass, field
from typing import List, Protocol, Sequence

from go_pocket_tts_tpu_torch.text.chunk import split_sentences

__all__ = [
    "DEFAULT_MIMI_FRAME_RATE",
    "ChunkMetadata",
    "estimate_max_frames",
    "prepare_chunks",
    "prepare_text",
]

DEFAULT_MIMI_FRAME_RATE = 12.5

# Token budget per synthesis chunk (`internal/tts/service.go:23`).
MAX_TOKENS_PER_CHUNK = 50


class TokenizerLike(Protocol):
    def encode(self, text: str) -> List[int]: ...


@dataclass
class ChunkMetadata:
    """A preprocessed text chunk and its generation parameters."""

    text: str
    token_ids: List[int] = field(default_factory=list)
    num_tokens: int = 0
    num_words: int = 0

    def max_frames(self) -> int:
        return estimate_max_frames(self.num_tokens, DEFAULT_MIMI_FRAME_RATE)

    def frames_after_eos(self) -> int:
        return 5 if self.num_words <= 4 else 3


def estimate_max_frames(token_count: int, frame_rate: float = DEFAULT_MIMI_FRAME_RATE) -> int:
    if token_count < 0:
        token_count = 0
    if not (frame_rate > 0) or math.isinf(frame_rate):
        frame_rate = DEFAULT_MIMI_FRAME_RATE
    return int(math.ceil((token_count / 3.0 + 2.0) * frame_rate))


def _split_words(s: str) -> List[str]:
    return s.split()


def prepare_text(input_text: str) -> str:
    # Step 1: normalize whitespace (newlines → spaces, collapse doubles).
    s = input_text.replace("\r\n", " ").replace("\r", " ").replace("\n", " ")
    s = re.sub(r" {2,}", " ", s).strip()

    # Step 2: capitalize first letter. Go uses unicode.ToUpper on the first
    # rune only; Python's str.upper on one char matches for the BMP cases the
    # reference tests cover.
    if s:
        s = s[0].upper() + s[1:]

    # Step 3: trailing period if the last char is alphanumeric.
    if s and s[-1].isalnum():
        s += "."

    # Step 4: pad 8 leading spaces when < 5 words (upstream quirk).
    if len(_split_words(s)) < 5:
        s = "        " + s

    return s


def prepare_chunks(
    input_text: str,
    tokenizer: TokenizerLike,
    max_tokens: int = MAX_TOKENS_PER_CHUNK,
) -> List[ChunkMetadata]:
    """Tokenize and split text into ≤``max_tokens`` chunks.

    Greedy sentence grouping: a sentence is added to the pending chunk unless
    re-tokenizing the prepared joined candidate would exceed the budget, in
    which case the pending chunk is flushed first (prepare.go:105-185).
    """
    if not input_text.strip():
        raise ValueError("input text is empty")

    sentences = split_sentences(input_text)
    if not sentences:
        sentences = [input_text]

    chunks: List[ChunkMetadata] = []
    pending: List[str] = []

    def flush() -> None:
        if not pending:
            return
        joined = " ".join(pending)
        prepared = prepare_text(joined)
        ids = list(tokenizer.encode(prepared))
        chunks.append(
            ChunkMetadata(
                text=prepared,
                token_ids=ids,
                num_tokens=len(ids),
                num_words=len(_split_words(joined)),
            )
        )
        pending.clear()

    for sent in sentences:
        prepared = prepare_text(sent)
        ids = list(tokenizer.encode(prepared))

        if pending:
            joined = prepare_text(" ".join(pending + [sent]))
            pending_tokens = len(list(tokenizer.encode(joined)))
        else:
            pending_tokens = len(ids)

        if pending and pending_tokens > max_tokens:
            flush()
        pending.append(sent)

    flush()
    return chunks
