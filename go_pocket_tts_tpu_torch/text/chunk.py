"""Sentence splitting and char-budget chunking.

Parity with `internal/text/chunk.go:9-73`: sentences split on ``.!?`` with the
terminator kept attached; empty segments dropped; char-budget grouping used by
the CLI ``--chunk`` mode.
"""

from __future__ import annotations

from typing import List

__all__ = ["split_sentences", "chunk_by_sentence"]

_TERMINATORS = {".", "!", "?"}


def split_sentences(text: str) -> List[str]:
    """Split on sentence-ending punctuation, keeping the terminator."""
    sentences: List[str] = []
    start = 0
    for i, ch in enumerate(text):
        if ch in _TERMINATORS:
            s = text[start : i + 1].strip()
            if s:
                sentences.append(s)
            start = i + 1
    if start < len(text):
        s = text[start:].strip()
        if s:
            sentences.append(s)
    return sentences


def chunk_by_sentence(text: str, max_chars: int) -> List[str]:
    """Group consecutive sentences within ``max_chars`` per chunk.

    ``max_chars <= 0`` disables splitting; an oversized single sentence is
    kept intact (chunk.go:9-44).
    """
    if max_chars <= 0:
        return [text]
    sentences = split_sentences(text)
    if len(sentences) <= 1:
        return [text]
    chunks: List[str] = []
    current = ""
    for s in sentences:
        if not current:
            current = s
            continue
        if len(current) + 1 + len(s) > max_chars:
            chunks.append(current)
            current = s
        else:
            current = f"{current} {s}"
    if current:
        chunks.append(current)
    return chunks
