"""Input text normalization (parity with `internal/text/normalize.go:14-26`)."""

from __future__ import annotations

__all__ = ["EmptyTextError", "normalize"]


class EmptyTextError(ValueError):
    """Raised when the input text is empty or whitespace-only."""


def normalize(s: str) -> str:
    """Normalize line endings to ``\\n``, trim, reject empty input."""
    s = s.replace("\r\n", "\n").replace("\r", "\n").strip()
    if not s:
        raise EmptyTextError("text is empty")
    return s
