"""SentencePiece *precompiled charsmap* normalizer — dependency-free.

``tokenizer.model``'s NormalizerSpec carries a precompiled charsmap blob:
upstream sentencepiece compiles its normalization rules (NMT_NFKC) into it,
and that upstream semantic is the ground truth the published model was
trained against. The reference only APPROXIMATES it — its vendored Go
encoder (`internal/tokenizer/sentencepiece.go:13-46` delegating to
go-sentencepiece-encoder) and its WASM mirror
(`internal/tokenizer/sentencepiece_bytes_wasm.go:225-276`) do a hardcoded
control-strip + whitespace fold + plain NFKC and never read the blob. Until
round 3 this repo's pure-Python backend made the same NFKC approximation;
this module implements the real charsmap semantics, so the pure fallback is
now exact w.r.t. upstream (beyond reference parity) without HF
``tokenizers``.

Blob layout (sentencepiece ``normalizer.cc:DecodePrecompiledCharsMap``,
mirrored by HF tokenizers' ``spm_precompiled``):

    [u32-LE trie_size] [trie: trie_size bytes of u32 units] [pool]

- the trie is a darts-clone XOR double-array keyed by UTF-8 byte strings;
  each accepted key's value is a byte offset into ``pool``
- ``pool`` is a concatenation of NUL-terminated UTF-8 replacement strings

Unit encoding (darts-clone ``DoubleArrayUnit``):

    has_leaf(u) = (u >> 8) & 1
    value(u)    = u & 0x7FFF_FFFF          (on the dedicated value unit)
    label(u)    = u & 0x8000_00FF          (compared against the key byte)
    offset(u)   = (u >> 10) << ((u & 0x200) >> 6)   (bit 9 => <<8 extension)

Normalization algorithm = sentencepiece ``Normalizer::NormalizePrefix``:
repeatedly take the LONGEST trie match at the current position and emit its
replacement; if no match, copy one UTF-8 character unchanged. (HF's
``normalizers.Precompiled`` instead segments into graphemes and applies the
shortest match per grapheme — the two agree on single-grapheme rules, which
is all NMT_NFKC-style tables contain in practice; tests pin both.)

``build_charsmap`` constructs format-compatible blobs from a plain mapping
(validated against the HF oracle in tests) so this environment — which has
no real ``tokenizer.model`` — can exercise the exact path end-to-end, and so
tooling can mint custom normalizers.
"""

from __future__ import annotations

import struct
import sys
import unicodedata
from typing import Dict, List, Tuple

__all__ = ["PrecompiledCharsmap", "build_charsmap", "nfkc_charsmap"]


def _utf8_char_len(first_byte: int) -> int:
    if first_byte < 0x80:
        return 1
    if first_byte < 0xC0:  # stray continuation byte: consume it alone
        return 1
    if first_byte < 0xE0:
        return 2
    if first_byte < 0xF0:
        return 3
    return 4


class PrecompiledCharsmap:
    """Reader: darts-clone common-prefix search + longest-match rewrite."""

    def __init__(self, blob: bytes) -> None:
        if len(blob) < 4:
            raise ValueError("charsmap: blob too short")
        (trie_size,) = struct.unpack("<I", blob[:4])
        if trie_size % 4 or 4 + trie_size > len(blob):
            raise ValueError("charsmap: bad trie size")
        units = memoryview(bytes(blob[4 : 4 + trie_size])).cast("I")
        if sys.byteorder != "little":  # pragma: no cover - LE everywhere here
            units = memoryview(
                struct.pack(
                    f"<{trie_size // 4}I",
                    *struct.unpack(f">{trie_size // 4}I", blob[4 : 4 + trie_size]),
                )
            ).cast("I")
        if len(units) == 0:
            raise ValueError("charsmap: empty trie")
        self._units = units
        self._pool = bytes(blob[4 + trie_size :])

    # -- darts-clone traversal ----------------------------------------------

    @staticmethod
    def _offset(unit: int) -> int:
        return (unit >> 10) << ((unit & 0x200) >> 6)

    def _longest_match(self, data: bytes, pos: int) -> Tuple[int, int]:
        """(match_byte_len, pool_offset) of the longest key matching
        ``data[pos:]``; (0, -1) when nothing matches."""
        units = self._units
        n_units = len(units)
        node_pos = self._offset(units[0])
        best_len, best_val = 0, -1
        for i in range(pos, len(data)):
            c = data[i]
            if c == 0:
                break
            node_pos ^= c
            if node_pos >= n_units:
                break
            unit = units[node_pos]
            if (unit & 0x800000FF) != c:
                break
            node_pos ^= self._offset(unit)
            if (unit >> 8) & 1:
                if node_pos >= n_units:
                    break
                best_len = i + 1 - pos
                best_val = units[node_pos] & 0x7FFFFFFF
        return best_len, best_val

    def _replacement(self, pool_offset: int) -> bytes:
        end = self._pool.find(0, pool_offset)
        if end < 0:
            end = len(self._pool)
        return self._pool[pool_offset:end]

    # -- public API ----------------------------------------------------------

    def normalize(self, text: str) -> str:
        data = text.encode("utf-8")
        out: List[bytes] = []
        pos, n = 0, len(data)
        while pos < n:
            length, val = self._longest_match(data, pos)
            if length > 0:
                out.append(self._replacement(val))
                pos += length
            else:
                ln = min(_utf8_char_len(data[pos]), n - pos)
                out.append(data[pos : pos + ln])
                pos += ln
        return b"".join(out).decode("utf-8", errors="replace")


# -- builder (tests / tooling) ----------------------------------------------


class _TrieNode:
    __slots__ = ("children", "value")

    def __init__(self) -> None:
        self.children: Dict[int, _TrieNode] = {}
        self.value: int | None = None


def _encode_offset(o: int) -> int | None:
    if o < (1 << 21):
        return o << 10
    if o % 256 == 0 and (o >> 8) < (1 << 21):
        return ((o >> 8) << 10) | 0x200
    return None


def _build_darts(items: List[Tuple[bytes, int]]) -> List[int]:
    """Double-array units (darts-clone XOR layout) for (key, value) pairs."""
    root = _TrieNode()
    for key, value in items:
        node = root
        for b in key:
            if b == 0:
                raise ValueError("charsmap: keys must not contain NUL")
            node = node.children.setdefault(b, _TrieNode())
        node.value = value

    units: List[int] = [0]
    used = [True]  # position 0 = root unit
    hint = [1]  # rolling first-fit start: first possibly-unused position
    # In the XOR layout the label byte is the only "check": slot q with label
    # c belongs to the parent whose base is q ^ c, so bases must be GLOBALLY
    # unique or traversal past a match reads another node's children as its
    # own (false longer matches). Value-less bases occupy no slot, hence the
    # separate set.
    bases_taken = set()

    def ensure(size: int) -> None:
        while len(units) < size:
            units.append(0)
            used.append(False)

    def place(node: _TrieNode, pos: int) -> None:
        """Choose node's child base, write its offset into units[pos]."""
        needs = sorted(node.children)
        if node.value is None and not needs:
            return
        ensure(hint[0] + 1)
        while used[hint[0]]:
            hint[0] += 1
            ensure(hint[0] + 1)
        b = hint[0]
        while True:
            o = pos ^ b
            enc = _encode_offset(o)
            if enc is not None and b not in bases_taken:
                ensure(max([b] + [b ^ c for c in needs]) + 1)
                ok = (node.value is None or not used[b]) and all(
                    not used[b ^ c] for c in needs
                )
                if ok:
                    break
            b += 1
        bases_taken.add(b)
        units[pos] |= enc | ((1 << 8) if node.value is not None else 0)
        if node.value is not None:
            used[b] = True
            units[b] = 0x80000000 | node.value
        for c in needs:
            used[b ^ c] = True
            units[b ^ c] = c
        for c in needs:
            place(node.children[c], b ^ c)

    place(root, 0)
    # Pad to a multiple of 256 units: with every base in-bounds, any
    # ``pos ^ byte`` then lands in the same 256-block, so readers that skip
    # bounds checks (darts-clone, HF's spm_precompiled) never index past the
    # array — real sentencepiece blobs carry the same invariant.
    while len(units) % 256:
        units.append(0)
    return units


def build_charsmap(mapping: Dict[str, str]) -> bytes:
    """Compile ``{source: replacement}`` into a precompiled-charsmap blob.

    Keys are matched longest-first on UTF-8 bytes; replacements may be
    empty (deletion). Output parses with both this module's reader and HF
    tokenizers' ``normalizers.Precompiled``.
    """
    pool = bytearray()
    items: List[Tuple[bytes, int]] = []
    for key in sorted(mapping):
        kb = key.encode("utf-8")
        if not kb:
            raise ValueError("charsmap: empty key")
        items.append((kb, len(pool)))
        pool += mapping[key].encode("utf-8") + b"\0"
    units = _build_darts(items)
    trie = struct.pack(f"<{len(units)}I", *units)
    return struct.pack("<I", len(trie)) + trie + bytes(pool)


def nfkc_charsmap(max_codepoint: int = 0x2FFF) -> bytes:
    """An NFKC-rule charsmap over single codepoints up to ``max_codepoint``
    (compat decomposition + canonical composition, the per-character core of
    NMT_NFKC) — a realistic-scale fixture for exercising the exact path."""
    mapping: Dict[str, str] = {}
    for cp in range(0x80, max_codepoint + 1):
        ch = chr(cp)
        if unicodedata.category(ch) in ("Cs", "Cn"):
            continue
        norm = unicodedata.normalize("NFKC", ch)
        if norm != ch:
            mapping[ch] = norm
    return build_charsmap(mapping)
