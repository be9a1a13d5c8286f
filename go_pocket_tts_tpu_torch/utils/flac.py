"""FLAC encoder/decoder (subset), dependency-free and NumPy-vectorized.

The reference serves WAV only (`internal/server/server.go`,
`internal/audio/wav.go`); PCM16 at 24 kHz is ~48 KB/s of egress per stream.
This module adds lossless compression at the serving edge — typically 2-3×
smaller for speech — while keeping WAV as the default and the parity format.

Scope (everything the TTS pipeline needs, nothing it doesn't):
- mono, 16-bit, any sample rate (we use 24 kHz)
- encoder: CONSTANT / VERBATIM / FIXED(0-4) subframes, Rice-coded residuals
  (partition order 0), fixed- or variable-blocksize streams
- streaming: :class:`FlacStreamEncoder` emits a header once, then one
  self-contained frame per PCM block (variable-blocksize framing), matching
  the chunked HTTP path's block cadence
- decoder: full subset round-trip incl. CRC-8/CRC-16 verification — used by
  the tests as an independent check of every emitted bit, and by clients
  that want to verify responses

Format per RFC 9639 (the FLAC specification). All bit packing is done on
uint8 *bit* arrays assembled with NumPy and packed per frame — the Rice
coder writes whole residual blocks with vector ops, not per-sample Python.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

__all__ = [
    "encode_flac",
    "decode_flac",
    "FlacStreamEncoder",
    "FlacError",
]


class FlacError(ValueError):
    """Malformed or unsupported FLAC data."""


# -- CRCs (bytewise, table-driven) -------------------------------------------


def _crc_table(poly: int, width: int) -> np.ndarray:
    table = np.zeros(256, np.uint32)
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    for i in range(256):
        crc = i << (width - 8)
        for _ in range(8):
            crc = ((crc << 1) ^ poly) if crc & top else (crc << 1)
        table[i] = crc & mask
    return table


_CRC8_TABLE = _crc_table(0x07, 8)
_CRC16_TABLE = _crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = int(_CRC8_TABLE[crc ^ b])
    return crc


def _crc16(data: bytes) -> int:
    # The frame CRC runs over every compressed byte, about half of the
    # whole encode as a Python loop. The reference package runs the same
    # table algorithm in C (``native/audioio.cpp``) with the same output;
    # that helper is not ported yet (ROADMAP.md).
    crc = 0
    for b in data:
        crc = int(_CRC16_TABLE[((crc >> 8) ^ b) & 0xFF]) ^ ((crc << 8) & 0xFFFF)
    return crc


# -- bit assembly -------------------------------------------------------------


class _BitChunks:
    """Accumulates a frame as a list of uint8 0/1 bit arrays; packs once."""

    def __init__(self) -> None:
        self._chunks: List[np.ndarray] = []

    def bits(self, value: int, n: int) -> None:
        if n == 0:
            return
        v = int(value) & ((1 << n) - 1)
        arr = (v >> np.arange(n - 1, -1, -1, dtype=np.int64)) & 1
        self._chunks.append(arr.astype(np.uint8))

    def raw(self, arr: np.ndarray) -> None:
        self._chunks.append(arr.astype(np.uint8, copy=False))

    def signed_block(self, values: np.ndarray, width: int) -> None:
        """Append each value as a ``width``-bit two's-complement integer."""
        v = values.astype(np.int64) & ((1 << width) - 1)
        shifts = np.arange(width - 1, -1, -1, dtype=np.int64)
        self._chunks.append(((v[:, None] >> shifts[None, :]) & 1).astype(np.uint8).reshape(-1))

    def rice_block(self, residuals: np.ndarray, k: int) -> None:
        """Rice-encode a residual block: unary(q) = q zeros then a 1, then
        the k low bits of the zigzag-folded value. Fully vectorized."""
        r = residuals.astype(np.int64)
        u = np.where(r >= 0, r << 1, (-r << 1) - 1).astype(np.uint64)
        q = (u >> np.uint64(k)).astype(np.int64)
        per = q + 1 + k
        offsets = np.concatenate(([0], np.cumsum(per)[:-1]))
        total = int(per.sum())
        bits = np.zeros(total, np.uint8)
        bits[offsets + q] = 1  # unary terminators
        if k:
            shifts = np.arange(k - 1, -1, -1, dtype=np.uint64)
            low = ((u[:, None] >> shifts[None, :]) & np.uint64(1)).astype(np.uint8)
            pos = (offsets + q + 1)[:, None] + np.arange(k)[None, :]
            bits[pos.reshape(-1)] = low.reshape(-1)
        self._chunks.append(bits)

    def to_bytes(self) -> bytes:
        """Pack to bytes, zero-padding to byte alignment (frame padding)."""
        bits = np.concatenate(self._chunks) if self._chunks else np.zeros(0, np.uint8)
        return np.packbits(bits).tobytes()


def _utf8_coded(value: int) -> bytes:
    """FLAC's extended UTF-8 number coding (frame/sample number, ≤36 bits)."""
    if value < 0x80:
        return bytes([value])
    for n_extra, first_max_bits in ((1, 11), (2, 16), (3, 21), (4, 26), (5, 31), (6, 36)):
        if value < (1 << first_max_bits):
            lead_bits = 6 - n_extra
            lead = (0xFF << (lead_bits + 1)) & 0xFF | (value >> (6 * n_extra))
            out = [lead]
            for i in range(n_extra - 1, -1, -1):
                out.append(0x80 | ((value >> (6 * i)) & 0x3F))
            return bytes(out)
    raise FlacError(f"number {value} too large for UTF-8 coding")


# -- fixed predictors ---------------------------------------------------------

# order -> coefficients applied to x[i-1..i-order]
_FIXED_COEF = {
    0: np.array([], np.int64),
    1: np.array([1], np.int64),
    2: np.array([2, -1], np.int64),
    3: np.array([3, -3, 1], np.int64),
    4: np.array([4, -6, 4, -1], np.int64),
}


def _fixed_residual(x: np.ndarray, order: int) -> np.ndarray:
    r = x.astype(np.int64)
    for _ in range(order):
        r = np.diff(r)
    return r


def _rice_param(residuals: np.ndarray) -> Tuple[int, int]:
    """Best Rice parameter k (0..14) and the residual bit cost at that k.

    One vectorized [n, 15] shift+sum instead of a per-k Python loop (the
    loop was ~27% of the encode)."""
    r = residuals.astype(np.int64)
    u = np.where(r >= 0, r << 1, (-r << 1) - 1).astype(np.uint64)
    ks = np.arange(15, dtype=np.uint64)
    costs = (u[:, None] >> ks[None, :]).sum(axis=0) + np.uint64(len(u)) * (
        ks + np.uint64(1)
    )
    k = int(np.argmin(costs))
    return k, int(costs[k])


# -- encoder -------------------------------------------------------------------


def _streaminfo(
    block_size: int,
    sample_rate: int,
    total_samples: int,
    min_block: Optional[int] = None,
) -> bytes:
    w = _BitChunks()
    w.bits(1, 1)  # last-metadata-block flag (no other blocks)
    w.bits(0, 7)  # type 0 = STREAMINFO
    w.bits(34, 24)  # length
    w.bits(min_block if min_block is not None else block_size, 16)
    w.bits(block_size, 16)
    w.bits(0, 24)  # min frame size unknown
    w.bits(0, 24)  # max frame size unknown
    w.bits(sample_rate, 20)
    w.bits(0, 3)  # channels - 1 (mono)
    w.bits(15, 5)  # bits per sample - 1 (16)
    w.bits(total_samples, 36)  # 0 = unknown (streaming)
    raw = w.to_bytes()
    return b"fLaC" + raw + b"\x00" * 16  # MD5 unknown


def _encode_subframe(w: _BitChunks, x: np.ndarray) -> None:
    """Pick CONSTANT / FIXED(0-4) / VERBATIM for one mono int16 block."""
    n = len(x)
    if n > 0 and np.all(x == x[0]):
        w.bits(0, 1)  # zero pad
        w.bits(0b000000, 6)  # CONSTANT
        w.bits(0, 1)  # no wasted bits
        w.bits(int(x[0]), 16)
        return

    best = None  # (cost_bits, order, k, residual)
    for order in range(min(5, n)):
        res = _fixed_residual(x, order)
        k, cost = _rice_param(res)
        cost += order * 16 + 8  # warmup samples + residual-coding header
        if best is None or cost < best[0]:
            best = (cost, order, k, res)
    verbatim_cost = n * 16
    if best is None or best[0] >= verbatim_cost:
        w.bits(0, 1)
        w.bits(0b000001, 6)  # VERBATIM
        w.bits(0, 1)
        w.signed_block(x, 16)
        return

    _cost, order, k, res = best
    w.bits(0, 1)
    w.bits(0b001000 | order, 6)  # FIXED, order
    w.bits(0, 1)
    if order:
        w.signed_block(x[:order], 16)  # warmup
    w.bits(0b00, 2)  # residual method: RICE (4-bit params)
    w.bits(0, 4)  # partition order 0 → one partition
    w.bits(k, 4)
    w.rice_block(res, k)


def _encode_frame(
    x: np.ndarray,
    number: int,
    block_size_code_ref: int,
    variable: bool,
) -> bytes:
    """One complete frame (header + subframe + padding + CRC-16).

    ``number`` is the frame index (fixed blocking) or the first sample index
    (variable blocking). ``block_size_code_ref`` is the stream's nominal
    block size; when ``len(x)`` differs (last frame / streaming), the size is
    carried explicitly via the 16-bit end-of-header field.
    """
    n = len(x)
    w = _BitChunks()
    w.bits(0b11111111111110, 14)  # sync
    w.bits(0, 1)  # reserved
    w.bits(1 if variable else 0, 1)  # blocking strategy
    w.bits(0b0111, 4)  # block size: 16-bit value-1 at end of header
    w.bits(0b0000, 4)  # sample rate: from STREAMINFO
    w.bits(0b0000, 4)  # channel assignment: mono
    w.bits(0b100, 3)  # sample size: 16 bits
    w.bits(0, 1)  # reserved
    header = w.to_bytes() + _utf8_coded(number) + bytes([(n - 1) >> 8, (n - 1) & 0xFF])
    header += bytes([_crc8(header)])

    body = _BitChunks()
    _encode_subframe(body, x)
    frame = header + body.to_bytes()  # to_bytes zero-pads to byte alignment
    crc = _crc16(frame)
    return frame + bytes([crc >> 8, crc & 0xFF])


def _to_int16(samples: np.ndarray) -> np.ndarray:
    if samples.dtype == np.int16:
        return samples
    # float PCM in [-1, 1] — same truncation as utils.wav.pcm16_bytes.
    return (np.clip(samples.astype(np.float32), -1.0, 1.0) * 32767.0).astype(np.int16)


def encode_flac(
    samples: np.ndarray, sample_rate: int = 24_000, block_size: int = 4096
) -> bytes:
    """Encode mono PCM (float32 in [-1,1] or int16) to a FLAC stream."""
    x = _to_int16(np.asarray(samples).reshape(-1))
    out = [_streaminfo(block_size, sample_rate, len(x))]
    for i, start in enumerate(range(0, len(x), block_size)):
        out.append(_encode_frame(x[start : start + block_size], i, block_size, False))
    if len(x) == 0:  # zero-sample stream: header only (decoders accept this)
        pass
    return b"".join(out)


class FlacStreamEncoder:
    """Incremental FLAC encoding for the chunked HTTP path.

    ``header()`` once, then ``encode_block(pcm)`` per PCM block — block sizes
    may vary (the adaptive 4→16-frame streaming segments), so frames use the
    variable-blocksize strategy with sample-number addressing.
    """

    def __init__(self, sample_rate: int = 24_000, max_block: int = 65535) -> None:
        self.sample_rate = sample_rate
        self.max_block = max_block
        self._sample_pos = 0

    def header(self) -> bytes:
        # Unknown total samples; min/max block sizes are nominal (16..max).
        return _streaminfo(self.max_block, self.sample_rate, 0, min_block=16)

    def encode_block(self, samples: np.ndarray) -> bytes:
        x = _to_int16(np.asarray(samples).reshape(-1))
        out = []
        for start in range(0, len(x), self.max_block):
            part = x[start : start + self.max_block]
            out.append(_encode_frame(part, self._sample_pos, self.max_block, True))
            self._sample_pos += len(part)
        return b"".join(out)


# -- decoder -------------------------------------------------------------------


class _BitReader:
    def __init__(self, data: bytes, pos_bits: int = 0) -> None:
        self.bits = np.unpackbits(np.frombuffer(data, np.uint8))
        self.pos = pos_bits

    def read(self, n: int) -> int:
        if self.pos + n > len(self.bits):
            raise FlacError("truncated FLAC stream")
        v = 0
        for b in self.bits[self.pos : self.pos + n]:
            v = (v << 1) | int(b)
        self.pos += n
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v & (1 << (n - 1)) else v

    def read_rice_block(self, n: int, k: int) -> np.ndarray:
        # One bulk copy to a Python list, then tight scalar scanning — per-bit
        # numpy indexing (or flatnonzero per code) would be quadratic.
        b = self.bits[self.pos :].tolist()
        p = 0
        out = np.empty(n, np.int64)
        try:
            for i in range(n):
                q = 0
                while not b[p]:
                    q += 1
                    p += 1
                p += 1  # the terminating 1
                rem = 0
                for _ in range(k):
                    rem = (rem << 1) | b[p]
                    p += 1
                u = (q << k) | rem
                out[i] = (u >> 1) ^ -(u & 1)
        except IndexError:
            raise FlacError("truncated rice-coded residual") from None
        self.pos += p
        return out

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


def _read_utf8_coded(r: _BitReader) -> int:
    first = r.read(8)
    if first < 0x80:
        return first
    n_extra = 0
    mask = 0x40
    while first & mask:
        n_extra += 1
        mask >>= 1
    if n_extra == 0:
        raise FlacError("invalid UTF-8 coded number")
    value = first & (mask - 1)
    for _ in range(n_extra):
        b = r.read(8)
        if (b & 0xC0) != 0x80:
            raise FlacError("invalid UTF-8 continuation")
        value = (value << 6) | (b & 0x3F)
    return value


_BLOCKSIZE_CODES = {
    0b0001: 192,
    **{c: 576 << (c - 2) for c in range(2, 6)},
    **{c: 256 << (c - 8) for c in range(8, 16)},
}


def decode_flac(data: bytes) -> Tuple[np.ndarray, int]:
    """Decode a (subset) FLAC stream → (int16 samples, sample_rate).

    Verifies the frame-header CRC-8 and whole-frame CRC-16; raises
    :class:`FlacError` on corruption or on features outside the encoder's
    subset (multi-channel, LPC, non-16-bit)."""
    if data[:4] != b"fLaC":
        raise FlacError("missing fLaC marker")
    pos = 4
    sample_rate = None
    bps = None
    # Metadata blocks.
    while True:
        if pos + 4 > len(data):
            raise FlacError("truncated metadata")
        last = data[pos] & 0x80
        btype = data[pos] & 0x7F
        length = int.from_bytes(data[pos + 1 : pos + 4], "big")
        body = data[pos + 4 : pos + 4 + length]
        if btype == 0:
            r = _BitReader(body)
            r.read(16)  # min block
            r.read(16)  # max block
            r.read(24)
            r.read(24)
            sample_rate = r.read(20)
            channels = r.read(3) + 1
            bps = r.read(5) + 1
            if channels != 1:
                raise FlacError(f"unsupported channel count {channels}")
            if bps != 16:
                raise FlacError(f"unsupported bits-per-sample {bps}")
        pos += 4 + length
        if last:
            break
    if sample_rate is None:
        raise FlacError("missing STREAMINFO")

    out: List[np.ndarray] = []
    while pos < len(data):
        frame, pos = _decode_frame(data, pos, sample_rate)
        out.append(frame)
    samples = np.concatenate(out) if out else np.zeros(0, np.int16)
    return samples, sample_rate


def _decode_frame(data: bytes, pos: int, sample_rate: int) -> Tuple[np.ndarray, int]:
    r = _BitReader(data[pos:])
    sync = r.read(14)
    if sync != 0b11111111111110:
        raise FlacError(f"bad frame sync at byte {pos}")
    r.read(1)  # reserved
    r.read(1)  # blocking strategy
    bs_code = r.read(4)
    sr_code = r.read(4)
    chan = r.read(4)
    size_code = r.read(3)
    r.read(1)
    if chan != 0:
        raise FlacError("unsupported channel assignment")
    if size_code != 0b100:
        raise FlacError("unsupported sample size")
    _read_utf8_coded(r)
    if bs_code == 0b0110:
        block_size = r.read(8) + 1
    elif bs_code == 0b0111:
        block_size = r.read(16) + 1
    elif bs_code in _BLOCKSIZE_CODES:
        block_size = _BLOCKSIZE_CODES[bs_code]
    else:
        raise FlacError(f"unsupported block size code {bs_code}")
    if sr_code not in (0,):  # 0 = from STREAMINFO (all this encoder emits)
        raise FlacError(f"unsupported sample rate code {sr_code}")
    header_len = r.pos // 8
    if _crc8(data[pos : pos + header_len]) != data[pos + header_len]:
        raise FlacError("frame header CRC-8 mismatch")
    r.pos += 8  # CRC byte

    # Subframe.
    if r.read(1) != 0:
        raise FlacError("invalid subframe padding bit")
    stype = r.read(6)
    if r.read(1) != 0:
        raise FlacError("wasted bits unsupported")
    if stype == 0b000000:
        x = np.full(block_size, r.read_signed(16), np.int64)
    elif stype == 0b000001:
        x = np.array([r.read_signed(16) for _ in range(block_size)], np.int64)
    elif 0b001000 <= stype <= 0b001100:
        order = stype & 0x07
        warm = [r.read_signed(16) for _ in range(order)]
        method = r.read(2)
        if method != 0:
            raise FlacError("unsupported residual method")
        part_order = r.read(4)
        if part_order != 0:
            raise FlacError("unsupported partition order")
        k = r.read(4)
        if k == 0b1111:
            raise FlacError("escaped rice partitions unsupported")
        res = r.read_rice_block(block_size - order, k)
        # Invert the o-th finite difference by o cumulative integrations,
        # each seeded from the warmup samples' difference pyramid.
        warm_arr = np.asarray(warm, np.int64)
        x = res
        for lvl in range(order, 0, -1):
            # D^{lvl-1}x at index lvl-1: first element of the warmup's
            # (lvl-1)-th difference.
            seed = _fixed_residual(warm_arr, lvl - 1)[0]
            x = np.cumsum(np.concatenate(([seed], x)))
    else:
        raise FlacError(f"unsupported subframe type {stype:06b}")

    r.align()
    frame_len = r.pos // 8
    want = _crc16(data[pos : pos + frame_len])
    got = int.from_bytes(data[pos + frame_len : pos + frame_len + 2], "big")
    if want != got:
        raise FlacError("frame CRC-16 mismatch")
    end = pos + frame_len + 2
    if np.any(x < -32768) or np.any(x > 32767):
        raise FlacError("decoded sample out of int16 range")
    return x.astype(np.int16), end
