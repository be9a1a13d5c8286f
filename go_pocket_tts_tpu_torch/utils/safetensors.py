"""Minimal read-only safetensors reader (NumPy).

Format: ``[8-byte LE header length][JSON header][raw tensor data]``. Reads
F32, F16 and BF16 (widened to float32) and I64; enough for float
checkpoints. The reference package's full reader/writer (voice files,
quantized artifacts) is not ported yet.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Dict

import numpy as np

__all__ = ["SafetensorsError", "load_bytes", "load_file"]

_DTYPES = {"F32": ("<f4", 4), "F16": ("<f2", 2), "BF16": ("<u2", 2), "I64": ("<i8", 8)}


class SafetensorsError(ValueError):
    """Raised for malformed safetensors payloads."""


def load_bytes(data: bytes) -> Dict[str, np.ndarray]:
    """Decode every tensor of a safetensors payload."""
    if len(data) < 8:
        raise SafetensorsError("safetensors: payload too small for header length")
    (header_len,) = struct.unpack_from("<Q", data, 0)
    if 8 + header_len > len(data):
        raise SafetensorsError("safetensors: header length exceeds payload size")
    try:
        header = json.loads(data[8 : 8 + header_len].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise SafetensorsError(f"safetensors: invalid JSON header: {exc}") from exc
    payload = memoryview(data)[8 + header_len :]
    out: Dict[str, np.ndarray] = {}
    for name, entry in header.items():
        if name == "__metadata__":
            continue
        dtype = str(entry.get("dtype", "")).upper()
        if dtype not in _DTYPES:
            raise SafetensorsError(f"safetensors: tensor {name!r} has unsupported dtype {dtype!r}")
        np_dtype, size = _DTYPES[dtype]
        shape = tuple(entry["shape"])
        start, end = entry["data_offsets"]
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if end - start != n * size or end > len(payload):
            raise SafetensorsError(f"safetensors: tensor {name!r} has a bad data range")
        raw = np.frombuffer(payload[start:end], dtype=np_dtype, count=n)
        if dtype == "BF16":
            arr = (raw.astype(np.uint32) << 16).view(np.float32)
        elif dtype == "F16":
            arr = raw.astype(np.float32)
        else:
            arr = raw.copy()
        out[name] = arr.reshape(shape)
    return out


def load_file(path: str | os.PathLike) -> Dict[str, np.ndarray]:
    with open(path, "rb") as f:
        return load_bytes(f.read())
