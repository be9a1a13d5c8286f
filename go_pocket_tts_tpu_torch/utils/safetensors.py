"""safetensors reader and writer (NumPy; counterpart of the tensor and
voice-file parts of ``go_pocket_tts_tpu/utils/safetensors.py``).

Format: ``[8-byte LE header length][JSON header][raw tensor data]``, with an
optional ``__metadata__`` entry of string pairs. The reader widens F16 and
BF16 to float32 and keeps I64, I8 and U8 in their integer dtype (the
pre-quantized checkpoints store int8 weights as I8 and packed int4 weights
as U8). The writer stores F32, BF16, I64, I8 and U8 and produces the same
bytes as the reference writer for the same tensors.

BF16 has no NumPy dtype without ``ml_dtypes``, which the port does not
need: a ``torch.bfloat16`` tensor is written as BF16 (its bit pattern is
the round-to-nearest-even top half of the float32).
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Mapping, Optional, Union

import numpy as np
import torch

__all__ = [
    "SafetensorsError",
    "load_bytes",
    "load_file",
    "read_header_metadata",
    "encode_tensors",
    "write_file",
    "pack_nibbles",
    "unpack_nibbles",
    "VoiceFileKind",
    "VoiceModelState",
    "inspect_voice_file",
    "inspect_voice_file_bytes",
    "load_voice_embedding",
    "load_voice_embedding_from_bytes",
    "load_voice_model_state",
    "load_voice_model_state_from_bytes",
]

_DTYPES = {
    "F32": ("<f4", 4),
    "F16": ("<f2", 2),
    "BF16": ("<u2", 2),
    "I64": ("<i8", 8),
    "I8": ("i1", 1),
    "U8": ("u1", 1),
}
_MAX_HEADER_BYTES = 100 * 1024 * 1024

Tensor = Union[np.ndarray, torch.Tensor]


class SafetensorsError(ValueError):
    """Raised for malformed safetensors payloads."""


def _parse_header(data: bytes) -> tuple:
    if len(data) < 8:
        raise SafetensorsError("safetensors: payload too small for header length")
    (header_len,) = struct.unpack_from("<Q", data, 0)
    if header_len > _MAX_HEADER_BYTES:
        raise SafetensorsError(f"safetensors: header length {header_len} exceeds {_MAX_HEADER_BYTES} limit")
    if 8 + header_len > len(data):
        raise SafetensorsError("safetensors: header length exceeds payload size")
    try:
        header = json.loads(data[8 : 8 + header_len].decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as exc:
        raise SafetensorsError(f"safetensors: invalid JSON header: {exc}") from exc
    if not isinstance(header, dict):
        raise SafetensorsError("safetensors: header must be a JSON object")
    return header, 8 + header_len


def load_bytes(data: bytes) -> Dict[str, np.ndarray]:
    """Decode every tensor of a safetensors payload."""
    header, start_of_data = _parse_header(data)
    payload = memoryview(data)[start_of_data:]
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


def read_header_metadata(path: str | os.PathLike) -> Dict[str, str]:
    """The ``__metadata__`` entry of a file, reading only its header."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise SafetensorsError("safetensors: file too small for header length")
        (header_len,) = struct.unpack("<Q", head)
        if header_len > _MAX_HEADER_BYTES:
            raise SafetensorsError(f"safetensors: header length {header_len} exceeds {_MAX_HEADER_BYTES} limit")
        header, _ = _parse_header(head + f.read(header_len))
    meta = header.get("__metadata__")
    if not isinstance(meta, dict):
        return {}
    return {str(k): str(v) for k, v in meta.items()}


def _encode_one(arr: Tensor) -> tuple:
    """``(dtype string, little-endian bytes)`` of one tensor, with the
    reference writer's rules: int64 → I64, int8 → I8, uint8 → U8, bfloat16
    → BF16, anything else → F32."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return "BF16", t.view(torch.int16).numpy().astype("<i2").tobytes()
        arr = t.numpy()
    a = np.asarray(arr)
    if a.dtype == np.int64:
        return "I64", a.astype("<i8").tobytes(order="C")
    if a.dtype == np.int8:
        return "I8", a.tobytes(order="C")
    if a.dtype == np.uint8:
        return "U8", a.tobytes(order="C")
    return "F32", a.astype("<f4").tobytes(order="C")


def encode_tensors(tensors: Mapping[str, Tensor], metadata: Optional[Mapping[str, str]] = None) -> bytes:
    """Encode named tensors (NumPy arrays, or torch tensors) as a
    safetensors payload, in the mapping's order; ``metadata`` becomes the
    ``__metadata__`` entry (string to string)."""
    if not tensors:
        raise SafetensorsError("safetensors: no tensors to encode")
    header: Dict[str, dict] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    blobs: List[bytes] = []
    offset = 0
    for name, arr in tensors.items():
        dtype, blob = _encode_one(arr)
        header[name] = {
            "dtype": dtype,
            "shape": [int(d) for d in arr.shape],
            "data_offsets": [offset, offset + len(blob)],
        }
        blobs.append(blob)
        offset += len(blob)
    header_bytes = json.dumps(header, separators=(",", ":")).encode("utf-8")
    return struct.pack("<Q", len(header_bytes)) + header_bytes + b"".join(blobs)


def write_file(
    path: str | os.PathLike, tensors: Mapping[str, Tensor], metadata: Optional[Mapping[str, str]] = None
) -> None:
    payload = encode_tensors(tensors, metadata=metadata)
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


# -- int4 nibble packing of the pre-quantized checkpoints ---------------------
#
# Two two's-complement nibbles per byte along the last axis, the low nibble
# holding the even index.


def pack_nibbles(q: np.ndarray) -> np.ndarray:
    """``[..., n]`` int8 in [-8, 7] → ``[..., n/2]`` uint8."""
    if q.shape[-1] % 2 != 0:
        raise ValueError(f"cannot nibble-pack odd last dim {q.shape}")
    u = q.astype(np.uint8) & 0x0F
    return (u[..., 0::2] | (u[..., 1::2] << 4)).astype(np.uint8)


def unpack_nibbles(packed: np.ndarray) -> np.ndarray:
    """``[..., n/2]`` uint8 → ``[..., n]`` int8 in [-8, 7]."""
    low = ((packed & 0x0F).astype(np.int8) ^ 0x8) - 0x8
    high = ((packed >> 4).astype(np.int8) ^ 0x8) - 0x8
    out = np.empty(packed.shape[:-1] + (packed.shape[-1] * 2,), dtype=np.int8)
    out[..., 0::2] = low
    out[..., 1::2] = high
    return out


# -- voice files ----------------------------------------------------------
#
# A voice file is either a legacy prompt embedding (``audio_prompt`` or the
# first tensor, ``[T, D]`` or ``[1, T, D]``) or upstream model state: per
# module ``<module>/cache`` ``[2, B, T, H, Dh]`` and ``<module>/offset``
# (older files name the offset ``current_end``; its first dimension is the
# offset). Tensors are read as float32.


class VoiceFileKind:
    UNKNOWN = "unknown"
    EMBEDDING = "embedding"
    MODEL_STATE = "model_state"


@dataclass
class VoiceModelState:
    """Upstream voice model state: ``modules[module][key]`` with key
    ``cache`` ``[2, B, T, H, Dh]`` or ``offset``, as float32 NumPy arrays."""

    modules: Dict[str, Dict[str, np.ndarray]] = field(default_factory=dict)


def _is_model_state_tensor_name(name: str) -> bool:
    slash = name.rfind("/")
    if slash <= 0 or slash == len(name) - 1:
        return False
    return name[slash + 1 :] in ("cache", "offset", "current_end")


def _classify_voice_tensor_names(names: Iterable[str]) -> str:
    names = list(names)
    if any(_is_model_state_tensor_name(n) for n in names):
        return VoiceFileKind.MODEL_STATE
    return VoiceFileKind.EMBEDDING if names else VoiceFileKind.UNKNOWN


def _read(path: str | os.PathLike) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _voice_tensors(data: bytes) -> Dict[str, np.ndarray]:
    """Every tensor of a voice file as float32, in name order."""
    tensors = load_bytes(data)
    return {name: tensors[name].astype(np.float32, copy=False) for name in sorted(tensors)}


def inspect_voice_file_bytes(data: bytes) -> str:
    return _classify_voice_tensor_names(load_bytes(data))


def inspect_voice_file(path: str | os.PathLike) -> str:
    return inspect_voice_file_bytes(_read(path))


def load_voice_embedding_from_bytes(data: bytes) -> np.ndarray:
    """A legacy voice embedding as float32 ``[1, T, D]``."""
    tensors = _voice_tensors(data)
    if _classify_voice_tensor_names(tensors) == VoiceFileKind.MODEL_STATE:
        raise SafetensorsError(
            "safetensors: voice file contains upstream model state, not a legacy audio_prompt embedding"
        )
    if not tensors:
        raise SafetensorsError("safetensors: no tensors found")
    arr = tensors["audio_prompt"] if "audio_prompt" in tensors else next(iter(tensors.values()))
    if arr.ndim == 2:
        return arr[None, :, :]
    if arr.ndim == 3:
        return arr
    raise SafetensorsError(f"safetensors: voice embedding has {arr.ndim}D shape {arr.shape}, expected 2D or 3D")


def load_voice_embedding(path: str | os.PathLike) -> np.ndarray:
    return load_voice_embedding_from_bytes(_read(path))


def load_voice_model_state_from_bytes(data: bytes) -> VoiceModelState:
    tensors = _voice_tensors(data)
    kind = _classify_voice_tensor_names(tensors)
    if kind != VoiceFileKind.MODEL_STATE:
        raise SafetensorsError(f"safetensors: voice file kind {kind!r} is not upstream model state")
    state = VoiceModelState()
    for name, arr in tensors.items():
        slash = name.rfind("/")
        if slash <= 0 or slash == len(name) - 1:
            raise SafetensorsError(f"safetensors: invalid model-state tensor name {name!r}")
        module_name, key = name[:slash], name[slash + 1 :]
        if key == "current_end":
            key = "offset"
            arr = np.array([float(arr.shape[0] if arr.ndim else 0)], dtype=np.float32)
        state.modules.setdefault(module_name, {})[key] = arr
    return state


def load_voice_model_state(path: str | os.PathLike) -> VoiceModelState:
    return load_voice_model_state_from_bytes(_read(path))
