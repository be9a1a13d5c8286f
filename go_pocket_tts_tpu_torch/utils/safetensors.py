"""safetensors reader and writer (NumPy; counterpart of
``go_pocket_tts_tpu/utils/safetensors.py``).

Format: ``[8-byte LE header length][JSON header][raw tensor data]``, with an
optional ``__metadata__`` entry of string pairs. :class:`Store` parses and
validates a payload (offsets and shapes against the data, a 100 MiB header
limit, an optional ``key_mapper`` renaming, lenient or strict) with the
reference's checks and messages; :func:`read_header` and
:func:`validate_model_keys` read the header alone. The reader widens F16
and BF16 to float32 and keeps I64, I8 and U8 in their integer dtype (the
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
from collections.abc import Mapping as _MappingABC
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

__all__ = [
    "SafetensorsError",
    "Store",
    "open_store",
    "open_store_from_bytes",
    "load_bytes",
    "load_file",
    "read_header",
    "read_header_metadata",
    "validate_model_keys",
    "REQUIRED_MODEL_KEYS",
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

_DTYPE_SIZES = {"F32": 4, "F16": 2, "BF16": 2, "I64": 8, "I8": 1, "U8": 1}
_MAX_HEADER_BYTES = 100 * 1024 * 1024

Tensor = Union[np.ndarray, torch.Tensor]
# KeyMapper: name -> (mapped_name, keep)
KeyMapper = Callable[[str], Tuple[str, bool]]


class SafetensorsError(ValueError):
    """Raised for malformed safetensors payloads."""


@dataclass(frozen=True)
class _Entry:
    dtype: str
    shape: Tuple[int, ...]
    start: int
    end: int


def _bf16_to_f32(raw: bytes, n: int) -> np.ndarray:
    u16 = np.frombuffer(raw, dtype="<u2", count=n)
    return (u16.astype(np.uint32) << 16).view(np.float32).copy()


class Store(_MappingABC):
    """Parsed safetensors payload with validated entries, held in memory.

    A read-only mapping of (mapped) tensor name → decoded NumPy array, in
    header order, so it serves as the ``tensors`` argument of the loaders
    and the exporter; each tensor is decoded when it is read.
    ``key_mapper(name) → (mapped, keep)`` renames or drops tensors; with
    ``strict_remap`` a duplicate mapped name, or a mapper that drops every
    tensor, raises.
    """

    def __init__(self, data: bytes, key_mapper: Optional[KeyMapper] = None, strict_remap: bool = False) -> None:
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

        payload = data[8 + header_len :]
        self._payload = payload
        self._entries: Dict[str, _Entry] = {}
        self._metadata: Dict[str, str] = {}
        for name, raw_entry in header.items():
            if name == "__metadata__":
                if isinstance(raw_entry, dict):
                    self._metadata = {str(k): str(v) for k, v in raw_entry.items()}
                continue
            entry = self._parse_entry(name, raw_entry, len(payload))
            mapped = name
            if key_mapper is not None:
                mapped, keep = key_mapper(name)
                if not keep:
                    continue
                if mapped in self._entries and strict_remap:
                    raise SafetensorsError(f"safetensors: key mapper produced duplicate name {mapped!r}")
            self._entries[mapped] = entry
        if key_mapper is not None and strict_remap and not self._entries:
            raise SafetensorsError("safetensors: key mapper removed every tensor")

    @staticmethod
    def _parse_entry(name: str, raw_entry: object, payload_len: int) -> _Entry:
        if not isinstance(raw_entry, dict):
            raise SafetensorsError(f"safetensors: tensor {name!r} entry must be an object")
        dtype = str(raw_entry.get("dtype", "")).upper()
        if dtype not in _DTYPE_SIZES:
            raise SafetensorsError(f"safetensors: tensor {name!r} has unsupported dtype {dtype!r}")
        shape_raw = raw_entry.get("shape")
        if not isinstance(shape_raw, list) or any(not isinstance(d, int) or d < 0 for d in shape_raw):
            raise SafetensorsError(f"safetensors: tensor {name!r} has invalid shape")
        offsets = raw_entry.get("data_offsets")
        if (
            not isinstance(offsets, list)
            or len(offsets) != 2
            or any(not isinstance(o, int) or o < 0 for o in offsets)
        ):
            raise SafetensorsError(f"safetensors: tensor {name!r} has invalid data_offsets")
        start, end = offsets
        n_elems = int(np.prod(shape_raw, dtype=np.int64)) if shape_raw else 1
        want = n_elems * _DTYPE_SIZES[dtype]
        if end < start or end - start != want:
            raise SafetensorsError(
                f"safetensors: tensor {name!r} data range [{start},{end}) does not match "
                f"shape {shape_raw} dtype {dtype} ({want} bytes)"
            )
        if end > payload_len:
            raise SafetensorsError(
                f"safetensors: tensor {name!r} data range [{start},{end}) exceeds payload "
                f"size {payload_len}"
            )
        return _Entry(dtype=dtype, shape=tuple(shape_raw), start=start, end=end)

    # -- accessors ---------------------------------------------------------

    @property
    def metadata(self) -> Mapping[str, str]:
        return self._metadata

    def names(self) -> List[str]:
        return sorted(self._entries)

    def has(self, name: str) -> bool:
        return name in self._entries

    def shape(self, name: str) -> Tuple[int, ...]:
        return self._require(name).shape

    def dtype(self, name: str) -> str:
        return self._require(name).dtype

    def _require(self, name: str) -> _Entry:
        entry = self._entries.get(name)
        if entry is None:
            sample = ", ".join(self.names()[:8]) or "none"
            raise KeyError(f"safetensors: tensor {name!r} not found (have: {sample}, ...)")
        return entry

    def tensor(self, name: str) -> np.ndarray:
        """Decode a tensor to NumPy, widening F16/BF16 to float32; I64, I8
        and U8 keep their integer dtype."""
        entry = self._require(name)
        raw = self._payload[entry.start : entry.end]
        n = int(np.prod(entry.shape, dtype=np.int64)) if entry.shape else 1
        if entry.dtype == "F32":
            arr = np.frombuffer(raw, dtype="<f4", count=n).copy()
        elif entry.dtype == "F16":
            arr = np.frombuffer(raw, dtype="<f2", count=n).astype(np.float32)
        elif entry.dtype == "BF16":
            arr = _bf16_to_f32(raw, n)
        elif entry.dtype == "I64":
            arr = np.frombuffer(raw, dtype="<i8", count=n).copy()
        elif entry.dtype == "I8":
            arr = np.frombuffer(raw, dtype=np.int8, count=n).copy()
        else:  # "U8"; the dtype was checked in _parse_entry
            arr = np.frombuffer(raw, dtype=np.uint8, count=n).copy()
        return arr.reshape(entry.shape)

    def tensor_f32(self, name: str) -> np.ndarray:
        """Decode to float32 unconditionally (I64 is value-cast)."""
        return self.tensor(name).astype(np.float32, copy=False)

    # -- the mapping of name → decoded tensor --------------------------------

    def __getitem__(self, name: str) -> np.ndarray:
        return self.tensor(name)

    def __contains__(self, name: object) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)


def open_store(path: str | os.PathLike, **kwargs) -> Store:
    with open(path, "rb") as f:
        return Store(f.read(), **kwargs)


def open_store_from_bytes(data: bytes, **kwargs) -> Store:
    return Store(data, **kwargs)


def load_bytes(data: bytes) -> Dict[str, np.ndarray]:
    """Decode every tensor of a safetensors payload, in header order."""
    return dict(Store(data).items())


def load_file(path: str | os.PathLike) -> Dict[str, np.ndarray]:
    return dict(open_store(path).items())


def read_header(path: str | os.PathLike) -> dict:
    """The raw header dict (tensor name → {dtype, shape, data_offsets}, plus
    ``__metadata__``), reading the header alone: instant on multi-GB
    files. Used by ``model dump-header``."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) < 8:
            raise SafetensorsError("safetensors: file too small for header length")
        (header_len,) = struct.unpack("<Q", head)
        if header_len > _MAX_HEADER_BYTES:
            raise SafetensorsError(f"safetensors: header length {header_len} exceeds {_MAX_HEADER_BYTES} limit")
        header_raw = f.read(header_len)
    if len(header_raw) != header_len:
        raise SafetensorsError("safetensors: truncated header")
    return json.loads(header_raw.decode("utf-8"))


def read_header_metadata(path: str | os.PathLike) -> Dict[str, str]:
    """The ``__metadata__`` entry of a file, reading only its header."""
    meta = read_header(path).get("__metadata__")
    if not isinstance(meta, dict):
        return {}
    return {str(k): str(v) for k, v in meta.items()}


# The keys the loader requires, by the loader's own names (the reference's
# ValidateModelKeys list uses another naming scheme than its VarBuilder
# paths; the VarBuilder paths are the ground truth).
REQUIRED_MODEL_KEYS = (
    "flow_lm.conditioner.embed.weight",
    "flow_lm.transformer.layers.0.self_attn.in_proj.weight",
    "flow_lm.flow_net.input_proj.weight",
    "flow_lm.bos_emb",
    "mimi.quantizer.output_proj.weight",
    "mimi.decoder.model.0.conv.weight",
)


def validate_model_keys(path: str | os.PathLike, required: Sequence[str] = REQUIRED_MODEL_KEYS) -> None:
    """Header-only presence check of the required model tensors."""
    header = read_header(path)
    missing = [k for k in required if k not in header]
    if missing:
        raise SafetensorsError(f"safetensors: missing required tensors: {missing}")


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
