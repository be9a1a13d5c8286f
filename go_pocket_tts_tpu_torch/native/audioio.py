"""ctypes loader of ``audioio.cpp`` (counterpart of the reference package's
``native/audioio.py``), with its build on first use.

The library is compiled by ``g++`` into ``go_pocket_tts_tpu_torch/_build/``
under a name that hashes the source and the flags, so an edited source never
loads a stale library, and nothing is written into the source tree.
Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["CXX_FLAGS", "SOURCE", "build", "load", "library_path"]

SOURCE = Path(__file__).resolve().parent / "audioio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lock = threading.Lock()
_loaded: Optional["_AudioIO"] = None
_load_failed = False


class _AudioIO:
    def __init__(self, lib: ctypes.CDLL) -> None:
        self._lib = lib
        lib.pcm16_from_f32.restype = ctypes.c_size_t
        lib.pcm16_from_f32.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int16), ctypes.c_size_t]
        lib.peak_abs_f32.restype = ctypes.c_float
        lib.peak_abs_f32.argtypes = [ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
        lib.f32_from_pcm16.restype = ctypes.c_size_t
        lib.f32_from_pcm16.argtypes = [ctypes.POINTER(ctypes.c_int16), ctypes.POINTER(ctypes.c_float), ctypes.c_size_t]
        lib.biquad_df1_f32.restype = ctypes.c_size_t
        lib.biquad_df1_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_size_t,
        ] + [ctypes.c_double] * 5
        lib.crc16_8005.restype = ctypes.c_uint16
        lib.crc16_8005.argtypes = [ctypes.c_char_p, ctypes.c_size_t]

    def pcm16_from_f32(self, samples: np.ndarray) -> bytes:
        src = np.ascontiguousarray(samples, dtype=np.float32)
        out = np.empty(src.size, dtype=np.int16)
        self._lib.pcm16_from_f32(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            src.size,
        )
        return out.tobytes()

    def peak_abs(self, samples: np.ndarray) -> float:
        src = np.ascontiguousarray(samples, dtype=np.float32)
        return float(self._lib.peak_abs_f32(src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), src.size))

    def f32_from_pcm16(self, pcm: np.ndarray) -> np.ndarray:
        src = np.ascontiguousarray(pcm, dtype=np.int16)
        out = np.empty(src.size, dtype=np.float32)
        self._lib.f32_from_pcm16(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            src.size,
        )
        return out

    def crc16_8005(self, data: bytes) -> int:
        return int(self._lib.crc16_8005(data, len(data)))

    def biquad_df1(self, samples: np.ndarray, b0: float, b1: float, b2: float, a1: float, a2: float) -> np.ndarray:
        src = np.ascontiguousarray(samples, dtype=np.float32)
        out = np.empty(src.size, dtype=np.float32)
        self._lib.biquad_df1_f32(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            src.size,
            b0,
            b1,
            b2,
            a1,
            a2,
        )
        return out


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libaudioio-{digest}.so"


def build() -> Path:
    """Compile the library with ``g++`` unless it is current; returns its
    path. Raises with the compiler's output when the build fails."""
    target = library_path()
    if target.exists():
        return target
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native audio helper cannot be built on this host")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)], capture_output=True, text=True, timeout=120
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)
    return target


def load() -> Optional[_AudioIO]:
    """The loaded helper, building it if needed; ``None`` when it cannot be
    built or loaded (the callers then take their NumPy paths)."""
    global _loaded, _load_failed
    if _loaded is not None or _load_failed:
        return _loaded
    with _lock:
        if _loaded is None and not _load_failed:
            try:
                _loaded = _AudioIO(ctypes.CDLL(str(build())))
            except (OSError, RuntimeError, subprocess.SubprocessError, AttributeError):
                _load_failed = True
        return _loaded
