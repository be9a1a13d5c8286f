"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with
``ctypes``.

Each ``csrc/<name>.cu`` compiles, on first use, into a shared library with a
plain C interface for ``sm_90a``; every source gets its own ``nvcc``
process and all of them start together. Libraries land in ``_build/``
(git-ignored) under a name that hashes the source, the shared ``*.cuh``
headers and the flags, so an edited source never loads a stale library. Nothing is built at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

__all__ = ["SOURCES", "NVCC_FLAGS", "build_all", "library", "build_log"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = (
    "decode_attention",
    "seanet_tail",
    "seanet_up2",
    "batched_decode_attention",
    "quantized_matmul",
    "int4_matmul",
    "layer_norm",
    "mamba2_step",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built on this host")


def _target(name: str) -> Path:
    # The shared headers count for every source: an edited header rebuilds.
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all() -> Dict[str, float]:
    """Compile every source that has no up-to-date library, one ``nvcc`` per
    source in parallel; returns seconds per source built (empty if all were
    current). Raises with the compiler's output if any build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name in SOURCES:
            target = _target(name)
            if target.exists():
                continue
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp,
                target,
                time.perf_counter(),
            )
        took = {}
        failed = []
        for name, (proc, tmp, target, t0) in procs.items():
            out, _ = proc.communicate()
            took[name] = time.perf_counter() - t0
            _logs[name] = out
            if proc.returncode != 0:
                failed.append(f"--- {name} (exit {proc.returncode}) ---\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, target)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        return took


def build_log(name: str) -> str:
    """The compiler's output (``-Xptxas -v`` register/shared-memory report)
    for a source built in this process, or '' if it was already current."""
    return _logs.get(name, "")


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    target = _target(name)
    if not target.exists():
        build_all()
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(target))
        return _libs[name]
