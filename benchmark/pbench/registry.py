"""Finding the benchmark's parts by name: ``configs/<name>.json``,
``workloads/<name>.json``, ``metrics/<name>.py`` and
``references/<name>.py`` under the benchmark's folder, and the cell's
entries in ``BENCHMARK.json`` beside it. Nothing here knows a cell, a
configuration or a metric: a new one is a new file and a new entry.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
from pathlib import Path
from types import ModuleType
from typing import Dict, List

__all__ = [
    "BenchError",
    "card_line",
    "cell_metrics",
    "load_config",
    "load_metric",
    "load_reference",
    "load_spec",
    "load_workload",
    "use_build_dirs",
]


class BenchError(Exception):
    """A benchmark that cannot run as asked (a missing part, no card)."""


def _json(path: Path, what: str, name: str) -> Dict:
    if not path.is_file():
        raise BenchError(f"no {what} named {name!r}: {path} does not exist")
    with open(path) as f:
        return json.load(f)


def _module(path: Path, what: str, name: str) -> ModuleType:
    if not path.is_file():
        raise BenchError(f"no {what} named {name!r}: {path} does not exist")
    mod_name = f"pbench_{what}_" + "".join(c if c.isalnum() else "_" for c in name)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(path: Path) -> Dict:
    return _json(Path(path), "benchmark description", str(path))


def load_workload(root: Path, name: str) -> Dict:
    w = _json(Path(root) / "workloads" / f"{name}.json", "workload", name)
    w.setdefault("name", name)
    return w


def load_config(root: Path, name: str) -> Dict:
    c = _json(Path(root) / "configs" / f"{name}.json", "configuration", name)
    c.setdefault("name", name)
    return c


def load_metric(root: Path, name: str):
    """The reader of metric ``name``: ``read(run) -> float | None``."""
    mod = _module(Path(root) / "metrics" / f"{name}.py", "metric", name)
    if not callable(getattr(mod, "read", None)):
        raise BenchError(f"metric {name!r}: {mod.__file__} has no read(run)")
    return mod.read


def load_reference(root: Path, name: str) -> ModuleType:
    return _module(Path(root) / "references" / f"{name}.py", "reference", name)


def cell_metrics(spec: Dict, cell: str, trace: bool) -> List[Dict]:
    """The entries of the metrics a run of ``cell`` reports: its end-to-end
    metrics, or with ``trace`` its per-layer ones; a metric with a
    ``workloads`` list belongs to those cells only."""
    kind = "per_layer" if trace else "end_to_end"
    return [m for m in spec.get(kind, []) if "workloads" not in m or cell in m["workloads"]]


def cell_entry(spec: Dict, cell: str) -> Dict:
    for w in spec.get("workloads", []):
        if w["name"] == cell:
            return w
    raise BenchError(f"no workload named {cell!r} in BENCHMARK.json")


def use_build_dirs() -> Dict[str, str]:
    """Keep every build and kernel cache of the program inside the
    benchmark's folder of the checkout, at fixed paths: the port's CUDA
    libraries (``kernels/build.py``), Triton's and PyTorch's extension
    caches."""
    root = Path(__file__).resolve().parent.parent
    dirs = {
        "kernels": root / "_build" / "kernels",
        "TRITON_CACHE_DIR": root / "_build" / "triton",
        "TORCH_EXTENSIONS_DIR": root / "_build" / "torch_extensions",
    }
    for d in dirs.values():
        d.mkdir(parents=True, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = str(dirs["TRITON_CACHE_DIR"])
    os.environ["TORCH_EXTENSIONS_DIR"] = str(dirs["TORCH_EXTENSIONS_DIR"])
    from go_pocket_tts_tpu_torch.kernels import build

    build.BUILD_DIR = dirs["kernels"]
    return {k: str(v) for k, v in dirs.items()}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"
