"""Preflight diagnostics (counterpart of ``go_pocket_tts_tpu/cli/doctor.py``;
`internal/doctor/doctor.go:60-183`).

Injected probe functions (replaced in tests), ✓/✗ lines, aggregated
failures, the reference's checks in the reference's order. Where the
reference probes its JAX backend, the port records two probes of the card:

- ``cuda backend``: the torch and CUDA versions, the device, its name and
  power limit as ``nvidia-smi`` gives them, and free/total memory; ✗ with no
  CUDA device;
- ``cuda kernels``: ``nvcc`` found and every ``csrc/*.cu`` library built for
  ``sm_90a`` (``kernels.build.build_all``) and loaded, in the library
  directory it names; ✗ with the build error.

The ``compile cache`` check probes ``runtime.compile_cache_dir``, which in
the port names that library directory (empty: the package's ``_build/``).
With ``--backend cli``, ``pocket-tts binary`` runs ``<exe> --version``, as
the reference does.
"""

from __future__ import annotations

import os
import subprocess
from copy import deepcopy
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, List, Optional, TextIO

from go_pocket_tts_tpu_torch.config import BACKEND_CLI, Config, apply_serving_autotune, normalize_backend

__all__ = ["DoctorResult", "run_doctor"]


@dataclass
class DoctorResult:
    ok: bool = True
    lines: List[str] = field(default_factory=list)
    failures: List[str] = field(default_factory=list)

    def record(self, name: str, ok: bool, detail: str = "") -> None:
        line = f"{'✓' if ok else '✗'} {name}" + (f" — {detail}" if detail else "")
        self.lines.append(line)
        if not ok:
            self.ok = False
            self.failures.append(name)


def _probe_cuda() -> str:
    import torch

    from go_pocket_tts_tpu_torch.device import card_line

    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device (torch {torch.__version__}, built for CUDA {torch.version.cuda})")
    free, total = torch.cuda.mem_get_info(0)
    return (
        f"torch {torch.__version__}, cuda {torch.version.cuda}, {torch.cuda.device_count()} device(s), "
        f"cuda:0 {torch.cuda.get_device_name(0)} [nvidia-smi: {card_line()}], "
        f"memory {free / 2**30:.1f}/{total / 2**30:.1f} GiB free"
    )


def _probe_kernels(cache_dir: str) -> str:
    from go_pocket_tts_tpu_torch.kernels import build

    if cache_dir:
        build.BUILD_DIR = Path(cache_dir)
    nvcc = build._nvcc()
    version = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60).stdout
    release = next((line.strip() for line in version.splitlines() if "release" in line), "version unknown")
    took = build.build_all()
    for name in build.SOURCES:
        build.library(name)
    libs = ", ".join(build._target(name).name for name in build.SOURCES)
    return (
        f"nvcc {nvcc} ({release}); {len(build.SOURCES)} libraries for sm_90a "
        f"({len(took)} built now) in {build.BUILD_DIR}: {libs}"
    )


def _probe_native() -> str:
    from go_pocket_tts_tpu_torch.native import audioio

    path = audioio.build()
    if audioio.load() is None:
        raise RuntimeError(f"{path.name} built but did not load")
    return f"{path.name} loaded"


def _probe_tokenizer_backend(tokenizer_path: str) -> tuple:
    """Which encode backend serving would use for this tokenizer file:
    ``(ok, detail)``. ✗ only when the model carries a precompiled charsmap
    the pure reader could not parse and the fast backend is unavailable:
    normalization then degrades to an NFKC approximation and non-ASCII text
    would tokenize differently from upstream."""
    try:
        import tokenizers  # noqa: F401

        have_fast = True
    except Exception:  # noqa: BLE001 - optional dependency
        have_fast = False

    from go_pocket_tts_tpu_torch.text.sentencepiece import load_tokenizer

    tok = load_tokenizer(tokenizer_path)
    has_charsmap = bool(tok.model.precompiled_charsmap)
    charsmap_err = tok.charsmap_error
    detail = (
        f"backend={tok.backend}, hf-tokenizers "
        f"{'importable' if have_fast else 'MISSING'}, "
        f"precompiled charsmap {'present' if has_charsmap else 'absent'}"
    )
    if tok.backend == "pure" and charsmap_err is not None:
        return False, detail + (
            f" — charsmap failed to parse ({charsmap_err}); normalization "
            "degrades to NFKC (non-ASCII text may mis-tokenize); install "
            "`tokenizers`"
        )
    return True, detail


def _probe_writable(directory: str) -> None:
    os.makedirs(directory, exist_ok=True)
    probe_path = os.path.join(directory, ".doctor-probe")
    with open(probe_path, "w") as f:
        f.write("ok")
    os.unlink(probe_path)


def run_doctor(
    cfg: Config,
    out: Optional[TextIO] = None,
    cuda_probe: Callable[[], str] = _probe_cuda,
    kernels_probe: Callable[[str], str] = _probe_kernels,
    native_probe: Callable[[], str] = _probe_native,
    tokenizer_probe: Callable[[str], tuple] = _probe_tokenizer_backend,
) -> DoctorResult:
    """Run every check, print the lines to ``out`` (if given) and return
    the result. ``kernels_probe`` takes ``runtime.compile_cache_dir``."""
    res = DoctorResult()

    try:
        res.record("cuda backend", True, cuda_probe())
    except Exception as exc:  # noqa: BLE001 - reported as a failed check
        res.record("cuda backend", False, str(exc))

    try:
        res.record("cuda kernels", True, kernels_probe(cfg.runtime.compile_cache_dir))
    except Exception as exc:  # noqa: BLE001 - reported as a failed check
        res.record("cuda kernels", False, str(exc))

    try:
        res.record("native helpers", True, native_probe())
    except Exception as exc:  # noqa: BLE001 - reported as a failed check
        res.record("native helpers", False, str(exc))

    # The kernel library directory: a wrong one means every process start
    # builds the kernels again (or fails to) — surface writability up front.
    from go_pocket_tts_tpu_torch.kernels import build

    cache_dir = cfg.runtime.compile_cache_dir or str(build.BUILD_DIR)
    try:
        _probe_writable(cache_dir)
        res.record("compile cache", True, f"{cache_dir} (writable)")
    except OSError as exc:
        res.record("compile cache", False, f"{cache_dir}: {exc}")

    # Voice upload (POST /voices): a bad dir or a no-voice-cloning
    # checkpoint would otherwise only surface as a 500 on the first upload.
    upload_dir = cfg.server.voice_upload_dir
    if upload_dir:
        try:
            _probe_writable(upload_dir)
            detail, ok = f"{upload_dir} (writable)", True
        except OSError as exc:
            detail, ok = f"{upload_dir}: {exc}", False
        if ok and os.path.exists(cfg.paths.model_path):
            try:
                from go_pocket_tts_tpu_torch.utils.safetensors import read_header

                header = read_header(cfg.paths.model_path)
                if not any(k.startswith("mimi.encoder.") for k in header):
                    ok = False
                    detail = "checkpoint has no Mimi encoder weights (voice cloning needs the full checkpoint)"
            except Exception as exc:  # noqa: BLE001 - reported as a failed check
                ok, detail = False, str(exc)
        res.record("voice upload", ok, detail)

    # External-binary probe for the cli backend (`cmd/pockettts/doctor.go:110-118`
    # runs `pocket-tts --version`).
    if normalize_backend(cfg.tts.backend) == BACKEND_CLI:
        exe = cfg.tts.cli_path or "pocket-tts"
        try:
            proc = subprocess.run([exe, "--version"], capture_output=True, timeout=10, text=True)
            version = (proc.stdout or proc.stderr).strip().splitlines()
            res.record("pocket-tts binary", proc.returncode == 0, version[0] if version else f"rc={proc.returncode}")
        except Exception as exc:  # noqa: BLE001 - reported as a failed check
            res.record("pocket-tts binary", False, f"{exe}: {exc}")

    model_ok = os.path.exists(cfg.paths.model_path)
    res.record("model file", model_ok, cfg.paths.model_path)
    if model_ok:
        try:
            from go_pocket_tts_tpu_torch.utils.safetensors import read_header_metadata, validate_model_keys

            validate_model_keys(cfg.paths.model_path)
            fmt = read_header_metadata(cfg.paths.model_path).get("pockettts.quantize", "")
            res.record("model keys", True, f"pre-quantized {fmt}" if fmt else "")
        except Exception as exc:  # noqa: BLE001 - reported as a failed check
            res.record("model keys", False, str(exc))

    tok_ok = os.path.exists(cfg.paths.tokenizer_model)
    res.record("tokenizer file", tok_ok, cfg.paths.tokenizer_model)
    if tok_ok:
        try:
            ok, detail = tokenizer_probe(cfg.paths.tokenizer_model)
            res.record("tokenizer backend", ok, detail)
        except Exception as exc:  # noqa: BLE001 - reported as a failed check
            res.record("tokenizer backend", False, str(exc))

    # Continuity sessions under batch serving carry KV history in each lane;
    # a small prompt capacity makes every chunk reset the session.
    if cfg.tts.continuity and cfg.runtime.batch_slots > 1:
        cap = cfg.runtime.batch_prompt_capacity
        ok = cap >= 256
        res.record(
            "continuity capacity",
            ok,
            f"batch_prompt_capacity={cap}"
            + (
                " (a session carries roughly capacity/(prompt bucket + chunk"
                " frames) chunks; >=512 recommended for multi-chunk sessions)"
                if ok
                else " — sessions will reset nearly every chunk; raise "
                "--runtime-batch-prompt-capacity (>=512 recommended)"
            ),
        )

    # What `serve` will switch to the batch-serving settings, so operators
    # see the effective configuration before traffic.
    if cfg.runtime.batch_slots > 1:
        changes = apply_serving_autotune(deepcopy(cfg))
        if changes:
            note = ""
            try:
                from go_pocket_tts_tpu_torch.utils.safetensors import read_header_metadata

                fmt = read_header_metadata(cfg.paths.model_path).get("pockettts.quantize", "")
                if fmt and any("runtime.quantize=" in c for c in changes):
                    # The weights arrive quantized: the artifact's width serves.
                    note = f" [checkpoint pre-quantized {fmt}: weight walk is a no-op]"
            except Exception:  # noqa: BLE001 - preview only; a missing file etc.
                pass
            res.record(
                "serving autotune",
                True,
                "serve will apply: "
                + "; ".join(changes)
                + " (explicit flags override; --runtime-autotune false disables)"
                + note,
            )
        else:
            res.record(
                "serving autotune",
                True,
                "no changes (all batch-serving knobs set explicitly or autotune disabled)",
            )

    if cfg.paths.voices_manifest and os.path.exists(cfg.paths.voices_manifest):
        try:
            from go_pocket_tts_tpu_torch.tts.voices import VoiceManager

            mgr = VoiceManager(cfg.paths.voices_manifest)
            res.record("voices manifest", True, f"{len(mgr.list_voices())} voices")
        except Exception as exc:  # noqa: BLE001 - reported as a failed check
            res.record("voices manifest", False, str(exc))
    else:
        res.record("voices manifest", True, "not configured (optional)")

    if out is not None:
        for line in res.lines:
            print(line, file=out)
        if not res.ok:
            print(f"\n{len(res.failures)} check(s) failed", file=out)
    return res
