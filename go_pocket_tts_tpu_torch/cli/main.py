"""CLI entry point of the port (counterpart of the reference package's
``cli/main.py``).

Subcommands: ``synth`` (``--tts-arg k=v`` with ``--backend cli``),
``serve`` (with ``--voice-upload-dir``, ``POST /voices``),
``export-voice``, ``bench``, ``stageprof``, ``doctor``, ``health``,
``model download|download-bundle|verify|dump-header|export`` and
``voice download``, with the reference's option names and defaults. Run via
``python -m go_pocket_tts_tpu_torch <cmd> ...`` or ``pockettts-gpu <cmd>``.

Every subcommand loads flags > env (``POCKETTTS_*``) > config file >
defaults before running (`cmd/pockettts/root.go:24-38`).
``POCKETTTS_PLATFORM`` sets the device: ``cpu`` runs the plain PyTorch
versions of the kernels on the CPU; unset, ``gpu`` or ``cuda`` runs on the
card, and fails on a host without CUDA. ``model export``, ``dump-header``,
the downloads and ``doctor``'s file checks run on the host alone.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
from typing import List, Optional

import numpy as np

from go_pocket_tts_tpu_torch.config import (
    BACKEND_CLI,
    Config,
    _parse_bool,
    apply_serving_autotune,
    load_config,
    normalize_backend,
    register_flags,
)
from go_pocket_tts_tpu_torch.utils import dsp, wav

log = logging.getLogger("pockettts")

_LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "error": logging.ERROR,
}


def _setup_logging(level: str) -> None:
    if level not in _LOG_LEVELS:
        raise SystemExit(f"unknown log level {level!r} (want debug|info|warn|error)")
    logging.basicConfig(
        stream=sys.stderr,
        level=_LOG_LEVELS[level],
        format='{"time":"%(asctime)s","level":"%(levelname)s","logger":"%(name)s","msg":%(message)r}',
    )


def platform_device() -> str:
    """The device ``POCKETTTS_PLATFORM`` names: ``cpu``, else ``cuda``."""
    platform = os.environ.get("POCKETTTS_PLATFORM", "").strip().lower()
    if platform == "cpu":
        return "cpu"
    if platform in ("", "gpu", "cuda"):
        return "cuda"
    raise ValueError(f"POCKETTTS_PLATFORM={platform!r} is not supported (want cpu, gpu or cuda)")


def _load_config(args) -> Config:
    cfg = load_config(args)
    cfg.runtime.device = platform_device()
    return cfg


def _build_service(cfg: Config):
    from go_pocket_tts_tpu_torch.tts.service import Service

    return Service.from_config(cfg)


def _resolve_voice(cfg: Config, voice: str) -> str:
    """Voice ID → path via manifest; else treat as a path; graceful skip when
    missing (`cmd/pockettts/synth.go:438-476`)."""
    if not voice:
        return ""
    if os.path.exists(voice):
        return voice
    if cfg.paths.voices_manifest and os.path.exists(cfg.paths.voices_manifest):
        from go_pocket_tts_tpu_torch.tts.voices import VoiceManager

        try:
            return VoiceManager(cfg.paths.voices_manifest).resolve_path(voice)
        except (KeyError, FileNotFoundError) as exc:
            log.warning("voice %r unavailable (%s); synthesizing without voice", voice, exc)
            return ""
    log.warning("voice %r not found; synthesizing without voice", voice)
    return ""


# -- synth -------------------------------------------------------------------


def cmd_synth(args) -> int:
    cfg = _load_config(args)
    _setup_logging(cfg.log_level)

    tts_args = getattr(args, "tts_arg", None) or []
    if tts_args:
        # Pass-through flags reach the wrapped binary only
        # (`cmd/pockettts/synth.go:173-174` errors identically); a malformed
        # item is a clean rc=2 error here, not a traceback out of Service
        # construction.
        if normalize_backend(cfg.tts.backend) != BACKEND_CLI:
            print("error: --tts-arg is only supported with --backend cli", file=sys.stderr)
            return 2
        from go_pocket_tts_tpu_torch.tts.runtime_cli import build_passthrough_args

        try:
            build_passthrough_args(tts_args)
        except ValueError as exc:
            print(f"error: {exc}", file=sys.stderr)
            return 2
        cfg.tts.cli_args = list(tts_args)

    text = args.text
    if not text or text == "-":
        text = sys.stdin.read()
    if not text or not text.strip():
        print("error: --text is required (or provide text on stdin)", file=sys.stderr)
        return 2

    from go_pocket_tts_tpu_torch.text import chunk_by_sentence, normalize

    text = normalize(text)
    voice_path = _resolve_voice(cfg, args.voice or cfg.tts.voice)

    svc = _build_service(cfg)
    try:
        pieces: List[str] = chunk_by_sentence(text, args.max_chunk_chars) if args.chunk else [text]
        samples = np.concatenate([svc.synthesize(p, voice_path) for p in pieces])
    finally:
        svc.close()

    # Opt-in DSP post chain (`cmd/pockettts/synth.go:361-390`).
    if args.normalize or args.peak_normalize:
        samples = dsp.peak_normalize(samples, args.peak_normalize or 0.95)
    if args.dc_block:
        samples = dsp.dc_block(samples)
    if args.fade_in_ms:
        samples = dsp.fade_in(samples, ms=args.fade_in_ms)
    if args.fade_out_ms:
        samples = dsp.fade_out(samples, ms=args.fade_out_ms)

    fmt = args.format or ("flac" if args.out.lower().endswith(".flac") else "wav")
    if fmt == "flac":
        from go_pocket_tts_tpu_torch.utils.flac import encode_flac

        data = encode_flac(samples)
    else:
        data = wav.encode_wav(samples)
    if args.out == "-":
        sys.stdout.buffer.write(data)
    else:
        with open(args.out, "wb") as f:
            f.write(data)
        log.info("wrote %d bytes (%0.2fs audio) to %s", len(data), len(samples) / 24000, args.out)
    return 0


# -- serve -------------------------------------------------------------------


def cmd_serve(args) -> int:
    cfg = _load_config(args)
    _setup_logging(cfg.log_level)
    # The reference's batch-serving settings become the effective defaults
    # at batch_slots > 1; explicit flags override.
    for change in apply_serving_autotune(cfg):
        log.info("autotune: %s (explicit flags override; --runtime-autotune false disables)", change)
    from go_pocket_tts_tpu_torch.server import Server

    voices = None
    if cfg.paths.voices_manifest and os.path.exists(cfg.paths.voices_manifest):
        from go_pocket_tts_tpu_torch.tts.voices import VoiceManager

        voices = VoiceManager(cfg.paths.voices_manifest)

    svc = _build_service(cfg)
    if args.prewarm:
        log.info("prewarming shape buckets...")
        voice_paths = []
        if voices is not None:
            for v in voices.list_voices():
                try:
                    voice_paths.append(voices.resolve_path(v.id))
                except (KeyError, FileNotFoundError) as exc:
                    log.warning("prewarm: voice %r unavailable (%s)", v.id, exc)
        svc.prewarm(voice_paths=voice_paths)
    uploader = None
    if cfg.server.voice_upload_dir:
        # Runtime voice cloning (POST /voices): uploads encode through the
        # Mimi encoder on the service's device, land in this directory,
        # register with the live voice list, and prewarm when the server
        # itself prewarmed.
        from go_pocket_tts_tpu_torch.tts.voice_upload import VoiceUploader
        from go_pocket_tts_tpu_torch.tts.voices import VoiceManager

        if voices is None:
            voices = VoiceManager.in_memory(cfg.server.voice_upload_dir)
        uploader = VoiceUploader(
            model_path=cfg.paths.model_path,
            upload_dir=cfg.server.voice_upload_dir,
            voices=voices,
            service=svc,
            max_audio_bytes=cfg.server.max_voice_audio_bytes,
            prewarm=bool(args.prewarm),
            device=cfg.runtime.device,
        )
        log.info("voice upload enabled: dir=%s", cfg.server.voice_upload_dir)
    # With continuous batching, request concurrency should cover the slots —
    # the semaphore otherwise starves the batch.
    workers = max(cfg.server.workers, cfg.runtime.batch_slots)
    srv = Server(
        svc,
        voices,
        listen_addr=cfg.server.listen_addr,
        workers=workers,
        max_text_bytes=cfg.server.max_text_bytes,
        request_timeout=cfg.server.request_timeout_secs,
        shutdown_timeout=cfg.server.shutdown_timeout_secs,
        voice_uploader=uploader,
    )
    log.info("serving on %s (backend=%s device=%s)", cfg.server.listen_addr, cfg.tts.backend, cfg.runtime.device)

    # Graceful SIGTERM drain (`cmd/pockettts/serve.go:38-44`).
    def _term(_sig, _frm):
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        srv.serve_forever()
    finally:
        svc.close()
    return 0


# -- export-voice ------------------------------------------------------------


def cmd_export_voice(args) -> int:
    cfg = _load_config(args)
    _setup_logging(cfg.log_level)
    from go_pocket_tts_tpu_torch.tts.voice_export import export_voice_embedding, export_voice_model_state

    if args.format == "model-state":
        frames = export_voice_model_state(
            model_path=cfg.paths.model_path, input_audio=args.input, output_path=args.output, device=cfg.runtime.device
        )
    else:
        out = export_voice_embedding(
            model_path=cfg.paths.model_path, input_audio=args.input, output_path=args.output, device=cfg.runtime.device
        )
        frames = out.shape[1]
    print(json.dumps({"output": args.output, "frames": frames, "format": args.format}))
    print(
        json.dumps({"suggested_manifest_entry": {"id": args.voice_id or "custom", "path": args.output, "license": ""}})
    )
    return 0


# -- bench / stageprof --------------------------------------------------------


def cmd_bench(args) -> int:
    cfg = _load_config(args)
    _setup_logging(cfg.log_level)
    from go_pocket_tts_tpu_torch.bench import check_rtf_threshold, format_json, format_table, run_bench

    svc = _build_service(cfg)
    try:
        stats = run_bench(
            svc,
            args.text,
            runs=args.runs,
            voice_path=_resolve_voice(cfg, args.voice or cfg.tts.voice),
            include_cold=not args.no_cold,
        )
    finally:
        svc.close()
    print(format_json(stats) if args.json else format_table(stats))
    try:
        check_rtf_threshold(stats, args.rtf_threshold)
    except RuntimeError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 1
    return 0


def cmd_stageprof(args) -> int:
    cfg = _load_config(args)
    _setup_logging(cfg.log_level)
    from go_pocket_tts_tpu_torch.bench.stageprof import profile_synthesis

    svc = _build_service(cfg)
    try:
        prof = profile_synthesis(
            svc,
            args.text,
            voice_path=_resolve_voice(cfg, args.voice or cfg.tts.voice),
            trace_dir=args.trace_dir or None,
        )
    finally:
        svc.close()
    print(prof.format_table())
    if prof.trace_path:
        log.info("wrote the Chrome trace %s", prof.trace_path)
    return 0


# -- doctor / health ---------------------------------------------------------


def cmd_doctor(args) -> int:
    cfg = _load_config(args)
    _setup_logging(cfg.log_level)
    from go_pocket_tts_tpu_torch.cli.doctor import run_doctor

    res = run_doctor(cfg, out=sys.stdout)
    return 0 if res.ok else 1


def cmd_health(args) -> int:
    cfg = load_config(args)
    from go_pocket_tts_tpu_torch.server import probe_http

    addr = args.url or f"http://127.0.0.1{cfg.server.listen_addr}"
    try:
        out = probe_http(addr)
    except Exception as exc:  # noqa: BLE001
        print(f"error: {exc}", file=sys.stderr)
        return 1
    print(json.dumps(out))
    return 0


# -- model / voice assets -----------------------------------------------------


def cmd_model_download(args) -> int:
    cfg = load_config(args)
    _setup_logging(cfg.log_level)
    from go_pocket_tts_tpu_torch.model_assets import download as dl
    from go_pocket_tts_tpu_torch.model_assets import manifest as mf

    def progress(name, written, total):
        pct = f"{written * 100 // total}%" if total else f"{written >> 20} MiB"
        print(f"  {name}: {pct}", file=sys.stderr)

    repo = args.repo or mf.GATED_REPO
    token = args.hf_token or os.environ.get("HF_TOKEN", "")
    fallback_repo = args.fallback_repo or mf.UNGATED_REPO
    try:
        resolved = dl.download_manifest(mf.pinned_manifest(repo), args.dest, progress, token=token)
    except dl.AccessDeniedError:
        # Gated-repo fallback (`cmd/pockettts/model_download.go:38-62`): the
        # token is dropped for the ungated repo; `--fallback-ungated false`
        # disables the retry.
        if not args.fallback_ungated:
            raise
        log.warning("access denied for %s; falling back to %s", repo, fallback_repo)
        resolved = dl.download_manifest(mf.pinned_manifest(fallback_repo), args.dest, progress)
    print(json.dumps(resolved, indent=2))
    return 0


# Tensor-name prefixes of the voice-cloning weights (the Mimi encoder and
# the speaker projection): the `without-voice-cloning` variant drops them.
VOICE_CLONING_PREFIXES = (
    "mimi.encoder",
    "mimi.encoder_transformer",
    "mimi.downsample",
    "mimi.quantizer.input_proj",
    "condition_provider",
)


def cmd_model_export(args) -> int:
    """Re-encode the checkpoint on the host, never the card: optionally
    without the voice-cloning weights (``--strip-voice-cloning``), with
    float tensors in bf16 (``--dtype bf16``) or with linear weights
    pre-quantized (``--quantize int8|int4``, through
    ``model_assets.quantize_export``). The bytes equal the reference
    CLI's for the same checkpoint and options."""
    cfg = load_config(args)
    _setup_logging(cfg.log_level)
    from go_pocket_tts_tpu_torch.utils.safetensors import open_store, write_file

    store = open_store(cfg.paths.model_path)
    strip_prefixes = VOICE_CLONING_PREFIXES if args.strip_voice_cloning else ()
    keep = [name for name in store.names() if not strip_prefixes or not name.startswith(strip_prefixes)]
    float_dtype = args.dtype or "f32"
    result = {"output": args.output}
    if args.quantize:
        from go_pocket_tts_tpu_torch.model_assets.quantize_export import (
            QUANT_METADATA_KEY,
            build_quantized_checkpoint,
        )

        bits = {"int8": 8, "int4": 4}[args.quantize]
        tensors, metadata, quantized = build_quantized_checkpoint(
            store, bits, keep_names=keep, float_dtype=float_dtype, metadata=store.metadata
        )
        write_file(args.output, tensors, metadata=metadata)
        result.update(
            tensors=len(tensors), quantized=len(quantized), format=metadata.get(QUANT_METADATA_KEY, "unquantized")
        )
    else:
        from go_pocket_tts_tpu_torch.model_assets.quantize_export import reencode_tensor

        tensors = {name: reencode_tensor(store, name, float_dtype) for name in keep}
        write_file(args.output, tensors, metadata=dict(store.metadata) or None)
        result["tensors"] = len(tensors)
    print(json.dumps(result))
    return 0


def cmd_model_dump_header(args) -> int:
    """The checkpoint's tensor inventory as JSON (names, shapes, dtypes,
    metadata and the required keys it lacks), from the header alone."""
    cfg = load_config(args)
    _setup_logging(cfg.log_level)
    from go_pocket_tts_tpu_torch.utils.safetensors import REQUIRED_MODEL_KEYS, SafetensorsError, read_header

    path = args.path or cfg.paths.model_path
    if not os.path.exists(path):
        print(json.dumps({"error": f"no such file: {path}"}))
        return 1
    try:
        header = read_header(path)
    except SafetensorsError as exc:
        print(json.dumps({"error": str(exc)}))
        return 1
    metadata = header.pop("__metadata__", {})
    tensors = {
        name: {"dtype": info.get("dtype"), "shape": info.get("shape")} for name, info in sorted(header.items())
    }
    missing = [k for k in REQUIRED_MODEL_KEYS if k not in tensors]
    print(
        json.dumps(
            {
                "path": path,
                "tensor_count": len(tensors),
                "metadata": metadata,
                "required_keys_missing": missing,
                "tensors": tensors,
            },
            indent=2 if args.pretty else None,
        )
    )
    return 0


def cmd_model_verify(args) -> int:
    cfg = _load_config(args)
    _setup_logging(cfg.log_level)
    from go_pocket_tts_tpu_torch.model_assets.verify import verify_native_model

    res = verify_native_model(cfg.paths.model_path, cfg.paths.tokenizer_model, device=cfg.runtime.device)
    for line in res.checks:
        print(line)
    return 0 if res.ok else 1


def cmd_model_download_bundle(args) -> int:
    """Archive-bundle download (`internal/model/onnx_bundle.go:19-120`):
    lock-pinned or explicit-URL tar.gz/zip, sha256-gated, extraction that
    refuses path traversal, then verification of the extracted files."""
    cfg = load_config(args)
    _setup_logging(cfg.log_level)
    from go_pocket_tts_tpu_torch.model_assets.bundle import download_bundle

    verified = download_bundle(
        out_dir=args.out_dir,
        bundle_url=args.bundle_url or "",
        sha256=args.sha256 or "",
        bundle_id=args.bundle_id or "",
        variant=args.variant,
        lock_file=args.lock_file,
        log=lambda msg: print(msg, file=sys.stderr),
    )
    print(json.dumps({"out_dir": args.out_dir, "files": len(verified)}))
    return 0


def cmd_voice_download(args) -> int:
    cfg = load_config(args)
    _setup_logging(cfg.log_level)
    from go_pocket_tts_tpu_torch.model_assets import download as dl
    from go_pocket_tts_tpu_torch.model_assets import manifest as mf

    token = args.hf_token or os.environ.get("HF_TOKEN", "")
    resolved = dl.download_manifest(mf.voice_manifest(), args.dest, token=token)
    print(json.dumps(resolved, indent=2))
    return 0


# -- parser ------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="pockettts-gpu",
        description="PocketTTS on an NVIDIA GPU: synthesize speech from text",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    def add(name, fn, help_text):
        p = sub.add_parser(name, help=help_text)
        register_flags(p)
        p.set_defaults(fn=fn)
        return p

    p = add("synth", cmd_synth, "Synthesize text to a WAV file")
    p.add_argument("--text", default="", help="Text to synthesize ('-' or empty = stdin)")
    p.add_argument(
        "--tts-arg",
        action="append",
        dest="tts_arg",
        metavar="KEY=VALUE",
        help="Pass-through pocket-tts flag in key=value form (repeatable; --backend cli only)",
    )
    p.add_argument("--out", default="out.wav", help="Output WAV path ('-' = stdout)")
    p.add_argument(
        "--format",
        default="",
        choices=["", "wav", "flac"],
        help="Output format (default: wav, or inferred from --out extension)",
    )
    p.add_argument("--voice", default="", help="Voice ID or .safetensors path")
    p.add_argument(
        "--chunk",
        action="store_true",
        help="Split text into sentence chunks and synthesize sequentially",
    )
    p.add_argument(
        "--max-chunk-chars",
        type=int,
        default=220,
        help="Maximum characters per chunk when --chunk is enabled",
    )
    p.add_argument("--normalize", action="store_true", help="Peak-normalize output audio")
    p.add_argument(
        "--peak-normalize",
        type=float,
        default=0.0,
        help="Peak normalize to a custom target (implies --normalize)",
    )
    p.add_argument("--dc-block", action="store_true", help="DC-block high-pass filter")
    p.add_argument("--fade-in-ms", type=float, default=0.0)
    p.add_argument("--fade-out-ms", type=float, default=0.0)

    p = add("serve", cmd_serve, "Run the HTTP synthesis server")
    p.add_argument(
        "--prewarm",
        action="store_true",
        help="Run the common shape buckets once before accepting traffic",
    )

    p = add("export-voice", cmd_export_voice, "Export a voice from a WAV prompt")
    p.add_argument(
        "--input", "--audio", dest="input", required=True, help="Input speaker WAV (--audio: reference alias)"
    )
    p.add_argument(
        "--output", "--out", dest="output", required=True, help="Output .safetensors path (--out: reference alias)"
    )
    p.add_argument("--voice-id", default="", help="Suggested manifest id")
    p.add_argument(
        "--format",
        default="embedding",
        choices=("embedding", "model-state"),
        help="Voice file format: legacy audio_prompt embedding or upstream KV model-state",
    )

    p = add("bench", cmd_bench, "Benchmark synthesis (RTF, TTFA)")
    p.add_argument("--text", default="The quick brown fox jumps over the lazy dog.")
    p.add_argument("--voice", default="")
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--no-cold", action="store_true", help="Skip the cold run")
    p.add_argument("--json", action="store_true")
    p.add_argument("--rtf-threshold", type=float, default=0.0, help="CI gate (0=off)")

    p = add("stageprof", cmd_stageprof, "Per-stage wall-time profile")
    p.add_argument("--text", default="The quick brown fox jumps over the lazy dog.")
    p.add_argument("--voice", default="")
    p.add_argument(
        "--trace-dir", default="", help="torch.profiler Chrome trace output dir (writes stageprof.trace.json)"
    )

    add("doctor", cmd_doctor, "Preflight diagnostics")

    p = add("health", cmd_health, "Probe a running server's /health")
    p.add_argument("--url", default="", help="Base URL (default from config)")

    model = sub.add_parser("model", help="Model asset management")
    msub = model.add_subparsers(dest="model_command", required=True)
    p = msub.add_parser("download")
    register_flags(p)
    p.add_argument(
        "--repo",
        "--hf-repo",
        dest="repo",
        default="",
        help="HF repo (default gated, auto-fallback; --hf-repo: reference alias)",
    )
    p.add_argument(
        "--dest", "--out-dir", dest="dest", default="models", help="Destination directory (--out-dir: reference alias)"
    )
    p.add_argument("--hf-token", default="", help="Hugging Face token (falls back to HF_TOKEN env var)")
    p.add_argument(
        "--fallback-ungated",
        default=True,
        type=_parse_bool,
        help="On gated access failure, retry with the ungated repo",
    )
    p.add_argument("--fallback-repo", default="", help="Ungated repo used when --fallback-ungated is enabled")
    p.set_defaults(fn=cmd_model_download)
    p = msub.add_parser("download-bundle", help="Download + verify a tar.gz/zip asset bundle")
    p.add_argument("--bundle-url", default="", help="Explicit bundle URL (http(s):// or file://)")
    p.add_argument("--bundle-id", default="", help="Bundle id from the lock file")
    p.add_argument("--variant", default="b6369a24")
    p.add_argument("--sha256", default="", help="Expected archive sha256 (overrides lock)")
    p.add_argument("--lock-file", default="bundles/bundles.lock.json")
    p.add_argument("--out-dir", required=True)
    p.set_defaults(fn=cmd_model_download_bundle)
    p = msub.add_parser("verify")
    register_flags(p)
    p.set_defaults(fn=cmd_model_verify)
    p = msub.add_parser("dump-header", help="Tensor names/shapes/dtypes + metadata as JSON (header-only read)")
    register_flags(p)
    p.add_argument("--path", default="", help="Checkpoint (default: configured model path)")
    p.add_argument("--pretty", action="store_true", help="Indented JSON")
    p.set_defaults(fn=cmd_model_dump_header)
    p = msub.add_parser("export")
    register_flags(p)
    p.add_argument("--output", required=True, help="Output .safetensors path")
    p.add_argument(
        "--strip-voice-cloning", action="store_true", help="Drop Mimi encoder / speaker projection weights"
    )
    p.add_argument(
        "--quantize",
        default="",
        choices=("", "int8", "int4"),
        help="Write linear weights pre-quantized (smaller artifact; loads directly into the serving quantized form)",
    )
    p.add_argument(
        "--dtype",
        default="",
        choices=("", "f32", "bf16"),
        help="Storage dtype for float tensors (bf16 halves them; combines with --quantize, where scales stay f32)",
    )
    p.set_defaults(fn=cmd_model_export)

    voice = sub.add_parser("voice", help="Voice asset management")
    vsub = voice.add_subparsers(dest="voice_command", required=True)
    p = vsub.add_parser("download")
    register_flags(p)
    p.add_argument(
        "--dest", "--out-dir", dest="dest", default="voices", help="Destination directory (--out-dir: reference alias)"
    )
    p.add_argument("--hf-token", default="", help="Hugging Face token (falls back to HF_TOKEN env var)")
    p.set_defaults(fn=cmd_voice_download)
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except ValueError as exc:
        # Config/input validation errors print one clean line, not a
        # traceback. Unexpected exception types still traceback — those
        # are bugs, or a missing card or a kernel that failed to build.
        print(f"error: {exc}", file=sys.stderr)
        return 2


if __name__ == "__main__":
    sys.exit(main())
