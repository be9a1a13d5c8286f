"""CLI entry point of the port (counterpart of the reference package's
``cli/main.py``).

Subcommands: ``synth``, ``serve`` (with ``--voice-upload-dir``, ``POST
/voices``), ``export-voice`` and ``health``. Run via
``python -m go_pocket_tts_tpu_torch <cmd> ...`` or ``pockettts-gpu <cmd>``.
The reference's other subcommands (``bench``, ``stageprof``, ``doctor``,
``model …``, ``voice download``) are not ported yet: calling one exits 2
with a message (``ROADMAP.md`` §1).

Every subcommand loads flags > env (``POCKETTTS_*``) > config file >
defaults before running (`cmd/pockettts/root.go:24-38`).
``POCKETTTS_PLATFORM`` sets the device: ``cpu`` runs the plain PyTorch
versions of the kernels on the CPU; unset, ``gpu`` or ``cuda`` runs on the
card, and fails on a host without CUDA.
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

from go_pocket_tts_tpu_torch.config import Config, apply_serving_autotune, load_config, register_flags
from go_pocket_tts_tpu_torch.utils import dsp, wav

log = logging.getLogger("pockettts")

_LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "error": logging.ERROR,
}

# The reference's subcommands that this package does not have yet.
NOT_PORTED = ("bench", "stageprof", "doctor", "model", "voice")


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


# -- health ------------------------------------------------------------------


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

    p = add("health", cmd_health, "Probe a running server's /health")
    p.add_argument("--url", default="", help="Base URL (default from config)")
    return parser


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        print(
            f"error: {argv[0]!r} is not yet ported to go_pocket_tts_tpu_torch "
            "(ROADMAP.md §1); the reference package has it: python -m go_pocket_tts_tpu",
            file=sys.stderr,
        )
        return 2
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
