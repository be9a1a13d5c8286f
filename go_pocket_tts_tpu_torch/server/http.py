"""HTTP server of the port: /health /stats /metrics /voices /tts /tts/stream.

A copy of the reference package's ``server/http.py`` over the port's
``Service``; API parity with `internal/server/server.go`:

- ``GET /health`` → ``{"status": "ok", "version": ...}`` (`server.go:145-158`)
- ``GET /voices`` → ``{"voices": [{id,path,license}]}`` (`server.go:160-167`)
- ``POST /tts`` — JSON ``{"text", "voice", "chunk", "format", "continuity"}``
  → ``audio/wav`` bytes
  (`server.go:175-258`); with ``"progress": true`` the response is a
  Server-Sent-Events stream: block-granular ``progress`` events while the
  device generates (the reference's per-step progress contract,
  `internal/tts/runtime.go:42`, at the finest granularity that doesn't
  force a per-frame host sync), then one ``audio`` event carrying the
  complete base64 WAV/FLAC
- ``POST /tts/stream`` — chunked streaming WAV: unknown-length header then
  PCM16 per synthesized chunk (`server.go:302-396`)
- ``POST /voices`` — runtime voice cloning (beyond the Go reference, whose
  voice list is immutable after start): ``{"id", "audio": <base64 WAV>,
  "license"?}`` → encode through the Mimi encoder on the card, persist,
  register, prewarm (`tts/voice_upload.py`). 403 unless ``serve
  --voice-upload-dir`` opted in; 409 on a duplicate id; 413 past the audio
  cap; 400 on bad input, audio past the encoder's 40.96 s included
- both accept ``"format": "flac"`` for losslessly compressed responses
  (typically 2-3× smaller; ``audio/flac``) — beyond the reference, which
  serves WAV only; WAV stays the default and the parity format
- ``GET /`` serves the bundled web demo (`web/index.html`) same-origin, and
  every response carries ``Access-Control-Allow-Origin: *`` (the API holds
  no secrets/credentials) so the page also works hosted elsewhere
- limits/timeouts: ``max_text_bytes`` → 413; queue-full → 503; per-request
  timeout → 504 (`server.go:58-73,195-233,398-421`)
- structured request logging with voice/text_len/duration_ms/wav_bytes
  (`server.go:236-252`)

Implementation: stdlib ``ThreadingHTTPServer`` (one thread per connection) +
a semaphore worker pool bounding concurrent syntheses — request-level
concurrency control identical in role to the reference's buffered-channel
semaphore. Device work is serialized inside the Service; the pool bounds
queueing and memory.
"""

from __future__ import annotations

import base64
import binascii
import json
import logging
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional

import numpy as np

from go_pocket_tts_tpu_torch.utils import wav
from go_pocket_tts_tpu_torch.version import __version__

log = logging.getLogger("pockettts.server")

__all__ = ["Server", "make_handler", "probe_http"]


def _accepts_param(service, name: str) -> bool:
    """Test stubs may expose a narrower synthesize_stream signature."""
    import inspect

    try:
        sig = inspect.signature(service.synthesize_stream)
    except (TypeError, ValueError):
        return False
    return name in sig.parameters


class _WorkerPool:
    """Bounded worker pool with cancellable waits (`server.go:398-421`)."""

    def __init__(self, workers: int) -> None:
        self._sem = threading.Semaphore(max(workers, 1))

    def acquire(self, timeout: float) -> bool:
        return self._sem.acquire(timeout=timeout)

    def release(self) -> None:
        self._sem.release()


class _Stats:
    """Process-lifetime serving counters for ``GET /stats``.

    Beyond the reference (which has only /health + request logs): one cheap
    mutexed snapshot for dashboards/load tests — in-flight gauge, outcome
    counters, and the aggregate synthesis rate (audio seconds produced per
    wall second spent synthesizing).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.in_flight = 0
        self.requests_total = 0
        self.ok_total = 0
        self.error_total = 0
        self.busy_503_total = 0
        self.timeout_504_total = 0
        self.voices_uploaded_total = 0
        self.audio_seconds_total = 0.0
        self.wall_seconds_total = 0.0

    def enter(self) -> None:
        with self._lock:
            self.in_flight += 1
            self.requests_total += 1

    def exit(self) -> None:
        with self._lock:
            self.in_flight -= 1

    def count(self, field: str) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + 1)

    def ok(self, audio_seconds: float, wall_seconds: float) -> None:
        with self._lock:
            self.ok_total += 1
            self.audio_seconds_total += audio_seconds
            self.wall_seconds_total += wall_seconds

    def snapshot(self) -> dict:
        with self._lock:
            wall = self.wall_seconds_total
            return {
                "in_flight": self.in_flight,
                "requests_total": self.requests_total,
                "ok_total": self.ok_total,
                "error_total": self.error_total,
                "busy_503_total": self.busy_503_total,
                "timeout_504_total": self.timeout_504_total,
                "voices_uploaded_total": self.voices_uploaded_total,
                "audio_seconds_total": round(self.audio_seconds_total, 3),
                "synthesis_wall_seconds_total": round(wall, 3),
                "aggregate_x_realtime": (
                    round(self.audio_seconds_total / wall, 2) if wall > 0 else None
                ),
            }

    def prometheus(self) -> str:
        """The same counters in Prometheus text exposition format
        (``GET /metrics``), so a stock scraper can watch a serving fleet
        without a translation shim."""
        snap = self.snapshot()
        kinds = {"in_flight": "gauge", "aggregate_x_realtime": "gauge"}
        lines = []
        for key, val in snap.items():
            if val is None:
                continue
            name = f"pockettts_{key}"
            lines.append(f"# TYPE {name} {kinds.get(key, 'counter')}")
            lines.append(f"{name} {val}")
        return "\n".join(lines) + "\n"


# Fallback when the service exposes no model config: one latent frame =
# 80 ms of 24 kHz audio (stock Mimi timing).
_DEFAULT_SAMPLES_PER_FRAME = 1920


def _is_timeout(exc: BaseException) -> bool:
    """True for the exception shapes the engines raise on deadline expiry:
    TimeoutError, a CancelledError (concurrent.futures or the Service's
    own), or message-level 'cancelled'/'deadline' surfaced from a runtime.
    Shared by all three synthesis handlers so the 504/500 split can't
    diverge per endpoint."""
    return (
        isinstance(exc, TimeoutError)
        or type(exc).__name__ == "CancelledError"
        or "cancelled" in str(exc).lower()
        or "deadline" in str(exc).lower()
    )


def _sse_event(event: str, obj) -> bytes:
    return f"event: {event}\ndata: {json.dumps(obj)}\n\n".encode("utf-8")


def make_handler(
    service,
    voices=None,
    max_text_bytes: int = 4096,
    request_timeout: float = 60.0,
    workers: int = 2,
    queue_timeout: float = 5.0,
    voice_uploader=None,
):
    """Build the request-handler class bound to a Service.

    ``service`` must expose ``synthesize_stream(text, voice)`` (a Service or
    compatible stub); ``voices`` optionally exposes ``list_voices()``.
    ``voice_uploader`` (a ``tts.voice_upload.VoiceUploader``) enables
    ``POST /voices``; when None the route answers 403: an open server must
    not accept file writes unless the operator opted in.
    """
    pool = _WorkerPool(workers)
    stats = _Stats()
    accepts_deadline = _accepts_param(service, "deadline")
    accepts_continuity = _accepts_param(service, "continuity")
    try:
        samples_per_frame = int(service.runtime.model.config.mimi.samples_per_latent)
    except (AttributeError, TypeError, ValueError):
        samples_per_frame = _DEFAULT_SAMPLES_PER_FRAME

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"
        server_version = f"pockettts-gpu/{__version__}"

        # -- helpers -------------------------------------------------------

        def _json(self, status: int, obj) -> None:
            body = json.dumps(obj).encode("utf-8")
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        _DRAIN_LIMIT = 1 << 26  # 64 MiB: bound on discarded request bytes

        def _drain_request_body(self) -> None:
            """Read and discard the unread request body (bounded) before an
            early error response.

            Responding while the client is still mid-send races its write:
            once the response is out and the connection tears down, the
            client sees EPIPE/ECONNRESET instead of the 4xx (observed as a
            flaky Broken pipe in the POST /voices validation test under
            full-suite load). The reference writes clean 413/400s the same
            way (`internal/server/server.go:186-233`). Bodies beyond the
            drain limit aren't worth absorbing (and may never arrive) —
            skip the read and drop the connection after responding.
            """
            try:
                length = int(self.headers.get("Content-Length") or 0)
            except (TypeError, ValueError):
                length = 0
            remaining = length - getattr(self, "_body_read", 0)
            if remaining <= 0:
                return
            if remaining > self._DRAIN_LIMIT:
                # An attacker-scale Content-Length claim (e.g. 2 GB on the
                # 413 path) must not pin the handler waiting for bytes that
                # will never come: respond immediately and drop the
                # connection instead of absorbing anything.
                self.close_connection = True
                return
            to_read = remaining
            try:
                old_timeout = self.connection.gettimeout()
                # A client that stalls mid-body must not pin the handler
                # thread: bound the drain with a socket timeout.
                self.connection.settimeout(10.0)
                try:
                    while to_read > 0:
                        chunk = self.rfile.read(min(to_read, 65536))
                        if not chunk:
                            break
                        to_read -= len(chunk)
                finally:
                    self.connection.settimeout(old_timeout)
            except (OSError, ValueError):
                pass
            self._body_read = length - to_read
            if to_read > 0:
                # Unread body bytes may still arrive; the connection is
                # desynced for keep-alive reuse.
                self.close_connection = True

        def _error(self, status: int, msg: str) -> None:
            self._drain_request_body()
            self._json(status, {"error": msg})

        def log_message(self, fmt, *args):  # route to slog-style logger
            log.debug("http: " + fmt, *args)

        def _read_tts_request(self):
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._error(400, "invalid Content-Length")
                return None
            if length <= 0:
                self._error(400, "request body is required")
                return None
            # Enforce the size limit BEFORE reading: Content-Length is
            # attacker-controlled, and buffering an arbitrary body to then
            # 413 it would hand out free memory (`server.go` caps at the
            # reader). Slack covers the JSON envelope around the text.
            if length > max_text_bytes + 4096:
                self._error(413, f"request exceeds maximum size ({max_text_bytes} text bytes)")
                return None
            raw = self.rfile.read(length)
            self._body_read = len(raw)
            try:
                req = json.loads(raw.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as exc:
                self._error(400, f"invalid JSON: {exc}")
                return None
            if not isinstance(req, dict):
                self._error(400, "request body must be a JSON object")
                return None
            text = req.get("text", "")
            if not isinstance(text, str):
                self._error(400, "text must be a string")
                return None
            if not text.strip():
                self._error(400, "text field is required")
                return None
            if len(text.encode("utf-8")) > max_text_bytes:
                self._error(
                    413, f"text exceeds maximum size of {max_text_bytes} bytes"
                )
                return None
            fmt = str(req.get("format", "wav")).lower()
            if fmt not in ("wav", "flac"):
                self._error(400, f"unsupported format {fmt!r} (wav or flac)")
                return None
            cont = req.get("continuity")
            if cont is not None and not isinstance(cont, bool):
                self._error(400, "continuity must be a boolean")
                return None
            return (
                text,
                req.get("voice", ""),
                bool(req.get("chunk", False)),
                fmt,
                bool(req.get("progress", False)),
                cont,  # None = server default; bool = per-request override
            )

        def _resolve_voice(self, voice: str) -> Optional[str]:
            if not voice:
                return ""
            import os

            if voices is not None:
                try:
                    return voices.resolve_path(voice)
                except KeyError:
                    if not os.path.exists(voice):
                        self._error(400, f"unknown voice {voice!r}")
                        return None
                except FileNotFoundError as exc:
                    self._error(400, str(exc))
                    return None
            elif not os.path.exists(voice):
                self._error(400, f"voice file not found: {voice!r}")
                return None
            return voice  # treat as a path

        # -- routes --------------------------------------------------------

        def end_headers(self):
            # Permissive CORS on every response: the API serves no secrets
            # and carries no credentials, and this lets the bundled web page
            # run from any origin (it also ships same-origin at GET /).
            self.send_header("Access-Control-Allow-Origin", "*")
            super().end_headers()

        def do_OPTIONS(self):
            self.send_response(204)
            self.send_header("Access-Control-Allow-Methods", "GET, POST, OPTIONS")
            self.send_header("Access-Control-Allow-Headers", "Content-Type")
            self.send_header("Content-Length", "0")
            self.end_headers()

        def _serve_index(self):
            """GET / — the bundled web demo, same-origin with the API."""
            import os as _os

            pkg_root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
            candidates = [
                # A cwd web/index.html lets deployments serve a custom page.
                _os.path.join(_os.getcwd(), "web", "index.html"),
                # Fallback: the demo shipped as package data (wheels too).
                _os.path.join(pkg_root, "web", "index.html"),
            ]
            for cand in candidates:
                try:
                    with open(cand, "rb") as f:
                        body = f.read()
                except OSError:
                    continue
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self._error(404, "web demo not found (web/index.html)")

        def do_GET(self):
            self._body_read = 0
            if self.path in ("/", "/index.html"):
                self._serve_index()
            elif self.path in ("/tts", "/tts/stream"):
                self._error(405, "method not allowed")
            elif self.path == "/health":
                self._json(200, {"status": "ok", "version": __version__})
            elif self.path == "/stats":
                self._json(200, stats.snapshot())
            elif self.path == "/metrics":
                body = stats.prometheus().encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/voices":
                listing = voices.list_voices() if voices is not None else []
                self._json(
                    200,
                    {
                        "voices": [
                            {"id": v.id, "path": v.path, "license": v.license}
                            for v in listing
                        ]
                    },
                )
            else:
                self._error(404, "not found")

        def do_POST(self):
            self._body_read = 0
            if self.path == "/tts":
                self._handle_tts()
            elif self.path == "/tts/stream":
                self._handle_tts_stream()
            elif self.path == "/voices":
                self._handle_voice_upload()
            elif self.path == "/health":
                self._error(405, "method not allowed")
            else:
                self._error(404, "not found")

        def _handle_voice_upload(self):
            """POST /voices: ``{"id", "audio": <base64 WAV>, "license"?}`` →
            encode, register, prewarm.

            Runs in the handler thread, outside the synthesis worker pool:
            uploads are rare admin operations and must not take a synthesis
            slot; the encode shares the device with the engine.
            """
            if voice_uploader is None:
                self._error(403, "voice upload is disabled (start serve with --voice-upload-dir)")
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
            except (TypeError, ValueError):
                self._error(400, "invalid Content-Length")
                return
            if length <= 0:
                self._error(400, "request body is required")
                return
            # Cap BEFORE reading (the header is the client's, same rule as
            # /tts): base64 inflates 4/3, plus the JSON envelope.
            max_audio = voice_uploader.max_audio_bytes
            if length > max_audio * 4 // 3 + 8192:
                self._error(413, f"request exceeds maximum size ({max_audio} audio bytes)")
                return
            raw = self.rfile.read(length)
            self._body_read = len(raw)
            try:
                req = json.loads(raw.decode("utf-8"))
            except (UnicodeDecodeError, json.JSONDecodeError) as exc:
                self._error(400, f"invalid JSON: {exc}")
                return
            if not isinstance(req, dict):
                self._error(400, "request body must be a JSON object")
                return
            vid, audio_b64, lic = req.get("id", ""), req.get("audio", ""), req.get("license", "")
            if not isinstance(vid, str) or not isinstance(audio_b64, str) or not isinstance(lic, str):
                self._error(400, "id, audio and license must be strings")
                return
            if not audio_b64:
                self._error(400, "audio field is required (base64-encoded WAV)")
                return
            try:
                wav_bytes = base64.b64decode(audio_b64, validate=True)
            except (binascii.Error, ValueError) as exc:
                self._error(400, f"audio is not valid base64: {exc}")
                return
            if len(wav_bytes) > max_audio:
                self._error(413, f"voice audio exceeds maximum size ({max_audio} bytes)")
                return
            from go_pocket_tts_tpu_torch.tts.voice_upload import DuplicateVoice

            try:
                record = voice_uploader.upload(vid, wav_bytes, license=lic)
            except DuplicateVoice as exc:
                self._error(409, str(exc))
                return
            except ValueError as exc:
                self._error(400, str(exc))
                return
            except Exception as exc:  # noqa: BLE001 - report, don't crash the thread
                log.error("voice upload failed", exc_info=True)
                self._error(500, f"voice upload failed: {exc}")
                return
            stats.count("voices_uploaded_total")
            self._json(200, {"voice": record})

        def _collect_pcm(
            self,
            text,
            voice_path,
            deadline,
            frame_streaming=False,
            on_block=None,
            continuity=None,
        ) -> np.ndarray:
            """Run the synthesis stream to completion → one PCM array.

            The deadline is also handed to the Service, which clamps each
            chunk's max_steps to the remaining budget — a request on the
            device can't be aborted mid-run, so this is what makes a 504 fire on
            time even for single-chunk requests. ``on_block(nsamples)``
            fires after each PCM block for progress reporting.
            """
            samples: List[np.ndarray] = []
            nsamples = 0
            stream_kwargs = {}
            if frame_streaming and getattr(service, "supports_frame_streaming", False):
                stream_kwargs["frame_streaming"] = True
            if accepts_deadline:
                stream_kwargs["deadline"] = deadline
            if continuity is not None and accepts_continuity:
                stream_kwargs["continuity"] = continuity
            for chunk in service.synthesize_stream(
                text,
                voice_path,
                cancel=lambda: time.monotonic() > deadline,
                **stream_kwargs,
            ):
                samples.append(chunk.samples)
                nsamples += len(chunk.samples)
                if on_block is not None:
                    on_block(nsamples)
                if time.monotonic() > deadline:
                    raise TimeoutError
            return np.concatenate(samples) if samples else np.zeros(0, np.float32)

        @staticmethod
        def _encode_body(pcm: np.ndarray, fmt: str) -> bytes:
            if fmt == "flac":
                from go_pocket_tts_tpu_torch.utils.flac import encode_flac

                return encode_flac(pcm)
            return wav.encode_wav(pcm)

        def _handle_tts(self):
            parsed = self._read_tts_request()
            if parsed is None:
                return
            text, voice, _chunk, fmt, progress, continuity = parsed
            voice_path = self._resolve_voice(voice)
            if voice_path is None:
                return
            if progress:
                return self._handle_tts_progress(
                    text, voice, voice_path, fmt, continuity
                )
            if not pool.acquire(queue_timeout):
                stats.count("busy_503_total")
                self._error(503, "server is busy")
                return
            stats.enter()
            start = time.monotonic()
            try:
                pcm = self._collect_pcm(
                    text, voice_path, start + request_timeout, continuity=continuity
                )
                body = self._encode_body(pcm, fmt)
            except Exception as exc:  # noqa: BLE001 - surface as 500 like the reference
                if _is_timeout(exc):
                    stats.count("timeout_504_total")
                    self._error(504, "synthesis timed out")
                    return
                log.error("synthesis failed: %s", exc)
                stats.count("error_total")
                self._error(500, str(exc))
                return
            finally:
                pool.release()
                stats.exit()

            dur_ms = (time.monotonic() - start) * 1e3
            stats.ok(len(pcm) / 24_000.0, dur_ms / 1e3)
            log.info(
                "tts ok voice=%s text_len=%d duration_ms=%.0f %s_bytes=%d",
                voice,
                len(text),
                dur_ms,
                fmt,
                len(body),
            )
            self.send_response(200)
            self.send_header(
                "Content-Type", "audio/flac" if fmt == "flac" else "audio/wav"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _handle_tts_progress(self, text, voice, voice_path, fmt, continuity=None):
            """POST /tts with ``progress: true`` → SSE events.

            ``event: progress`` fires per PCM block (frame streaming when the
            runtime supports it, else per text chunk) with
            ``{frames_done, frames_total, seconds_done}``; ``event: audio``
            carries the finished base64 body; mid-stream failures become
            ``event: error`` with the status the plain path would have sent.
            Block-granular progress over HTTP (the reference's per-step
            contract, `internal/tts/runtime.go:42`).
            """
            import base64

            if not pool.acquire(queue_timeout):
                stats.count("busy_503_total")
                self._error(503, "server is busy")
                return
            stats.enter()
            start = time.monotonic()
            wrote_header = False
            try:
                deadline = start + request_timeout
                # Best-effort total-frame estimate for the progress bar (the
                # Service computes it with its own chunker + frame rate, so
                # it agrees with the per-chunk estimated_max_steps); the
                # final audio event is the ground truth.
                frames_total = 0
                try:
                    estimator = getattr(service, "estimate_total_frames", None)
                    if estimator is not None:
                        frames_total = estimator(text)
                except Exception:  # noqa: BLE001 - estimate only
                    frames_total = 0

                self.send_response(200)
                self.send_header("Content-Type", "text/event-stream")
                self.send_header("Cache-Control", "no-cache")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                wrote_header = True

                def emit_progress(nsamples: int) -> None:
                    done = nsamples // samples_per_frame
                    self._write_chunk(
                        _sse_event(
                            "progress",
                            {
                                "frames_done": done,
                                "frames_total": max(frames_total, done),
                                "seconds_done": round(nsamples / 24_000.0, 3),
                            },
                        )
                    )

                pcm = self._collect_pcm(
                    text,
                    voice_path,
                    deadline,
                    frame_streaming=True,
                    on_block=emit_progress,
                    continuity=continuity,
                )
                body = self._encode_body(pcm, fmt)
                self._write_chunk(
                    _sse_event(
                        "audio",
                        {
                            "format": fmt,
                            "seconds": round(len(pcm) / 24_000.0, 3),
                            "audio_b64": base64.b64encode(body).decode("ascii"),
                        },
                    )
                )
                self._write_chunk(b"")
                stats.ok(len(pcm) / 24_000.0, time.monotonic() - start)
                log.info(
                    "tts ok (progress) voice=%s text_len=%d duration_ms=%.0f %s_bytes=%d",
                    voice,
                    len(text),
                    (time.monotonic() - start) * 1e3,
                    fmt,
                    len(body),
                )
            except Exception as exc:  # noqa: BLE001
                timed_out = _is_timeout(exc)
                status = 504 if timed_out else 500
                msg = "synthesis timed out" if timed_out else str(exc)
                stats.count("timeout_504_total" if timed_out else "error_total")
                if not wrote_header:
                    self._error(status, msg)
                else:
                    log.error("progress synthesis failed mid-stream: %s", exc)
                    try:
                        self._write_chunk(
                            _sse_event("error", {"status": status, "error": msg})
                        )
                        self._write_chunk(b"")
                    except OSError:
                        pass
            finally:
                pool.release()
                stats.exit()

        def _handle_tts_stream(self):
            parsed = self._read_tts_request()
            if parsed is None:
                return
            text, voice, _chunk, fmt, _progress, continuity = parsed
            voice_path = self._resolve_voice(voice)
            if voice_path is None:
                return
            if not pool.acquire(queue_timeout):
                stats.count("busy_503_total")
                self._error(503, "server is busy")
                return
            stats.enter()
            start = time.monotonic()
            wrote_header = False
            flac_enc = None
            if fmt == "flac":
                from go_pocket_tts_tpu_torch.utils.flac import FlacStreamEncoder

                flac_enc = FlacStreamEncoder()
            try:
                deadline = start + request_timeout
                self.send_response(200)
                self.send_header(
                    "Content-Type", "audio/flac" if fmt == "flac" else "audio/wav"
                )
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()
                wrote_header = True
                self._write_chunk(
                    flac_enc.header() if flac_enc else wav.streaming_wav_header()
                )
                total = 0
                nsamples = 0
                stream_kwargs = {}
                if getattr(service, "supports_frame_streaming", False):
                    stream_kwargs["frame_streaming"] = True
                if accepts_deadline:
                    stream_kwargs["deadline"] = deadline
                if continuity is not None and accepts_continuity:
                    stream_kwargs["continuity"] = continuity
                for chunk in service.synthesize_stream(
                    text,
                    voice_path,
                    cancel=lambda: time.monotonic() > deadline,
                    **stream_kwargs,
                ):
                    if flac_enc is not None:
                        payload = flac_enc.encode_block(chunk.samples)
                    else:
                        payload = wav.pcm16_bytes(chunk.samples)
                    total += len(payload)
                    nsamples += len(chunk.samples)
                    if payload:  # zero-length chunk would terminate the body
                        self._write_chunk(payload)
                self._write_chunk(b"")  # terminal chunk
                stats.ok(nsamples / 24_000.0, time.monotonic() - start)
                log.info(
                    "tts/stream ok voice=%s text_len=%d duration_ms=%.0f pcm_bytes=%d",
                    voice,
                    len(text),
                    (time.monotonic() - start) * 1e3,
                    total,
                )
            except Exception as exc:  # noqa: BLE001
                timed_out = _is_timeout(exc)
                if not wrote_header:
                    if timed_out:
                        stats.count("timeout_504_total")
                        self._error(504, "synthesis timed out")
                    else:
                        stats.count("error_total")
                        self._error(500, str(exc))
                else:
                    # The status is out, so a body cut short (no terminal
                    # chunk) is the signal left. The handler ends the
                    # connection when it returns; closing the socket object
                    # here would leave its open file objects holding the
                    # connection, and the client waiting on it.
                    log.error("streaming synthesis %s mid-stream: %s", "timed out" if timed_out else "failed", exc)
                    stats.count("timeout_504_total" if timed_out else "error_total")
                    self.close_connection = True
            finally:
                pool.release()
                stats.exit()

        def _write_chunk(self, payload: bytes) -> None:
            self.wfile.write(f"{len(payload):X}\r\n".encode() + payload + b"\r\n")
            self.wfile.flush()

    return Handler


class _QuietThreadingHTTPServer(ThreadingHTTPServer):
    """Client disconnects (broken pipe / reset while we stream or reply)
    are routine for a streaming server; socketserver's default prints a
    full traceback to stderr per occurrence. Log one structured line
    instead, and keep real handler bugs loud."""

    def handle_error(self, request, client_address):  # noqa: N802 (stdlib API)
        import sys

        exc = sys.exc_info()[1]
        if isinstance(
            exc, (BrokenPipeError, ConnectionResetError, ConnectionAbortedError)
        ):
            log.debug("client %s disconnected mid-request: %r", client_address, exc)
            return
        log.error("unhandled error serving %s", client_address, exc_info=True)


class Server:
    """Lifecycle wrapper: listen, serve in background, graceful shutdown
    (`server.go:441-514`)."""

    def __init__(
        self,
        service,
        voices=None,
        listen_addr: str = ":8080",
        workers: int = 2,
        max_text_bytes: int = 4096,
        request_timeout: float = 60.0,
        shutdown_timeout: float = 30.0,
        voice_uploader=None,
    ) -> None:
        host, _, port = listen_addr.rpartition(":")
        self._addr = (host or "0.0.0.0", int(port))
        self.shutdown_timeout = shutdown_timeout
        handler = make_handler(
            service,
            voices,
            max_text_bytes=max_text_bytes,
            request_timeout=request_timeout,
            workers=workers,
            voice_uploader=voice_uploader,
        )
        self._httpd = _QuietThreadingHTTPServer(self._addr, handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    def start(self) -> None:
        self._thread = threading.Thread(target=self._httpd.serve_forever, daemon=True)
        self._thread.start()
        log.info("http server listening on %s:%d", *self._httpd.server_address[:2])

    def shutdown(self) -> None:
        self._httpd.shutdown()
        if self._thread is not None:
            self._thread.join(timeout=self.shutdown_timeout)
        self._httpd.server_close()

    def serve_forever(self) -> None:
        try:
            self._httpd.serve_forever()
        except KeyboardInterrupt:
            log.info("shutting down")
            self._httpd.server_close()


def probe_http(base_url: str, timeout: float = 5.0) -> dict:
    """Health probe (`server.go:517-529`; used by the `health` command)."""
    with urllib.request.urlopen(f"{base_url}/health", timeout=timeout) as resp:
        if resp.status != 200:
            raise RuntimeError(f"unexpected health status: {resp.status}")
        return json.loads(resp.read().decode("utf-8"))
