"""The port's HTTP server against the JAX package's: the stub-service cases
of tests/test_server.py (status codes, headers, WAV/FLAC framing, SSE,
400/403/404/405/413/500/503/504, ``/stats`` and ``/metrics``), each sent to
both servers with the bodies compared; then one request end to end through
the port's ``Service`` on the CPU against the JAX package's, and ``POST
/tts/stream`` over both packages' batcher services."""

import http.client
import json
import socket
import threading
import time

import numpy as np
import pytest

from go_pocket_tts_tpu.server import Server as JServer
from go_pocket_tts_tpu.tts.parity import rms_delta
from go_pocket_tts_tpu.tts.voices import Voice
from go_pocket_tts_tpu_torch.server import Server, probe_http
from go_pocket_tts_tpu_torch.server.http import make_handler
from go_pocket_tts_tpu_torch.tts.service import CancelledError, PCMChunk
from go_pocket_tts_tpu_torch.utils import wav
from torch_fixtures import THREE_CHUNKS, build_models, service_pair, tokenizer_bytes


class _StubService:
    """Synthesizes 100 samples per chunk, optionally slowly or failing."""

    def __init__(self, delay=0.0, chunks=1, fail=False, samples=100):
        self.delay, self.chunks, self.fail, self.samples = delay, chunks, fail, samples

    def synthesize_stream(self, text, voice_path="", cancel=None):
        if self.fail:
            raise RuntimeError("boom")
        for i in range(self.chunks):
            if self.delay:
                time.sleep(self.delay)
            if cancel is not None and cancel():
                raise CancelledError("cancelled")
            pcm = (np.sin(np.arange(self.samples) * 0.05 + i) * 0.3).astype(np.float32)
            yield PCMChunk(samples=pcm, chunk_index=i, final=i == self.chunks - 1)


class _StubVoices:
    def list_voices(self):
        return [Voice(id="alba", path="alba.safetensors", license="CC-BY-4.0")]

    def resolve_path(self, vid):
        if vid == "alba":
            return "/tmp/alba.safetensors"
        raise KeyError(vid)


def _servers(svc, voices=None, **kw):
    """The JAX server and the port's over the same service, started."""
    pair = [cls(svc, voices, listen_addr="127.0.0.1:0", **kw) for cls in (JServer, Server)]
    for srv in pair:
        srv.start()
    return pair


def _request(port, method, path, body=None, headers=None, timeout=10):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        if isinstance(body, (dict, list)):
            body = json.dumps(body).encode()
        conn.request(method, path, body=body, headers=headers or {})
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def _both(pair, *args, **kw):
    return [_request(srv.port, *args, **kw) for srv in pair]


@pytest.fixture(scope="module")
def stub_pair():
    pair = _servers(_StubService(chunks=3), _StubVoices(), workers=2, max_text_bytes=64, request_timeout=5.0)
    yield pair
    for srv in pair:
        srv.shutdown()


_HEADERS = ("Content-Type", "Content-Length", "Transfer-Encoding", "Access-Control-Allow-Origin",
            "Access-Control-Allow-Methods", "Cache-Control")

CASES = {
    "health": ("GET", "/health", None),
    "voices": ("GET", "/voices", None),
    "tts_wav": ("POST", "/tts", {"text": "hello"}),
    "tts_flac": ("POST", "/tts", {"text": "hello", "format": "flac"}),
    "tts_voice": ("POST", "/tts", {"text": "hello", "voice": "alba", "chunk": True, "continuity": False}),
    "tts_progress_sse": ("POST", "/tts", {"text": "hello", "progress": True}),
    "stream_wav": ("POST", "/tts/stream", {"text": "hello"}),
    "stream_flac": ("POST", "/tts/stream", {"text": "hello", "format": "flac"}),
    "empty_text_400": ("POST", "/tts", {"text": "   "}),
    "missing_text_400": ("POST", "/tts", {"voice": "alba"}),
    "text_not_string_400": ("POST", "/tts", {"text": 7}),
    "non_object_400": ("POST", "/tts", [1, 2]),
    "invalid_json_400": ("POST", "/tts", b"{nope"),
    "bad_format_400": ("POST", "/tts/stream", {"text": "hi", "format": "mp3"}),
    "bad_continuity_400": ("POST", "/tts", {"text": "hi", "continuity": "yes"}),
    "unknown_voice_400": ("POST", "/tts", {"text": "hi", "voice": "nobody"}),
    "no_body_400": ("POST", "/tts", b""),
    "oversize_413": ("POST", "/tts", {"text": "x" * 100}),
    "get_tts_405": ("GET", "/tts", None),
    "post_health_405": ("POST", "/health", b"{}"),
    "not_found_404": ("GET", "/nope", None),
    "post_not_found_404": ("POST", "/nope", b"{}"),
    "options_204": ("OPTIONS", "/tts", None),
}


@pytest.mark.parametrize("case", list(CASES))
def test_responses_match_the_reference(stub_pair, case):
    method, path, body = CASES[case]
    (j_status, j_headers, j_body), (t_status, t_headers, t_body) = _both(stub_pair, method, path, body)
    assert t_status == j_status
    assert {h: t_headers.get(h) for h in _HEADERS} == {h: j_headers.get(h) for h in _HEADERS}
    assert t_body == j_body
    if case.startswith(("tts_wav", "stream_wav")):
        pcm, rate = wav.decode_wav(t_body)
        assert rate == 24000 and len(pcm) == 300


def test_server_header_names_the_port():
    pair = _servers(_StubService())
    try:
        (_, j_headers, _), (_, t_headers, _) = _both(pair, "GET", "/health")
    finally:
        for srv in pair:
            srv.shutdown()
    assert j_headers["Server"].startswith("pockettts-tpu/")
    assert t_headers["Server"].startswith("pockettts-gpu/")


def test_stats_and_metrics_match_after_traffic():
    pair = _servers(_StubService(), workers=2)
    try:
        for path, body in (("/tts/stream", {"text": "hi"}), ("/tts", {"text": "hi"}), ("/tts", {"text": ""})):
            _both(pair, "POST", path, body)
        # A streamed reply counts as ok after its last chunk is out: wait
        # for both servers to count it.
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            (_, _, j_stats), (_, _, t_stats) = _both(pair, "GET", "/stats")
            if json.loads(j_stats)["ok_total"] == json.loads(t_stats)["ok_total"] == 2:
                break
            time.sleep(0.05)
        (_, _, j_metrics), (_, _, t_metrics) = _both(pair, "GET", "/metrics")
    finally:
        for srv in pair:
            srv.shutdown()
    got, want = json.loads(t_stats), json.loads(j_stats)
    assert got.keys() == want.keys()
    assert (got["requests_total"], got["ok_total"], got["error_total"]) == (2, 2, 0)
    for key in ("requests_total", "ok_total", "error_total", "busy_503_total", "timeout_504_total",
                "voices_uploaded_total", "audio_seconds_total"):
        assert got[key] == want[key], key
    names = lambda body: [line.split()[0] for line in body.decode().splitlines() if line and not line.startswith("#")]  # noqa: E731
    assert names(t_metrics) == names(j_metrics)
    assert "# TYPE pockettts_in_flight gauge" in t_metrics.decode()


def test_error_500_and_stats_match():
    pair = _servers(_StubService(fail=True))
    try:
        results = _both(pair, "POST", "/tts", {"text": "hello"})
        progress = _both(pair, "POST", "/tts", {"text": "hello", "progress": True})
        stats = [json.loads(b) for _, _, b in _both(pair, "GET", "/stats")]
    finally:
        for srv in pair:
            srv.shutdown()
    assert [r[0] for r in results] == [500, 500] and results[0][2] == results[1][2]
    assert json.loads(results[1][2])["error"] == "boom"
    assert progress[1][0] == progress[0][0] == 200 and progress[1][2] == progress[0][2]
    assert stats[1]["error_total"] == stats[0]["error_total"] == 2


def test_stream_failure_after_the_header_ends_the_body_short():
    """``POST /tts/stream`` failing after the 200 and the WAV header: the
    body ends without its terminal chunk, at once. (The reference keeps
    the connection open until the client's timeout.)"""
    srv = Server(_StubService(fail=True), listen_addr="127.0.0.1:0")
    srv.start()
    conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=5)
    try:
        conn.request("POST", "/tts/stream", body=json.dumps({"text": "hi"}))
        resp = conn.getresponse()
        assert resp.status == 200
        with pytest.raises(http.client.IncompleteRead) as info:
            resp.read()
        assert info.value.partial == wav.streaming_wav_header()
        stats = json.loads(_request(srv.port, "GET", "/stats")[2])
    finally:
        conn.close()
        srv.shutdown()
    assert stats["error_total"] == 1


def test_timeout_504_matches():
    pair = _servers(_StubService(delay=0.4, chunks=3), request_timeout=0.5)
    try:
        results = _both(pair, "POST", "/tts", {"text": "hello"})
    finally:
        for srv in pair:
            srv.shutdown()
    assert [r[0] for r in results] == [504, 504]
    assert results[1][2] == results[0][2]


def test_progress_error_mid_stream_matches():
    class _FailAfterOne(_StubService):
        def synthesize_stream(self, text, voice_path="", cancel=None):
            yield PCMChunk(samples=np.full(1920, 0.1, np.float32), chunk_index=0, final=False)
            raise RuntimeError("boom mid-stream")

    pair = _servers(_FailAfterOne())
    try:
        results = _both(pair, "POST", "/tts", {"text": "hello", "progress": True})
    finally:
        for srv in pair:
            srv.shutdown()
    assert results[1][0] == results[0][0] == 200
    assert results[1][2] == results[0][2]
    assert b"event: error" in results[1][2] and b"boom mid-stream" in results[1][2]


def test_worker_pool_saturation_503():
    svc = _StubService(delay=1.0)
    srv = Server(svc, listen_addr="127.0.0.1:0", workers=1, request_timeout=5.0)
    srv._httpd.RequestHandlerClass = make_handler(svc, None, max_text_bytes=4096, request_timeout=5.0, workers=1,
                                                  queue_timeout=0.2)
    srv.start()
    codes = []
    try:
        threads = [threading.Thread(target=lambda: codes.append(_request(srv.port, "POST", "/tts", {"text": "hi"})[0]))
                   for _ in range(3)]
        for t in threads:
            t.start()
            time.sleep(0.1)
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        srv.shutdown()
    assert 503 in codes and 200 in codes


def test_voice_upload_is_refused_as_without_an_uploader(stub_pair):
    body = {"id": "v", "audio": "UklGRg=="}
    (j_status, _, j_body), (t_status, _, t_body) = _both(stub_pair, "POST", "/voices", body)
    assert t_status == j_status == 403
    assert json.loads(t_body) == json.loads(j_body)
    assert "--voice-upload-dir" in json.loads(t_body)["error"]


def test_web_demo_is_the_ports_own(stub_pair):
    status, headers, body = _request(stub_pair[1].port, "GET", "/")
    assert status == 200 and headers["Content-Type"].startswith("text/html")
    assert b"/tts" in body and b"go_pocket_tts_tpu_torch" in body


def test_oversize_content_length_rejected_before_read(stub_pair):
    conn = http.client.HTTPConnection("127.0.0.1", stub_pair[1].port, timeout=10)
    try:
        conn.putrequest("POST", "/tts")
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(2**31 - 1))
        conn.endheaders()
        conn.send(b'{"text":')
        assert conn.getresponse().status == 413
    finally:
        conn.close()


def test_probe_http(stub_pair):
    assert probe_http(f"http://127.0.0.1:{stub_pair[1].port}") == {"status": "ok", "version": "0.1.0"}


# -- one request end to end through both packages' Service ---------------------


def test_tts_end_to_end_through_the_services():
    from go_pocket_tts_tpu.config import TTSConfig as JTTSConfig
    from go_pocket_tts_tpu.models import synthetic as j_syn
    from go_pocket_tts_tpu.models.model import load_model_from_store
    from go_pocket_tts_tpu.runtime import TPURuntime
    from go_pocket_tts_tpu.text.sentencepiece import load_tokenizer_from_bytes as j_tokenizer
    from go_pocket_tts_tpu.tts.service import Service as JService
    from go_pocket_tts_tpu.utils.safetensors import encode_tensors, open_store_from_bytes
    from go_pocket_tts_tpu_torch.config import TTSConfig
    from go_pocket_tts_tpu_torch.models import synthetic
    from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors
    from go_pocket_tts_tpu_torch.runtime import GPURuntime
    from go_pocket_tts_tpu_torch.text.sentencepiece import load_tokenizer_from_bytes
    from go_pocket_tts_tpu_torch.tts.service import Service

    arch, seed = synthetic.tiny_arch(), 8
    jm = load_model_from_store(open_store_from_bytes(encode_tensors(j_syn.build_checkpoint(arch, seed=seed))),
                               num_heads=arch.num_heads)
    tm = load_model_from_tensors(synthetic.build_checkpoint(arch, seed=seed), num_heads=arch.num_heads, device="cpu")
    tts = dict(temperature=0.0, eos_threshold=1e9, max_steps=5)
    data = tokenizer_bytes()
    services = (
        JService(TPURuntime(jm, seed=1, frame_bucket=64), j_tokenizer(data), JTTSConfig(**tts)),
        Service(GPURuntime(tm, seed=1, frame_bucket=64, device="cpu"), load_tokenizer_from_bytes(data), TTSConfig(**tts)),
    )
    pair = [cls(svc, listen_addr="127.0.0.1:0", request_timeout=120) for cls, svc in zip((JServer, Server), services)]
    for srv in pair:
        srv.start()
    try:
        (j_status, _, j_body), (t_status, t_headers, t_body) = _both(
            pair, "POST", "/tts", {"text": "Hello world, the quick fox."}, timeout=120
        )
        stats = json.loads(_request(pair[1].port, "GET", "/stats")[2])
    finally:
        for srv in pair:
            srv.shutdown()
    assert t_status == j_status == 200 and t_headers["Content-Type"] == "audio/wav"
    got, rate = wav.decode_wav(t_body)
    want, _ = wav.decode_wav(j_body)
    assert rate == 24000 and got.shape == want.shape == (5 * 1920,)
    assert rms_delta(got, want) < 1e-3
    assert stats["ok_total"] == 1 and stats["audio_seconds_total"] == 0.4


# -- the batcher's frame streaming over HTTP -----------------------------------


def _chunk_sizes(port: int, path: str, body: dict):
    """The chunk sizes of a chunked HTTP response, read off the wire."""
    with socket.create_connection(("127.0.0.1", port), timeout=120) as sock:
        data = json.dumps(body).encode()
        sock.sendall(
            f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Type: application/json\r\nContent-Length: {len(data)}\r\n"
            f"Connection: close\r\n\r\n".encode() + data
        )
        raw = b""
        while True:
            part = sock.recv(1 << 16)
            if not part:
                break
            raw += part
    head, rest = raw.split(b"\r\n\r\n", 1)
    assert head.startswith(b"HTTP/1.1 200") or head.startswith(b"HTTP/1.0 200"), head[:40]
    sizes = []
    while True:
        line, rest = rest.split(b"\r\n", 1)
        n = int(line, 16)
        if n == 0:
            return sizes
        sizes.append(n)
        rest = rest[n + 2 :]


@pytest.fixture(scope="module")
def batcher_services():
    with service_pair(build_models()) as pair:
        yield pair


def test_stream_over_http_gives_the_reference_layout(batcher_services):
    """``POST /tts/stream`` over the batcher services: the port's server
    sends the JAX server's chunks (the WAV header, then one PCM block per
    chunk of 4 frames and its remainder), several per text chunk."""
    pair = [cls(svc, None, listen_addr="127.0.0.1:0", request_timeout=120) for cls, svc in zip((JServer, Server), batcher_services)]
    for srv in pair:
        srv.start()
    try:
        want, got = (_chunk_sizes(srv.port, "/tts/stream", {"text": THREE_CHUNKS}) for srv in pair)
        conn = http.client.HTTPConnection("127.0.0.1", pair[1].port, timeout=120)
        conn.request("GET", "/stats")
        stats = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        for srv in pair:
            srv.shutdown()
    assert got == want == [44] + [4 * 1920 * 2, 2 * 1920 * 2] * 3
    assert stats["ok_total"] == 1
