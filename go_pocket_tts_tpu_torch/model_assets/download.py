"""Checksum-verified asset downloads with atomic writes and lock manifests
(counterpart of ``go_pocket_tts_tpu/model_assets/download.py``;
`internal/model/download.go:52-398`):

- stream download → ``.tmp`` with sha256 computed while writing → atomic
  rename; skip when the local file already matches the pinned checksum
- periodic progress reporting
- gated repos: checksum resolved from HF ``ETag`` metadata headers
- 401/403 → :class:`AccessDeniedError` so the caller can fall back to the
  ungated repo (`cmd/pockettts/model_download.go:38-62`)
- ``download-manifest.lock.json`` records resolved checksums

The URL opener is an argument, so tests pass a fake one and nothing is
fetched.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import urllib.error
import urllib.request
from dataclasses import asdict
from typing import Callable, Dict, Optional

from go_pocket_tts_tpu_torch.model_assets.manifest import Manifest

__all__ = ["AccessDeniedError", "download_manifest", "hf_url", "sha256_file"]

LOCK_FILENAME = "download-manifest.lock.json"
_PROGRESS_INTERVAL = 2.0


class AccessDeniedError(PermissionError):
    """Raised on 401/403 from a gated repo."""


def hf_url(repo: str, revision: str, filename: str) -> str:
    return f"https://huggingface.co/{repo}/resolve/{revision}/{filename}"


def sha256_file(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while True:
            block = f.read(chunk)
            if not block:
                break
            h.update(block)
    return h.hexdigest()


def _resolve_checksum_from_metadata(url: str, opener=urllib.request.urlopen) -> str:
    """HEAD request; HF exposes the blob sha256 via X-Linked-ETag/ETag
    (`download.go:287-321`)."""
    req = urllib.request.Request(url, method="HEAD")
    with opener(req) as resp:
        etag = resp.headers.get("X-Linked-ETag") or resp.headers.get("ETag") or ""
    etag = etag.strip('"')
    return etag if len(etag) == 64 else ""


def _download_with_progress(
    url: str,
    dest: str,
    want_sha256: str,
    progress: Optional[Callable[[int, int], None]],
    opener=urllib.request.urlopen,
) -> str:
    tmp = dest + ".tmp"
    h = hashlib.sha256()
    try:
        with opener(url) as resp:
            total = int(resp.headers.get("Content-Length") or 0)
            written = 0
            last = time.monotonic()
            with open(tmp, "wb") as f:
                while True:
                    block = resp.read(1 << 20)
                    if not block:
                        break
                    f.write(block)
                    h.update(block)
                    written += len(block)
                    now = time.monotonic()
                    if progress and now - last >= _PROGRESS_INTERVAL:
                        progress(written, total)
                        last = now
    except urllib.error.HTTPError as exc:
        if os.path.exists(tmp):
            os.unlink(tmp)
        if exc.code in (401, 403):
            raise AccessDeniedError(f"access denied ({exc.code}) for {url}") from exc
        raise
    digest = h.hexdigest()
    if want_sha256 and digest != want_sha256:
        os.unlink(tmp)
        raise ValueError(
            f"checksum mismatch for {url}: got {digest}, want {want_sha256}"
        )
    os.replace(tmp, dest)
    if progress:
        progress(written, total)
    return digest


def download_manifest(
    manifest: Manifest,
    dest_dir: str,
    progress: Optional[Callable[[str, int, int], None]] = None,
    opener=urllib.request.urlopen,
    token: str = "",
) -> Dict[str, str]:
    """Download every manifest file into ``dest_dir``; returns
    filename→sha256. Writes the lock manifest on success. ``token`` adds a
    Bearer Authorization header for gated repos (`--hf-token` / ``HF_TOKEN``,
    `cmd/pockettts-tools/model_download.go:74`); callers drop it on the
    ungated fallback like the reference (`model_download.go:50`)."""
    if token:
        base_opener = opener

        def opener(url_or_req):  # noqa: F811 - deliberate authorized wrapper
            req = (
                url_or_req
                if isinstance(url_or_req, urllib.request.Request)
                else urllib.request.Request(url_or_req)
            )
            # Unredirected: HF gated downloads 302 to a presigned CDN URL;
            # forwarding the bearer token there both leaks it and makes S3
            # reject the request (two auth mechanisms).
            req.add_unredirected_header("Authorization", f"Bearer {token}")
            return base_opener(req)

    os.makedirs(dest_dir, exist_ok=True)
    resolved: Dict[str, str] = {}
    for mf in manifest.files:
        dest = os.path.join(dest_dir, mf.save_name)
        os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
        want = mf.sha256
        url = hf_url(manifest.repo, mf.revision, mf.filename)
        if not want:
            want = _resolve_checksum_from_metadata(url, opener)
        if os.path.exists(dest) and want and sha256_file(dest) == want:
            resolved[mf.save_name] = want
            continue
        per_file = (lambda w, t, name=mf.save_name: progress(name, w, t)) if progress else None
        resolved[mf.save_name] = _download_with_progress(url, dest, want, per_file, opener)

    lock_path = os.path.join(dest_dir, LOCK_FILENAME)
    with open(lock_path, "w", encoding="utf-8") as f:
        json.dump(
            {
                "repo": manifest.repo,
                "files": [
                    {**asdict(mf), "sha256": resolved[mf.save_name]}
                    for mf in manifest.files
                ],
            },
            f,
            indent=2,
        )
    return resolved
