"""Archive-bundle download + verify (tar.gz / zip; counterpart of
``go_pocket_tts_tpu/model_assets/bundle.py``).

The generic-asset capability the reference implements for its ONNX bundles
(`internal/model/onnx_bundle.go:19-120`): resolve a bundle from a pinned lock
file (by id, else by variant) or an explicit URL, stream-download while
sha256-hashing, refuse on checksum mismatch, extract zip/tar.gz with
path-traversal protection, then verify the extracted contents.

Bundle format: the archive may carry a
``bundle-manifest.json`` — ``{"files": [{"path": ..., "sha256": ...}, ...]}``
— in which case every listed file is checksum-verified after extraction (the
role `verifyONNXManifestDir` plays for ONNX graphs). Without a manifest,
extraction succeeding and at least one file landing is the (weaker) check,
plus a safetensors header sanity check when a ``*.safetensors`` is present.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import tarfile
import tempfile
import urllib.request
import zipfile
from dataclasses import dataclass
from typing import List, Optional

from go_pocket_tts_tpu_torch.model_assets.download import sha256_file

__all__ = ["Bundle", "download_bundle", "extract_archive", "verify_bundle_dir"]

_SHA256_RE = re.compile(r"^[0-9a-f]{64}$")
DEFAULT_LOCK_FILE = os.path.join("bundles", "bundles.lock.json")
DEFAULT_VARIANT = "b6369a24"


@dataclass
class Bundle:
    id: str
    variant: str
    url: str
    sha256: str = ""


def _resolve_from_lock(lock_file: str, bundle_id: str, variant: str) -> Bundle:
    try:
        with open(lock_file, "r", encoding="utf-8") as fh:
            lock = json.load(fh)
    except OSError as exc:
        raise FileNotFoundError(f"read bundle lock file {lock_file!r}: {exc}") from exc
    bundles = [Bundle(**b) for b in lock.get("bundles", [])]
    if not bundles:
        raise ValueError(f"bundle lock {lock_file!r} has no bundles; pass --bundle-url")
    if bundle_id:
        for b in bundles:
            if b.id == bundle_id:
                return b
        raise KeyError(f"bundle id {bundle_id!r} not found in {lock_file}")
    for b in bundles:
        if b.variant == variant:
            return b
    raise KeyError(f"no bundle found for variant {variant!r} in {lock_file}")


def _fetch(url: str, opener=urllib.request.urlopen) -> tuple:
    """Stream-download (http/https or file://...or plain path) to a temp file,
    hashing as it writes. Returns (tmp_path, sha256_hex)."""
    fd, tmp = tempfile.mkstemp(prefix="pockettts-bundle-")
    h = hashlib.sha256()
    try:
        if url.startswith(("http://", "https://")):
            src = opener(url)
            status = getattr(src, "status", 200)
            if not 200 <= status < 300:
                raise RuntimeError(f"bundle download failed: HTTP {status}")
        else:
            src = open(url[len("file://"):] if url.startswith("file://") else url, "rb")
        with os.fdopen(fd, "wb") as dst, src:
            while True:
                chunk = src.read(1 << 20)
                if not chunk:
                    break
                h.update(chunk)
                dst.write(chunk)
    except Exception:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
    return tmp, h.hexdigest()


def _safe_target(out_dir: str, name: str) -> str:
    """Path-traversal guard (zip-slip): the resolved target must stay inside
    ``out_dir`` (mirrors `onnx_bundle.go safeExtractPath`)."""
    target = os.path.realpath(os.path.join(out_dir, name))
    root = os.path.realpath(out_dir)
    if target != root and not target.startswith(root + os.sep):
        raise ValueError(f"bundle entry {name!r} escapes the output directory")
    return target


def extract_archive(path: str, out_dir: str, kind: str = "") -> List[str]:
    """Extract a zip or tar.gz archive into ``out_dir``. ``kind`` may force
    'zip'/'tar'; by default both are attempted (temp files have no suffix).
    Returns the extracted file paths."""
    os.makedirs(out_dir, exist_ok=True)
    if kind != "tar" and zipfile.is_zipfile(path):
        out: List[str] = []
        with zipfile.ZipFile(path) as zf:
            for info in zf.infolist():
                target = _safe_target(out_dir, info.filename)
                if info.is_dir():
                    os.makedirs(target, exist_ok=True)
                    continue
                os.makedirs(os.path.dirname(target), exist_ok=True)
                with zf.open(info) as src, open(target, "wb") as dst:
                    shutil.copyfileobj(src, dst)
                out.append(target)
        return out
    if kind != "zip" and tarfile.is_tarfile(path):
        out = []
        with tarfile.open(path, "r:*") as tf:
            for member in tf:
                target = _safe_target(out_dir, member.name)
                if member.isdir():
                    os.makedirs(target, exist_ok=True)
                    continue
                if not member.isfile():
                    continue  # skip links/devices: never extract through them
                os.makedirs(os.path.dirname(target), exist_ok=True)
                src = tf.extractfile(member)
                with open(target, "wb") as dst:
                    shutil.copyfileobj(src, dst)
                out.append(target)
        return out
    raise ValueError(f"unsupported bundle format for {path} (expected .zip or .tar.gz)")


def verify_bundle_dir(out_dir: str) -> List[str]:
    """Post-extract verification. With a ``bundle-manifest.json``, every
    listed file must exist with the recorded sha256; otherwise any present
    ``*.safetensors`` gets a header sanity check. Returns verified paths."""
    verified: List[str] = []
    manifest_path = os.path.join(out_dir, "bundle-manifest.json")
    if os.path.exists(manifest_path):
        with open(manifest_path, "r", encoding="utf-8") as fh:
            manifest = json.load(fh)
        for entry in manifest.get("files", []):
            target = _safe_target(out_dir, entry["path"])
            if not os.path.exists(target):
                raise FileNotFoundError(f"bundle manifest lists missing file {entry['path']!r}")
            want = entry.get("sha256", "").lower()
            if want:
                got = sha256_file(target)
                if got != want:
                    raise ValueError(
                        f"bundle file {entry['path']!r} checksum mismatch: "
                        f"expected {want} got {got}"
                    )
            verified.append(target)
        return verified
    # No manifest: sanity-check any safetensors headers.
    from go_pocket_tts_tpu_torch.utils.safetensors import open_store

    for root, _dirs, files in os.walk(out_dir):
        for name in files:
            path = os.path.join(root, name)
            if name.endswith(".safetensors"):
                open_store(path)  # raises on a corrupt header
            verified.append(path)
    if not verified:
        raise ValueError(f"bundle extracted no files into {out_dir}")
    return verified


def download_bundle(
    out_dir: str,
    bundle_url: str = "",
    sha256: str = "",
    bundle_id: str = "",
    variant: str = DEFAULT_VARIANT,
    lock_file: str = DEFAULT_LOCK_FILE,
    opener=urllib.request.urlopen,
    log=print,
) -> List[str]:
    """Resolve → fetch(+hash) → checksum gate → extract → verify.

    Mirrors `DownloadONNXBundle` (`onnx_bundle.go:42-125`) minus the
    ONNX-specific manifest step (see :func:`verify_bundle_dir`).
    """
    if not out_dir:
        raise ValueError("out dir is required")
    checksum = sha256.strip().lower()
    url = bundle_url.strip()
    if not url:
        b = _resolve_from_lock(lock_file, bundle_id, variant)
        url = b.url
        if not checksum:
            checksum = b.sha256.strip().lower()
        log(f"resolved bundle from lock: id={b.id} variant={b.variant} url={b.url}")
    if not url:
        raise ValueError(f"bundle URL is required (pass --bundle-url or configure {lock_file})")
    if checksum and not _SHA256_RE.match(checksum):
        raise ValueError(f"invalid sha256 checksum {checksum!r}")

    tmp, actual = _fetch(url, opener=opener)
    try:
        if checksum and checksum != actual:
            raise ValueError(f"bundle checksum mismatch: expected {checksum} got {actual}")
        log(f"downloaded bundle ({url}) sha256={actual}")
        lower = url.lower()
        kind = "zip" if lower.endswith(".zip") else (
            "tar" if lower.endswith((".tar.gz", ".tgz")) else ""
        )
        extracted = extract_archive(tmp, out_dir, kind)
        log(f"extracted {len(extracted)} files into {out_dir}")
    finally:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    verified = verify_bundle_dir(out_dir)
    log(f"verified bundle contents in {out_dir}")
    return verified
