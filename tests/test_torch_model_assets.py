"""The port's model-asset modules against the JAX package's: the pinned
manifests, ``download_manifest`` over a fake URL opener (nothing is
fetched), archive bundles, and ``verify_native_model``. Each case runs
through both packages, each in a directory of its own, and must end the
same way: the same result, or the same exception and message."""

import gzip
import hashlib
import io
import json
import os
import tarfile
import urllib.error
import urllib.request
import zipfile
from dataclasses import asdict

import numpy as np
import pytest

from go_pocket_tts_tpu.model_assets import bundle as j_bundle
from go_pocket_tts_tpu.model_assets import download as j_dl
from go_pocket_tts_tpu.model_assets import manifest as j_mf
from go_pocket_tts_tpu.model_assets.verify import verify_native_model as j_verify
from go_pocket_tts_tpu_torch.model_assets import bundle as t_bundle
from go_pocket_tts_tpu_torch.model_assets import download as t_dl
from go_pocket_tts_tpu_torch.model_assets import manifest as t_mf
from go_pocket_tts_tpu_torch.model_assets.verify import verify_native_model as t_verify
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.utils.safetensors import encode_tensors, write_file

# -- manifests -------------------------------------------------------------------


def test_manifests_equal_field_for_field():
    assert (t_mf.GATED_REPO, t_mf.UNGATED_REPO) == (j_mf.GATED_REPO, j_mf.UNGATED_REPO)
    for repo in (j_mf.GATED_REPO, j_mf.UNGATED_REPO):
        assert asdict(t_mf.pinned_manifest(repo)) == asdict(j_mf.pinned_manifest(repo))
    assert asdict(t_mf.voice_manifest()) == asdict(j_mf.voice_manifest())
    assert [f.save_name for f in t_mf.voice_manifest().files] == [f.save_name for f in j_mf.voice_manifest().files]
    for mod in (j_mf, t_mf):
        with pytest.raises(ValueError, match="no pinned manifest"):
            mod.pinned_manifest("unknown/repo")
    assert t_dl.hf_url("r", "v", "f") == j_dl.hf_url("r", "v", "f")
    assert t_dl.LOCK_FILENAME == j_dl.LOCK_FILENAME


# -- downloads over a fake opener -----------------------------------------------------


class _Response(io.BytesIO):
    def __init__(self, data=b"", headers=None):
        super().__init__(data)
        self.headers = headers or {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


PAYLOAD = b"model-bytes" * 50
DIGEST = hashlib.sha256(PAYLOAD).hexdigest()


def _manifest(mod, sha256=DIGEST):
    return mod.Manifest(repo="test/repo", files=[mod.ModelFile("weights/file.bin", "rev", sha256=sha256, local_path="")])


def _opener(seen, payload=PAYLOAD, etag=DIGEST, status=None):
    def opener(req):
        url = req.full_url if isinstance(req, urllib.request.Request) else req
        method = req.get_method() if isinstance(req, urllib.request.Request) else "GET"
        auth = req.unredirected_hdrs.get("Authorization") if isinstance(req, urllib.request.Request) else None
        redirected = req.headers.get("Authorization") if isinstance(req, urllib.request.Request) else None
        seen.append((method, url, auth, redirected))
        if status is not None:
            raise urllib.error.HTTPError(url, status, "denied", {}, None)
        if method == "HEAD":
            return _Response(b"", {"X-Linked-ETag": f'"{etag}"'})
        return _Response(payload, {"Content-Length": str(len(payload))})

    return opener


def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as exc:  # noqa: BLE001 - the outcome is compared across packages
        return (type(exc).__name__, str(exc))


DOWNLOADS = {
    # Pinned checksum: one GET, the lock records it.
    "pinned": dict(sha256=DIGEST, opener={}),
    # Gated repo, no pinned checksum: HEAD for the ETag, then the GET.
    "etag": dict(sha256="", opener={}),
    # The ETag is no sha256: downloaded without a check, the digest recorded.
    "etag_not_a_digest": dict(sha256="", opener={"etag": "abc"}),
    "mismatch": dict(sha256="0" * 64, opener={}),
    "denied_401": dict(sha256=DIGEST, opener={"status": 401}),
    "denied_403": dict(sha256=DIGEST, opener={"status": 403}),
    "server_error": dict(sha256=DIGEST, opener={"status": 500}),
    "with_token": dict(sha256="", opener={}, token="tok123"),
}


@pytest.mark.parametrize("case", list(DOWNLOADS))
def test_download_manifest_matches_the_reference(tmp_path, case):
    spec = DOWNLOADS[case]
    runs = {}
    for name, mf, dl in (("jax", j_mf, j_dl), ("port", t_mf, t_dl)):
        dest, seen, progress = tmp_path / name, [], []
        out = _outcome(
            lambda: dl.download_manifest(
                _manifest(mf, spec["sha256"]),
                str(dest),
                progress=lambda n, w, t: progress.append((n, w, t)),
                opener=_opener(seen, **spec["opener"]),
                token=spec.get("token", ""),
            )
        )
        lock = dest / dl.LOCK_FILENAME
        files = sorted(str(p.relative_to(dest)) for p in dest.rglob("*") if p.is_file()) if dest.exists() else []
        runs[name] = (out, seen, progress, lock.read_bytes() if lock.exists() else None, files)
    (j_out, j_seen, j_prog, j_lock, j_files), (t_out, t_seen, t_prog, t_lock, t_files) = runs["jax"], runs["port"]
    assert t_out == j_out
    assert t_seen == j_seen and t_prog == j_prog and t_lock == j_lock and t_files == j_files
    if case.startswith("denied"):
        assert t_out[0] == "AccessDeniedError" and isinstance(t_dl.AccessDeniedError("x"), PermissionError)
    if case == "mismatch":
        assert t_out[0] == "ValueError" and "checksum mismatch" in t_out[1] and t_files == []
    if case == "with_token":
        # The bearer token never follows a redirect to the CDN.
        assert all(auth == "Bearer tok123" and redirected is None for _m, _u, auth, redirected in t_seen)
    if case in ("pinned", "etag"):
        assert t_out == ("ok", {"weights/file.bin": DIGEST}) and json.loads(t_lock)["files"][0]["sha256"] == DIGEST


def test_download_skips_a_file_whose_checksum_matches(tmp_path):
    for name, mf, dl in (("jax", j_mf, j_dl), ("port", t_mf, t_dl)):
        dest = tmp_path / name
        (dest / "weights").mkdir(parents=True)
        (dest / "weights" / "file.bin").write_bytes(PAYLOAD)

        def explode(req):
            raise AssertionError("should not download")

        assert dl.download_manifest(_manifest(mf), str(dest), opener=explode) == {"weights/file.bin": DIGEST}
    assert (tmp_path / "port" / t_dl.LOCK_FILENAME).read_bytes() == (tmp_path / "jax" / j_dl.LOCK_FILENAME).read_bytes()
    assert t_dl.sha256_file(str(tmp_path / "port" / "weights" / "file.bin")) == DIGEST


# -- bundles -------------------------------------------------------------------------


def _tar_gz(path, files, links=()):
    """Write a .tar.gz whose bytes depend only on ``files`` and ``links``:
    the gzip header's mtime is 0 and names no file, so the JAX and the
    port's runs of one case see the same archive and the same sha256."""
    with open(path, "wb") as raw, gzip.GzipFile(filename="", mode="wb", fileobj=raw, mtime=0) as gz, tarfile.open(fileobj=gz, mode="w") as tf:
        for name, data in files.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))
        for name, target in links:
            info = tarfile.TarInfo(name)
            info.type = tarfile.SYMTYPE
            info.linkname = target
            tf.addfile(info)


def _zip(path, files):
    with zipfile.ZipFile(path, "w") as zf:
        for name, data in files.items():
            info = zipfile.ZipInfo(name, date_time=(1980, 1, 1, 0, 0, 0))
            info.external_attr = 0o600 << 16  # what writestr gives a bare name
            zf.writestr(info, data)


@pytest.mark.parametrize("write", [_tar_gz, _zip], ids=["tar_gz", "zip"])
def test_archives_are_byte_stable_across_seconds(tmp_path, monkeypatch, write):
    """Two builds of one archive a second apart give equal bytes."""
    import time

    files = {"model.safetensors": b"m" * 64, "tokenizer.model": b"tok"}
    write(str(tmp_path / "a"), files)
    now = time.time()
    monkeypatch.setattr(time, "time", lambda: now + 1.0)
    monkeypatch.setattr(time, "localtime", lambda *a: time.gmtime(now + 1.0))
    write(str(tmp_path / "b"), files)
    assert (tmp_path / "a").read_bytes() == (tmp_path / "b").read_bytes()


def _with_manifest(files):
    listed = {n: d for n, d in files.items()}
    manifest = {"files": [{"path": n, "sha256": hashlib.sha256(d).hexdigest()} for n, d in listed.items()]}
    return {**files, "bundle-manifest.json": json.dumps(manifest).encode()}


def _checkpoint_bytes():
    return encode_tensors(synthetic.build_checkpoint(synthetic.tiny_arch(), seed=2))


def _tree(root):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def _bundle_case(tmp_path, mod, case):
    """Build the case's archive under tmp_path, run it through ``mod`` into
    tmp_path/out; returns (outcome, extracted tree)."""
    tmp_path.mkdir(parents=True)
    out = tmp_path / "out"
    files = _with_manifest({"model.safetensors": _checkpoint_bytes(), "tokenizer.model": b"tok"})
    kw = {}
    if case in ("tar_roundtrip", "zip_roundtrip", "corrupt_archive"):
        archive = tmp_path / ("b.zip" if case.startswith("zip") else "b.tar.gz")
        (_zip if case.startswith("zip") else _tar_gz)(str(archive), files)
        digest = hashlib.sha256(archive.read_bytes()).hexdigest()
        kw = dict(bundle_url=f"file://{archive}", sha256="0" * 64 if case == "corrupt_archive" else digest)
    elif case in ("lock_by_id", "lock_by_variant", "lock_unknown_id"):
        archive = tmp_path / "b.zip"
        _zip(str(archive), files)
        digest = hashlib.sha256(archive.read_bytes()).hexdigest()
        lock = tmp_path / "bundles.lock.json"
        bundles = [
            {"id": "other", "variant": "x", "url": "file:///nonexistent", "sha256": ""},
            {"id": "main", "variant": "b6369a24", "url": f"file://{archive}", "sha256": digest},
        ]
        lock.write_text(json.dumps({"bundles": bundles}))
        kw = dict(lock_file=str(lock), bundle_id={"lock_by_id": "main", "lock_unknown_id": "nope"}.get(case, ""))
    elif case in ("zip_slip", "tar_slip", "links_skipped"):
        archive = tmp_path / ("evil.zip" if case == "zip_slip" else "evil.tar.gz")
        if case == "zip_slip":
            _zip(str(archive), {"../evil.txt": b"pwn"})
        elif case == "tar_slip":
            _tar_gz(str(archive), {"../../evil.txt": b"pwn"})
        else:
            _tar_gz(str(archive), {"a.txt": b"a"}, links=(("link.txt", "/etc/passwd"),))
        return _outcome(lambda: [os.path.relpath(p, out) for p in mod.extract_archive(str(archive), str(out))]), _tree(tmp_path)
    elif case in ("corrupt_entry", "missing_entry"):
        archive = tmp_path / "b.tar.gz"
        _tar_gz(str(archive), files)
        mod.extract_archive(str(archive), str(out), "tar")
        if case == "corrupt_entry":
            (out / "model.safetensors").write_bytes(b"tampered")
        else:
            os.unlink(out / "tokenizer.model")
        return _outcome(lambda: [os.path.relpath(p, out) for p in mod.verify_bundle_dir(str(out))]), _tree(out)
    elif case in ("no_manifest_good", "no_manifest_bad_header", "empty"):
        archive = tmp_path / "b.zip"
        body = {"no_manifest_good": {"m.safetensors": _checkpoint_bytes()}, "no_manifest_bad_header": {"m.safetensors": b"\xff" * 32}, "empty": {}}[case]
        _zip(str(archive), body)
        mod.extract_archive(str(archive), str(out), "zip")
        return _outcome(lambda: sorted(os.path.relpath(p, out) for p in mod.verify_bundle_dir(str(out)))), _tree(out)
    result = _outcome(lambda: sorted(os.path.relpath(p, out) for p in mod.download_bundle(str(out), log=lambda m: None, **kw)))
    return result, (_tree(out) if out.exists() else {})


BUNDLES = [
    "tar_roundtrip",
    "zip_roundtrip",
    "corrupt_archive",
    "lock_by_id",
    "lock_by_variant",
    "lock_unknown_id",
    "zip_slip",
    "tar_slip",
    "links_skipped",
    "corrupt_entry",
    "missing_entry",
    "no_manifest_good",
    "no_manifest_bad_header",
    "empty",
]


@pytest.mark.parametrize("case", BUNDLES)
def test_bundles_match_the_reference(tmp_path, case):
    j_out, j_tree = _bundle_case(tmp_path / "jax", j_bundle, case)
    t_out, t_tree = _bundle_case(tmp_path / "port", t_bundle, case)
    scrub = lambda o: (o[0], o[1].replace(str(tmp_path / "jax"), "@").replace(str(tmp_path / "port"), "@")) if o[0] != "ok" else o  # noqa: E731
    assert scrub(t_out) == scrub(j_out)
    assert {k: v for k, v in t_tree.items() if not k.endswith((".gz", ".zip", ".json"))} == {
        k: v for k, v in j_tree.items() if not k.endswith((".gz", ".zip", ".json"))
    }
    expect_ok = case in ("tar_roundtrip", "zip_roundtrip", "lock_by_id", "lock_by_variant", "links_skipped", "no_manifest_good")
    assert (t_out[0] == "ok") == expect_ok, t_out
    if case in ("zip_slip", "tar_slip"):
        assert "escapes" in t_out[1] and not (tmp_path / "port" / "evil.txt").exists()
    if case == "links_skipped":
        assert t_out[1] == ["a.txt"] and not os.path.lexists(tmp_path / "port" / "out" / "link.txt")
    if case == "tar_roundtrip":
        assert t_tree["model.safetensors"] == _checkpoint_bytes()


# -- verify_native_model -------------------------------------------------------------


@pytest.mark.parametrize("case", ["good", "int8", "missing_file", "missing_keys", "no_tokenizer", "bad_tokenizer"])
def test_verify_native_model_lines_match(tmp_path, case):
    from torch_fixtures import tokenizer_bytes
    from go_pocket_tts_tpu_torch.model_assets.quantize_export import build_quantized_checkpoint

    arch = synthetic.tiny_arch()
    tensors = synthetic.build_checkpoint(arch, seed=5)
    model, tok = tmp_path / "model.safetensors", tmp_path / "tokenizer.model"
    if case == "int8":
        q, meta, _ = build_quantized_checkpoint(tensors, 8, num_heads=arch.num_heads)
        write_file(model, q, metadata=meta)
    elif case == "missing_keys":
        write_file(model, {k: v for k, v in tensors.items() if not k.startswith("flow_lm.bos")})
    elif case != "missing_file":
        write_file(model, tensors)
    tok.write_bytes(b"\x00garbage" if case == "bad_tokenizer" else tokenizer_bytes())
    tok_path = str(tmp_path / "absent.model") if case == "no_tokenizer" else str(tok)
    want = j_verify(str(model), tok_path)
    got = t_verify(str(model), tok_path, device="cpu")
    assert got.checks == want.checks and got.ok == want.ok and got.failures == want.failures
    assert got.ok == (case in ("good", "int8"))
    if case == "int8":
        assert "✓ model smoke load: d_model=64, pre-quantized int8" in got.checks
