"""The port's ``doctor`` and model/voice asset subcommands against the JAX
package's: ``run_doctor``'s lines for the same configs with injected probes
(the port's two card probes in the place of the JAX backend line), the
``model dump-header`` JSON and the ``model export`` bytes of both CLIs, and
``model download`` / ``voice download`` over a fake URL opener."""

import functools
import hashlib
import io
import json
import urllib.error
import urllib.request

import pytest

from go_pocket_tts_tpu import config as j_cfg
from go_pocket_tts_tpu.cli.doctor import run_doctor as j_run_doctor
from go_pocket_tts_tpu.cli.main import main as j_main
from go_pocket_tts_tpu.model_assets import download as j_dl
from go_pocket_tts_tpu.model_assets import manifest as j_mf
from go_pocket_tts_tpu.text import sentencepiece as j_spm
from go_pocket_tts_tpu_torch import config as t_cfg
from go_pocket_tts_tpu_torch.cli.doctor import run_doctor
from go_pocket_tts_tpu_torch.cli.main import main
from go_pocket_tts_tpu_torch.model_assets import download as t_dl
from go_pocket_tts_tpu_torch.model_assets import manifest as t_mf
from go_pocket_tts_tpu_torch.model_assets.quantize_export import build_quantized_checkpoint
from go_pocket_tts_tpu_torch.models import synthetic
from go_pocket_tts_tpu_torch.text import sentencepiece as t_spm
from go_pocket_tts_tpu_torch.utils.safetensors import open_store, write_file
from torch_fixtures import tokenizer_bytes

ARCH = synthetic.tiny_arch()


def _raise(msg):
    def probe(*_args):
        raise RuntimeError(msg)

    return probe


J_PROBES = dict(jax_probe=lambda: "jax x.y", native_probe=lambda: "lib ok", tokenizer_probe=lambda p: (True, "backend=hf"))
T_PROBES = dict(
    cuda_probe=lambda: "torch x.y, card",
    kernels_probe=lambda cache_dir: f"6 libraries in {cache_dir or '_build'}",
    native_probe=lambda: "lib ok",
    tokenizer_probe=lambda p: (True, "backend=hf"),
)


def _configs(tmp_path, **fields):
    """Both packages' configs with the same ``section.field`` values (the
    compile cache in one directory, so both probe the same path)."""
    out = []
    for mod in (j_cfg, t_cfg):
        cfg = mod.Config()
        cfg.runtime.compile_cache_dir = str(tmp_path / "cache")
        cfg.paths.voices_manifest = ""
        for key, value in fields.items():
            section, name = key.split("__")
            setattr(getattr(cfg, section), name, value)
        out.append(cfg)
    return out


def _model(tmp_path, strip=False, quantize=0):
    tensors = synthetic.build_checkpoint(ARCH, seed=1)
    if strip:
        tensors = {k: v for k, v in tensors.items() if not k.startswith("mimi.encoder")}
    path = tmp_path / "model.safetensors"
    if quantize:
        q, meta, _ = build_quantized_checkpoint(tensors, quantize, num_heads=ARCH.num_heads)
        write_file(path, q, metadata=meta)
    else:
        write_file(path, tensors)
    return str(path)


def _tokenizer(tmp_path, charsmap=b""):
    m = t_spm.SentencePieceModel.parse(tokenizer_bytes())
    m.precompiled_charsmap = charsmap
    path = tmp_path / "tokenizer.model"
    path.write_bytes(m.serialize())
    return str(path)


def _doctor_case(tmp_path, case, monkeypatch):
    """(fields, jax probes, port probes) of one case."""
    j_probes, t_probes = dict(J_PROBES), dict(T_PROBES)
    missing = dict(paths__model_path=str(tmp_path / "missing.safetensors"), paths__tokenizer_model=str(tmp_path / "missing.model"))
    if case == "all_green":
        return dict(paths__model_path=_model(tmp_path), paths__tokenizer_model=_tokenizer(tmp_path)), j_probes, t_probes
    if case == "pre_quantized_batch":
        fields = dict(paths__model_path=_model(tmp_path, quantize=8), paths__tokenizer_model=_tokenizer(tmp_path))
        return dict(fields, runtime__batch_slots=8), j_probes, t_probes
    if case in ("voice_upload", "voice_upload_stripped"):
        fields = dict(paths__model_path=_model(tmp_path, strip=case.endswith("stripped")), paths__tokenizer_model="")
        return dict(fields, server__voice_upload_dir=str(tmp_path / "uploads")), j_probes, t_probes
    if case == "autotune_preview":
        return dict(missing, runtime__batch_slots=8), j_probes, t_probes
    if case == "autotune_off":
        return dict(missing, runtime__batch_slots=8, runtime__autotune=False), j_probes, t_probes
    if case in ("continuity_small", "continuity_large"):
        cap = 128 if case.endswith("small") else 512
        return dict(missing, tts__continuity=True, runtime__batch_slots=4, runtime__batch_prompt_capacity=cap), j_probes, t_probes
    if case in ("degraded_tokenizer", "exact_tokenizer"):
        # The pure backend whatever the image has; the charsmap bytes are fake.
        for mod in (j_spm, t_spm):
            monkeypatch.setattr(mod, "_build_hf_backend", lambda model: None)
        charsmap = b"\x01\x02\x03" if case == "degraded_tokenizer" else b""
        for probes in (j_probes, t_probes):
            del probes["tokenizer_probe"]
        return dict(paths__model_path=_model(tmp_path), paths__tokenizer_model=_tokenizer(tmp_path, charsmap)), j_probes, t_probes
    if case == "failures":
        j_probes.update(jax_probe=_raise("no jax"), native_probe=_raise("no lib"))
        t_probes.update(cuda_probe=_raise("no CUDA device"), kernels_probe=_raise("nvcc not found"), native_probe=_raise("no lib"))
        return missing, j_probes, t_probes
    if case == "voices_manifest":
        manifest = tmp_path / "voices.json"
        manifest.write_text(json.dumps({"voices": [{"id": "a", "path": "a.safetensors", "license": ""}]}))
        return dict(missing, paths__voices_manifest=str(manifest)), j_probes, t_probes
    raise AssertionError(case)


DOCTOR_CASES = [
    "all_green",
    "pre_quantized_batch",
    "voice_upload",
    "voice_upload_stripped",
    "autotune_preview",
    "autotune_off",
    "continuity_small",
    "continuity_large",
    "degraded_tokenizer",
    "exact_tokenizer",
    "failures",
    "voices_manifest",
]


@pytest.mark.parametrize("case", DOCTOR_CASES)
def test_doctor_lines_match_the_reference(tmp_path, monkeypatch, case):
    fields, j_probes, t_probes = _doctor_case(tmp_path, case, monkeypatch)
    j_c, t_c = _configs(tmp_path, **fields)
    j_out, t_out = io.StringIO(), io.StringIO()
    want = j_run_doctor(j_c, out=j_out, **j_probes)
    got = run_doctor(t_c, out=t_out, **t_probes)
    # The JAX backend line becomes the port's two card lines; the rest match.
    assert [line.split(" — ")[0] for line in got.lines[:2]] == [
        ("✗" if case == "failures" else "✓") + " cuda backend",
        ("✗" if case == "failures" else "✓") + " cuda kernels",
    ]
    assert want.lines[0].split(" — ")[0] == ("✗" if case == "failures" else "✓") + " jax backend"
    assert got.lines[2:] == want.lines[1:]
    assert [f for f in got.failures if not f.startswith("cuda")] == [f for f in want.failures if f != "jax backend"]
    assert got.ok == want.ok
    assert t_out.getvalue().splitlines()[2:] == j_out.getvalue().splitlines()[1:] or not got.ok
    if case == "all_green":
        assert got.ok and got.lines[1] == f"✓ cuda kernels — 6 libraries in {tmp_path / 'cache'}"
    if case == "failures":
        assert got.failures[:2] == ["cuda backend", "cuda kernels"]
        assert "5 check(s) failed" in t_out.getvalue() and "4 check(s) failed" in j_out.getvalue()
    if case == "autotune_preview":
        assert t_c.runtime.quantize is False  # doctor only previews


def test_default_probes_on_this_host(tmp_path, monkeypatch):
    """The default card probes report ✗ without CUDA, and the native helper
    and tokenizer probes run for real."""
    import torch

    from go_pocket_tts_tpu_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", build.BUILD_DIR)  # the kernels probe points it at the config's
    (t_c,) = _configs(tmp_path, paths__model_path=_model(tmp_path), paths__tokenizer_model=_tokenizer(tmp_path))[1:]
    res = run_doctor(t_c)
    names = [line.split(" — ")[0][2:] for line in res.lines]
    assert names[:5] == ["cuda backend", "cuda kernels", "native helpers", "compile cache", "model file"]
    assert res.lines[2].startswith("✓ native helpers — libaudioio-")
    if not torch.cuda.is_available():
        assert res.failures == ["cuda backend", "cuda kernels"]
        assert "no CUDA device" in res.lines[0]


@pytest.fixture
def cli_env(tmp_path, monkeypatch):
    model = _model(tmp_path)
    monkeypatch.setenv("POCKETTTS_PATHS_MODEL_PATH", model)
    monkeypatch.setenv("POCKETTTS_PATHS_TOKENIZER_MODEL", _tokenizer(tmp_path))
    monkeypatch.setenv("POCKETTTS_RUNTIME_COMPILE_CACHE_DIR", "")
    monkeypatch.delenv("POCKETTTS_PLATFORM", raising=False)
    monkeypatch.chdir(tmp_path)
    return tmp_path


@pytest.mark.parametrize("path", ["model", "int4", "missing", "garbage"])
def test_dump_header_json_matches_the_jax_cli(cli_env, capsys, path):
    target = {"model": "", "int4": str(cli_env / "q4.safetensors"), "missing": str(cli_env / "none"), "garbage": str(cli_env / "g")}[path]
    if path == "int4":
        q, meta, _ = build_quantized_checkpoint(open_store(cli_env / "model.safetensors"), 4, num_heads=ARCH.num_heads, metadata={})
        write_file(target, q, metadata=meta)
    if path == "garbage":
        (cli_env / "g").write_bytes(b"\xff" * 32)
    args = ["model", "dump-header", "--pretty"] + (["--path", target] if target else [])
    rc_j = j_main(args)
    want = capsys.readouterr().out
    rc_t = main(args)
    got = capsys.readouterr().out
    assert (rc_t, got) == (rc_j, want)
    if path in ("model", "int4"):
        out = json.loads(got)
        assert rc_t == 0 and out["required_keys_missing"] == [] and out["tensor_count"] == len(out["tensors"])


EXPORTS = {
    "plain": [],
    "strip": ["--strip-voice-cloning"],
    "bf16": ["--dtype", "bf16"],
    "int8": ["--quantize", "int8"],
    "int4": ["--quantize", "int4", "--strip-voice-cloning"],
    "int8_bf16": ["--quantize", "int8", "--dtype", "bf16"],
}


@pytest.mark.parametrize("case", list(EXPORTS))
def test_model_export_bytes_match_the_jax_cli(cli_env, capsys, case):
    assert j_main(["model", "export", "--output", "jax.safetensors", *EXPORTS[case]]) == 0
    want = json.loads(capsys.readouterr().out)
    assert main(["model", "export", "--output", "port.safetensors", *EXPORTS[case]]) == 0
    got = json.loads(capsys.readouterr().out)
    assert {**got, "output": ""} == {**want, "output": ""}
    assert (cli_env / "port.safetensors").read_bytes() == (cli_env / "jax.safetensors").read_bytes()
    names = open_store(cli_env / "port.safetensors").names()
    assert any(n.startswith("mimi.encoder") for n in names) == ("--strip-voice-cloning" not in EXPORTS[case])


# -- downloads over a fake opener ---------------------------------------------------------


class _Response(io.BytesIO):
    def __init__(self, data=b"", headers=None):
        super().__init__(data)
        self.headers = headers or {}

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _payload(filename: str) -> bytes:
    return f"fake bytes of {filename}".encode() * 10


def _fake_manifests(mf):
    """The pinned manifests, their files' digests those of the fake
    payloads (a gated file keeps its empty digest: the ETag supplies it)."""
    pinned, voices = mf.pinned_manifest, mf.voice_manifest

    def swap(manifest):
        files = [
            mf.ModelFile(f.filename, f.revision, hashlib.sha256(_payload(f.filename)).hexdigest() if f.sha256 else "", f.local_path)
            for f in manifest.files
        ]
        return mf.Manifest(manifest.repo, files)

    return (lambda repo: swap(pinned(repo))), (lambda: swap(voices()))


def _opener(seen, denied_repo=""):
    def opener(req):
        url = req.full_url if isinstance(req, urllib.request.Request) else req
        method = req.get_method() if isinstance(req, urllib.request.Request) else "GET"
        auth = req.unredirected_hdrs.get("Authorization") if isinstance(req, urllib.request.Request) else None
        seen.append((method, url.split("/resolve/")[0], auth))
        if denied_repo and f"/{denied_repo}/" in url and method == "GET":
            raise urllib.error.HTTPError(url, 403, "gated", {}, None)
        filename = url.split("/", 7)[-1]
        data = _payload(filename)
        if method == "HEAD":
            return _Response(b"", {"ETag": hashlib.sha256(data).hexdigest()})
        return _Response(data, {"Content-Length": str(len(data))})

    return opener


DOWNLOAD_CASES = {
    "gated_with_token": (["model", "download", "--hf-token", "tok"], ""),
    "gated_denied_falls_back": (["model", "download", "--hf-repo", j_mf.GATED_REPO, "--hf-token", "tok"], j_mf.GATED_REPO),
    "no_fallback": (["model", "download", "--fallback-ungated", "false"], j_mf.GATED_REPO),
    "ungated_out_dir": (["model", "download", "--repo", j_mf.UNGATED_REPO, "--out-dir", "m2"], ""),
    "voices": (["voice", "download", "--out-dir", "v"], ""),
}


@pytest.mark.parametrize("case", list(DOWNLOAD_CASES))
def test_downloads_match_the_jax_cli(cli_env, monkeypatch, capsys, case):
    args, denied = DOWNLOAD_CASES[case]
    runs = {}
    for name, mod_main, dl, mf in (("jax", j_main, j_dl, j_mf), ("port", main, t_dl, t_mf)):
        (cli_env / name).mkdir()
        monkeypatch.chdir(cli_env / name)
        seen = []
        monkeypatch.setattr(dl, "download_manifest", functools.partial(dl.download_manifest, opener=_opener(seen, denied)))
        pinned, voices = _fake_manifests(mf)
        monkeypatch.setattr(mf, "pinned_manifest", pinned)
        monkeypatch.setattr(mf, "voice_manifest", voices)
        try:
            rc = mod_main(args)
        except dl.AccessDeniedError as exc:
            rc = f"AccessDeniedError: {exc}"
        out = capsys.readouterr()
        tree = {str(p.relative_to(cli_env / name)): p.read_bytes() for p in sorted((cli_env / name).rglob("*")) if p.is_file()}
        runs[name] = (rc, out.out, seen, tree)
    assert runs["port"] == runs["jax"]
    rc, stdout, seen, tree = runs["port"]
    if case == "no_fallback":
        assert str(rc).startswith("AccessDeniedError") and [m for m, *_x in seen] == ["HEAD", "GET"]  # no retry
    else:
        assert rc == 0 and json.loads(stdout)
        assert any(name.endswith(t_dl.LOCK_FILENAME) for name in tree)
    if case == "gated_denied_falls_back":
        # The token goes to the gated repo and is dropped for the fallback.
        gated = [auth for _m, repo, auth in seen if repo.endswith("/" + j_mf.GATED_REPO)]
        ungated = [auth for _m, repo, auth in seen if repo.endswith("/" + j_mf.UNGATED_REPO)]
        assert gated == ["Bearer tok"] * 2 and ungated == [None] * 2
    if case == "voices":
        assert len([n for n in tree if n.endswith(".safetensors")]) == 8
