"""Pinned HuggingFace manifests for model, tokenizer and voice assets (a
copy of ``go_pocket_tts_tpu/model_assets/manifest.py``, field for field).

Repos, revisions and sha256 digests are pinned
(`internal/model/manifest.go:18-85`); the gated repo's checksum is resolved
from HF metadata at download time and written into a local lock manifest.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

__all__ = ["ModelFile", "Manifest", "pinned_manifest", "voice_manifest",
           "GATED_REPO", "UNGATED_REPO"]

GATED_REPO = "kyutai/pocket-tts"
UNGATED_REPO = "kyutai/pocket-tts-without-voice-cloning"

_UNGATED_REVISION = "d4fdd22ae8c8e1cb3634e150ebeff1dab2d16df3"
_GATED_REVISION = "427e3d61b276ed69fdd03de0d185fa8a8d97fc5b"


@dataclass(frozen=True)
class ModelFile:
    filename: str
    revision: str
    sha256: str = ""
    local_path: str = ""  # defaults to filename

    @property
    def save_name(self) -> str:
        return self.local_path or self.filename


@dataclass(frozen=True)
class Manifest:
    repo: str
    files: List[ModelFile] = field(default_factory=list)


def pinned_manifest(repo: str) -> Manifest:
    if repo == GATED_REPO:
        return Manifest(
            repo=repo,
            files=[
                # Gated: checksum resolved from HF ETag metadata at runtime.
                ModelFile("tts_b6369a24.safetensors", _GATED_REVISION, sha256="")
            ],
        )
    if repo == UNGATED_REPO:
        return Manifest(
            repo=repo,
            files=[
                ModelFile(
                    "tts_b6369a24.safetensors",
                    _UNGATED_REVISION,
                    sha256="58aa704a88faad35f22c34ea1cb55c4c5629de8b8e035c6e4936e2673dc07617",
                ),
                ModelFile(
                    "tokenizer.model",
                    _UNGATED_REVISION,
                    sha256="d461765ae179566678c93091c5fa6f2984c31bbe990bf1aa62d92c64d91bc3f6",
                ),
            ],
        )
    raise ValueError(f"no pinned manifest for repo {repo!r}")


_VOICES = {
    "alba": "ad234695323e4030336b6afc8a050c97e3110603e11ecd8226d9562488300a50",
    "azelma": "ef33fad34437cb187d2702f0a946d8ba7a01efdb8efbc8088c770d49c181ba73",
    "cosette": "ca8926c4f234afa9d722173967e7bebdc6269538ca5910d65f41c3c1317717d3",
    "eponine": "bb31940f62da665391de139da2e57d740757df26b73d7ec24152c78a3b8ac0c5",
    "fantine": "b6918a2ece002d2d9037ff53c4ea38730175e8798786658b0958443edf49d355",
    "javert": "2e857904ee76657e083b0e92664d21bd133e37df320af6eb04f752e679422d91",
    "jean": "329530f87ce503061acefca8669300963420ff97e43647a326aa46bd987b983c",
    "marius": "33f75e45fac0005630671f4b1bb632d51b6a083b18417de94855bbd7596a0630",
}


def voice_manifest() -> Manifest:
    return Manifest(
        repo=UNGATED_REPO,
        files=[
            ModelFile(
                filename=f"embeddings/{name}.safetensors",
                revision=_UNGATED_REVISION,
                sha256=digest,
                local_path=f"{name}.safetensors",
            )
            for name, digest in sorted(_VOICES.items())
        ],
    )
