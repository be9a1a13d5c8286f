"""Voice manifest management (parity with `internal/tts/voice.go:11-95`).

``voices/manifest.json``: ``{"voices": [{"id", "path", "license"}]}``; paths
resolve relative to the manifest directory; duplicate/empty IDs rejected.
"""

from __future__ import annotations

import json
import os
import threading
from dataclasses import dataclass
from typing import Dict, List

__all__ = ["Voice", "VoiceManager"]


@dataclass(frozen=True)
class Voice:
    id: str
    path: str
    license: str = ""


class VoiceManager:
    def __init__(self, manifest_path: str) -> None:
        if not manifest_path:
            raise ValueError("manifest path is required")
        with open(manifest_path, "r", encoding="utf-8") as f:
            manifest = json.load(f)
        # Malformed manifests must raise ValueError, never AttributeError
        # (tests/test_fuzz.py; the reference validates the same way,
        # `internal/tts/voice.go:11-95`).
        if not isinstance(manifest, dict):
            raise ValueError("voice manifest must be a JSON object")
        entries = manifest.get("voices", [])
        if not isinstance(entries, list):
            raise ValueError('voice manifest "voices" must be a list')
        self._lock = threading.Lock()
        self._base_dir = os.path.dirname(os.path.abspath(manifest_path))
        self._voices: List[Voice] = []
        self._by_id: Dict[str, Voice] = {}
        for entry in entries:
            if not isinstance(entry, dict):
                raise ValueError("voice manifest entries must be objects")
            v = Voice(
                id=str(entry.get("id", "") or ""),
                path=str(entry.get("path", "") or ""),
                license=str(entry.get("license", "") or ""),
            )
            if not v.id:
                raise ValueError("voice manifest contains empty id")
            if not v.path:
                raise ValueError(f"voice {v.id!r} has empty path")
            if v.id in self._by_id:
                raise ValueError(f"duplicate voice id {v.id!r}")
            self._voices.append(v)
            self._by_id[v.id] = v

    @classmethod
    def in_memory(cls, base_dir: str = "") -> "VoiceManager":
        """A manager with no manifest file — used by ``serve`` when voice
        upload is enabled without a voices manifest on disk."""
        mgr = cls.__new__(cls)
        mgr._lock = threading.Lock()
        mgr._base_dir = os.path.abspath(base_dir or os.getcwd())
        mgr._voices = []
        mgr._by_id = {}
        return mgr

    def register(self, voice_id: str, path: str, license: str = "") -> Voice:
        """Register a voice at runtime (``POST /voices`` upload path).

        Thread-safe; rejects empty ids/paths and duplicates the same way
        manifest loading does. Beyond reference parity — the Go manifest is
        immutable after load (`internal/tts/voice.go:11-95`)."""
        v = Voice(id=str(voice_id or ""), path=str(path or ""), license=license)
        if not v.id:
            raise ValueError("voice id is required")
        if not v.path:
            raise ValueError(f"voice {v.id!r} has empty path")
        with self._lock:
            if v.id in self._by_id:
                raise ValueError(f"duplicate voice id {v.id!r}")
            self._voices.append(v)
            self._by_id[v.id] = v
        return v

    def list_voices(self) -> List[Voice]:
        with self._lock:
            return list(self._voices)

    def resolve_path(self, voice_id: str) -> str:
        with self._lock:
            v = self._by_id.get(voice_id)
        if v is None:
            raise KeyError(f"unknown voice id {voice_id!r}")
        path = v.path
        if not os.path.isabs(path):
            path = os.path.join(self._base_dir, path)
        path = os.path.normpath(path)
        if not os.path.exists(path):
            raise FileNotFoundError(f"voice file for {voice_id!r}: {path}")
        return path
