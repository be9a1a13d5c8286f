"""CLI subprocess backend: shell out to an external ``pocket-tts`` binary
(counterpart of the reference package's ``tts/runtime_cli.py``).

The reference's third backend strategy (`internal/server/server.go:599-654`,
`cmd/pockettts/synth.go:209-256`): text in, WAV bytes out of a subprocess.
Used by ``serve``/``synth`` when ``--backend cli`` is selected; it runs
nothing on the card.
"""

from __future__ import annotations

import subprocess
from typing import List, Sequence

import numpy as np

from go_pocket_tts_tpu_torch.utils import wav

__all__ = ["CLIRuntime", "build_passthrough_args"]


def build_passthrough_args(items: Sequence[str]) -> List[str]:
    """``k=v`` items → normalized ``--k=v`` flags for the wrapped binary
    (`cmd/pockettts/synth.go:521-551`): blank items skipped, missing ``=``
    or empty key rejected, existing ``-``/``--`` prefixes preserved."""
    args: List[str] = []
    for item in items:
        item = item.strip()
        if not item:
            continue
        key, sep, val = item.partition("=")
        if not sep:
            raise ValueError(f"invalid --tts-arg {item!r}: expected key=value")
        key = key.strip()
        val = val.strip()
        if not key:
            raise ValueError(f"invalid --tts-arg {item!r}: empty key")
        if key.startswith("--") or key.startswith("-"):
            args.append(f"{key}={val}")
        else:
            args.append(f"--{key}={val}")
    return args


class CLIRuntime:
    """Whole-text synthesizer over a subprocess (no tokenizer round-trip)."""

    def __init__(
        self,
        cli_path: str = "pocket-tts",
        quiet: bool = True,
        timeout: float = 300.0,
        extra_args: Sequence[str] = (),
        config_path: str = "",
    ):
        self.cli_path = cli_path
        self.quiet = quiet
        self.timeout = timeout
        self.extra_args = build_passthrough_args(extra_args)
        self.config_path = config_path

    def mimi_timing(self):
        return 12.5, 200.0, 16

    def synthesize_text(self, text: str, voice_path: str = "") -> np.ndarray:
        cmd: List[str] = [self.cli_path, "generate", "--text", text, "--output-path", "-"]
        if voice_path:
            cmd += ["--voice", voice_path]
        if self.config_path:
            cmd += ["--config", self.config_path]
        if self.quiet:
            cmd.append("--quiet")
        cmd += self.extra_args
        proc = subprocess.run(
            cmd, capture_output=True, timeout=self.timeout, check=False
        )
        if proc.returncode != 0:
            stderr = proc.stderr.decode("utf-8", errors="replace")[:512]
            raise RuntimeError(f"pocket-tts subprocess failed ({proc.returncode}): {stderr}")
        samples, _rate = wav.decode_wav(proc.stdout)
        return samples

    def close(self) -> None:
        pass
