"""Model and tokenizer verification (counterpart of
``go_pocket_tts_tpu/model_assets/verify.py``; `internal/model/verify.go`,
`cmd/pockettts/model_verify.go:55-100`): file exists → header keys → smoke
load on the device → tokenizer check."""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Union

import torch

from go_pocket_tts_tpu_torch.device import DEFAULT_DEVICE
from go_pocket_tts_tpu_torch.utils.safetensors import validate_model_keys

__all__ = ["VerifyResult", "verify_native_model"]


@dataclass
class VerifyResult:
    ok: bool = True
    checks: List[str] = field(default_factory=list)
    failures: List[str] = field(default_factory=list)

    def record(self, name: str, ok: bool, detail: str = "") -> None:
        line = f"{'✓' if ok else '✗'} {name}" + (f": {detail}" if detail else "")
        self.checks.append(line)
        if not ok:
            self.ok = False
            self.failures.append(line)


def verify_native_model(
    model_path: str,
    tokenizer_path: str = "",
    smoke_load: bool = True,
    device: Union[str, torch.device] = DEFAULT_DEVICE,
) -> VerifyResult:
    """The checks as ✓/✗ lines. The smoke load builds the model on
    ``device`` (the card unless the caller asks for the CPU; no CUDA there
    is a failed check, never a load on the CPU)."""
    res = VerifyResult()

    exists = os.path.exists(model_path)
    res.record("model file exists", exists, model_path)
    if not exists:
        return res

    try:
        validate_model_keys(model_path)
        res.record("model header keys", True)
    except Exception as exc:  # noqa: BLE001 - reported as a failed check
        res.record("model header keys", False, str(exc))
        return res

    if smoke_load:
        try:
            from go_pocket_tts_tpu_torch.models.model import load_model
            from go_pocket_tts_tpu_torch.models.quantize import model_quantized_bits

            model = load_model(model_path, device=device)
            d = model.config.flow_lm.d_model
            bits = model_quantized_bits(model.params)
            detail = f"d_model={d}" + (f", pre-quantized int{bits}" if bits else "")
            res.record("model smoke load", True, detail)
        except Exception as exc:  # noqa: BLE001 - reported as a failed check
            res.record("model smoke load", False, str(exc))

    if tokenizer_path:
        if not os.path.exists(tokenizer_path):
            res.record("tokenizer file exists", False, tokenizer_path)
        else:
            try:
                from go_pocket_tts_tpu_torch.text.sentencepiece import load_tokenizer

                tok = load_tokenizer(tokenizer_path)
                ids = tok.encode("Hello world.")
                res.record("tokenizer encode", bool(ids), f"vocab={tok.vocab_size}")
            except Exception as exc:  # noqa: BLE001 - reported as a failed check
                res.record("tokenizer encode", False, str(exc))
    return res
