"""Upstream-parity fixture tier: load + verify reference-schema JSON dumps
(counterpart of the reference package's ``tts/parity_fixture.py``).

The reference's strongest oracle is JSON dumps of the actual upstream PyTorch
model (`scripts/dump_python_parity.py:106-196` of the Go reference), loaded
by its Go tests via ``POCKETTTS_NATIVE_PY_FIXTURE``
(`internal/native/python_parity_test.go:12-252`). This module implements the
same contract for the port's model:

- :func:`load_fixture` parses the reference dump schema
  (``flow_lm_prefill_step`` + ``mimi`` cases, ``{shape, data}`` tensors)
- :func:`verify_fixture` replays the dumped inputs through the port's model
  on the model's device (the decode-attention and SEANet kernels on the
  card, their plain versions on the CPU) and compares at the reference
  tolerances (`internal/runtime/ops/tolerance.go`,
  `python_parity_test.go:88,118-120`): hidden/eos abs 2e-4 / rel 5e-3,
  latent→mimi rel 1e-3, decoded audio rel 5e-2

``scripts/torch_dump_parity.py`` produces fixtures in this schema from the
port's independent torch oracle (:mod:`tts.runtime_torch`).
"""

from __future__ import annotations

import contextlib
import json
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from go_pocket_tts_tpu_torch.device import exact_float32
from go_pocket_tts_tpu_torch.tts.parity import TensorParityReport, compare_tensor

__all__ = ["ParityFixture", "load_fixture", "verify_fixture", "HIDDEN_TOL", "CONV_TOL", "DECONV_TOL"]

# Reference tolerances (`python_parity_test.go:88,118-120`).
HIDDEN_TOL = dict(atol=2e-4, rtol=5e-3)
CONV_TOL = dict(atol=2e-4, rtol=1e-3)
DECONV_TOL = dict(atol=2e-4, rtol=5e-2)


def _tensor(obj: Optional[dict]) -> Optional[np.ndarray]:
    if obj is None:
        return None
    return np.asarray(obj["data"], np.float32).reshape(obj["shape"])


def _host(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


@dataclass
class ParityFixture:
    flow: Optional[dict] = None
    mimi: List[dict] = field(default_factory=list)
    source: dict = field(default_factory=dict)


def load_fixture(path: str) -> ParityFixture:
    with open(path, "r", encoding="utf-8") as fh:
        raw = json.load(fh)
    return ParityFixture(
        flow=raw.get("flow_lm_prefill_step"),
        mimi=raw.get("mimi", []),
        source=raw.get("source", {}),
    )


def _verify_flow(model, case: dict) -> List[TensorParityReport]:
    """Replay tokens → prefill → one transformer step, compare the dumped
    last-hidden / eos-logit / per-layer offsets."""
    from go_pocket_tts_tpu_torch.models import flow_lm as flm
    from go_pocket_tts_tpu_torch.models import flow_transformer as ftr
    from go_pocket_tts_tpu_torch.models.params import apply_linear

    flow = model.params["flow_lm"]
    cfg = model.config.flow_lm
    dev, dtype = model.device, model.dtype
    tokens = [int(t) for t in case["tokens"]]
    reports: List[TensorParityReport] = []

    emb = flm.text_embeddings(flow, torch.tensor([tokens], dtype=torch.long, device=dev))
    cache = ftr.init_kv_cache(cfg.transformer, batch=1, capacity=len(tokens) + 8, dtype=dtype, device=dev)
    cache = flm.prompt(flow, cfg, cache, emb)

    def check_offsets(name: str, want: Optional[list]) -> None:
        if not want:
            return
        # This engine advances all layers in lock-step behind one offset;
        # the upstream dump records one offset per stateful module.
        got = int(cache["offset"])
        ok = all(int(o) == got for o in want)
        reports.append(TensorParityReport(name, True, 0.0 if ok else float("inf"), 0.0 if ok else float("inf"), ok))

    check_offsets("flow_prompt_layer_offsets", case.get("prompt_layer_offsets"))

    latent = torch.from_numpy(_tensor(case["step_latent"])).to(dev, dtype)  # [1, 1, L]
    x = apply_linear(flow["input_linear"], latent)
    y, cache = ftr.transformer_forward_cached(flow["transformer"], cfg.transformer, cache, x)
    check_offsets("flow_step_layer_offsets", case.get("step_layer_offsets"))
    last, eos = flm._hidden_and_eos(flow, y)

    want_last = _tensor(case.get("step_last_hidden"))
    if want_last is not None:
        reports.append(compare_tensor("flow_lm_step_last_hidden", _host(last), want_last, **HIDDEN_TOL))
    want_eos = _tensor(case.get("step_eos_logits"))
    if want_eos is not None:
        reports.append(
            compare_tensor("flow_lm_step_eos_logits", _host(eos).reshape(want_eos.shape), want_eos, **HIDDEN_TOL)
        )
    return reports


def _verify_mimi(model, case: dict) -> List[TensorParityReport]:
    name = case.get("name", "mimi")
    latent = torch.from_numpy(_tensor(case["latent"])).to(model.device, model.dtype)  # [1, T, L]
    reports: List[TensorParityReport] = []

    mimi_latent = model.latent_to_mimi(latent)
    want_l2m = _tensor(case.get("latent_to_mimi"))
    if want_l2m is not None:
        reports.append(compare_tensor(f"{name}/latent_to_mimi", _host(mimi_latent), want_l2m, **CONV_TOL))
    want_audio = _tensor(case.get("mimi_decode"))
    if want_audio is not None:
        audio = model.mimi_decode(mimi_latent)
        reports.append(compare_tensor(f"{name}/mimi_decode", _host(audio), want_audio, **DECONV_TOL))
    return reports


def verify_fixture(model, fixture: ParityFixture) -> List[TensorParityReport]:
    """Run every case in the fixture through ``model`` (a
    :class:`models.model.PocketTTSModel`, float32 params, on any device)
    and return the reports. A float32 model on the card computes in true
    float32, whatever the caller's TF32 flags."""
    exact = model.device.type == "cuda" and model.dtype == torch.float32
    reports: List[TensorParityReport] = []
    with torch.inference_mode(), exact_float32() if exact else contextlib.nullcontext():
        if fixture.flow is not None:
            reports.extend(_verify_flow(model, fixture.flow))
        for case in fixture.mimi:
            reports.extend(_verify_mimi(model, case))
    return reports
