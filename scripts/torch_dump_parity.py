#!/usr/bin/env python3
"""Dump a parity fixture in the reference JSON schema from the PyTorch port's
independent torch oracle (``go_pocket_tts_tpu_torch/tts/runtime_torch.py``).

The port-side producer of ``scripts/dump_parity.py --backend torch-oracle``:
the same schema, the same deterministic ``det_ramp`` inputs and the same
cases, importing only the port (no JAX), so it runs on a host that has
PyTorch alone. The fixture is replayed by
``go_pocket_tts_tpu_torch.tts.parity_fixture.verify_fixture``:

    python scripts/torch_dump_parity.py --model ckpt.safetensors \\
        --num-heads 16 --device cpu --output build/parity/oracle.json

Schema::

    {"source": {...},
     "flow_lm_prefill_step": {"tokens", "step_latent", "prompt_layer_offsets",
                              "step_layer_offsets", "step_last_hidden",
                              "step_eos_logits"},
     "mimi": [{"name", "latent", "latent_to_mimi", "mimi_decode"}, ...]}

Tensors are ``{"shape": [...], "data": [flat floats]}``. Pseudo-inputs are the
schema's deterministic ramp ``((i % 23) - 11) * scale`` (step latent scale
0.05, mimi latent scale 0.03). ``--device`` defaults to ``cuda`` (the oracle
then computes in true float32 on the card); pass ``cpu`` for the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _REPO not in sys.path:
    sys.path.insert(0, _REPO)


def det_ramp(shape, scale: float) -> np.ndarray:
    n = int(np.prod(shape))
    return ((np.arange(n, dtype=np.float32) % 23 - 11) * scale).reshape(shape)


def tensor_json(arr) -> Dict[str, Any]:
    a = np.asarray(arr, np.float32)
    return {"shape": list(a.shape), "data": [float(x) for x in a.reshape(-1)]}


def dump_from_torch_oracle(model: str, num_heads: int, flow_tokens: str, mimi_frames: str, device: str) -> Dict[str, Any]:
    import torch

    from go_pocket_tts_tpu_torch.tts.runtime_torch import TorchRuntime

    rt = TorchRuntime.from_checkpoint(model, num_heads=num_heads, device=device)
    L, dev = rt.L, rt.device
    tokens = [int(t) for t in flow_tokens.split(",")]

    def host(t):
        return t.cpu().numpy()

    with rt._compute():
        ids = torch.tensor(tokens, dtype=torch.long, device=dev)
        emb = L("flow_lm.conditioner.embed.weight")[ids][None]
        kv = [None] * rt.n_layers
        x = emb
        for i in range(rt.n_layers):
            x = rt._attn_layer(f"flow_lm.transformer.layers.{i}", x, kv, i, 0, rt.num_heads)
        prompt_offsets = [emb.shape[1]] * rt.n_layers

        latent = torch.from_numpy(det_ramp((1, 1, rt.latent_dim), 0.05)).to(dev)
        x = L.linear("flow_lm.input_linear", latent)
        for i in range(rt.n_layers):
            x = rt._attn_layer(f"flow_lm.transformer.layers.{i}", x, kv, i, emb.shape[1], rt.num_heads)
        step_offsets = [emb.shape[1] + 1] * rt.n_layers
        y = L.layer_norm("flow_lm.out_norm", x)
        last = y[:, -1]
        eos = L.linear("flow_lm.out_eos", last)

        flow_case = {
            "tokens": tokens,
            "step_latent": tensor_json(host(latent)),
            "prompt_layer_offsets": prompt_offsets,
            "step_layer_offsets": step_offsets,
            "step_last_hidden": tensor_json(host(last)),
            "step_eos_logits": tensor_json(host(eos)),
        }

        mimi_cases: List[Dict[str, Any]] = []
        for frames in (int(f) for f in mimi_frames.split(",")):
            lat = torch.from_numpy(det_ramp((1, frames, rt.latent_dim), 0.03)).to(dev)
            denorm = lat * L("flow_lm.emb_std") + L("flow_lm.emb_mean")
            w = L("mimi.quantizer.output_proj.weight")[:, :, 0]
            q = torch.einsum("oc,btc->bot", w, denorm)
            if L.has("mimi.quantizer.output_proj.bias"):
                q = q + L("mimi.quantizer.output_proj.bias")[None, :, None]
            audio = rt._mimi_decode(q)
            mimi_cases.append(
                {
                    "name": f"{frames}_frames",
                    "latent": tensor_json(host(lat)),
                    "latent_to_mimi": tensor_json(host(q)),
                    "mimi_decode": tensor_json(host(audio)),
                }
            )

    return {
        "source": {"producer": "torch-oracle", "model": model},
        "flow_lm_prefill_step": flow_case,
        "mimi": mimi_cases,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--model", required=True, help="safetensors checkpoint")
    p.add_argument("--num-heads", type=int, default=16)
    p.add_argument("--output", required=True)
    p.add_argument("--flow-tokens", default="10,20,30")
    p.add_argument("--mimi-frames", default="1,2,4")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    fixture = dump_from_torch_oracle(args.model, args.num_heads, args.flow_tokens, args.mimi_frames, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    with open(args.output, "w", encoding="utf-8") as fh:
        json.dump(fixture, fh)
    print(args.output)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
