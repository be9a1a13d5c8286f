"""How far the batcher's requests drift from the unsharded batcher's when
the same slots are re-partitioned over a mesh, per weight and KV-cache kind.

    python3 scripts/torch_mesh_drift.py [--frames 40]

Needs one CUDA card; every rank of every mesh sits on it. Builds the
kernels, then ``real_arch()`` float32 weights from ``chip_smoke.py``'s
seed, and serves ``chip_smoke.py``'s first 8 serving requests at
temperature 0 (queued before the engines start, so each run admits them as
one burst) through an 8-slot batcher with 8-step blocks and 64-step
bursts, for float32 weights with a float KV cache, int8 weights with a
float KV cache and int8 weights with an int8 KV cache: unsharded twice,
then over ``dp_mesh(2)``, ``dp_tp_mesh(1, 2)`` and ``dp_tp_mesh(2, 2)``.
Prints, per run and request, the RMS against the first unsharded run over
the whole request and at frames 0, 1, 4, 9, 19 and the last, with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_mesh_drift: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from go_pocket_tts_tpu_torch.device import card_line
    from go_pocket_tts_tpu_torch.kernels import build
    from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher, dp_mesh, dp_tp_mesh
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig
    from go_pocket_tts_tpu_torch.runtime.generate import quantized_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    build.build_all()
    arch, model32 = cs.build_model(torch.float32)
    reqs = cs.serving_requests(arch)[0][:8]
    cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=args.frames)
    dev = torch.device("cuda", torch.cuda.current_device())

    def run(model, **kw):
        batcher = ContinuousBatcher(model, slots=8, prompt_capacity=128, max_frames=256, dtype=torch.float32,
                                    seed=cs.SEED, device="cuda", steps_per_sync=8, steps_per_sync_burst=64, **kw)
        futs = [batcher.submit(r, cfg) for r in reqs]
        batcher.start()
        try:
            return [f.result(timeout=600) for f in futs]
        finally:
            batcher.stop()

    def report(name, got, want):
        last = args.frames - 1
        for i, (g, w) in enumerate(zip(got, want)):
            d = (g.astype(np.float64) - w).reshape(-1, 1920)
            per = np.sqrt(np.mean(d**2, axis=1))
            frames = " ".join(f"{f} {per[f]:.2e}" for f in sorted({0, 1, 4, 9, 19, last}) if f <= last)
            print(f"[{name}] request {i}: whole {np.sqrt(np.mean(d**2)):.3e}; frames {frames}  [{card}]", flush=True)

    model8 = quantized_model(model32, True)
    for label, model, kw in (("f32 weights, float KV", model32, {}), ("int8 weights, float KV", model8, {}),
                             ("int8 weights, int8 KV", model8, {"kv_quantize": True})):
        want = run(model, **kw)
        report(f"{label}; unsharded again", run(model, **kw), want)
        for mesh_name, mesh in (("dp=2", dp_mesh(2, devices=[dev] * 2)), ("tp=2", dp_tp_mesh(1, 2, devices=[dev] * 2)),
                                ("dp=2 x tp=2", dp_tp_mesh(2, 2, devices=[dev] * 4))):
            report(f"{label}; {mesh_name}", run(model, mesh=mesh, **kw), want)
    return 0


if __name__ == "__main__":
    sys.exit(main())
