"""Where the time of one batched AR step goes in the port's continuous
batcher.

    python3 scripts/torch_profile_batched.py [--slots 8] [--steps 64] [--quantize 8|4|0] [--no-kv-quantize] [--top 12]

Needs one CUDA card. Builds ``real_arch()`` synthetic weights (bfloat16)
from a seed and a ``ContinuousBatcher`` at the serving configuration (int8
weights, or packed int4 with ``--quantize 4``, or bfloat16 with
``--quantize 0``; an int8 KV cache unless switched off), admits one request into every
slot (prompts of 12-45 tokens, as ``chip_smoke.py`` sends), and then drives
the engine's AR block (``_batched_ar_multi_step``) by hand, without its
thread:

1. one block of ``--steps`` steps, timed on the host from enqueue to a
   device sync (wall per step), and the host time to enqueue it alone;
2. the same block under ``torch.profiler``: device busy time per step (sum
   of kernel times), launches per step, and the kernels that take the most
   device time (``--top`` of them; ``--top 0`` lists every kernel with its
   launches per step, to tell two weight formats' steps apart).

Prints the card's name and power limit beside the numbers.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from go_pocket_tts_tpu_torch.models import synthetic  # noqa: E402
from go_pocket_tts_tpu_torch.models.model import load_model_from_tensors  # noqa: E402
from go_pocket_tts_tpu_torch.parallel import ContinuousBatcher  # noqa: E402
from go_pocket_tts_tpu_torch.parallel import batching  # noqa: E402
from go_pocket_tts_tpu_torch.runtime import GenerateConfig  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--quantize", type=int, choices=(8, 4, 0), default=8, help="weight bits; 0 keeps bfloat16")
    ap.add_argument("--no-kv-quantize", action="store_true")
    ap.add_argument("--top", type=int, default=12, help="kernels listed by device time; 0: all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_profile_batched: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    arch = synthetic.real_arch()
    model = load_model_from_tensors(
        synthetic.build_checkpoint(arch, seed=args.seed), num_heads=arch.num_heads, device="cuda", dtype=torch.bfloat16
    )
    batcher = ContinuousBatcher(
        model, slots=args.slots, prompt_capacity=128, max_frames=256, dtype=torch.bfloat16, seed=args.seed,
        steps_per_sync=8, steps_per_sync_burst=64, quantize=args.quantize,
        kv_quantize=not args.no_kv_quantize, device="cuda",
    )
    rng = np.random.RandomState(args.seed)
    cfg = GenerateConfig(temperature=0.7, eos_threshold=1e9, max_steps=256)
    for n in rng.randint(12, 46, size=args.slots):
        batcher.submit(rng.randint(0, arch.n_bins, size=n).tolist(), cfg)
    params, flow_cfg = batcher.model.params["flow_lm"], batcher.model.config.flow_lm

    def block(k):
        batcher._state, flags = batching._batched_ar_multi_step(
            params, flow_cfg, batcher._state, k, 1, batcher._gen, batcher._time_cond, batcher._fused_ada
        )
        return flags

    with torch.no_grad():
        batcher._admit()  # every slot prefilled and live
        block(8)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        block(args.steps)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ms = (t2 - t0) * 1e3 / args.steps
        enqueue = (t1 - t0) * 1e3 / args.steps
        knobs = f"slots={args.slots} quantize={args.quantize} kv_quantize={not args.no_kv_quantize}"
        print(f"{knobs}: wall {ms:.3f} ms/step (host enqueue {enqueue:.3f} ms/step) over {args.steps} steps  [{card}]")

        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            block(args.steps)
            torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    print(
        f"profiled: device busy {busy_us / 1e3 / args.steps:.4f} ms/step, "
        f"{launches / args.steps:.1f} kernels/step  [{card}]"
    )
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[: args.top or None]:
        print(
            f"  {e.self_device_time_total / 1e3 / args.steps:8.4f} ms/step  {e.count / args.steps:6.1f}/step  {e.key[:90]}"
        )
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
