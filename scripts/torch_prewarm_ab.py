"""The batcher's first wave with and without ``prewarm``, each in a fresh
process.

    python3 scripts/torch_prewarm_ab.py [--order none,prewarm,sweep,sweep,prewarm,none]

Needs one CUDA card. Builds the kernels once, then runs one child process
per entry of ``--order``. Each child builds ``real_arch()`` synthetic
weights (bfloat16, from ``chip_smoke.py``'s seed), a ``BatcherRuntime`` at
the serving settings (8 slots, int8 weights and KV cache, 8-step blocks,
64-step bursts, prompt capacity 128), warms it as its mode says, and runs
``chip_smoke.py``'s mixed wave (phase 5's 16 requests at once, the first 8
streamed) twice:

- ``none``: no warm-up; the first wave meets the process cold;
- ``prewarm``: ``BatcherRuntime.prewarm((12,))``, as ``chip_smoke.py``
  phase 12 calls it (a full-slot admission of 12-token requests, a single
  admission, a streamed single and a streamed full-slot wave);
- ``sweep``: the same, then the JAX package's sweep over every
  harvest-decode bucket a lane can reach, each as a full-slot wave and a
  single request.

Prints, per child, the warm-up's wall and each wave's time to first block
(p50 and max over the 8 streamed lanes), wall and x real time aggregate,
then one JSON line with all of it and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("none", "prewarm", "sweep")


def harvest_sweep(batcher, n_tokens: int = 12, timeout: float = 600.0) -> None:
    """Every harvest-decode bucket up to ``max_frames``, at its cheapest
    frame count, as a full-slot wave and as a single request."""
    from go_pocket_tts_tpu_torch.runtime import GenerateConfig
    from go_pocket_tts_tpu_torch.utils import buckets as bk

    tokens, n = [0] * n_tokens, 1
    while n <= batcher.max_frames:
        b = bk.pick_bucket(n, bk.DECODE_BUCKETS)
        cfg = GenerateConfig(temperature=0.0, eos_threshold=1e9, max_steps=n)
        for f in [batcher.submit(tokens, cfg) for _ in range(batcher.slots)]:
            f.result(timeout=timeout)
        batcher.generate(tokens, cfg, timeout=timeout)
        n = b + 1


def child(mode: str) -> dict:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from go_pocket_tts_tpu_torch.parallel import BatcherRuntime

    torch.backends.cuda.matmul.allow_tf32 = False
    cs.CARD = cs.card_line()
    arch, model = cs.build_model(torch.bfloat16)
    rt = BatcherRuntime(model, dtype=torch.bfloat16, seed=cs.SEED, device="cuda", **cs.SERVING)
    try:
        t = time.perf_counter()
        if mode != "none":
            rt.prewarm((12,))
        if mode == "sweep":
            harvest_sweep(rt.batcher)
        warm_s = time.perf_counter() - t
        waves = [cs.mixed_wave(rt, arch, {}) for _ in range(2)]
    finally:
        rt.close()
    out = {"mode": mode, "warm_s": warm_s, "card": cs.CARD}
    for i, w in enumerate(waves, 1):
        firsts = sorted(w["first_s"])
        out[f"wave{i}"] = {
            "first_p50_ms": statistics.median(firsts) * 1e3,
            "first_max_ms": firsts[-1] * 1e3,
            "first_ms": [f * 1e3 for f in firsts],
            "wall_ms": w["wall_s"] * 1e3,
            "x_real_time": w["audio_s"] / w["wall_s"],
        }
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--order", default="none,prewarm,sweep,sweep,prewarm,none")
    ap.add_argument("--child", choices=MODES, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print("RESULT " + json.dumps(child(args.child)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("torch_prewarm_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from go_pocket_tts_tpu_torch.kernels import build

    t = time.perf_counter()
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t:.1f} s", flush=True)
    results = []
    for mode in args.order.split(","):
        if mode not in MODES:
            raise SystemExit(f"torch_prewarm_ab: unknown mode {mode!r}")
        t = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", mode],
            capture_output=True, text=True, timeout=900, cwd=ROOT,
        )
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"torch_prewarm_ab: child {mode} exited {proc.returncode}")
        r = json.loads(lines[-1][len("RESULT "):])
        r["process_s"] = time.perf_counter() - t
        results.append(r)
        waves = "; ".join(
            f"wave {i}: first block p50 {w['first_p50_ms']:.1f} ms, max {w['first_max_ms']:.1f} ms, "
            f"wall {w['wall_ms']:.1f} ms, x{w['x_real_time']:.2f}"
            for i, w in ((i, r[f"wave{i}"]) for i in (1, 2))
        )
        print(f"{mode:7s}: warm-up {r['warm_s'] * 1e3:.1f} ms; {waves}  [{r['card']}]", flush=True)
    print(json.dumps({"prewarm_ab": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
