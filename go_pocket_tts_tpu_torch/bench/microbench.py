"""Op micro-benchmarks of the port (counterpart of
``go_pocket_tts_tpu/bench/microbench.py``; the reference's
`internal/runtime/ops/ops_bench_test.go`).

Times the hot ops at the model's shapes through the port's ``ops`` on one
device::

    python -m go_pocket_tts_tpu_torch.bench.microbench [--device cuda|cpu] [--reps N]

On the card each op is timed with CUDA events around one call after a
warm-up, the median and the minimum of ``--reps`` calls; the first line
names the card and its power limit (``nvidia-smi``). ``--device cpu`` times
PyTorch's CPU kernels with the host clock, which says nothing about a card.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from go_pocket_tts_tpu_torch import ops
from go_pocket_tts_tpu_torch.device import DEFAULT_DEVICE, card_line, resolve_device
from go_pocket_tts_tpu_torch.ops.local_attention import local_windowed_attention

__all__ = ["main"]


def _call_ms(fn, args, dev: torch.device) -> float:
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn(*args)
    return (time.perf_counter() - t0) * 1e3


def _bench(name: str, fn, *args, dev: torch.device, reps: int) -> float:
    _call_ms(fn, args, dev)  # warm-up
    ts = [_call_ms(fn, args, dev) for _ in range(reps)]
    p50 = statistics.median(ts)
    print(f"{name:<40} p50 {p50:8.3f} ms   min {min(ts):8.3f} ms")
    return p50


def main(argv: Optional[List[str]] = None) -> int:
    parser = argparse.ArgumentParser(prog="microbench", description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=DEFAULT_DEVICE, help="cuda (default) or cpu")
    parser.add_argument("--reps", type=int, default=20, help="timed calls per op, after one warm-up")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    reps = max(args.reps, 1)
    if dev.type == "cuda":
        print(f"card: {card_line()}; torch {torch.__version__}, cuda {torch.version.cuda}, CUDA events")
    else:
        print(f"device: cpu; torch {torch.__version__}, host clock (no device metric)")

    rng = np.random.RandomState(0)

    def t(shape, dtype=torch.float32, scale=1.0):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale).to(dev, dtype)

    with torch.inference_mode():
        # Dispatch floor.
        _bench("dispatch floor (x+1)", lambda x: x + 1, torch.zeros(8, device=dev), dev=dev, reps=reps)

        # Decode-step attention at FlowLM shapes.
        b, h, c, d = 1, 16, 448, 64
        q, k, v = t((b, h, 1, d)), t((b, h, c, d)), t((b, h, c, d))
        pos_q = torch.tensor([7], dtype=torch.int32, device=dev)
        pos_k = torch.arange(c, dtype=torch.int32, device=dev)
        _bench(
            "attention step [1,16,1,448,64]",
            lambda q, k, v: ops.attention_with_positions(q, k, v, pos_q, pos_k),
            q,
            k,
            v,
            dev=dev,
            reps=reps,
        )

        # Mimi-decode local attention at the 256-frame bucket's shapes.
        qm = t((1, 8, 4096, 64))
        _bench(
            "local attention [1,8,4096,64] w=250",
            lambda q: local_windowed_attention(q, q, q, 250),
            qm,
            dev=dev,
            reps=reps,
        )

        # RoPE at step shapes.
        cos, sin = (x.to(dev) for x in ops.build_rope_tables(8192, 64))
        _bench("rope [1,16,1,64]", lambda x: ops.apply_rope(x, cos, sin, 7), q, dev=dev, reps=reps)

        # A transformer layer's qkv projection (1024-d model).
        x, w_qkv = t((1, 1024), torch.bfloat16), t((1024, 3072), torch.bfloat16)
        _bench("qkv matvec [1,1024]x[1024,3072] bf16", torch.matmul, x, w_qkv, dev=dev, reps=reps)

        # SEANet transposed conv at decode shapes (stride 6, 512 -> 256 channels).
        xin = t((1, 512, 4096), torch.bfloat16)
        packed = ops.repack_conv_transpose_kernel(t((512, 256, 12), scale=0.1), 1)
        _bench(
            "convT [1,512,4096] s6 k12 -> 256ch",
            lambda x: ops.conv_transpose1d_trim(x, packed, None, 6, 1),
            xin,
            dev=dev,
            reps=reps,
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
