"""Kernels 5 and 6 on their own: the checks of ``chip_smoke.py`` phase 2
for the int8 weight-only matmul (``quantized_matmul``) or, with ``--int4``,
the packed-int4 one (``int4_matmul``).

    python3 scripts/time_quantized_matmul.py [--int4] [--serving]

Needs one CUDA card and ``nvcc``. At every gated linear of the published
model (``chip_smoke.QMM_SHAPES``) and 1, 8 and 64 rows it prints the
kernel's max error against its plain version (float32 product and fused
form), its device time by CUDA-graph replay, the plain version's, the
library call's where this torch has one, a matmul on the dequantized
weight, and the bound, with the card's name and power limit. With
``--serving`` it then runs ``chip_smoke.py``'s phase 5 (the 8-slot int8 /
int8-KV batcher on 16 requests, then 4 with a bf16 KV cache) or, with
``--int4``, phase 7 (the int4 artifact exported, loaded and served by the
same batcher on the same 16 requests, then one ``GPURuntime`` request),
and prints its aggregate x real time. Run from another checkout's root, it
times that checkout's kernel and batcher with that checkout's checks: one
call can time two trees in turns.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys

import torch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--int4", action="store_true", help="kernel 6 (and phase 7) in place of kernel 5 (and phase 5)")
    ap.add_argument("--serving", action="store_true", help="also run chip_smoke.py's phase 5 (7 with --int4)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_quantized_matmul: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.main: full float32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.CARD = chip_smoke.card_line()
    print(f"card: {chip_smoke.CARD}; torch {torch.__version__}; checkout {os.getcwd()}")
    rows = collections.defaultdict(dict)
    if args.int4:
        chip_smoke.check_int4_matmul(rows)
    else:
        chip_smoke.check_quantized_matmul(rows)
    if args.serving and args.int4:
        # Phase 7 prints its aggregate (against phase 5's, not run here: nan).
        arch, model32 = chip_smoke.build_model(torch.float32)
        chip_smoke.int4_serving(model32, arch, {}, float("nan"))
    elif args.serving:
        arch, model = chip_smoke.build_model(torch.bfloat16)
        x_real = chip_smoke.batched_serving(model, arch, {})
        print(f"phase 5: int8 weights + int8 KV cache x{x_real:.2f} real time aggregate  [{chip_smoke.CARD}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
