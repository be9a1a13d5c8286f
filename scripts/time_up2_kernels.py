"""Kernels 7 and 8 on their own: the check of ``chip_smoke.py`` phase 2 for
the up2 kernel (``fused_up2_res``) and the up2 -> up3 -> tail cascade
(``fused_up2_up3_tail``, whole and in 16-frame streamed blocks).

    python3 scripts/time_up2_kernels.py

Needs one CUDA card and ``nvcc``. For float32 and bfloat16 at 160 frames
(x [1,256,15360]) it prints each kernel's max error against its plain
version, its device time by CUDA-graph replay, the plain version's, kernel
7's op chain of ``mimi_decode`` and the bound, with the card's name and
power limit. Run from another checkout's root, it times that checkout's
kernels with this check.
"""

from __future__ import annotations

import collections
import os
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("time_up2_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.main: full float32 plain versions
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.CARD = chip_smoke.card_line()
    print(f"card: {chip_smoke.CARD}; torch {torch.__version__}; checkout {os.getcwd()}")
    chip_smoke.check_up2(collections.defaultdict(dict))
    return 0


if __name__ == "__main__":
    sys.exit(main())
