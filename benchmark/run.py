"""The benchmark of the PyTorch and CUDA port, one run of one cell.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

Run from the root of a checkout on a machine with the cards the cell asks
for. Prints the checks on standard error and, as the last line of standard
output, one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``. Exits with 2 and prints no result when the cell cannot run
(no card, too few cards, a part missing, a forbidden module loaded).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
HOST_THREADS = 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # The port must not make a library load JAX behind its back; and the
    # load comes from one process with few threads.
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    os.environ.setdefault("OMP_NUM_THREADS", str(HOST_THREADS))
    sys.path.insert(0, str(ROOT))
    sys.path.insert(1, str(CHECKOUT))
    import torch

    torch.set_num_threads(HOST_THREADS)
    from pbench import harness, registry

    try:
        result = harness.run_cell(
            ROOT, CHECKOUT / "BENCHMARK.json", args.workload, args.seed, args.seconds, bool(args.trace), T_START
        )
    except (registry.BenchError, ImportError) as exc:
        print(f"benchmark: cannot run: {exc}", file=sys.stderr, flush=True)
        return 2
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
