"""The control's readings: the plain reference, computed in the precision
below the configuration's (its file's ``control`` entry), put in the
program's place for a cell's requests, and judged by the cell's own output
check. Its numbers must come out above the limits (PERF.md §6 gives the
readings each limit was set from).

For each seed the cell's traffic is drawn as a run draws it, and the
check's sample is taken from the greedy requests of its first
``--requests-drawn`` requests (the longest always in it): the control
serves them one by one, its frames handed to the probe, and the check
measures them against the reference of the configuration.

Usage (on a card): ``python benchmark/tools/control.py --workload NAME
--seeds N,N,N [--out FILE]``.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from pbench import check, harness, registry, traffic  # noqa: E402
from pbench.probe import FrameProbe  # noqa: E402
from pbench.weights import make_weights  # noqa: E402


@dataclass
class Served:
    request: traffic.Request
    pcm: np.ndarray
    error: object = None


def readings(root: Path, cell: str, seed: int, drawn: int, device: torch.device) -> dict:
    workload = registry.load_workload(root, cell)
    config = registry.load_config(root, workload["config"])
    ref_mod = registry.load_reference(root, config["reference_impl"])
    weights = make_weights(ref_mod, config, harness._sub_seed(seed, 1), device)
    requests = list(itertools.islice(traffic.draw(workload, harness._sub_seed(seed, 3)), drawn))
    control = ref_mod.PocketTTSReference(weights, config, config["control"])
    probe = FrameProbe()
    served = []
    for req in requests:
        if not req.greedy:
            continue
        frames = control.frames(req.tokens, req.frames)
        probe.put(req.index, frames)
        served.append(Served(req, control.decode(frames)))
    picked = check.sample(served, int(workload["check"]["requests"]), harness._sub_seed(seed, 4))
    ref = ref_mod.PocketTTSReference(weights, config, config.get("reference"))
    numbers = check.measure(ref, picked, lambda r: probe.frames(r.request.index, r.request.frames),
                            int(workload["check"]["head_frames"]), control=control)
    numbers["frames_checked"] = sum(r.request.frames for r in picked)
    return numbers


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--requests-drawn", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=str(ROOT))
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    out = {"workload": args.workload, "card": registry.card_line(), "control": {}}
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out["control"][seed] = readings(Path(args.root), args.workload, seed, args.requests_drawn, torch.device(args.device))
        out["control"][seed]["seconds"] = time.perf_counter() - t0
        print(seed, out["control"][seed], flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
