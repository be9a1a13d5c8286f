"""A sweep of an open-loop cell's arrival rate: the cell's traffic at each
of a few rates, one run each, to find the highest rate the port sustains
(the knee) before the cell's rate is fixed at four fifths of it.

A rate is sustained when every request due in the window ends within the
drain, the requests due in the window's last quarter wait no longer than
those of its first quarter by the median (no growing backlog), and each
latency's p95 stays within ``TAIL_FACTOR`` (1.2) times its p95 at the
lowest rate swept: past that the tail is set by the queue, not by the
service, and swings from run to run. The knee is the highest rate that is
sustained with every lower rate. Prints, per rate, the requests, the
failures, the p50 and p95 of both latencies and of the first and last
quarters, whether it is sustained, and last the knee.

Usage (on a card): ``python benchmark/tools/sweep.py --workload NAME
--rates 8,12,16 --seconds 51 --seed N [--out FILE]``.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(1, str(ROOT.parent))

from pbench import harness, registry, stats  # noqa: E402

# A rate's p95 may read this many times the lowest rate's and still count
# as sustained: past it the queue, not the service, sets the tail.
TAIL_FACTOR = 1.2


def latencies(records, route):
    out = []
    for r in records:
        if r.request.route != route:
            continue
        end = r.first if route == "stream" else r.done
        out.append((r.due, stats.MISS if r.error or end is None else end - r.due))
    return out


def summary(run_records, t0, seconds):
    out = {"requests": len(run_records), "failed": sum(1 for r in run_records if r.error)}
    for route, name in (("stream", "ttfa"), ("oneshot", "request")):
        lat = latencies(run_records, route)
        if not lat:
            continue
        vals = [v for _d, v in lat]
        first = [v for d, v in lat if d < t0 + seconds / 4]
        last = [v for d, v in lat if d >= t0 + 3 * seconds / 4]
        out[name] = {k: (None if v is None else v * 1e3) for k, v in (
            ("p50_ms", stats.percentile(vals, 50)), ("p95_ms", stats.percentile(vals, 95)),
            ("first_quarter_p50_ms", stats.percentile(first, 50)), ("last_quarter_p50_ms", stats.percentile(last, 50)),
            ("first_quarter_p95_ms", stats.percentile(first, 95)), ("last_quarter_p95_ms", stats.percentile(last, 95)))}
    return out


def sustained(summ, base, factor):
    """Whether a rate's summary ``summ`` is sustained against ``base``, the
    lowest rate's."""
    if summ["failed"]:
        return False
    for name in ("ttfa", "request"):
        if name not in summ:
            continue
        s, b = summ[name], base[name]
        if None in (s["p95_ms"], b["p95_ms"], s["first_quarter_p50_ms"], s["last_quarter_p50_ms"]):
            return False
        if s["p95_ms"] > factor * b["p95_ms"] or s["last_quarter_p50_ms"] > factor * s["first_quarter_p50_ms"]:
            return False
    return True


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=4_000_000_007)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    tmp = Path(tempfile.mkdtemp(prefix="sweep-"))
    try:
        for sub in ("configs", "metrics", "references", "workloads"):
            shutil.copytree(ROOT / sub, tmp / sub)
        spec = registry.load_spec(ROOT.parent / "BENCHMARK.json")
        result = {"workload": args.workload, "card": registry.card_line(), "rates": {}}
        for rate in (float(r) for r in args.rates.split(",")):
            w = registry.load_workload(ROOT, args.workload)
            w["rate_per_s"] = rate
            (tmp / "workloads" / f"{args.workload}.json").write_text(json.dumps(w))
            (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
            kept = {}
            out = harness.run_cell(tmp, tmp / "BENCHMARK.json", args.workload, args.seed, args.seconds, False,
                                   time.perf_counter(), log=lambda s: None, keep=kept)
            run = kept["run"]
            result["rates"][rate] = {"summary": summary(run.records, run.t0, args.seconds),
                                     "correct": out["correct"], "metrics": out["metrics"]}
            print(rate, json.dumps(result["rates"][rate]), flush=True)
        rates = sorted(result["rates"])
        base = result["rates"][rates[0]]["summary"]
        knee = None
        for rate in rates:
            ok = sustained(result["rates"][rate]["summary"], base, TAIL_FACTOR)
            result["rates"][rate]["sustained"] = ok
            if not ok:
                break
            knee = rate
        result["knee"] = knee
        print("knee", knee, flush=True)
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result, indent=1))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
