"""Spreads of a cell's runs, the way the bounds are set: for each metric,
the distance between the first and third quartiles
(``statistics.quantiles(values, n=4)``) as a share of the median, per set
of runs, and the largest check numbers.

Usage: ``python benchmark/tools/spread.py SUMMARY [SUMMARY ...]``, each a
``series.sh`` summary file; runs are grouped by cell and, within a cell,
by the summary file they came from (one set each).
"""

from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict


def spread(values):
    if len(values) < 2:
        return None
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med if med else None


def main(paths) -> int:
    sets = defaultdict(lambda: defaultdict(list))  # cell -> set -> results
    for path in paths:
        for line in open(path):
            tag, rc, wall, *rest = line.split(" ", 3)
            if rc != "rc=0" or not rest:
                print("not a result:", line.strip()[:200])
                continue
            cell = tag.rsplit("-", 2)[0]
            sets[cell][path].append(json.loads(rest[-1]))
    for cell, by_set in sets.items():
        print(f"== {cell}")
        worst = defaultdict(float)
        for path, results in by_set.items():
            names = sorted({k for r in results for k in r["metrics"]})
            parts = []
            for name in names:
                vals = [r["metrics"][name]["value"] for r in results if name in r["metrics"]]
                s = spread(vals)
                parts.append(f"{name}: median {statistics.median(vals):.6g} spread {s if s is None else round(s, 5)} (n={len(vals)})")
            print(f"  {path}: correct {sum(r['correct'] for r in results)}/{len(results)}")
            for p in parts:
                print("   ", p)
            for r in results:
                for k, v in r.get("checks", {}).items():
                    worst[k] = max(worst[k], v["value"])
        print("  largest check numbers:", dict(worst))
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
