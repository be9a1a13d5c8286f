#!/usr/bin/env bash
# Runs of the benchmark one after another, each as its own process, from the
# root of a checkout: series.sh OUTDIR SECONDS CELL:SEED:TRACE ...
# Each run's standard output and error go to OUTDIR/<cell>-<seed>-<trace>.{out,err};
# a summary line per run (exit code, wall seconds, the result's last line) to
# OUTDIR/summary.txt.
set -u
out=$1; secs=$2; shift 2
mkdir -p "$out"
for spec in "$@"; do
  IFS=: read -r cell seed trace <<<"$spec"
  tag="$cell-$seed-$trace"
  t0=$(date +%s%N)
  python3 benchmark/run.py --workload "$cell" --seed "$seed" --seconds "$secs" --trace "$trace" \
    >"$out/$tag.out" 2>"$out/$tag.err"
  rc=$?
  t1=$(date +%s%N)
  echo "$tag rc=$rc wall_ms=$(( (t1 - t0) / 1000000 )) $(tail -n 1 "$out/$tag.out")" >>"$out/summary.txt"
done
