"""The harness finds its parts by name: a new configuration, workload or
metric is a new file and a new entry, and a part that is not there fails
clearly."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from pbench import registry

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent


def test_every_entry_has_its_files():
    spec = registry.load_spec(REPO / "BENCHMARK.json")
    for c in spec["configs"]:
        cfg = registry.load_config(BENCH, c["name"])
        assert (REPO / c["file"]).resolve() == (BENCH / "configs" / f"{c['name']}.json").resolve()
        registry.load_reference(BENCH, cfg["reference_impl"])
    for w in spec["workloads"]:
        assert registry.load_workload(BENCH, w["traffic"])["config"] == w["config"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(registry.load_metric(BENCH, m["name"]))


def test_new_files_are_found_by_name(tiny_root):
    (tiny_root / "metrics" / "requests_seen.py").write_text("def read(run):\n    return float(len(run.records))\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["per_layer"].append({"name": "requests_seen", "unit": "count", "better": "higher", "source": "host_clock",
                              "layer": "runtime", "moves": "audio_rate", "workloads": ["tiny-stream"]})
    names = [m["name"] for m in registry.cell_metrics(spec, "tiny-stream", trace=True)]
    assert "requests_seen" in names and "mfu.single" in names and "mfu.batch" not in names
    assert registry.load_metric(tiny_root, "requests_seen")(type("R", (), {"records": [1, 2]})()) == 2.0
    assert registry.load_workload(tiny_root, "tiny-mixed")["config"] == "tiny-int8-b4"
    assert registry.load_config(tiny_root, "tiny-int8-b4")["system"]["slots"] == 4


def test_cell_metrics_follow_their_workloads():
    spec = registry.load_spec(REPO / "BENCHMARK.json")
    e2e = {m["name"] for m in registry.cell_metrics(spec, "int8-b8-mixed-open", trace=False)}
    assert e2e == {"setup_s", "ttfa_p99_ms", "request_p95_ms"}
    per = {m["name"] for m in registry.cell_metrics(spec, "bf16-single-stream", trace=True)}
    assert "decode_attention_roofline.single" in per and "lane_occupancy.batch" not in per


@pytest.mark.parametrize("what", ["workload", "configuration", "metric"])
def test_missing_part_fails_clearly(tmp_path, what):
    with pytest.raises(registry.BenchError, match="no .* named 'absent'"):
        {"workload": registry.load_workload, "configuration": registry.load_config,
         "metric": registry.load_metric}[what](tmp_path, "absent")


def _run(args, cwd, env=None):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=300, env=env)


def test_unknown_workload_exits_without_result():
    p = _run(["--workload", "no-such-cell", "--seed", "1", "--seconds", "1", "--trace", "0"], REPO)
    assert p.returncode == 2 and p.stdout == ""
    assert "no workload named 'no-such-cell'" in p.stderr


def test_no_card_exits_without_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: this is the no-card case")
    p = _run(["--workload", "bf16-single-stream", "--seed", "3", "--seconds", "1", "--trace", "0"], REPO)
    assert p.returncode == 2 and p.stdout == ""
    assert "no CUDA device" in p.stderr


def test_benchmark_alone_exits_without_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's
    folder has no program to measure: no result."""
    import shutil

    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = _run(["--workload", "bf16-single-stream", "--seed", "3", "--seconds", "1", "--trace", "0"], tmp_path, env)
    assert p.returncode != 0 and p.stdout == ""
