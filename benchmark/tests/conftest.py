"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
root of the repository (CPU); the tests marked ``cuda`` run on a card and
skip elsewhere. The benchmark's folder and the repository root go on the
path, as ``benchmark/run.py`` puts them."""

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
REPO = BENCH.parent
for p in (str(BENCH), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

# The published widths scaled down (the port's ``tiny_arch()``); Mimi keeps
# its 8 heads, which the port reads from its own configuration.
TINY = dict(n_bins=64, d_model=64, num_heads=4, num_layers=2, ffn_dim=128, latent_dim=8, flow_dim=32,
            flow_depth=2, flow_hidden=48, freq_half=8, te_hidden=24, mimi_dim=32, mimi_layers=2, mimi_heads=8,
            mimi_ffn=64, seanet_channels=[32, 16, 8, 4])


def tiny_config(name: str, system: dict, reference: dict) -> dict:
    cfg = json.loads((BENCH / "configs" / "pockettts-b6369a24-bf16.json").read_text())
    cfg.update(TINY)
    cfg.update(name=name, system=system, reference=reference)
    return cfg


@pytest.fixture
def tiny_root(tmp_path):
    """A benchmark folder with tiny configurations and cells of the real
    cells' traffic (narrowed to 4-8 tokens), the real metric readers and
    reference, and a BENCHMARK.json naming them: what a later PR that adds a
    cell would add."""
    root = tmp_path / "bench"
    for sub in ("metrics", "references"):
        shutil.copytree(BENCH / sub, root / sub)
    (root / "configs").mkdir()
    (root / "workloads").mkdir()
    single = tiny_config("tiny-f32", {"kind": "runtime", "dtype": "float32", "quantize": False},
                         {"weights": "float32", "kv": "float32"})
    batch = tiny_config("tiny-int8-b4", {"kind": "batcher", "dtype": "float32", "quantize": True, "kv_quantize": True,
                                          "slots": 4, "prompt_capacity": 128, "max_frames": 256,
                                          "steps_per_sync": 8, "steps_per_sync_burst": 64},
                        {"weights": "int8", "kv": "int8"})
    for cfg in (single, batch):
        (root / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    cells = {"tiny-stream": ("tiny-f32", "bf16-single-stream"), "tiny-oneshot": ("tiny-int8-b4", "int8-b8-saturated"),
             "tiny-mixed": ("tiny-int8-b4", "int8-b8-mixed-open"), "tiny-single-oneshot": ("tiny-f32", "bf16-single-oneshot")}
    spec["workloads"] = []
    for cell, (config, like) in cells.items():
        w = json.loads((BENCH / "workloads" / f"{like}.json").read_text())
        w.update(config=config, vocab=64, tokens={"median": 6, "sigma": 0.3, "min": 4, "max": 8}, block=8)
        if w["loop"] == "open":
            w["rate_per_s"] = 3.0
        w["clients"] = min(w.get("clients", 1), 4)
        # Float32 on both sides of the single runtime; the batcher's int8 KV
        # rows take the other level now and then (see the reference test).
        tol = 1e-4 if config == "tiny-f32" else 3e-3
        # The single runtime's one-shot route returns int16 PCM, truncated
        # toward zero: up to one level (1/32767) a sample, ~4e-4 of this
        # tiny decoder's RMS (~0.04); its frames stay float32.
        pcm_tol = 1e-3 if cell == "tiny-single-oneshot" else tol
        w["check"] = dict(w["check"], requests=2, limits={"never_delivered": 0, "malformed": 0, "step_err": tol,
                                                           "decode_rel_rms": pcm_tol, "head_rel_rms": pcm_tol})
        (root / "workloads" / f"{cell}.json").write_text(json.dumps(w))
        spec["workloads"].append({"name": cell, "config": config, "traffic": cell, "chips": 1, "why": like})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if like in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root
