"""The hybrid configuration's cell on the CPU at a small size: a sound run
is correct against ``references/pockettts_granite_hybrid.py`` and an
altered frame is not; its new readers read a traced run, and stay silent
(None, no raise) on a program without the Mamba-2 step; the reference's
counts at the published widths."""

import json
import math
import time
from types import SimpleNamespace

import pytest
import torch

from pbench import harness, registry, systems

from conftest import BENCH, REPO

CELL = "granite-h-micro-bf16-stream"


def tiny_hybrid(config: dict) -> dict:
    """granite-4.0-h's layer pattern cut to 3 Mamba-2 layers and 1 attention
    layer at d 64 (4 heads over 2 KV heads, 8 Mamba heads of 16, state 16),
    the port's ``tiny_arch()`` flowNet and Mimi (8 heads)."""
    return dict(
        config, name="tiny-hybrid", hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
        shared_intermediate_size=96, layer_types=["mamba", "mamba", "attention", "mamba"], mamba_n_heads=8,
        mamba_d_head=16, mamba_d_state=16, attention_multiplier=0.0625, d_model=64, num_heads=4, n_bins=64,
        latent_dim=8, flow_dim=32, flow_depth=2, flow_hidden=48, freq_half=8, te_hidden=24, mimi_dim=32,
        mimi_layers=2, mimi_heads=8, mimi_ffn=64, seanet_channels=[32, 16, 8, 4],
        system={"kind": "runtime", "dtype": "float32", "quantize": False},
    )


@pytest.fixture
def hybrid_root(tmp_path):
    import shutil

    root = tmp_path / "bench"
    for sub in ("metrics", "references"):
        shutil.copytree(BENCH / sub, root / sub)
    (root / "configs").mkdir()
    (root / "workloads").mkdir()
    config = json.loads((BENCH / "configs" / "pockettts-granite-4.0-h-micro-bf16.json").read_text())
    (root / "configs" / "tiny-hybrid.json").write_text(json.dumps(tiny_hybrid(config)))
    w = json.loads((BENCH / "workloads" / f"{CELL}.json").read_text())
    w.update(config="tiny-hybrid", vocab=64, tokens={"median": 6, "sigma": 0.3, "min": 4, "max": 8}, block=8)
    # Float32 on both sides: sums in other orders (the port's scan and step
    # against the reference's quadratic form).
    w["check"] = dict(w["check"], requests=2, limits={"never_delivered": 0, "malformed": 0, "step_err": 1e-4,
                                                       "decode_rel_rms": 1e-4, "head_rel_rms": 1e-4})
    (root / "workloads" / "tiny-hybrid-stream.json").write_text(json.dumps(w))
    spec = json.loads((REPO / "BENCHMARK.json").read_text())
    spec["workloads"] = [{"name": "tiny-hybrid-stream", "config": "tiny-hybrid", "traffic": "tiny-hybrid-stream",
                          "chips": 1, "why": CELL}]
    for m in spec["end_to_end"] + spec["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append("tiny-hybrid-stream")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


@pytest.fixture(autouse=True)
def no_warm_up(monkeypatch):
    monkeypatch.setattr(systems.RuntimeSystem, "warm", lambda self, *a: None)


def _run(root, trace=False, hook=None):
    lines = []
    out = harness.run_cell(root, root / "BENCHMARK.json", "tiny-hybrid-stream", 2**32 + 7, 2.0, trace,
                           time.perf_counter(), device="cpu", require_card=False, log=lines.append, hook=hook)
    return out, lines


def test_sound_run_is_correct(hybrid_root):
    out, lines = _run(hybrid_root)
    assert out["correct"], lines
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"setup_s", "audio_rate", "ttfa_p95_ms"}


def test_altered_frame_is_not_correct(hybrid_root):
    def hook(system):
        rt = system.runtime
        orig = rt._ar_loop

        def ar_loop(*args, **kwargs):
            frames, n, carry = orig(*args, **kwargs)
            frames[0, 0] += 0.05
            return frames, n, carry

        rt._ar_loop = ar_loop

    out, lines = _run(hybrid_root, hook=hook)
    assert not out["correct"], lines


def test_traced_run_reads_the_new_metrics(hybrid_root):
    """On the CPU the trace holds no device kernel: the device readers
    return None, mfu reads."""
    out, lines = _run(hybrid_root, trace=True)
    assert out["correct"], lines
    assert set(out["metrics"]) == {"mfu.hybrid"}


def test_readers_stay_silent_without_the_step_kernel():
    """A program without the Mamba-2 step (the parent of this cell) gives
    the new device readers nothing to read: None, not a raise."""
    ref = registry.load_reference(BENCH, "pockettts_granite_hybrid")
    config = registry.load_config(BENCH, "pockettts-granite-4.0-h-micro-bf16")
    trace = SimpleNamespace(counts0={"layer_norm": {"launches": 0, "shapes": {}}},
                            counts1={"layer_norm": {"launches": 9, "shapes": {}}},
                            kernels=[("ln_rows_kernel", 0.1, 1e-6)], t0=0.0, t1=1.0)
    run = SimpleNamespace(trace=trace, config=config, reference=ref)
    for name in ("device_ops_per_frame.hybrid", "mamba2_step_roofline.hybrid"):
        assert registry.load_metric(BENCH, name)(run) is None


def test_reference_counts_at_the_published_widths():
    ref = registry.load_reference(BENCH, "pockettts_granite_hybrid")
    config = registry.load_config(BENCH, "pockettts-granite-4.0-h-micro-bf16")
    specs = ref.leaf_specs(config)
    assert len({name for name, *_ in specs}) == len(specs)
    backbone = sum(math.prod(s) for name, s, *_ in specs if name.startswith("flow_lm.backbone.layers"))
    assert backbone == 2_985_873_152  # 36 · 76,182,976 + 4 · 60,821,504
    # The float32 SSM state read and written is 4.19 MB of the 4.32 MB.
    assert ref.mamba2_step_bytes(config) == 4_324_224
    assert ref.frame_step_flops(config, 200) > ref.frame_step_flops(config, 100) > 2 * 2.9e9
    with pytest.raises(ValueError):
        ref.PocketTTSReference({"x": torch.zeros(1)}, config, {"state": "bfloat16"})
