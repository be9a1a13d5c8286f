"""A run whose timed path is broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU at a small size (``tiny_root``): set-up, the window, the metrics
and the output check. Warm-up is skipped (on the CPU there is nothing to
capture). The faults a served model can have: an answer altered where it
is produced, and the control, the reference in a lower precision put in
the program's place. (The training faults, a state left unchanged or half
a batch left out, and an exchange between cards do not exist in these
cells.)"""

import json
import time

import numpy as np
import pytest

from pbench import harness, registry, systems

REF = None


@pytest.fixture(autouse=True)
def no_warm_up(monkeypatch):
    for cls in (systems.RuntimeSystem, systems.BatcherSystem):
        monkeypatch.setattr(cls, "warm", lambda self, *a: None)


def _run(root, cell, hook=None, seconds=2.0, trace=False):
    lines = []
    out = harness.run_cell(root, root / "BENCHMARK.json", cell, 2**32 + 5, seconds, trace, time.perf_counter(),
                           device="cpu", require_card=False, log=lines.append, hook=hook)
    return out, lines


@pytest.mark.parametrize("cell", ["tiny-stream", "tiny-oneshot", "tiny-mixed", "tiny-single-oneshot"])
def test_sound_run_is_correct(tiny_root, cell):
    out, lines = _run(tiny_root, cell)
    assert out["correct"], lines
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks" and lines[-1].startswith("check head_rel_rms")
    assert set(out["metrics"]) >= {"setup_s"}


def _alter(scale):
    """An answer altered where it is produced: every route's first block
    scaled by ``scale``."""

    def hook(system):
        stream, oneshot = system.stream, system.oneshot

        def bad_stream(tokens, temperature, frames, key=None):
            for i, block in enumerate(stream(tokens, temperature, frames, key)):
                yield block * scale if i == 0 else block

        system.stream = bad_stream
        system.oneshot = lambda tokens, temperature, frames, key=None: oneshot(tokens, temperature, frames, key) * scale

    return hook


@pytest.mark.parametrize("cell", ["tiny-stream", "tiny-oneshot", "tiny-mixed", "tiny-single-oneshot"])
def test_altered_answer_is_not_correct(tiny_root, cell):
    out, lines = _run(tiny_root, cell, hook=_alter(1.01))
    assert not out["correct"], lines
    for name in ("head_rel_rms", "decode_rel_rms"):
        assert out["checks"][name]["value"] > out["checks"][name]["limit"]
    assert out["checks"]["step_err"]["value"] <= out["checks"]["step_err"]["limit"]


def test_altered_frame_is_not_correct(tiny_root):
    """A frame altered where it is produced, the audio decoded from it: the
    teacher-forced step catches it past the head."""

    def hook(system):
        orig = system.runtime._ar_loop

        def ar_loop(*args, **kwargs):
            frames, n, carry = orig(*args, **kwargs)
            frames[0, -1] += 0.05
            return frames, n, carry

        system.runtime._ar_loop = ar_loop
        system.probe.attach_runtime(system.runtime)

    out, lines = _run(tiny_root, "tiny-stream", hook=hook)
    assert not out["correct"], lines
    assert out["checks"]["step_err"]["value"] > out["checks"]["step_err"]["limit"]


def test_dropped_request_is_not_correct(tiny_root):
    def hook(system):
        oneshot = system.oneshot
        calls = []

        def flaky(tokens, temperature, frames, key=None):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("lost")
            return oneshot(tokens, temperature, frames, key)

        system.oneshot = flaky

    out, _ = _run(tiny_root, "tiny-oneshot", hook=hook)
    assert not out["correct"] and out["failed"] == 1
    assert out["checks"]["never_delivered"]["value"] == 1


def _control(precision):
    """The reference, computed in ``precision``, in the program's place: it
    serves every request greedily and hands its frames to the probe."""

    def hook(system):
        from conftest import BENCH

        ref = registry.load_reference(BENCH, "pockettts").PocketTTSReference(system._test_weights, system.config, precision)

        def serve(tokens, t, frames, key=None):
            f = ref.frames(tokens, frames)
            if key is not None:
                system.probe.put(key, f)
            return ref.decode(f)

        system.oneshot = serve
        system.stream = lambda tokens, t, frames, key=None: iter([serve(tokens, t, frames, key)])

    return hook


def _limit_decode_vs_control(root, cell, limit):
    path = root / "workloads" / f"{cell}.json"
    w = json.loads(path.read_text())
    w["check"]["limits"]["decode_vs_control"] = limit
    path.write_text(json.dumps(w))


def test_sound_run_is_correct_against_the_control_decode(tiny_root):
    """The decode's gap as a share of the control's on the same frames: a
    sound run reads far under 1."""
    _limit_decode_vs_control(tiny_root, "tiny-oneshot", 0.45)
    out, lines = _run(tiny_root, "tiny-oneshot")
    assert out["correct"], lines
    assert 0 <= out["checks"]["decode_vs_control"]["value"] < 0.45
    assert any("decode_vs_control" in line for line in lines if line.startswith("check request"))


@pytest.mark.parametrize("cell, precision", [
    # Each a step below what the configuration states, as the real
    # configurations' "control" entries.
    ("tiny-stream", {"weights": "fp8", "activations": "fp8"}),
    ("tiny-single-oneshot", {"weights": "fp8", "activations": "fp8"}),
    ("tiny-oneshot", {"weights": "int4", "kv": "int4", "activations": "fp8"}),
])
def test_control_is_not_correct(tiny_root, monkeypatch, cell, precision):
    made = {}
    real = systems.build_system

    def keep_weights(config, host, device, seed):
        s = real(config, host, device, seed)
        s._test_weights = {k: v.clone() for k, v in host.items()}
        made["s"] = s
        return s

    monkeypatch.setattr(systems, "build_system", keep_weights)
    out, lines = _run(tiny_root, cell, hook=_control(precision))
    assert not out["correct"], lines
    assert np.isfinite(out["checks"]["head_rel_rms"]["value"])


def test_control_reads_one_against_its_own_decode(tiny_root, monkeypatch):
    """The control in the program's place decodes its frames as the check's
    control does: ``decode_vs_control`` reads 1, above any limit under it."""
    _limit_decode_vs_control(tiny_root, "tiny-oneshot", 0.45)
    real = systems.build_system

    def keep_weights(config, host, device, seed):
        s = real(config, host, device, seed)
        s._test_weights = {k: v.clone() for k, v in host.items()}
        return s

    monkeypatch.setattr(systems, "build_system", keep_weights)
    control = registry.load_config(tiny_root, "tiny-int8-b4")["control"]
    out, lines = _run(tiny_root, "tiny-oneshot", hook=_control(control))
    assert not out["correct"], lines
    assert out["checks"]["decode_vs_control"]["value"] == pytest.approx(1.0, rel=1e-6)
