"""The frame probe names the private attribute of the port that moved, and
the output check's readings per request, worked by hand."""

import types

import numpy as np
import pytest
import torch

from pbench import check
from pbench.probe import FrameProbe, ProbeError
from pbench.registry import BenchError


class _Engine:
    def __init__(self, state=None, info=None):
        self._state = {"frames": torch.arange(12.0).reshape(2, 3, 2)} if state is None else state
        self._slot_info = [types.SimpleNamespace(request=None) for _ in range(2)] if info is None else info
        self.released = []

    def _release_slots(self, slots):
        self.released.extend(slots)


def test_probe_error_is_a_bench_error():
    assert issubclass(ProbeError, BenchError)


@pytest.mark.parametrize("engine, named", [
    (_Engine(state={"other": 1}), "_state"),
    (_Engine(info=[object(), object()]), "_slot_info"),
    (types.SimpleNamespace(_state={}, _slot_info=[]), "_release_slots"),
])
def test_attach_engine_names_the_missing_attribute(engine, named):
    with pytest.raises(ProbeError, match=named):
        FrameProbe().attach_engine(engine)


def test_a_moved_lane_field_is_named_and_the_engine_goes_on():
    engine = _Engine()
    probe = FrameProbe()
    probe.attach_engine(engine)
    cfg = object()
    probe.want(cfg, 7)
    engine._slot_info[1].request = types.SimpleNamespace(cfg=cfg)
    engine._release_slots([1])
    assert engine.released == [1]
    assert torch.equal(probe.frames(7, 3), torch.arange(6.0, 12.0).reshape(3, 2))
    engine._slot_info[0].request = types.SimpleNamespace()  # no .cfg: the field moved
    engine._release_slots([0])
    assert engine.released == [1, 0]
    with pytest.raises(ProbeError, match=r"request\.cfg"):
        probe.frames(7, 3)
    with pytest.raises(ProbeError):
        probe.raise_if_moved()


def test_a_moved_ar_loop_return_is_named():
    runtime = types.SimpleNamespace(_ar_loop=lambda: (torch.zeros(1, 4, 2), torch.tensor([4])))
    probe = FrameProbe()
    probe.attach_runtime(runtime)
    with probe.recording(3):
        assert len(runtime._ar_loop()) == 2  # the call's own result passes through
    with pytest.raises(ProbeError, match="_ar_loop"):
        probe.frames(3, 4)


def test_attach_runtime_needs_the_ar_loop():
    with pytest.raises(ProbeError, match="_ar_loop"):
        FrameProbe().attach_runtime(types.SimpleNamespace())


class _Ref:
    """A reference whose decode is the frames repeated to 1920 samples a
    frame; teacher forcing and the head give the served frames back."""

    device = torch.device("cpu")

    def teacher_frames(self, tokens, served):
        return served

    def frames(self, tokens, n):
        return self.given[:n]

    def decode(self, frames):
        return np.repeat(frames[:, 0].double().numpy(), check.SAMPLES_PER_FRAME)


def test_readings_per_request_by_hand():
    # Two one-frame requests: a loud one (reference level 1.0, served 1.01)
    # and a quiet one (0.1, served 0.102); they read 0.01 and 0.02, and the
    # check keeps the larger.
    records = []
    for index, (level, served) in enumerate([(1.0, 1.01), (0.1, 0.102)]):
        req = types.SimpleNamespace(index=index, tokens=[1], frames=1)
        rec = types.SimpleNamespace(request=req, pcm=np.full(check.SAMPLES_PER_FRAME, served))
        rec.frames_ = torch.tensor([[level]], dtype=torch.float64)
        records.append(rec)
    ref = _Ref()
    notes = []

    def frames_of(r):
        ref.given = r.frames_
        return r.frames_

    out = check.measure(ref, records, frames_of, head_frames=1, notes=notes)
    assert out["decode_rel_rms"] == pytest.approx(0.02, rel=1e-9)
    assert out["step_err"] == 0.0
    assert len(notes) == 2 and notes[1].startswith("check request 1: 1 tokens, 1 frames")
    assert "decode_rel_rms 0.01" in notes[0] and "reference RMS 1.0" in notes[0]
    assert "reference RMS 0.1" in notes[1] and "largest gap at frame 0" in notes[1]
