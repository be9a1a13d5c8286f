"""The plain reference agrees with the port at a small size on the CPU:
float32 through the single runtime's streamed path, and int8 weights with
an int8 KV cache (float32 activations) through the batcher. Both sides get
the same weights from the seed and the same text."""

import numpy as np
import pytest
import torch

from pbench import check, registry, systems
from pbench.weights import make_weights

from conftest import BENCH, tiny_config

REF = registry.load_reference(BENCH, "pockettts")


@pytest.fixture(scope="module")
def weights():
    return make_weights(REF, tiny_config("w", {}, {}), 2**31 + 99, torch.device("cpu"))


@pytest.mark.parametrize("tokens, frames", [([5, 9, 2, 33], 42), (list(range(1, 40)), 60)])
def test_single_runtime_float32(weights, tokens, frames):
    cfg = tiny_config("tiny-f32", {"kind": "runtime", "dtype": "float32"}, {})
    sysm = systems.build_system(cfg, systems.host_copy(weights), torch.device("cpu"), 7)
    got = np.concatenate(list(sysm.stream(tokens, 0.0, frames)))
    want = REF.PocketTTSReference(weights, cfg, cfg["reference"]).synthesize(tokens, frames)
    assert len(got) == len(want) == frames * 1920
    # Float32 on both sides: summation order only.
    assert check.rel_rms(got, want) < 1e-5


def test_batcher_int8(weights):
    cfg = tiny_config("tiny-int8", {"kind": "batcher", "dtype": "float32", "quantize": True, "kv_quantize": True,
                                    "slots": 4, "prompt_capacity": 128, "max_frames": 256,
                                    "steps_per_sync": 8, "steps_per_sync_burst": 64}, {"weights": "int8", "kv": "int8"})
    sysm = systems.build_system(cfg, systems.host_copy(weights), torch.device("cpu"), 7)
    try:
        reqs = [([3, 1, 4, 1, 5], 42), ([2, 7, 1, 8, 2, 8, 1, 8], 44)]
        futs = [sysm.batcher.submit(t, systems._gen_config(0.0, f)) for t, f in reqs]
        got = [f.result(timeout=300) for f in futs]
    finally:
        sysm.close()
    ref = REF.PocketTTSReference(weights, cfg, cfg["reference"])
    for (tokens, frames), pcm in zip(reqs, got):
        want = ref.synthesize(tokens, frames)
        # Same int8 levels on both sides; a K/V row that sits on a rounding
        # boundary can take the other level, so not bit-equal.
        assert check.rel_rms(pcm, want) < 2e-3
        # The float reference is far off: the quantization is in the check.
        assert check.rel_rms(pcm, REF.PocketTTSReference(weights, cfg, {}).synthesize(tokens, frames)) > 1e-3


def test_quantization_rules():
    w = torch.tensor([[1.0, -0.5, 0.25, 0.0], [0.0, 0.0, 0.0, 0.0]])
    q8 = REF.quantize_weight(w, 8)
    assert torch.equal(q8[1], w[1])  # a zero row keeps scale 1 and stays zero
    assert torch.allclose(q8[0], torch.round(w[0] * 127) / 127)
    x = torch.tensor([[0.5, -1.0, 0.2]])
    assert torch.allclose(REF.quantize_rows(x, 8), torch.round(x / (1 / 127)) * (1 / 127))
    assert REF.quantize_rows(x, 4).unique().numel() <= 3
