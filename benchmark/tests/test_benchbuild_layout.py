"""A configuration's checkpoint layout comes from its reference module.

For the PocketTTS configurations the layout, the drawn tensors, their host
copy and the whole step's share of the peak are the same, bit for bit, as
before the reference module took the layout over (``frozen_layout.py``). A
layout with keys that PocketTTS lacks, in bfloat16, goes through the
registry, the draw, the host copy and the operation counts with no edit of
the harness. On a card, a bfloat16 layout the size of Moonlight-16B-A3B is
drawn and copied to the host within the set's bytes and one chunk."""

import json
import math
import time
import types

import pytest
import torch

import frozen_layout as frozen
from conftest import BENCH, tiny_config
from pbench import derive, registry, roofline, systems, weights
from pbench.harness import Run
from pbench.load import Record
from pbench.traffic import Request

CONFIGS = ["pockettts-b6369a24-bf16", "pockettts-b6369a24-int8-b8"]
SEEDS = [0, 7, 2**31 + 99, 2**33 + 5]


def _layout(config):
    return registry.load_reference(BENCH, config["reference_impl"])


@pytest.mark.parametrize("name", CONFIGS)
def test_leaf_specs_as_before(name):
    config = registry.load_config(BENCH, name)
    layout = _layout(config)
    assert layout.CHECKPOINT_DTYPE == "float32"
    assert layout.leaf_specs(config) == frozen.leaf_specs(config)
    assert weights.weight_count(layout, config) == 102_869_410


@pytest.mark.parametrize("seed", SEEDS)
def test_draw_as_before(seed):
    config = tiny_config("w", {}, {})
    got = weights.make_weights(_layout(config), config, seed, torch.device("cpu"))
    want = frozen.make_weights(config, seed, torch.device("cpu"))
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype == torch.float32, name
        assert torch.equal(got[name], want[name]), name


def test_host_copy_as_before():
    config = tiny_config("w", {}, {})
    drawn = weights.make_weights(_layout(config), config, 2**31 + 99, torch.device("cpu"))
    got, want = systems.host_copy(drawn), frozen.host_copy(drawn)
    assert list(got) == list(want)
    for name in want:
        assert got[name].dtype == want[name].dtype and got[name].shape == want[name].shape, name
        assert got[name].device.type == "cpu" and torch.equal(got[name], want[name]), name


def _run(config, layout, requests, seconds=10.0) -> Run:
    """A window of ``seconds`` from t0 = 100 in which each request's blocks
    arrived at the given times; some before the window, some after."""
    run = Run(cell="synthetic", config=config, reference=layout, workload={}, seconds=seconds, setup_s=1.0,
              t0=100.0, t1=100.0 + seconds)
    for i, (n_tokens, blocks) in enumerate(requests):
        frames = sum(f for _t, f in blocks)
        req = Request(index=i, tokens=[1] * n_tokens, frames=frames, route="stream", temperature=0.0, due=None)
        rec = Record(req, due=99.0, sent=99.0, done=blocks[-1][0])
        rec.blocks = [(t, f * derive.SAMPLES_PER_FRAME) for t, f in blocks]
        run.records.append(rec)
    return run


REQUESTS = [
    (20, [(99.5, 4), (100.2, 8), (100.9, 16), (101.5, 16), (102.0, 27)]),  # first block before the window
    (4, [(103.0, 42)]),  # one-shot
    (50, [(105.0, 4), (105.1, 8)] + [(105.2 + 0.1 * k, 16) for k in range(13)] + [(109.9, 14)]),
    (33, [(109.95, 4), (110.5, 8)]),  # its second block after the window
]


@pytest.mark.parametrize("name", CONFIGS)
def test_mfu_as_before(name):
    config = registry.load_config(BENCH, name)
    run = _run(config, _layout(config), REQUESTS)
    got = derive.mfu_pct(run)
    assert got is not None and got > 0
    assert got == frozen.mfu_pct(run)


def test_chunked_draw_is_the_sequential_draw(monkeypatch):
    """With a chunk of a few hundred values, the two streams are drawn in
    many consecutive calls from one generator; each leaf is the next slice
    of its stream, ``offset + scale · draw`` (``exp`` for kind "e")."""
    monkeypatch.setattr(weights, "CHUNK", 300)
    config = tiny_config("w", {}, {})
    layout = _layout(config)
    specs = layout.leaf_specs(config)
    got = weights.make_weights(layout, config, 12345, torch.device("cpu"))

    gen = torch.Generator(device="cpu")
    gen.manual_seed(12345)

    def stream(kinds, draw):
        total = sum(math.prod(sh) for _n, sh, k, _s, _o in specs if k in kinds)
        parts, left = [], total
        while left:
            parts.append(draw(min(300, left), generator=gen))
            left -= parts[-1].numel()
        return torch.cat(parts), len(parts)

    (normal, n_calls), (unif, _) = stream(("n",), torch.randn), stream(("u", "e"), torch.rand)
    assert n_calls > 10
    i_n = i_u = 0
    for name, shape, kind, scale, offset in specs:
        size = math.prod(shape)
        if kind == "n":
            want = normal[i_n : i_n + size] * scale + offset
            i_n += size
        elif kind == "u":
            want = unif[i_u : i_u + size] * scale + offset
            i_u += size
        elif kind == "e":
            want = torch.exp(unif[i_u : i_u + size] * scale)
            i_u += size
        else:
            want = torch.full((size,), offset)
        assert torch.equal(got[name], want.reshape(shape)), name


# -- a layout of another architecture, new files only -------------------------

TOY_REFERENCE = '''
"""A toy backbone: RMSNorms, a router and stacked experts, in bfloat16."""
import math
import torch

CHECKPOINT_DTYPE = "bfloat16"


def leaf_specs(config):
    d, f, e = config["hidden_size"], config["moe_intermediate_size"], config["n_routed_experts"]
    s = [("model.embed_tokens.weight", (config["n_bins"] + 1, d), "n", 0.02, 0.0)]
    for i in range(config["num_hidden_layers"]):
        p = f"model.layers.{i}"
        s.append((f"{p}.input_layernorm.weight", (d,), "n", 0.05, 1.0))
        s.append((f"{p}.mlp.gate.weight", (e, d), "n", 1.0 / math.sqrt(d), 0.0))
        s.append((f"{p}.mlp.gate.e_score_correction_bias", (e,), "u", 0.1, -0.05))
        s.append((f"{p}.mlp.experts.gate_up_proj", (e, 2 * f, d), "n", 1.0 / math.sqrt(d), 0.0))
        s.append((f"{p}.mlp.experts.down_proj", (e, d, f), "n", 1.0 / math.sqrt(f), 0.0))
        s.append((f"{p}.post_attention_layernorm.weight", (d,), "c", 0.0, 1.0))
    return s


def frame_step_flops(config, rows):
    d, f, k = config["hidden_size"], config["moe_intermediate_size"], config["num_experts_per_tok"]
    per_layer = 2.0 * d * config["n_routed_experts"] + k * 2.0 * 3 * d * f + 4.0 * rows * d
    return config["num_hidden_layers"] * per_layer


def prefill_flops(config, n_tokens):
    return n_tokens * frame_step_flops(config, 0) + config["num_hidden_layers"] * 4.0 * config["hidden_size"] * n_tokens * (n_tokens + 1) / 2


class PocketTTSReference:
    def __init__(self, weights, config, precision=None):
        self.w = {k: v.float() for k, v in weights.items()}
'''

TOY_KEYS = dict(hidden_size=64, moe_intermediate_size=24, n_routed_experts=8, num_experts_per_tok=2,
                num_hidden_layers=2)


@pytest.fixture
def toy_root(tmp_path):
    root = tmp_path / "bench"
    (root / "references").mkdir(parents=True)
    (root / "configs").mkdir()
    (root / "references" / "toy_moe.py").write_text(TOY_REFERENCE)
    config = tiny_config("toy-moe", {"kind": "runtime", "dtype": "bfloat16"}, {})
    config.update(TOY_KEYS, reference_impl="toy_moe")
    (root / "configs" / "toy-moe.json").write_text(json.dumps(config))
    return root


def test_a_layout_of_its_own(toy_root):
    config = registry.load_config(toy_root, "toy-moe")
    layout = registry.load_reference(toy_root, config["reference_impl"])
    specs = layout.leaf_specs(config)
    drawn = weights.make_weights(layout, config, 2**32 + 17, torch.device("cpu"))
    assert list(drawn) == [s[0] for s in specs]
    assert "model.layers.1.mlp.experts.gate_up_proj" in drawn and "flow_lm.bos_emb" not in drawn
    assert drawn["model.layers.0.mlp.experts.down_proj"].shape == (8, 64, 24)
    assert all(t.dtype == torch.bfloat16 for t in drawn.values())
    assert weights.weight_count(layout, config) == sum(t.numel() for t in drawn.values())

    # Each leaf is bfloat16 of offset + scale · draw, the streams in order.
    gen = torch.Generator(device="cpu")
    gen.manual_seed(2**32 + 17)
    normal = torch.randn(sum(math.prod(s[1]) for s in specs if s[2] == "n"), generator=gen)
    unif = torch.rand(sum(math.prod(s[1]) for s in specs if s[2] == "u"), generator=gen)
    i_n = i_u = 0
    for name, shape, kind, scale, offset in specs:
        size = math.prod(shape)
        if kind == "n":
            want, i_n = normal[i_n : i_n + size] * scale + offset, i_n + size
        elif kind == "u":
            want, i_u = unif[i_u : i_u + size] * scale + offset, i_u + size
        else:
            want = torch.full((size,), offset)
        assert torch.equal(drawn[name], want.to(torch.bfloat16).reshape(shape)), name

    host = systems.host_copy(drawn)
    assert all(t.dtype == torch.bfloat16 and t.device.type == "cpu" for t in host.values())
    assert all(torch.equal(host[n], drawn[n]) for n in drawn)
    ref = layout.PocketTTSReference(host, config, None)
    assert all(t.dtype == torch.float32 for t in ref.w.values())

    # The whole step's share of the peak sums the layout's own counts (and
    # Mimi's decode, which every configuration keeps).
    run = _run(config, layout, [(10, [(100.5, 4), (101.0, 8)])])
    steps = sum(layout.frame_step_flops(config, 10 + j + 1) for j in range(12))
    ops = steps + layout.prefill_flops(config, 10) + roofline.decode_flops(config, 0, 12)
    assert derive.mfu_pct(run) == pytest.approx(100.0 * ops / (10.0 * roofline.PEAK_FLOPS["bfloat16"]),
                                                rel=1e-12)


# -- on a card: a set the size of Moonlight-16B-A3B -----------------------------

MOONLIGHT = dict(hidden_size=2048, intermediate_size=11264, moe_intermediate_size=1408, n_routed_experts=64,
                 n_shared_experts=2, num_hidden_layers=27, first_k_dense_replace=1, num_attention_heads=16,
                 kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128)


def moonlight_specs(c):
    """Moonlight-16B-A3B's decoder leaves (https://huggingface.co/moonshotai/Moonlight-16B-A3B,
    config.json), without the vocabulary; each expert stack one leaf."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    qk = c["qk_nope_head_dim"] + c["qk_rope_head_dim"]
    s = []

    def lin(name, out_dim, in_dim, stack=()):
        s.append((name, (*stack, out_dim, in_dim), "n", 1.0 / math.sqrt(in_dim), 0.0))

    for i in range(c["num_hidden_layers"]):
        p = f"model.layers.{i}"
        s.append((f"{p}.input_layernorm.weight", (d,), "n", 0.05, 1.0))
        s.append((f"{p}.post_attention_layernorm.weight", (d,), "n", 0.05, 1.0))
        lin(f"{p}.self_attn.q_proj.weight", h * qk, d)
        lin(f"{p}.self_attn.kv_a_proj_with_mqa.weight", c["kv_lora_rank"] + c["qk_rope_head_dim"], d)
        s.append((f"{p}.self_attn.kv_a_layernorm.weight", (c["kv_lora_rank"],), "n", 0.05, 1.0))
        lin(f"{p}.self_attn.kv_b_proj.weight", h * (c["qk_nope_head_dim"] + c["v_head_dim"]), c["kv_lora_rank"])
        lin(f"{p}.self_attn.o_proj.weight", d, h * c["v_head_dim"])
        if i < c["first_k_dense_replace"]:
            for name in ("gate_proj", "up_proj"):
                lin(f"{p}.mlp.{name}.weight", c["intermediate_size"], d)
            lin(f"{p}.mlp.down_proj.weight", d, c["intermediate_size"])
            continue
        e, f = c["n_routed_experts"], c["moe_intermediate_size"]
        lin(f"{p}.mlp.gate.weight", e, d)
        s.append((f"{p}.mlp.gate.e_score_correction_bias", (e,), "u", 0.1, -0.05))
        for name in ("gate_proj", "up_proj"):
            lin(f"{p}.mlp.experts.{name}", f, d, (e,))
        lin(f"{p}.mlp.experts.down_proj", d, f, (e,))
        shared = c["n_shared_experts"] * f
        for name in ("gate_proj", "up_proj"):
            lin(f"{p}.mlp.shared_experts.{name}.weight", shared, d)
        lin(f"{p}.mlp.shared_experts.down_proj.weight", d, shared)
    return s


def test_moonlight_layout_size():
    """Without the card: the test layout holds Moonlight's 15.29 B decoder
    parameters (one dense layer of 83.0 M, 26 expert layers of 584.8 M)."""
    n = sum(math.prod(shape) for _n, shape, *_ in moonlight_specs(MOONLIGHT))
    dense = sum(math.prod(shape) for name, shape, *_ in moonlight_specs(MOONLIGHT) if name.startswith("model.layers.0."))
    assert dense == 82_973_184 and (n - dense) == 26 * 584_847_936 and n >= 15.2e9


def _status_kib(path, key):
    with open(path) as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1])
    return -1


@pytest.mark.cuda
def test_moonlight_sized_bf16_draw_fits_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    layout = types.SimpleNamespace(CHECKPOINT_DTYPE="bfloat16", leaf_specs=moonlight_specs)
    dev = torch.device("cuda")
    n = weights.weight_count(layout, MOONLIGHT)
    set_bytes = 2 * n
    hwm0, rss0 = _status_kib("/proc/self/status", "VmHWM"), _status_kib("/proc/self/status", "VmRSS")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    drawn = weights.make_weights(layout, MOONLIGHT, 2**31 + 12345, dev)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    host = systems.host_copy(drawn)
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) - base
    hwm1, rss1 = _status_kib("/proc/self/status", "VmHWM"), _status_kib("/proc/self/status", "VmRSS")
    reading = {
        "card": registry.card_line(), "parameters": n, "set_bytes": set_bytes, "peak_bytes": peak,
        "peak_over_set_bytes": peak - set_bytes, "draw_s": t1 - t0, "host_copy_s": t2 - t1,
        "host_mem_total_kib": _status_kib("/proc/meminfo", "MemTotal"), "vm_hwm_growth_kib": hwm1 - hwm0,
        "vm_rss_growth_kib": rss1 - rss0, "host_bytes": sum(t.numel() * t.element_size() for t in host.values()),
    }
    print("moonlight-sized draw:", json.dumps(reading), flush=True)
    assert n >= 15.2e9
    assert peak <= set_bytes + 4 * weights.CHUNK + 10**9
    assert all(t.dtype == torch.bfloat16 for t in host.values())
    name = "model.layers.26.mlp.experts.down_proj"
    assert torch.equal(host[name][63], drawn[name][63].cpu())
    del drawn
    # Each kind's values as its spec draws them: the experts ~ N(0, 1/1408),
    # the router's bias in [-0.05, 0.05).
    std = host[name].float().std().item()
    assert abs(std * math.sqrt(1408) - 1.0) < 0.01
    bias = host["model.layers.5.mlp.gate.e_score_correction_bias"].float()
    assert bias.min().item() >= -0.05 and bias.max().item() <= 0.05
