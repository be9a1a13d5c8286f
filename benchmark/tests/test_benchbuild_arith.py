"""The yardstick's arithmetic against numbers worked by hand."""

import json
from pathlib import Path

import pytest

from pbench import derive, registry, roofline, stats

BENCH = Path(__file__).resolve().parent.parent
ARCH = json.loads((BENCH / "configs" / "pockettts-b6369a24-bf16.json").read_text())
LAYOUT = registry.load_reference(BENCH, ARCH["reference_impl"])


@pytest.mark.parametrize("q, want", [(50, 5), (95, 10), (100, 10), (10, 1), (1, 1)])
def test_nearest_rank_percentile(q, want):
    assert stats.percentile(list(range(10, 0, -1)), q) == want


def test_percentile_of_a_miss_and_of_nothing():
    assert stats.percentile([], 95) is None
    assert stats.percentile([1.0] * 18 + [stats.MISS] * 2, 95) == stats.MISS
    assert stats.percentile([1.0] * 19 + [stats.MISS], 95) == 1.0


@pytest.mark.parametrize("q, want", [(95, 95.0), (99, 99.0), (90, 90.0)])
def test_latency_tails_in_ms(q, want):
    # 100 latencies of 1..100 ms, shuffled: the nearest rank is the value.
    values = [((i * 37) % 100 + 1) / 1e3 for i in range(100)]
    assert derive.percentile_ms(values, q) == pytest.approx(want)
    assert derive.p95_ms(values) == pytest.approx(95.0)


def test_a_tail_on_a_miss_reads_the_miss_value():
    values = [0.01] * 98 + [stats.MISS] * 2
    assert derive.percentile_ms(values, 99) == derive.MISS_MS
    assert derive.percentile_ms(values, 95) == pytest.approx(10.0)
    assert derive.percentile_ms([], 99) is None


def test_rates():
    assert stats.audio_seconds(48_000) == 2.0
    assert stats.x_realtime(9.45, 0.1) == pytest.approx(94.5)
    assert stats.rate(300.0, 30.0) == 10.0
    with pytest.raises(ValueError):
        stats.rate(1.0, 0.0)


def test_bound_takes_the_longer_side():
    # 3.35 GB at 3.35 TB/s is 1 ms; 989 GFLOP at 989 TFLOP/s is 1 ms.
    assert roofline.bound_s(3.35e9, 1.0) == pytest.approx(1e-3)
    assert roofline.bound_s(1.0, 989e9) == pytest.approx(1e-3)
    assert roofline.bound_s(1.0, 67e9, "float32") == pytest.approx(1e-3)


def test_seanet_work_per_sample():
    # Kernel 8 per PCM sample: up2 131072/4 + res2 65536/4 + up3 32768 +
    # res3 16384 + final 896 = 99200 (chip_smoke.py's SEANET_WORK).
    assert roofline.SEANET_WORK["fused_up2_up3_tail"][0] == 32768 + 16384 + 32768 + 16384 + 896
    # Weights: up2 256·128·10 + 128, res2 64·128·3 + 64 + 128·64 + 128,
    # up3 128·64·8 + 64, res3 32·64·3 + 32 + 64·32 + 64, final 64·7 + 1.
    want = 327808 + (24576 + 64 + 8192 + 128) + 65600 + (6144 + 32 + 2048 + 64) + 449
    assert roofline.seanet_weight_count(ARCH, "fused_up2_up3_tail") == want
    # A 4-frame stream block: x [1, 256, 384] → 7680 PCM samples.
    b = roofline.seanet_bound_s(ARCH, "fused_up2_up3_tail", (1, 256, 384))
    ops = 99200 * 7680
    bytes_moved = 2 * (256 * 384 + want + 7680)
    assert b == pytest.approx(max(ops / 989e12, bytes_moved / 3.35e12))


def test_step_and_prefill_flops():
    d, ffn = 1024, 4096
    transformer = 2 * 6 * (d * 3 * d + d * d + d * ffn + ffn * d)
    flow = 2 * (1024 * 512 + 32 * 512 + 6 * 2 * 512 * 1024 + 512 * 20 * 512 + 512 * 32)
    heads = 2 * (32 * 1024 + 1024)
    assert LAYOUT.frame_step_flops(ARCH, 0) == transformer + flow + heads
    assert LAYOUT.frame_step_flops(ARCH, 10) - LAYOUT.frame_step_flops(ARCH, 0) == 6 * 4 * 10 * d
    assert LAYOUT.prefill_flops(ARCH, 2) == 2 * transformer + 6 * 4 * d * 3


def test_decode_flops_split_adds_up():
    whole = roofline.decode_flops(ARCH, 0, 40)
    parts = roofline.decode_flops(ARCH, 0, 4) + roofline.decode_flops(ARCH, 4, 12) + roofline.decode_flops(ARCH, 16, 24)
    assert parts == pytest.approx(whole)
    # SEANet per frame: 1920 PCM samples of kernel 8's stages (99200 each)
    # plus up1 (512·256·12·16) + res1 (96 columns) + the first conv.
    seanet = 1920 * 99200 + 2 * 512 * 256 * 12 * 16 + 96 * (2 * 256 * 128 * 3 + 2 * 128 * 256)
    first = 16 * 2 * 512 * 512 * 7
    assert roofline.decode_flops(ARCH, 300, 1) > seanet + first


def test_quantized_matmul_shapes_and_bound():
    shapes = roofline.quantized_matmul_shapes(LAYOUT.step_linears(ARCH).values())
    # 6 layers × 4 linears, cond_embed, 6 × 2 flowNet MLPs, the fused adaLN.
    assert len(shapes) == 24 + 1 + 12 + 1
    b = roofline.quantized_matmul_bound_s(8, 1024, 4096)
    assert b == pytest.approx((1024 * 4096 + 8 * 4096 + 2 * 8 * 1024 + 2 * 8 * 4096) / 3.35e12)


def test_decode_attention_bound():
    # 100 rows, 16 heads of 64 in bf16: K and V 2·16·100·64·2 bytes, plus q,
    # k, v and the output.
    b = roofline.decode_attention_bound_s(ARCH, 100)
    assert b == pytest.approx((2 * 16 * 100 * 64 * 2 + 4 * 16 * 64 * 2) / 3.35e12)
