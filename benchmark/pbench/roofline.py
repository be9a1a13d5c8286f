"""Peaks, bounds and operation counts: the yardstick of the roofline and MFU
metrics.

The peaks and :func:`bound_s` are frozen copies of ``chip_smoke.py``'s
``PEAK_BYTES_PER_S``, ``PEAK_FLOPS`` and ``bound``; :data:`SEANET_WORK`
and :func:`seanet_bound_s` of its ``SEANET_WORK`` and ``seanet_bound``
(published H100 SXM rates, dense; bytes and operations from the shapes,
each input byte read once and each output byte written once). Mimi's
decode operations are counted here from a configuration's widths, since
every configuration keeps Mimi; the rest of the model's operations come
from the configuration's reference module (``frame_step_flops``,
``prefill_flops``): the work that a request's inputs need, whatever
implements it.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

__all__ = [
    "PEAK_BYTES_PER_S",
    "PEAK_FLOPS",
    "SEANET_WORK",
    "bound_s",
    "decode_attention_bound_s",
    "decode_flops",
    "quantized_matmul_shapes",
    "quantized_matmul_bound_s",
    "seanet_bound_s",
    "seanet_weight_count",
]

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BYTES = {"bfloat16": 2, "float32": 4, "int8": 1}

# Float operations per output column, output columns per input column and
# output channels of the SEANet kernels, from x's shape [B, C, T].
SEANET_WORK = {
    "fused_seanet_up_tail": (50048.0, 4, 1),
    "fused_seanet_tail": (17280.0, 1, 1),
    "fused_up2_res": (196608.0, 5, 128),
    "fused_up2_up3_tail": (99200.0, 20, 1),
}


def bound_s(bytes_moved: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least time on one H100: bytes at the HBM rate or operations at
    the dtype's peak, whichever is longer."""
    return max(bytes_moved / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def decode_flops(arch: Dict, first_frame: int, n_frames: int) -> float:
    """Operations of decoding frames ``first_frame .. first_frame + n - 1``
    of a request: the latent → Mimi projection, the upsampling, Mimi's
    windowed transformer and the SEANet."""
    c, lat, ffn = arch["mimi_dim"], arch["latent_dim"], arch["mimi_ffn"]
    steps = arch["upsample_stride"]
    ctx = arch["mimi_context"]
    ch, strides, k0, kf = arch["seanet_channels"], arch["seanet_strides"], arch["seanet_kernel_init"], arch["seanet_kernel_final"]
    per_frame = 2.0 * lat * c + 2.0 * c * arch["upsample_kernel"]
    per_step = 2.0 * (c * 3 * c + c * c + c * ffn + ffn * c) * arch["mimi_layers"] + 2.0 * c * ch[0] * k0
    seanet = 0.0
    rate = steps  # SEANet columns per frame before each stage
    for i, s in enumerate(strides):
        cin, cout = ch[i], ch[i + 1]
        seanet += 2.0 * cin * cout * 2 * s * rate  # transposed conv, kernel 2s, per input column
        rate *= s
        seanet += (2.0 * cout * (cout // 2) * 3 + 2.0 * (cout // 2) * cout) * rate  # residual block
    seanet += 2.0 * ch[-1] * kf * rate
    total = n_frames * (per_frame + steps * per_step + seanet)
    # Attention rows: Mimi step p attends to min(p + 1, context) rows.
    p0, p1 = first_frame * steps, (first_frame + n_frames) * steps
    rows = _window_rows(p1, ctx) - _window_rows(p0, ctx)
    return total + arch["mimi_layers"] * 4.0 * c * rows


def _window_rows(n_steps: int, ctx: int) -> float:
    """Sum over steps 0..n-1 of min(p + 1, ctx)."""
    full = min(n_steps, ctx)
    return full * (full + 1) / 2 + max(n_steps - ctx, 0) * ctx


def decode_attention_bound_s(arch: Dict, rows: float, dtype: str = "bfloat16") -> float:
    """One launch of the single runtime's decode attention (one layer, one
    lane): the K and V rows it needs, q, the new k and v, and the output,
    against the products over those rows."""
    es = BYTES[dtype]
    h, dh = arch["num_heads"], arch["d_model"] // arch["num_heads"]
    bytes_moved = es * (2 * h * rows * dh + 4 * h * dh)
    return bound_s(bytes_moved, 4.0 * h * rows * dh, dtype)


def quantized_matmul_shapes(linears: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    """``(K, N)`` of the AR step's int8 linears (``(in, out)`` each) that the
    quantized-matmul kernel takes (its gate: ``K % 128 == 0`` and
    ``N % 256 == 0``; the AR step's few rows pass ``M <= 64``)."""
    return [(k, n) for k, n in linears if k % 128 == 0 and n % 256 == 0]


def quantized_matmul_bound_s(m: int, k: int, n: int) -> float:
    """``y[M, N] = x[M, K] @ w_q[K, N] · scale[N] (+ b[N])`` with bfloat16
    activations: the int8 weight read once, the scale, a float32 bias, x
    and y, against ``2·M·K·N`` operations."""
    bytes_moved = k * n + 4 * n + 4 * n + 2 * m * k + 2 * m * n
    return bound_s(bytes_moved, 2.0 * m * k * n, "bfloat16")


def seanet_weight_count(arch: Dict, name: str) -> int:
    """Weights and biases the SEANet kernel ``name`` reads."""
    ch, strides = arch["seanet_channels"], arch["seanet_strides"]

    def up(i: int) -> int:
        return ch[i] * ch[i + 1] * 2 * strides[i] + ch[i + 1]

    def res(i: int) -> int:
        c = ch[i + 1]
        return (c // 2) * c * 3 + c // 2 + c * (c // 2) + c

    final = ch[-1] * arch["seanet_kernel_final"] + 1
    counts = {
        "fused_up2_up3_tail": up(1) + res(1) + up(2) + res(2) + final,
        "fused_up2_res": up(1) + res(1),
        "fused_seanet_up_tail": up(2) + res(2) + final,
        "fused_seanet_tail": res(2) + final,
    }
    return counts[name]


def seanet_bound_s(arch: Dict, name: str, shape: Iterable[int], dtype: str = "bfloat16") -> float:
    """x [B, C, T], the weights and the output moved once, against the
    kernel's operations, at x's shape."""
    b, c, t = shape
    flop, per_col, c_out = SEANET_WORK[name]
    cols = b * per_col * t
    es = BYTES[dtype]
    return bound_s(es * (b * c * t + seanet_weight_count(arch, name) + cols * c_out), flop * cols, dtype)

