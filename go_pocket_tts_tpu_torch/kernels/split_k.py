"""How the split-K skinny-matmul kernels (``csrc/quantized_matmul.cu``,
kernel 5, int8 weights, and ``csrc/int4_matmul.cu``, kernel 6, packed int4
weights with group scales of 128 rows; both on ``csrc/split_k_matmul.cuh``)
cut ``(x[M, K] @ w[K, N])`` among thread blocks.

The grid is ``(splits, N / block_n)``: each column tile of ``block_n``
columns is one thread-block cluster of ``splits`` blocks (at most 8, the
portable cluster size; 1 needs no cluster), and block ``s`` of a cluster
owns the weight rows ``[s·R, min((s+1)·R, K))``, ``R = rows_per_split`` a
multiple of 128 (the gate's ``K % 128``), so the splits cover ``K`` exactly,
every split owns whole int4 scale groups, and the last one may be shorter.
Every block covers all ``M ≤ 64`` rows of ``x``, padded to ``m_tile`` (a
multiple of 16, the tensor-core tile).

``block_n`` and ``splits`` are chosen so that the grid is as many blocks as
fit the card's SMs at one block each: a second block on an SM doubles that
SM's bytes, and the kernel lasts as long as its slowest block. Of equal
grids the one with fewer splits wins (a smaller combine): 64 × 2 blocks for
a 1024 → 4096 linear, 16 × 8 for 4096 → 1024, 80 × 1 (128 columns) for
512 → 10240. A block stages ``tile_rows`` of its rows at once (its whole
split wherever shared memory allows: at every linear of the published
model), then the next ``tile_rows`` in the same buffers. An int4 block
stages half the weight bytes a row and, beside them, its ``tile_rows / 128``
rows of ``block_n`` float32 group scales (``w_bits=4``).

Both kernels' wrappers share the rest of their contract here too: the
operand checks (:func:`check_types`, :func:`check_operands`), the C entry
point's signature and launch (:func:`launch`), and the plain form of the
fused epilogue (:func:`plain_epilogue`).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = [
    "MatmulPlan",
    "matmul_plan",
    "smem_bytes",
    "check_types",
    "check_operands",
    "launch",
    "plain_epilogue",
    "K_ALIGN",
    "MAX_SPLITS",
    "SMS",
    "MAX_SMEM",
    "THREADS",
]

K_ALIGN = 128  # rows per split come in multiples of this: one async copy each
MAX_SPLITS = 8  # portable thread-block cluster size
SMS = 132  # streaming multiprocessors of an H100 SXM
MAX_SMEM = 230400  # dynamic shared memory of a block: sm_90's 227 KB less 2 KB of static
THREADS = 256  # 8 warps a block
ROW_PAD = 16  # bytes after each staged x row (conflict-free fragment loads)
MAX_TILE_ROWS = 16 * K_ALIGN  # 16 copies (and barriers) a pass
ALIGN = 1024  # the swizzled weight tiles' alignment, reserved once
PARTIALS_MAX = 64 * 1024  # rank 0's room for its peers' partials, which caps S at large M


class MatmulPlan(NamedTuple):
    block_n: int  # columns of a tile: 64 or 128
    splits: int  # blocks of a cluster, 1..8
    rows_per_split: int  # K rows a block owns, a multiple of 128
    tile_rows: int  # K rows a block stages at once, a multiple of 128
    m_tile: int  # x rows a block covers, M rounded up to 16
    parts_apart: bool  # the partials get bytes of their own (else they reuse the staged rows')


def _weight_row_bytes(block_n: int, w_bits: int) -> int:
    """Staged bytes per K row of a block: its weight bytes and, for int4,
    its share of a 128-row group's float32 scales."""
    return block_n * w_bits // 8 + (block_n * 4 // K_ALIGN if w_bits == 4 else 0)


def _sizes(block_n: int, splits: int, tile_rows: int, m_tile: int, m: int, x_bytes: int, w_bits: int):
    stage = tile_rows * _weight_row_bytes(block_n, w_bits) + m_tile * (tile_rows * x_bytes + ROW_PAD)
    warps = THREADS // block_n * m * (block_n + 4) * 4  # the warps' partials, [parts][M][BN + 4]
    peers = (splits - 1) * m * block_n * 4
    return stage, warps, peers


def smem_bytes(plan: MatmulPlan, m: int, x_bytes: int, w_bits: int = 8) -> int:
    """Dynamic shared memory of one block: the staged weight (and int4
    scales) and x rows, then the warps' partials and rank 0's room for its
    peers' partials, apart or (where that would not fit) over the staged
    rows once they are read."""
    stage, warps, peers = _sizes(plan.block_n, plan.splits, plan.tile_rows, plan.m_tile, m, x_bytes, w_bits)
    body = stage + warps + peers if plan.parts_apart else max(stage, warps + peers)
    return ALIGN + body


def matmul_plan(m: int, k: int, n: int, x_bytes: int, w_bits: int = 8) -> MatmulPlan:
    """The plan for ``x[m, k]`` (elements of ``x_bytes`` bytes) times an int8
    ``w[k, n]`` (``w_bits=8``) or a packed int4 one (``w_bits=4``), within the
    kernels' gate (``m <= 64``, ``k % 128 == 0``, ``n % 256 == 0``). The grid
    rule does not depend on ``w_bits``; the rows staged at once do."""
    if not (0 < m <= 64 and k > 0 and k % K_ALIGN == 0 and n > 0 and n % 256 == 0):
        raise ValueError(f"matmul_plan: (m, k, n) = {(m, k, n)} outside the kernel's gate")
    if x_bytes not in (2, 4):
        raise ValueError(f"matmul_plan: x elements of {x_bytes} bytes")
    if w_bits not in (4, 8):
        raise ValueError(f"matmul_plan: weights of {w_bits} bits")
    m_tile = -(-m // 16) * 16
    chunks = k // K_ALIGN
    best = None
    for bn in (64, 128):
        # At least two copies a split (one more split costs more in the combine
        # than half a split's bytes take to land), and room in rank 0 for the
        # peers' partials.
        most = max(1, min(MAX_SPLITS, 1 + PARTIALS_MAX // (m * bn * 4), chunks // 2))
        for want in range(1, most + 1):
            rows = -(-chunks // want) * K_ALIGN
            splits = -(-k // rows)
            blocks = n // bn * splits
            # One block an SM, as many as fit; then fewer splits; past the
            # SMs (a very wide N), the fewest blocks.
            key = (blocks <= SMS, blocks if blocks <= SMS else -blocks, -splits)
            if best is None or key > best[0]:
                best = (key, bn, splits, rows)
    _, block_n, splits, rows = best
    per_row = _weight_row_bytes(block_n, w_bits) + m_tile * x_bytes
    fit = (MAX_SMEM - ALIGN - m_tile * ROW_PAD) // per_row // K_ALIGN * K_ALIGN
    tile = min(rows, fit, MAX_TILE_ROWS)
    stage, warps, peers = _sizes(block_n, splits, tile, m_tile, m, x_bytes, w_bits)
    # Apart, the partials need no barrier after the last read of the staged
    # rows; taken where two blocks still fit an SM.
    apart = ALIGN + stage + warps + peers <= MAX_SMEM // 2
    return MatmulPlan(block_n, splits, rows, tile, m_tile, apart)


# -- the wrappers' shared contract -------------------------------------------------

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# (dtype, x, w, scale, bias, bias_dtype, out, out_t, M, K, N, block_n,
# splits, rows_per_split, tile_rows, parts_apart, stream)
_ARGTYPES = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def plain_epilogue(y: torch.Tensor, x_dtype: torch.dtype, bias: Optional[torch.Tensor], out_dtype: torch.dtype):
    """The fused epilogue's plain form: the float32 product ``y`` as it is
    or, with a bias or an activation-dtype output, rounded to ``x_dtype``
    and the bias rounded to it added, as ``out_dtype``."""
    if bias is not None or out_dtype != torch.float32:
        y = y.to(x_dtype)
        if bias is not None:
            y = y + bias.to(x_dtype)
    return y.to(out_dtype)


def check_types(kernel: str, x: torch.Tensor, out_dtype: torch.dtype) -> None:
    if x.dtype not in DTYPE_CODES:
        raise TypeError(f"{kernel}: activation dtype {x.dtype} not supported")
    if out_dtype not in (torch.float32, x.dtype):
        raise TypeError(f"{kernel}: out_dtype {out_dtype} is neither float32 nor {x.dtype}")


def check_operands(
    kernel: str, x: torch.Tensor, bias: Optional[torch.Tensor], n: int, operands: Sequence[Tuple[str, torch.Tensor]]
) -> None:
    """The bias's type and shape, and every operand (the bias too)
    contiguous, 16-byte aligned and on x's device."""
    if bias is not None and (bias.dtype not in DTYPE_CODES or tuple(bias.shape) != (n,)):
        raise ValueError(f"{kernel}: bias must be float32 or bfloat16 [N]")
    for name, t in (*operands, ("bias", bias)):
        if t is None:
            continue
        if t.device != x.device or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous on {x.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{kernel}: {name} must be 16-byte aligned")


def launch(
    fn,
    x: torch.Tensor,
    w: torch.Tensor,
    scale: torch.Tensor,
    bias: Optional[torch.Tensor],
    out_dtype: torch.dtype,
    w_bits: int,
) -> torch.Tensor:
    """One launch of a split-K kernel's C entry point ``fn`` on checked
    operands (``x [M, K]`` contiguous, ``w`` of N columns), cut by
    :func:`matmul_plan`; the output is ``[M, N]`` of ``out_dtype``. Raises
    on a launch error."""
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _ARGTYPES
    m, k = x.shape
    n = w.shape[1]
    plan = matmul_plan(m, k, n, x.element_size(), w_bits)
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    err = fn(
        DTYPE_CODES[x.dtype],
        x.data_ptr(),
        w.data_ptr(),
        scale.data_ptr(),
        bias.data_ptr() if bias is not None else None,
        DTYPE_CODES[bias.dtype] if bias is not None else 0,
        out.data_ptr(),
        int(out_dtype != torch.float32),
        m,
        k,
        n,
        plan.block_n,
        plan.splits,
        plan.rows_per_split,
        plan.tile_rows,
        int(plan.parts_apart),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA launch failed (cudaError {err})")
    return out
