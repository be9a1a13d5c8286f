"""How the split-K skinny-matmul kernel (``csrc/quantized_matmul.cu``,
kernel 5) cuts ``(x[M, K] @ w[K, N])`` among thread blocks.

The grid is ``(splits, N / block_n)``: each column tile of ``block_n``
columns is one thread-block cluster of ``splits`` blocks (at most 8, the
portable cluster size; 1 needs no cluster), and block ``s`` of a cluster
owns the weight rows ``[s·R, min((s+1)·R, K))``, ``R = rows_per_split`` a
multiple of 128 (the gate's ``K % 128``), so the splits cover ``K`` exactly
and the last one may be shorter. Every block covers all ``M ≤ 64`` rows of
``x``, padded to ``m_tile`` (a multiple of 16, the tensor-core tile).

``block_n`` and ``splits`` are chosen so that the grid is as many blocks as
fit the card's SMs at one block each: a second block on an SM doubles that
SM's bytes, and the kernel lasts as long as its slowest block. Of equal
grids the one with fewer splits wins (a smaller combine): 64 × 2 blocks for
a 1024 → 4096 linear, 16 × 8 for 4096 → 1024, 80 × 1 (128 columns) for
512 → 10240. A block stages ``tile_rows`` of its rows at once (its whole
split wherever shared memory allows: at every linear of the published
model), then the next ``tile_rows`` in the same buffers.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["MatmulPlan", "matmul_plan", "smem_bytes", "K_ALIGN", "MAX_SPLITS", "SMS", "MAX_SMEM", "THREADS"]

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


def _sizes(block_n: int, splits: int, tile_rows: int, m_tile: int, m: int, x_bytes: int):
    stage = tile_rows * block_n + m_tile * (tile_rows * x_bytes + ROW_PAD)
    warps = THREADS // block_n * m * (block_n + 4) * 4  # the warps' partials, [parts][M][BN + 4]
    peers = (splits - 1) * m * block_n * 4
    return stage, warps, peers


def smem_bytes(plan: MatmulPlan, m: int, x_bytes: int) -> int:
    """Dynamic shared memory of one block: the staged weight and x rows, then
    the warps' partials and rank 0's room for its peers' partials, apart or
    (where that would not fit) over the staged rows once they are read."""
    stage, warps, peers = _sizes(plan.block_n, plan.splits, plan.tile_rows, plan.m_tile, m, x_bytes)
    body = stage + warps + peers if plan.parts_apart else max(stage, warps + peers)
    return ALIGN + body


def matmul_plan(m: int, k: int, n: int, x_bytes: int) -> MatmulPlan:
    """The plan for ``x[m, k]`` (elements of ``x_bytes`` bytes) times an int8
    ``w[k, n]``, within the kernel's gate (``m <= 64``, ``k % 128 == 0``,
    ``n % 256 == 0``)."""
    if not (0 < m <= 64 and k > 0 and k % K_ALIGN == 0 and n > 0 and n % 256 == 0):
        raise ValueError(f"matmul_plan: (m, k, n) = {(m, k, n)} outside the kernel's gate")
    if x_bytes not in (2, 4):
        raise ValueError(f"matmul_plan: x elements of {x_bytes} bytes")
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
    per_row = block_n + m_tile * x_bytes
    fit = (MAX_SMEM - ALIGN - m_tile * ROW_PAD) // per_row // K_ALIGN * K_ALIGN
    tile = min(rows, fit, MAX_TILE_ROWS)
    stage, warps, peers = _sizes(block_n, splits, tile, m_tile, m, x_bytes)
    # Apart, the partials need no barrier after the last read of the staged
    # rows; taken where two blocks still fit an SM.
    apart = ALIGN + stage + warps + peers <= MAX_SMEM // 2
    return MatmulPlan(block_n, splits, rows, tile, m_tile, apart)
