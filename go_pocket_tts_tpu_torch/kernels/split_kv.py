"""How the split-KV decode-attention kernels (``csrc/split_kv_attention.cuh``,
run by kernels 1 and 4) cut a cache of ``C`` rows among the blocks of one
(lane, head) cluster.

Each pair's rows are split into ``splits`` runs of ``rows_per_split`` rows,
a multiple of 16 (the bulk copies move 16-byte multiples and the int8 row
scales of 16 rows are 64 bytes); split ``s`` owns rows
``[s·R, min((s+1)·R, C))``, so the splits cover ``[0, C)`` exactly and the
last one takes the masked tail. ``splits`` is at most 8, the portable
cluster size, and is chosen so that ``splits × pairs`` blocks fill the
card's SMs about ``BLOCKS_PER_SM`` deep: 7–8 splits for the 16 heads of one
lane, 4 for 8 lanes × 16 heads.
"""

from __future__ import annotations

from typing import Tuple

__all__ = ["split_plan", "boundary_offsets", "ROW_ALIGN", "MAX_SPLITS", "SMS", "BLOCKS_PER_SM"]

ROW_ALIGN = 16
MAX_SPLITS = 8  # portable thread-block cluster size
SMS = 132  # streaming multiprocessors of an H100 SXM
BLOCKS_PER_SM = 4  # a block holds at most 34 KB of ring and 128 threads


def split_plan(capacity: int, pairs: int) -> Tuple[int, int]:
    """``(splits, rows_per_split)`` for ``pairs`` (lane, head) pairs over a
    cache of ``capacity`` rows."""
    if capacity < 1 or pairs < 1:
        raise ValueError(f"split_plan: capacity {capacity} and pairs {pairs} must be positive")
    chunks = -(-capacity // ROW_ALIGN)
    want = max(1, min(MAX_SPLITS, BLOCKS_PER_SM * SMS // pairs, chunks))
    rows = -(-chunks // want) * ROW_ALIGN
    return -(-capacity // rows), rows


def boundary_offsets(capacity: int, pairs: int) -> list:
    """The offsets at which the plan's edge cases meet, for the kernels'
    checks: 0, 15, 16, 17, both sides of every split boundary, the last
    slot, the capacity and past it."""
    splits, rows = split_plan(capacity, pairs)
    edges = [s * rows + d for s in range(1, splits) for d in (-1, 0, 1)]
    return sorted({o for o in (0, 15, 16, 17, *edges, capacity - 1, capacity, capacity + 5) if o >= 0})
