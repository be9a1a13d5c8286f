"""Shape bucketing (a copy of ``go_pocket_tts_tpu/utils/buckets.py``).

Prompt lengths and frame counts are padded up to a small set of buckets so
caches and buffers keep a few static sizes. Padded computation is masked
(prompt) or causally discarded (Mimi decode), so bucketing is exact.
"""

from __future__ import annotations

from typing import Sequence, Tuple

__all__ = ["round_up", "pick_bucket", "PROMPT_BUCKETS", "FRAME_BUCKETS", "DECODE_BUCKETS"]

PROMPT_BUCKETS: Tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024)
FRAME_BUCKETS: Tuple[int, ...] = (64, 128, 256, 512, 1024)
DECODE_BUCKETS: Tuple[int, ...] = (16, 32, 64, 128, 256, 512, 1024)


def round_up(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket ≥ n; multiples of the largest bucket beyond that."""
    if n <= 0:
        return buckets[0]
    for b in buckets:
        if n <= b:
            return b
    return round_up(n, buckets[-1])
