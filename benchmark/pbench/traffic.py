"""The traffic generator: one general generator that reads a workload
file's parameters and draws its requests from ``--seed``.

Every seed gets the same work in another order. Requests come in blocks of
``block`` requests; each block holds the same token counts (the quantiles
at ``(i + 0.5) / block`` of the workload's length distribution, rounded and
clipped), the same number of requests of each route and of greedy ones, and
for an open loop the same inter-arrival gaps (the exponential's quantiles,
scaled to the mean ``1 / rate``); the seed permutes each block and draws
the token ids. So a window that runs a few blocks does the same amount of
work on every seed, and the seed changes only the order and the text.

Workload keys read here: ``tokens`` (``median``, ``sigma``, ``min``,
``max``: a lognormal), ``vocab``, ``routes`` (route name to share),
``greedy_share``, ``temperature``, ``block``, and for ``loop: "open"``
``rate_per_s``.
"""

from __future__ import annotations

import math
import statistics
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

__all__ = ["Request", "block_lengths", "draw", "frames_for_tokens"]

FRAME_RATE = 12.5


def frames_for_tokens(n_tokens: int, frame_rate: float = FRAME_RATE) -> int:
    """The frame budget of a chunk of ``n_tokens`` (a copy of the port's
    ``text.prepare.estimate_max_frames``): ``ceil((n / 3 + 2) · rate)``."""
    return int(math.ceil((max(n_tokens, 0) / 3.0 + 2.0) * frame_rate))


@dataclass(frozen=True)
class Request:
    index: int
    tokens: List[int]
    frames: int
    route: str
    temperature: float
    # Seconds after the window opens at which an open loop sends it (None
    # in a closed loop, where a client sends it when its previous ends).
    due: Optional[float]

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0


def block_lengths(workload: Dict) -> List[int]:
    """The token counts of one block: lognormal quantiles, rounded and
    clipped to ``[min, max]``."""
    spec = workload["tokens"]
    block = int(workload["block"])
    dist = statistics.NormalDist()
    out = []
    for i in range(block):
        z = dist.inv_cdf((i + 0.5) / block)
        n = round(spec["median"] * math.exp(spec["sigma"] * z))
        out.append(int(min(max(n, spec["min"]), spec["max"])))
    return out


def _counts(shares: Dict[str, float], block: int) -> List[str]:
    """``block`` labels split by ``shares`` (largest remainders)."""
    names = sorted(shares)
    total = sum(shares.values())
    raw = [shares[n] / total * block for n in names]
    counts = [int(math.floor(r)) for r in raw]
    for j in sorted(range(len(names)), key=lambda j: raw[j] - counts[j], reverse=True)[: block - sum(counts)]:
        counts[j] += 1
    return [n for n, c in zip(names, counts) for _ in range(c)]


def _gaps(rate: float, block: int) -> np.ndarray:
    """The exponential's quantiles at ``(i + 0.5) / block``, scaled to the
    mean ``1 / rate``."""
    q = (np.arange(block) + 0.5) / block
    g = -np.log1p(-q)
    return g / g.mean() / rate


def draw(workload: Dict, seed: int) -> Iterator[Request]:
    """The workload's requests in order, without end."""
    block = int(workload["block"])
    lengths = block_lengths(workload)
    routes = _counts(workload["routes"], block)
    greedy_n = int(round(workload.get("greedy_share", 0.0) * block))
    temperature = float(workload["temperature"])
    vocab = int(workload["vocab"])
    open_loop = workload["loop"] == "open"
    gaps = _gaps(float(workload["rate_per_s"]), block) if open_loop else None
    rng = np.random.Generator(np.random.PCG64(int(seed) & (2**63 - 1)))
    index, due = 0, 0.0
    while True:
        order = rng.permutation(block)
        route_order = rng.permutation(block)
        greedy = set(rng.permutation(block)[:greedy_n].tolist())
        gap_order = rng.permutation(block)
        for j in range(block):
            n = lengths[order[j]]
            ids = rng.integers(0, vocab, size=n).tolist()
            req_due = None
            if open_loop:
                req_due = due
                due += float(gaps[gap_order[j]])
            yield Request(
                index=index,
                tokens=[int(t) for t in ids],
                frames=frames_for_tokens(n),
                route=routes[route_order[j]],
                temperature=0.0 if j in greedy else temperature,
                due=req_due,
            )
            index += 1
