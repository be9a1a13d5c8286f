"""The load generator: closed or open loops over a system's routes, timed
from the client's side with the benchmark's own spans.

A closed loop runs ``clients`` threads; each sends its next request when
its previous one has ended, until the window closes. An open loop sends
each request at its due time, whatever is in flight, from a dispatcher
thread into a pool of client threads; a request is timed from when it was
due, so a stall counts against the requests behind it, and the
dispatcher's lateness is recorded. After the window closes, every request
sent in it is waited for (a minute past the close at most); one that never
ends is a miss.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import ThreadPoolExecutor, wait
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np

from pbench.traffic import Request

__all__ = ["Record", "run_closed", "run_open"]

DRAIN_S = 60.0


@dataclass
class Record:
    request: Request
    due: float  # perf_counter time the request was due (open) or sent (closed)
    sent: float = 0.0
    blocks: List[Tuple[float, int]] = field(default_factory=list)  # (arrival, samples)
    done: Optional[float] = None
    error: Optional[str] = None
    pcm: Optional[np.ndarray] = None  # kept for greedy requests (the output check)

    @property
    def samples(self) -> int:
        return sum(n for _t, n in self.blocks)

    @property
    def first(self) -> Optional[float]:
        return self.blocks[0][0] if self.blocks else None


def _execute(system, rec: Record) -> None:
    req = rec.request
    keep = req.greedy
    key = req.index if keep else None
    parts = []
    try:
        if req.route == "stream":
            for block in system.stream(req.tokens, req.temperature, req.frames, key):
                rec.blocks.append((time.perf_counter(), len(block)))
                if keep:
                    parts.append(np.asarray(block, np.float32))
        else:
            pcm = system.oneshot(req.tokens, req.temperature, req.frames, key)
            rec.blocks.append((time.perf_counter(), len(pcm)))
            if keep:
                parts.append(np.asarray(pcm, np.float32))
        rec.done = time.perf_counter()
        if keep:
            rec.pcm = np.concatenate(parts) if parts else np.zeros(0, np.float32)
    except Exception as exc:  # noqa: BLE001 - a failed request is a miss, recorded and counted
        rec.error = f"{type(exc).__name__}: {exc}"


def run_closed(system, requests: Iterator[Request], clients: int, t0: float, seconds: float) -> List[Record]:
    lock = threading.Lock()
    records: List[Record] = []
    t_end = t0 + seconds

    def client() -> None:
        while True:
            now = time.perf_counter()
            if now >= t_end:
                return
            with lock:
                rec = Record(next(requests), due=now, sent=now)
                records.append(rec)
            _execute(system, rec)

    threads = [threading.Thread(target=client, name=f"bench-client-{i}", daemon=True) for i in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=max(t_end - time.perf_counter(), 0.0) + DRAIN_S)
    for rec in records:
        if rec.done is None and rec.error is None:
            rec.error = "never ended"
    records.sort(key=lambda r: r.request.index)
    return records


def run_open(system, requests: Iterator[Request], workers: int, t0: float, seconds: float) -> List[Record]:
    records: List[Record] = []
    pool = ThreadPoolExecutor(max_workers=workers, thread_name_prefix="bench-client")
    futures = []
    try:
        for req in requests:
            if req.due >= seconds:
                break
            due = t0 + req.due
            delay = due - time.perf_counter()
            if delay > 0:
                time.sleep(delay)
            rec = Record(req, due=due, sent=time.perf_counter())
            records.append(rec)
            futures.append(pool.submit(_execute, system, rec))
        wait(futures, timeout=max(t0 + seconds + DRAIN_S - time.perf_counter(), 0.0))
    finally:
        pool.shutdown(wait=False, cancel_futures=True)
    for rec in records:
        if rec.done is None and rec.error is None:
            rec.error = "never ended"
    return records
