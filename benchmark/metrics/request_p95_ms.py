"""``request_p95_ms``: the nearest-rank 95th percentile, over every
one-shot request of the window, of the time from when it was due or sent
to its whole PCM in the client's hands; a failure is a miss."""

from pbench import derive


def read(run):
    return derive.p95_ms(derive.request_latencies(run))
