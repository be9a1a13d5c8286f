"""``ttfa_p95_ms``: the nearest-rank 95th percentile, over every streamed
request of the window, of the time from when it was due (open loop) or
sent (closed loop) to its first PCM block in the client's hands; a request
that failed or never delivered is a miss."""

from pbench import derive


def read(run):
    return derive.p95_ms(derive.first_block_latencies(run))
