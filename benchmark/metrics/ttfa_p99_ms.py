"""``ttfa_p99_ms``: the nearest-rank 99th percentile, over every streamed
request of the window, of the time from when it was due (open loop) or
sent (closed loop) to its first PCM block in the client's hands; a request
that failed or never delivered is a miss."""

from pbench import derive


def read(run):
    return derive.percentile_ms(derive.first_block_latencies(run), 99.0)
