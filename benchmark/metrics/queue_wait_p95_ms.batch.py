"""``queue_wait_p95_ms.batch``: the nearest-rank 95th percentile of the
batcher's ``queue`` spans (``parallel/batching.py``: from ``_enqueue`` on
the client's thread to an engine taking the request in ``_admit``) that
end inside the window before the traced slice, where the profiler slows
the engine and the queue backs up (``spans.untraced``), in ms. The port's
own spans: None where it has none."""

from pbench import spans


def read(run):
    return spans.queue_wait_p95_ms(run)
