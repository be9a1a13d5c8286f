"""``device_idle_host_pct.batch``: the share of the traced slice, in %, in
which no device operation ran while the innermost span open on the
batcher's engine thread was a host span (``reap``, ``block``, ``admit``'s
``prepare`` and ``enqueue``, ``emit``, ``harvest``; not a ``wait`` nested in
any of them, not ``idle``). It describes the traced program: the profiler
slows the engine's graph launches, and so lengthens its host spans, inside
the slice. None without a trace, without device
operations in it, or where the port has no spans."""

from pbench import spans


def read(run):
    return spans.device_idle_host_pct(run, "engine")
