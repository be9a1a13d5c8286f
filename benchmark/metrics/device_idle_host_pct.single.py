"""``device_idle_host_pct.single``: the share of the traced slice, in %, in
which no device operation ran while the innermost span open on the single
runtime's thread was a host span (``setup``, ``enqueue``, ``emit``; not a
``wait``, not outside the port). It describes the traced program: the
profiler slows the runtime's graph launches, and so lengthens its host
spans, inside the slice. None without a trace, without device
operations in it, or where the port has no spans."""

from pbench import spans


def read(run):
    return spans.device_idle_host_pct(run, "runtime")
