"""``runtime_ms_per_frame.single``: the union of the single runtime's spans
(``setup``, ``enqueue``, ``wait``, ``emit``; not the request's root) on the
requests' thread inside the window before the traced slice, where the
profiler slows the graph launches (``spans.untraced``), over the frames of the ``enqueue``
spans that start in it, in ms a frame: ``stream_ms_per_frame.single``
without the caller's share. The port's own spans: None where it has
none."""

from pbench import spans


def read(run):
    return spans.runtime_ms_per_frame(run)
