"""``graph_captures.batch``: CUDA graphs the batcher's engines captured
inside the window (``ContinuousBatcher.graph_stats()`` captures summed, the
difference over the window)."""


def read(run):
    return float(run.captures1 - run.captures0)
