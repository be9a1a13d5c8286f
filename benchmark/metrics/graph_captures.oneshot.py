"""``graph_captures.oneshot``: CUDA graphs the single runtime captured inside
the window of a one-shot cell (its ``GraphCache.captures``, the difference
over the window): 0 when set-up warmed every prompt, AR and decode bucket
the traffic reaches. A capture in the window lands in a request's time."""


def read(run):
    return float(run.captures1 - run.captures0)
