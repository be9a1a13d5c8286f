"""``graph_captures.single``: CUDA graphs the single runtime captured inside
the window (its ``GraphCache.captures``, the difference over the window):
0 when set-up warmed every shape bucket the traffic reaches."""


def read(run):
    return float(run.captures1 - run.captures0)
