"""``setup_s``: seconds from the process's start to the window's, on the
host clock: imports, weights from the seed, the kernel libraries (built
on a checkout's first run), the system and the capture of the cell's
shape buckets."""


def read(run):
    return run.setup_s
