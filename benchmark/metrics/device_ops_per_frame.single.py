"""``device_ops_per_frame.single``: device kernels in the traced slice over
the frames made in it (AR steps: kernel 1's launches in the slice over the
layers; the single runtime makes one frame a step)."""

from pbench import derive


def read(run):
    if run.trace is None:
        return None
    steps = derive.ar_steps(run, derive.SINGLE_ATTENTION, traced=True)
    if steps <= 0:
        return None
    return len(derive.trace_kernels(run, "")) / steps
