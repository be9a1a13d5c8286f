"""``device_ops_per_frame.hybrid``: device kernels in the traced slice over
the frames made in it (AR steps: the Mamba-2 decode step's launches in the
slice, by its wrapper's counter, over the configuration's Mamba layers;
the single runtime makes one frame a step). None where the program has no
such wrapper."""

from pbench import derive

WRAPPER = "mamba2_step"


def read(run):
    if run.trace is None or WRAPPER not in run.trace.counts1:
        return None
    steps = derive.launches(run.trace.counts0, run.trace.counts1, (WRAPPER,)) / run.config["layer_types"].count("mamba")
    if steps <= 0:
        return None
    return len(derive.trace_kernels(run, "")) / steps
