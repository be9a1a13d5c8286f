"""``mamba2_step_roofline.hybrid``: the Mamba-2 decode-step kernel
(``mamba2_step_kernel`` in the trace) in the traced slice: its launches'
least time on one H100 (the bytes one launch must move, the
configuration's reference ``mamba2_step_bytes`` for one row, at the HBM
rate: bytes bound it) over their device time, in %. None where the slice
has no such kernel or the reference counts none."""

from pbench import derive, roofline

KERNEL = "mamba2_step_kernel"


def read(run):
    least = getattr(run.reference, "mamba2_step_bytes", None)
    if run.trace is None or least is None:
        return None
    kernels = derive.trace_kernels(run, KERNEL)
    return derive.roofline_pct(len(kernels) * roofline.bound_s(least(run.config), 0.0), kernels)
