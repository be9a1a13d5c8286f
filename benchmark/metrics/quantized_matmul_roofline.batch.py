"""``quantized_matmul_roofline.batch``: kernel 5 (``quantized_matmul_kernel``)
in the traced slice: its launches' least time (each the mean over the AR
step's int8 linears that the kernel takes, at M = slots rows: the int8
weight read once, against 2·M·K·N operations) over their device time, in %.
The AR step's linears are the PocketTTS reference module's
(``step_linears``)."""

from pbench import derive, roofline

KERNEL = "quantized_matmul_kernel"


def read(run):
    if run.trace is None:
        return None
    kernels = derive.trace_kernels(run, KERNEL)
    shapes = roofline.quantized_matmul_shapes(run.reference.step_linears(run.config).values())
    if not kernels or not shapes:
        return None
    m = run.config["system"]["slots"]
    mean = sum(roofline.quantized_matmul_bound_s(m, k, n) for k, n in shapes) / len(shapes)
    return derive.roofline_pct(len(kernels) * mean, kernels)
