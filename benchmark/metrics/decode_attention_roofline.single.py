"""``decode_attention_roofline.single``: kernel 1 (the single runtime's
decode attention, ``split_kv_attention`` in the trace) in the traced slice:
its launches' least time on one H100 (the K and V rows the window's
requests attend to on average, read once) over their device time, in %."""

from pbench import derive, roofline

KERNEL = "split_kv_attention"


def read(run):
    if run.trace is None:
        return None
    kernels = derive.trace_kernels(run, KERNEL)
    rows = derive.mean_rows(run)
    if rows is None:
        return None
    return derive.roofline_pct(len(kernels) * roofline.decode_attention_bound_s(run.config, rows), kernels)
