"""``fused_up2_up3_tail_roofline.stream``: kernel 8's stream blocks
(``cascade_mma_kernel``) in the traced slice of the single runtime's
streams: their least time (each at the mean of the shapes the wrapper
launched in the slice, x, the weights and the PCM moved once, against its
operations) over their device time, in %."""

from pbench import derive


def read(run):
    return derive.stream_cascade_roofline_pct(run)
