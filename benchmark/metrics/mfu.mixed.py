"""``mfu.mixed``: the model operations that the window's delivered frames
and prefills needed (``pbench/roofline.py``'s count from the widths), over
the window's seconds × the H100's dense bfloat16 peak (989 TFLOP/s), in %,
in the cell of streamed and one-shot lanes together; it bounds kernel 8's
batched stream blocks there."""

from pbench import derive


def read(run):
    return derive.mfu_pct(run)
