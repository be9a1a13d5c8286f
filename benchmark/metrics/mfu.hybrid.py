"""``mfu.hybrid``: the model operations that the window's delivered frames
and prefills needed (the hybrid configuration's reference counts: the AR
step's backbone, EOS head and flowNet, the prompt's backbone, and Mimi's
decode from ``pbench/roofline.py``), over the window's seconds × the
H100's dense bfloat16 peak (989 TFLOP/s), in %."""

from pbench import derive


def read(run):
    return derive.mfu_pct(run)
