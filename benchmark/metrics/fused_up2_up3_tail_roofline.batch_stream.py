"""``fused_up2_up3_tail_roofline.batch_stream``: kernel 8's stream blocks
(``cascade_mma_kernel``) in the traced slice of the batcher's streamed
lanes (one batched stream decode a block, each lane at its own start): the
same least time over device time as ``fused_up2_up3_tail_roofline.stream``,
in %."""

from pbench import derive


def read(run):
    return derive.stream_cascade_roofline_pct(run)
