"""``stream_ms_per_frame.single``: per streamed request of the window that
finished, (its last block's arrival − its first's) over the frames after
its first block, in ms; the median over requests. The benchmark's own
spans around ``stream_generate``."""

from pbench import derive

SAMPLES_PER_FRAME = 1920


def read(run):
    values = []
    for r in run.records:
        if r.request.route != "stream" or r.error is not None or len(r.blocks) < 2:
            continue
        after = (r.samples - r.blocks[0][1]) / SAMPLES_PER_FRAME
        if after > 0 and derive.in_window(run, r.blocks[0][0]):
            values.append((r.blocks[-1][0] - r.blocks[0][0]) / after * 1e3)
    return derive.median(values)
