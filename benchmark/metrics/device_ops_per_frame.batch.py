"""``device_ops_per_frame.batch``: device kernels in the traced slice over
the lane-frames made in it (AR steps in the slice, from kernel 4's
launches, × slots × the window's lane occupancy)."""

from pbench import derive


def read(run):
    if run.trace is None:
        return None
    steps_w = derive.ar_steps(run, derive.BATCH_ATTENTION)
    steps = derive.ar_steps(run, derive.BATCH_ATTENTION, traced=True)
    if steps <= 0 or steps_w <= 0:
        return None
    lane_frames = steps * derive.frames_in_window(run) / steps_w
    return len(derive.trace_kernels(run, "")) / lane_frames if lane_frames > 0 else None
