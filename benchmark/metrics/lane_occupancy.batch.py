"""``lane_occupancy.batch``: lane-frames delivered in the window over (AR
steps run × slots). Steps are kernel 4's launches over the window over its
launches per step (one per layer)."""

from pbench import derive


def read(run):
    steps = derive.ar_steps(run, derive.BATCH_ATTENTION)
    if steps <= 0:
        return None
    return derive.frames_in_window(run) / (steps * run.config["system"]["slots"])
