"""``attached_lane_share.batch``: Σ k·attached ÷ Σ k·slots over the
batcher's ``block`` spans that start inside the window before the traced slice
(``spans.untraced``; ``k`` the block's
AR steps, ``attached`` its lanes that hold a request). Beside
``lane_occupancy.batch`` it splits the idle lane-steps into empty slots
(1 − share) and finished lanes riding out their block (share −
occupancy). The port's own spans: None where it has none."""

from pbench import spans


def read(run):
    return spans.attached_lane_share(run)
