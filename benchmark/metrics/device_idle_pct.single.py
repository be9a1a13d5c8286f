"""``device_idle_pct.single``: the share of the traced slice in which no
device operation ran, in %."""

from pbench import derive


def read(run):
    return derive.idle_pct(run)
