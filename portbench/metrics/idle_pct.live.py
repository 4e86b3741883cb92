"""idle_pct.live: the share of the traced window in which nothing ran on
the device, 100 x (1 - union of device busy intervals / window), live."""


def read(r):
    if r.trace.window_s <= 0 or r.trace.launches <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
