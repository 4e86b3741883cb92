"""wait_ms.batch: the port's ``wait`` spans (the host blocked until the card
has done the queued work, K8's) under each ``nlms.apply`` span of the
traced window, summed, over the offline calls issued there, in ms."""

from portbench import spans


def read(r):
    return spans.per_tree_ms("nlms.apply", r.calls, ("wait",))
