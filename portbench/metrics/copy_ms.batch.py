"""copy_ms.batch: the port's ``copy`` spans (the state's transfers between
the host and the card) under each ``nlms.apply`` span of the traced window,
summed, over the offline calls issued there, in ms."""

from portbench import spans


def read(r):
    return spans.per_tree_ms("nlms.apply", r.calls, ("copy",))
