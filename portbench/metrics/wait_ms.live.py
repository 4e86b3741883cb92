"""wait_ms.live: the port's ``wait`` spans (the host blocked until the card
has done queued work: host reads of card values, the drains before the
copies) under each ``session.process`` span of the traced window, summed,
over the chunks started there, in ms."""

from portbench import spans


def read(r):
    return spans.per_tree_ms("session.process", r.chunks, ("wait",))
