"""copy_ms.live: the port's ``copy`` spans (blocking transfers between the
host and the card: the chunk in, the op's state, the output out) under each
``session.process`` span of the traced window, summed, over the chunks
started there, in ms."""

from portbench import spans


def read(r):
    return spans.per_tree_ms("session.process", r.chunks, ("copy",))
