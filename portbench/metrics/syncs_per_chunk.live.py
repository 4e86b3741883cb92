"""syncs_per_chunk.live: the port's ``copy`` and ``wait`` spans under each
``session.process`` span of the traced window, over the chunks started
there: every point where the program itself blocks on the card.  The drains
that recording adds (``*.drain``: a wait before a copy, so that the copy
holds the transfer alone) are left out: a chunk blocks there only because
it is traced."""

from portbench import spans


def read(r):
    return spans.count_per_tree("session.process", r.chunks, ("copy", "wait"), drains=False)
