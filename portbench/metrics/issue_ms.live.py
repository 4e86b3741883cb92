"""issue_ms.live: each ``session.process`` span of the traced window less
the union of the ``copy`` and ``wait`` spans inside it (the host's Python
and launch path), over the chunks started there, in ms."""

from portbench import spans


def read(r):
    return spans.self_ms("session.process", r.chunks)
