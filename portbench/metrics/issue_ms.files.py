"""issue_ms.files: each ``enhance.blocks`` span of the traced window (an
offline call of the Wiener chain) less the union of the ``copy`` and
``wait`` spans inside it (the host's Python and launch path), over the
offline calls issued there, in ms."""

from portbench import spans


def read(r):
    return spans.self_ms("enhance.blocks", r.calls)
