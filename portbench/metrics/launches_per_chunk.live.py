"""launches_per_chunk.live: the kernels, copies and sets that started on the
device in the traced window, over the live chunks whose service started in
it."""


def read(r):
    if r.chunks <= 0 or r.trace.launches <= 0:
        return None
    return r.trace.launches / r.chunks
