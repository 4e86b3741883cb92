"""launches_per_call.batch: the kernels, copies and sets that started on the
device in the traced window, over the offline calls issued in it."""


def read(r):
    if r.calls <= 0 or r.trace.launches <= 0:
        return None
    return r.trace.launches / r.calls
