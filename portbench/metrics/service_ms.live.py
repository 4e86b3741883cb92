"""service_ms.live: the harness's own spans around each session call
(``Session.process``) in the traced window, summed and over the chunks
served there, in ms: service time with no queueing in it."""


def read(r):
    if r.chunks <= 0 or r.service_s <= 0:
        return None
    return 1e3 * r.service_s / r.chunks
