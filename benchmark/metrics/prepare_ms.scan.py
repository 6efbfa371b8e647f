"""Request set-up (``server._prepare``: each group's per-sample evaluation,
the filter, the region), mean milliseconds per answered request."""


def read(m):
    return m.span_mean_ms("prepare")
