"""The view path (``fastpath.FastView.run``: site selection, merge, the count
tiers, the emitted lines), mean milliseconds per answered request."""


def read(m):
    return m.span_mean_ms("view")
