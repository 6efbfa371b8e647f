"""The count tiers (``fastpath.DbCtx.counts_for``, whichever tier answers,
to the counts on the host), mean milliseconds per answered request."""


def read(m):
    return m.span_mean_ms("count")
