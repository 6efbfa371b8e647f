"""The 95th percentile of every request's latency in the traced window
(from its due time to its last body byte, one never answered counting the
whole wait), in ms: the tail the end-to-end metrics leave out, since it
spreads from run to run with the full collections that fall in a window."""

import numpy as np


def read(m):
    if m.latency_ms is None or not len(m.latency_ms):
        return None
    return float(np.percentile(m.latency_ms, 95))
