"""The counts' way back to the host after a pass on the card: the
program's ``count.readback`` spans (``counts_to_numpy``: the wait for the
pass and the copy), in the window, mean milliseconds per device pass."""

from bgt_tpu_torch import log


def read(m):
    records = getattr(log, "records", None)
    if records is None:
        return None
    d = [s.t1 - s.t0 for s in records()
         if s.name == "count.readback" and m.t0 <= s.t0 * 1e-9 < m.t1]
    return sum(d) / len(d) * 1e-6 if d else None
