"""The server's queue: from a connection's accept to ``do_GET``
(``server.queue``) and from the producer thread's start to its first line
(``producer.wait``), the program's spans in the window, mean milliseconds
per answered request."""

from bgt_tpu_torch import log


def read(m):
    records = getattr(log, "records", None)
    if records is None or not m.answered:
        return None
    d = [s.t1 - s.t0 for s in records()
         if s.name in ("server.queue", "producer.wait")
         and m.t0 <= s.t0 * 1e-9 < m.t1]
    return sum(d) / m.answered * 1e-6 if d else None
