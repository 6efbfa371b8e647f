"""The server's own work on a request: the program's ``request`` span (from
``do_GET`` to the chunked trailer) less the union of its ``server.queue``,
``prepare`` and ``view`` spans within it, so the reader's opening, the
parsing and the response writes; mean milliseconds per answered request."""

from bgt_tpu_torch import log

PARTS = ("server.queue", "prepare", "view")


def read(m):
    records = getattr(log, "records", None)
    if records is None or not m.answered:
        return None
    spans = records()
    requests = [s for s in spans
                if s.name == "request" and m.t0 <= s.t0 * 1e-9 < m.t1]
    if not requests:
        return None
    parts: dict = {}
    for s in spans:
        if s.name in PARTS:
            parts.setdefault(s.request, []).append((s.t0, s.t1))
    own = 0
    for r in requests:
        covered, end = 0, r.t0
        for a, b in sorted(parts.get(r.request, ())):
            a, b = max(a, end), min(b, r.t1)
            if b > a:
                covered += b - a
                end = b
        own += r.t1 - r.t0 - covered
    return own / m.answered * 1e-6
