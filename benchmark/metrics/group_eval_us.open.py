"""Request set-up per sample: the program's ``prepare.group`` spans (one
expression group of a request) over the samples each evaluated (the
``.spl`` rows of every database), in the window, in microseconds a sample
and group."""

from bgt_tpu_torch import log


def read(m):
    records = getattr(log, "records", None)
    if records is None:
        return None
    groups = [s for s in records()
              if s.name == "prepare.group" and m.t0 <= s.t0 * 1e-9 < m.t1]
    samples = sum(s.attrs.get("samples", 0) for s in groups)
    if not samples:
        return None
    return sum(s.t1 - s.t0 for s in groups) / samples * 1e-3
