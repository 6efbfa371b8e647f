"""Loading the cell's database's tile in the set-up: the program's
``tiles.build`` span (the tile built from the ``.pbf``, or mapped) of the
database whose tile was built last before the window, and the
``tiles.upload`` spans (both planes sent to the card) of that database
from then on, in seconds."""

from bgt_tpu_torch import log


def read(m):
    records = getattr(log, "records", None)
    if records is None:
        return None
    before = [s for s in records() if s.t1 * 1e-9 <= m.t0]
    built = [s for s in before if s.name == "tiles.build"]
    if not built:
        return None
    last = built[-1]
    return sum(s.t1 - s.t0 for s in before
               if s.name in ("tiles.build", "tiles.upload")
               and s.attrs.get("db") == last.attrs.get("db")
               and s.t0 >= last.t0) * 1e-9
