"""BED interval sets with stabbing queries (reference bedidx.c).

Per-chromosome sorted interval arrays queried with numpy searchsorted; the
parsing quirks of the reference reader are preserved (bedidx.c:95-144):
whitespace-delimited columns, a 2-column line means the single 1-based
position, intervals with end<=beg are dropped.
"""

from __future__ import annotations

import gzip

import numpy as np


class Bed:
    def __init__(self):
        self._raw: dict[str, list[tuple[int, int]]] = {}
        self._idx: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    @classmethod
    def read(cls, fn: str) -> "Bed":
        bed = cls()
        f = open(fn, "rb")
        if f.read(2) == b"\x1f\x8b":
            f.close()
            fp = gzip.open(fn, "rt", encoding="latin-1")
        else:
            f.seek(0)
            import io
            fp = io.TextIOWrapper(f, encoding="latin-1")
        with fp:
            for line in fp:
                cols = line.split()
                if not cols:
                    continue
                chrom = cols[0]
                bed._raw.setdefault(chrom, [])
                beg = end = -1
                if len(cols) > 1 and cols[1][:1].isdigit():
                    beg = int(cols[1])
                    if len(cols) > 2 and cols[2][:1].isdigit():
                        end = int(cols[2])
                        if end < beg:
                            end = -1
                if end < 0 and beg > 0:
                    end = beg
                    beg = beg - 1
                if beg >= 0 and end > beg:
                    bed._raw[chrom].append((beg, end))
        bed._index()
        return bed

    def _index(self) -> None:
        for chrom, ivals in self._raw.items():
            if not ivals:
                self._idx[chrom] = (np.zeros(0, np.int64), np.zeros(0, np.int64),
                                    np.zeros(0, np.int64))
                continue
            arr = np.array(sorted(ivals), dtype=np.int64)
            begs, ends = arr[:, 0], arr[:, 1]
            # running max of ends lets us binary-search the overlap frontier
            maxend = np.maximum.accumulate(ends)
            self._idx[chrom] = (begs, ends, maxend)

    def overlap(self, chrom: str, beg: int, end: int) -> bool:
        """True if [beg, end) overlaps any interval on chrom."""
        hit = self._idx.get(chrom)
        if hit is None:
            return False
        begs, ends, maxend = hit
        if begs.size == 0:
            return False
        # candidates: intervals with beg_i < end
        hi = int(np.searchsorted(begs, end, side="left"))
        if hi == 0:
            return False
        # any of them with end_i > beg?
        return bool(maxend[hi - 1] > beg)
