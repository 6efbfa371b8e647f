"""The yardstick the per-layer metrics hold the device to.

The peak is the H100 SXM's, from NVIDIA's data sheet at a 700 W limit: 3.35
TB/s of HBM3.  ``count_bound_ms`` is copied from the port's
``tools/measure.py``: the least time of a masked-popcount count pass is the
time to read both genotype planes and the masks once and to write the
counts once at that rate.  It has no operations term: the counting runs on
the binary tensor cores, whose rate the data sheet does not give.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12


def count_bound_ms(rows: int, words: int, groups: int, out_ints: int = 4) -> float:
    """The least time of a count over (rows, words) planes and ``groups``
    masks writing ``out_ints`` int32 per row and group."""
    nbytes = (2 * rows + groups) * words * 4 + rows * groups * out_ints * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def is_count_kernel(name: str) -> bool:
    """A kernel that counts genotype codes, whichever implements it."""
    low = name.lower()
    return "count" in low
