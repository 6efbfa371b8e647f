"""Exact replica of the reference's introsort (reference ksort.h KSORT_INIT).

The haplotype-count report is ordered by an UNSTABLE introsort in the
reference (bgt.c:929); ties between equal counts land in an order determined
by the algorithm's partitioning, so byte parity of ``bgt view -H`` requires
running the very same algorithm, not merely "a" descending sort.
"""

from __future__ import annotations

_SHRINK = 1.2473309501039786540366528676643


def _insertsort(a: list, lo: int, hi: int, lt) -> None:
    for i in range(lo + 1, hi):
        j = i
        while j > lo and lt(a[j], a[j - 1]):
            a[j], a[j - 1] = a[j - 1], a[j]
            j -= 1


def _combsort(a: list, lo: int, n: int, lt) -> None:
    gap = n
    while True:
        if gap > 2:
            gap = int(gap / _SHRINK)
            if gap in (9, 10):
                gap = 11
        do_swap = False
        for i in range(lo, lo + n - gap):
            j = i + gap
            if lt(a[j], a[i]):
                a[i], a[j] = a[j], a[i]
                do_swap = True
        if not (do_swap or gap > 2):
            break
    if gap != 1:
        _insertsort(a, lo, lo + n, lt)


def ks_introsort(a: list, lt) -> None:
    """Sort ``a`` in place with comparator ``lt``, replicating ksort.h."""
    n = len(a)
    if n < 1:
        return
    if n == 2:
        if lt(a[1], a[0]):
            a[0], a[1] = a[1], a[0]
        return
    d = 2
    while (1 << d) < n:
        d += 1
    stack: list[tuple[int, int, int]] = []
    s, t = 0, n - 1
    d <<= 1
    while True:
        if s < t:
            d -= 1
            if d == 0:
                _combsort(a, s, t - s + 1, lt)
                t = s
                continue
            i, j = s, t
            k = i + ((j - i) >> 1) + 1
            if lt(a[k], a[i]):
                if lt(a[k], a[j]):
                    k = j
            else:
                k = i if lt(a[j], a[i]) else j
            rp = a[k]
            if k != t:
                a[k], a[t] = a[t], a[k]
            while True:
                i += 1
                while lt(a[i], rp):
                    i += 1
                j -= 1
                while i <= j and lt(rp, a[j]):
                    j -= 1
                if j <= i:
                    break
                a[i], a[j] = a[j], a[i]
            a[i], a[t] = a[t], a[i]
            if i - s > t - i:
                if i - s > 16:
                    stack.append((s, i - 1, d))
                s = i + 1 if t - i > 16 else t
            else:
                if t - i > 16:
                    stack.append((i + 1, t, d))
                t = i - 1 if i - s > 16 else s
        else:
            if not stack:
                _insertsort(a, 0, n, lt)
                return
            s, t, d = stack.pop()
