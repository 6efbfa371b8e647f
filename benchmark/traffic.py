"""One general generator of requests: a traffic mix (a JSON file of
parameters under ``traffic/``) and the seed give the requests of a run.

Every seed gets the same requests' worth of work, in another order: what
each request holds -- its group set, the values its group templates draw,
its filter and the quantile level of its region's length, all four
together -- is drawn from the mix's own generator (``DESIGN``), the same
for every seed.  The seed's generator only permutes the requests within
each block and places the intervals, and the seed makes the cohort.  So two
seeds differ in which samples and sites a request touches, not in how much
work the run holds:

- arrivals (open loop): ``rate_per_s x seconds`` requests, one every
  ``1 / rate_per_s`` seconds;
- shares (which group set, whether a filter): exact counts in each block
  of ``BLOCK`` requests;
- region lengths: one at each quantile level of their distribution in each
  block;
- labels, integers and windows of the group templates, and the filter
  expressions: drawn uniformly by the mix's generator, ``fresh`` and
  ``distinct`` redrawing.

The warm-up is one request of each group set, in the mix's order, the
first over the whole stretch: its count work passes the host tier's budget,
so the planes are resident on the card when the window opens, as in a
server that has answered any long query.

Mix keys: ``loop`` (``open`` with ``rate_per_s``, or ``closed`` with
``clients``); ``max_gt`` (the server's ``-m``, else the configuration's);
``params`` (further query parameters); ``regions`` (``intervals``: ``count``
intervals of ``min_bp``-``max_bp`` with Zipf(``zipf_s``) popularity; or
``span``: ``min_bp`` to the whole stretch); ``group_sets`` (each with its
``share``, and either ``each_label`` of a metadata key or ``groups``, a list
of groups, each a list of predicate templates: ``{"key", "op", "draw":
"label"}``, ``{"key", "op", "draw": "int", "lo", "hi"}`` or ``{"key",
"draw": "window", "min_width", "max_width"}``; ``fresh`` forbids a request
whose drawn values an earlier request of the run had, ``distinct`` names a
key whose labels differ between a request's groups); ``filters``
(``share``, and ``by_groups``: lists of expressions by group count, or
``default``); ``warmup`` (``reverse_groups`` sends each warm-up request's
groups in reverse order, so that fixed group sets are new to the program
when the window opens).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from urllib.parse import urlencode

import numpy as np

from . import cohort as cohort_mod

BLOCK = 16
DESIGN = 0   # the seed of the mix's own draws: what every run's requests hold


@dataclass
class Request:
    i: int
    region: tuple               # (beg, end), 1-based and inclusive
    groups: list                # each a list of (key, op, value)
    filter: str | None          # kexpr syntax (&&, ||)
    path: str
    due: float | None = None    # seconds after the window opens


def _exact_counts(shares, n: int) -> np.ndarray:
    """Counts for ``shares`` that sum to ``n`` (largest remainder)."""
    raw = np.asarray(shares, float) / float(sum(shares)) * n
    base = np.floor(raw).astype(int)
    order = np.argsort(-(raw - base), kind="stable")
    base[order[: n - base.sum()]] += 1
    return base


def _strata(rng, n: int, block: int) -> np.ndarray:
    """``n`` quantile levels in (0, 1): each block's are ``(j + 0.5) / b``
    in an order drawn from ``rng``."""
    out = np.empty(n)
    for lo in range(0, n, block):
        b = min(block, n - lo)
        out[lo: lo + b] = (rng.permutation(b) + 0.5) / b
    return out


def _categories(rng, shares, n: int, block: int) -> np.ndarray:
    out = np.empty(n, dtype=np.int64)
    for lo in range(0, n, block):
        b = min(block, n - lo)
        cat = np.repeat(np.arange(len(shares)), _exact_counts(shares, b))
        out[lo: lo + b] = cat[rng.permutation(b)]
    return out


def render_group(preds) -> str:
    parts = []
    for key, op, val in preds:
        v = f'"{val}"' if isinstance(val, str) else str(int(val))
        parts.append(f"{key}{op}{v}")
    return ".and.".join(parts)


def render_filter(expr: str) -> str:
    return expr.replace("&&", ".and.").replace("||", ".or.")


class Generator:
    def __init__(self, mix: dict, cfg: dict, coh: cohort_mod.Cohort,
                 seed: int):
        self.mix = mix
        self.cfg = cfg
        self.coh = coh
        self.seed = seed
        self.seen: set = set()
        self.lo_bp = int(coh.pos[0])
        self.hi_bp = int(coh.pos[-1])
        self._intervals = None

    # --- regions -------------------------------------------------------------

    def _interval_set(self, rng):
        spec = self.mix["regions"]
        count = spec["count"]
        lmin, lmax = math.log(spec["min_bp"]), math.log(spec["max_bp"])
        lengths = np.exp(lmin + (np.arange(count) + 0.5) / count * (lmax - lmin))
        # the length of each popularity rank is part of the mix, not the seed
        lengths = lengths[np.random.default_rng(0).permutation(count)]
        lengths = np.minimum(lengths.astype(np.int64), self.hi_bp - self.lo_bp)
        starts = self.lo_bp + (rng.random(count)
                               * (self.hi_bp - self.lo_bp - lengths)).astype(np.int64)
        return starts, lengths

    def _regions(self, rng, u: np.ndarray) -> list:
        """A region at each quantile level ``u`` of the mix's lengths."""
        spec = self.mix["regions"]
        if spec["kind"] == "intervals":
            if self._intervals is None:
                self._intervals = self._interval_set(rng)
            starts, lengths = self._intervals
            ranks = np.arange(1, spec["count"] + 1, dtype=float)
            cdf = np.cumsum(ranks ** -spec["zipf_s"])
            pick = np.searchsorted(cdf / cdf[-1], u)
            return [(int(starts[k]), int(starts[k] + lengths[k] - 1))
                    for k in pick]
        if spec["kind"] == "span":
            whole = self.hi_bp - self.lo_bp + 1
            lengths = (spec["min_bp"] + u * (whole - spec["min_bp"])).astype(np.int64)
            starts = self.lo_bp + (rng.random(len(u)) * (whole - lengths)).astype(np.int64)
            return [(int(s), int(s + ln - 1)) for s, ln in zip(starts, lengths)]
        raise ValueError(f"unknown region kind {spec['kind']!r}")

    # --- groups --------------------------------------------------------------

    def _labels(self, key: str) -> list:
        return sorted(set(self.coh.meta[key].tolist()))

    def _draw_groups(self, rng, gset: dict) -> list:
        if "each_label" in gset:
            key = gset["each_label"]
            return [[(key, "==", lab)] for lab in self._labels(key)]
        for _ in range(10000):
            used: set = set()
            groups = []
            for tmpl in gset["groups"]:
                preds = []
                for p in tmpl:
                    if p["draw"] == "label":
                        labs = self._labels(p["key"])
                        if gset.get("distinct") == p["key"]:
                            labs = [x for x in labs if x not in used]
                        lab = labs[int(rng.integers(len(labs)))]
                        used.add(lab)
                        preds.append((p["key"], p["op"], lab))
                    elif p["draw"] == "int":
                        preds.append((p["key"], p["op"],
                                      int(rng.integers(p["lo"], p["hi"] + 1))))
                    elif p["draw"] == "window":
                        lo, hi = self.cfg["samples"]["metadata"][p["key"]]["int_uniform"]
                        w = int(rng.integers(p["min_width"], p["max_width"] + 1))
                        t = int(rng.integers(lo, hi + 2 - w))
                        preds += [(p["key"], ">=", t), (p["key"], "<", t + w)]
                    else:
                        raise ValueError(f"unknown draw {p['draw']!r}")
                groups.append(preds)
            key = tuple(tuple(g) for g in groups)
            if not gset.get("fresh") or key not in self.seen:
                self.seen.add(key)
                return groups
        raise RuntimeError("no fresh group set left to draw")

    # --- requests ------------------------------------------------------------

    def requests(self, n: int, stream: int, block: int | None = None,
                 which: np.ndarray | None = None, reverse_groups: bool = False,
                 whole_first: bool = False) -> list:
        """``n`` requests, drawn from the mix's generator and then permuted
        within each block by the seed's (with ``which``, in the order
        given)."""
        design = cohort_mod.rng_for(DESIGN, stream)
        rng = cohort_mod.rng_for(self.seed, stream)
        block = block or n
        mix = self.mix
        gsets = mix["group_sets"]
        order = np.arange(n)
        if which is None:
            which = _categories(design, [g["share"] for g in gsets], n, block)
            order = np.concatenate([lo + rng.permutation(min(block, n - lo))
                                    for lo in range(0, n, block)])
        levels = _strata(design, n, block)
        fspec = mix.get("filters")
        has_f = (_categories(design, [1 - fspec["share"], fspec["share"]], n, block)
                 if fspec else np.zeros(n, np.int64))
        drawn = []
        for i in range(n):
            groups = self._draw_groups(design, gsets[which[i]])
            filt = None
            if has_f[i]:
                pool = fspec["by_groups"].get(str(len(groups)),
                                              fspec["by_groups"].get("default"))
                if pool:
                    filt = pool[int(design.integers(len(pool)))]
            drawn.append((groups, filt))
        regions = self._regions(rng, levels[order])
        if whole_first:
            regions[0] = (self.lo_bp, self.hi_bp)
        out = []
        for i, d in enumerate(order):
            groups, filt = drawn[d]
            if reverse_groups:
                groups = groups[::-1]
            beg, end = regions[i]
            q = [("s", render_group(g)) for g in groups]
            q.append(("r", f"{self.coh.chrom}:{beg}-{end}"))
            if filt is not None:
                q.append(("f", render_filter(filt)))
            q += list(mix.get("params", {}).items())
            out.append(Request(i, (beg, end), groups, filt,
                               "/?" + urlencode(q)))
        return out

    def warmup(self) -> list:
        """One request of each group set, the first over the whole stretch."""
        n = len(self.mix["group_sets"])
        return self.requests(
            n, cohort_mod.STREAM_WARMUP, which=np.arange(n),
            reverse_groups=self.mix.get("warmup", {}).get("reverse_groups", False),
            whole_first=True)

    def window(self, seconds: float, n_closed: int | None = None,
               stream: int = cohort_mod.STREAM_TRAFFIC) -> list:
        """The requests of the measured window: for an open loop each with
        its due time, for a closed loop ``n_closed`` in the order the
        clients take them."""
        mix = self.mix
        if mix["loop"] == "closed":
            return self.requests(n_closed, stream, BLOCK)
        n = max(1, int(round(mix["rate_per_s"] * seconds)))
        reqs = self.requests(n, stream, BLOCK)
        for r in reqs:
            r.due = seconds * (r.i + 1) / n
        return reqs
