"""Programmatic query API with the count tiers on a torch device.

``bgt_tpu.api``'s ``Dataset`` with its queries run by this package's
``FastView`` on ``device`` (default ``cuda``); the result is the same
``QueryResult`` of numpy arrays:

    import bgt_tpu_torch
    ds = bgt_tpu_torch.open("1kg11", device="cuda")
    res = ds.query(region="11:100000-200000",
                   samples=['population=="CEU"', 'population=="YRI"'],
                   site_filter="AC1/AN1>=0.1&&AC2==0")
    res.an, res.group_ac, res.genotypes()
"""

from __future__ import annotations

import torch

from bgt_tpu import api as base
from bgt_tpu.formats.bed import Bed
from bgt_tpu.query import engine

from .query import fastpath

QueryResult = base.QueryResult


class Dataset(base.Dataset):
    """One or more BGT databases queried jointly, counting on ``device``."""

    def __init__(self, prefixes, device: torch.device | str | None = None):
        super().__init__(prefixes)
        self.device = torch.device("cuda" if device is None else device)

    def query(self, region: str | None = None, samples=None,
              site_filter: str | None = None, bed=None, bed_exclude=False,
              start: int = 0, limit: int | None = None,
              genotypes: bool = True) -> QueryResult:
        """``bgt_tpu.api.Dataset.query`` with its counts on ``self.device``.

        samples: a list of group selectors (each a name list like
        ",S1,S2", a file path, or a metadata expression); one AC#/AN#
        column pair per group.
        """
        bm = engine.BgtmReader(self.files)
        try:
            bm.set_flag(engine.F_SET_AC)
            if site_filter is not None:
                if bm.set_flt_site(site_filter) != 0:
                    raise ValueError(f"bad site filter: {site_filter!r}")
            if region is not None:
                if bm.set_region(region) < 0:
                    raise ValueError(f"bad region: {region!r}")
            if bed is not None:
                bm.set_bed(bed if isinstance(bed, Bed) else Bed.read(bed),
                           bed_exclude)
            for s in samples or ():
                if bm.add_group(s) < 0:
                    raise ValueError(f"bad sample selector: {s!r}")
            bm.prepare()

            class _Opt:
                seekn = start
                n_rec = limit

            fv = fastpath.FastView(bm, _Opt(), self.device)
            return self._collect(bm, fv, genotypes)
        finally:
            bm.close()


def open(prefixes, device: torch.device | str | None = None) -> Dataset:  # noqa: A001 - mirrors bgt_tpu.open
    """Open one or more BGT databases for queries counting on ``device``."""
    return Dataset(prefixes, device)
