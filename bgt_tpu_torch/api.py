"""Programmatic query API with the count tiers on a torch device.

The port's copy of ``bgt_tpu/api.py``: the query pipeline as Python objects
returning numpy arrays, with the counts taken on ``device`` (default
``cuda``):

    import bgt_tpu_torch
    ds = bgt_tpu_torch.open("1kg11", device="cuda")
    res = ds.query(region="11:100000-200000",
                   samples=['population=="CEU"', 'population=="YRI"'],
                   site_filter="AC1/AN1>=0.1&&AC2==0")
    res.pos, res.ref, res.alt      # site arrays
    res.an, res.ac                 # overall counts
    res.group_an, res.group_ac     # per-group counts (n_sites, n_groups)
    res.genotypes()                # (n_sites, n_out_samples, 2) allele codes
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .query import engine, fastpath


@dataclass
class QueryResult:
    """Columnar result of a site query."""

    chrom: list
    pos: np.ndarray          # 0-based start
    rlen: np.ndarray
    ref: list
    alt: list
    has_m: np.ndarray        # site carries an overlapping-allele (<M>) column
    an: np.ndarray
    ac: np.ndarray
    ac_m: np.ndarray
    group_an: np.ndarray | None
    group_ac: np.ndarray | None
    samples: list
    _gt: object = field(default=None, repr=False)

    @property
    def n_sites(self) -> int:
        return self.pos.size

    def genotypes(self) -> np.ndarray:
        """(n_sites, n_samples, 2) uint8 codes: 0=ref 1=alt 2=missing 3=<M>."""
        if self._gt is None:
            raise ValueError("query(genotypes=False); re-run with genotypes=True")
        if callable(self._gt):
            self._gt = self._gt()
        return self._gt

    def allele_frequency(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.where(self.an > 0, self.ac / np.maximum(self.an, 1), np.nan)


class Dataset:
    """One or more BGT databases queried jointly (the bgtm composition),
    counting on ``device`` (default ``cuda``)."""

    def __init__(self, prefixes, device: torch.device | str | None = None):
        if isinstance(prefixes, str):
            prefixes = [prefixes]
        self.files = [engine.open_bgt_cached(p) for p in prefixes]
        self.device = torch.device("cuda" if device is None else device)

    @property
    def samples(self) -> list[str]:
        out = []
        for bf in self.files:
            out.extend(bf.f.row_name(i) for i in range(bf.n_samples))
        return out

    @property
    def n_sites(self) -> int:
        return sum(fastpath.get_site_table(bf).n for bf in self.files)

    def query(self, region: str | None = None, samples=None,
              site_filter: str | None = None, bed=None, bed_exclude=False,
              start: int = 0, limit: int | None = None,
              genotypes: bool = True) -> QueryResult:
        """Run a counting query; mirrors the `view` flag surface.

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
                from .formats.bed import Bed
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

    def _collect(self, bm: engine.BgtmReader, fv: fastpath.FastView,
                 want_gt: bool) -> QueryResult:
        rows_per_db = [
            ctx.select_rows() if ctx.g.n_out > 0 else np.zeros(0, np.int64)
            for ctx in fv.dbs
        ]
        mv = fv._merge(rows_per_db)
        n_groups = bm.n_groups
        counts = np.zeros((mv.n, n_groups, 4), dtype=np.int64)
        for d, ctx in enumerate(fv.dbs):
            if ctx.g.n_out == 0:
                continue
            masks = ctx.masks(n_groups)
            rows_d = rows_per_db[d]
            cd = ctx.counts_for(rows_d, masks, lambda: fv.sharding)
            pres = mv.pres[:, d]
            if len(fv.dbs) == 1:
                counts += cd
            else:
                have = pres >= 0
                counts[have] += cd[np.searchsorted(rows_d, pres[have])]
                miss = np.zeros((n_groups, 4), dtype=np.int64)
                for gi in range(n_groups):
                    miss[gi, 2] = int(np.unpackbits(masks[gi].view(np.uint8)).sum())
                counts[~have] += miss[None, :, :]
        tot = counts.sum(axis=1)
        an = tot[:, 0] + tot[:, 1] + tot[:, 3]
        ac = tot[:, 1]
        ac_m = tot[:, 3]
        gan = counts[:, :, 0] + counts[:, :, 1] + counts[:, :, 3]
        gac = counts[:, :, 1]

        sel = np.arange(mv.n)
        if bm.site_flt is not None:
            keep = np.ones(mv.n, dtype=bool)
            env = {"AC": ac, "AN": an}
            for gi in range(n_groups):
                env[f"AN{gi + 1}"] = gan[:, gi]
                env[f"AC{gi + 1}"] = gac[:, gi]
            try:
                fn = bm.site_flt.compile_vector(np)
                missing = bm.site_flt.var_names - set(env)
                if missing:
                    raise TypeError(f"unknown vars {missing}")
                _t, vec = fn(env)
                keep = np.asarray(vec) != 0
            except (TypeError, KeyError):
                for i in range(mv.n):
                    keep[i] = bm.pass_site_flt(fv._site_info(i, counts))
            sel = np.nonzero(keep)[0]
        limit = getattr(fv.opt, "n_rec", None)
        if limit is not None:
            sel = sel[:limit]

        ctg_names = [n for n, _ in bm.h_out.ids[1]]
        out_samples = []
        for d, ctx in enumerate(fv.dbs):
            out_samples.extend(ctx.g.f.f.row_name(int(i)) for i in ctx.g.out)

        gt = None
        if want_gt:
            def gt_thunk(sel=sel, mv=mv, dbs=fv.dbs):
                blocks = []
                for d, ctx in enumerate(dbs):
                    if ctx.g.n_out == 0:
                        continue
                    cols = np.empty(ctx.g.n_out * 2, dtype=np.int64)
                    cols[0::2] = np.asarray(ctx.g.out) * 2
                    cols[1::2] = np.asarray(ctx.g.out) * 2 + 1
                    pres = mv.pres[sel, d]
                    have = pres >= 0
                    block = np.full((sel.size, cols.size), 2, dtype=np.uint8)
                    if have.any():
                        block[have] = ctx.ts.codes(pres[have], cols)
                    blocks.append(block)
                full = np.concatenate(blocks, axis=1) if len(blocks) > 1 else blocks[0]
                return full.reshape(sel.size, -1, 2)

            gt = gt_thunk

        return QueryResult(
            chrom=[ctg_names[r] for r in mv.rid[sel]],
            pos=mv.pos[sel],
            rlen=mv.rlen[sel],
            ref=[mv.ref_s(int(i)) for i in sel],
            alt=[mv.alt_s(int(i)) for i in sel],
            has_m=mv.n_allele[sel] > 2,
            an=an[sel], ac=ac[sel], ac_m=ac_m[sel],
            group_an=gan[sel] if n_groups > 1 else None,
            group_ac=gac[sel] if n_groups > 1 else None,
            samples=out_samples,
            _gt=gt,
        )

    def close(self):
        pass


def open(prefixes, device: torch.device | str | None = None) -> Dataset:  # noqa: A001 - mirrors the CLI verb
    """Open one or more BGT databases for queries counting on ``device``."""
    return Dataset(prefixes, device)
