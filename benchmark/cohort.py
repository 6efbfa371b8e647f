"""The cohort a cell runs on, made from its configuration and the seed.

A frozen copy of the port's hit-only founder-mosaic model
(``bgt_tpu_torch/testing.py:synth_gt_bcf_sparse_to_file``): each of the
``2 x n_samples`` haplotypes copies one of ``n_founders`` founder haplotypes,
whose allele at a site is drawn at a beta(a, b) frequency of that site, and
jumps to a random founder between two sites with probability
``switch_rate``; a haplotype's call is missing with probability
``p_missing``.  The switches and the missing calls are the successes of
Bernoulli trials, drawn by geometric gaps.  Codes are 0 (reference), 1
(alternate) and 2 (missing), one byte per haplotype.

Positions lie on a stretch of the configuration's chromosome at its site
density (geometric gaps), each site a biallelic SNP.  Sample metadata is
the configuration's: labels with their sizes assigned to samples in an
order drawn from the seed, and integers drawn uniformly.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

BASES = np.frombuffer(b"ACGT", np.uint8)

# independent streams drawn from one seed
STREAM_CODES, STREAM_SITES, STREAM_SAMPLES, STREAM_TRAFFIC, STREAM_WARMUP = range(5)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """The generator of ``stream`` for ``seed`` (any whole number)."""
    return np.random.default_rng(
        np.random.SeedSequence(seed % (1 << 64), spawn_key=(stream,)))


@dataclass
class Cohort:
    codes: np.ndarray       # (n_sites, 2 * n_samples) uint8: 0, 1 or 2
    pos: np.ndarray         # (n_sites,) int64, 1-based, increasing
    ref: np.ndarray         # (n_sites,) uint8 base
    alt: np.ndarray         # (n_sites,) uint8 base
    names: list             # sample names, in column order
    meta: dict              # key -> (n_samples,) array (str labels or int64)
    chrom: str
    chrom_len: int

    @property
    def n_samples(self) -> int:
        return len(self.names)

    def spl_text(self) -> str:
        """The database's ``.spl``: one FMF row a sample with its metadata
        (``key:Z:label``, ``key:i:integer``)."""
        cols = []
        for key, vals in self.meta.items():
            tag = "i" if vals.dtype.kind in "iu" else "Z"
            cols.append([f"\t{key}:{tag}:{v}" for v in vals.tolist()])
        return "".join(name + "".join(c[i] for c in cols) + "\n"
                       for i, name in enumerate(self.names))


def bernoulli_hits(rng: np.random.Generator, p: float, n: int) -> np.ndarray:
    """Sorted indices of the successes among ``n`` Bernoulli(p) trials,
    drawn as geometric gaps."""
    if p <= 0.0 or n == 0:
        return np.zeros(0, dtype=np.int64)
    batch = int(n * p + 6.0 * (n * p) ** 0.5) + 16
    parts, last = [], -1
    while last < n:
        hits = last + np.cumsum(rng.geometric(p, batch))
        parts.append(hits)
        last = int(hits[-1])
    hits = np.concatenate(parts)
    return hits[:np.searchsorted(hits, n)]


def make_codes(cfg: dict, seed: int, chunk_sites: int = 2048) -> np.ndarray:
    rng = rng_for(seed, STREAM_CODES)
    n_sites, n_hap = cfg["n_sites"], 2 * cfg["n_samples"]
    n_founders = cfg["n_founders"]
    fa, fb = cfg["founder_freq_beta"]
    codes = np.empty((n_sites, n_hap), dtype=np.uint8)
    cur = rng.integers(0, n_founders, n_hap).astype(np.intp)
    for lo in range(0, n_sites, chunk_sites):
        hi = min(lo + chunk_sites, n_sites)
        k = hi - lo
        freqs = rng.beta(fa, fb, size=k)
        founder = (rng.random((k, n_founders)) < freqs[:, None]).astype(np.uint8)
        switch = bernoulli_hits(rng, cfg["switch_rate"], k * n_hap)
        jumps = rng.integers(0, n_founders, switch.size)
        miss = bernoulli_hits(rng, cfg["p_missing"], k * n_hap)
        row_of = np.searchsorted(switch // n_hap, np.arange(k + 1))
        col_of = switch % n_hap
        block = codes[lo:hi]
        for i in range(k):
            a, b = row_of[i], row_of[i + 1]
            if lo + i > 0:  # the cohort's first row keeps its founders
                cur[col_of[a:b]] = jumps[a:b]
            np.take(founder[i], cur, out=block[i])
        block.reshape(-1)[miss] = 2
    return codes


def make_sites(cfg: dict, seed: int):
    """(pos, ref, alt): 1-based increasing positions from ``start_bp`` at
    ``site_density_per_kbp``, and a random SNP at each."""
    rng = rng_for(seed, STREAM_SITES)
    n = cfg["n_sites"]
    gaps = rng.geometric(cfg["site_density_per_kbp"] / 1000.0, n)
    pos = cfg["start_bp"] + np.cumsum(gaps) - gaps[0]
    if int(pos[-1]) >= cfg["chrom_len"]:
        raise ValueError("the sites run past the end of the chromosome")
    ref = rng.integers(0, 4, n)
    alt = (ref + rng.integers(1, 4, n)) % 4
    return pos.astype(np.int64), BASES[ref], BASES[alt]


def make_samples(cfg: dict, seed: int):
    """(names, metadata) from the configuration's ``samples`` block."""
    rng = rng_for(seed, STREAM_SAMPLES)
    n = cfg["n_samples"]
    spec = cfg["samples"]
    names = [f"{spec['prefix']}{i:05d}" for i in range(n)]
    meta = {}
    for key, m in spec["metadata"].items():
        if "labels" in m:
            sizes = m["labels"]
            if sum(sizes.values()) != n:
                raise ValueError(f"the sizes of {key} do not sum to {n}")
            vals = np.repeat(np.array(list(sizes), dtype=object),
                             list(sizes.values()))
            meta[key] = vals[rng.permutation(n)]
        elif "of" in m:  # a label of another key's label
            parent = meta[m["of"]]
            up = {child: top for top, kids in m["groups"].items()
                  for child in kids}
            meta[key] = np.array([up[v] for v in parent], dtype=object)
        else:
            lo, hi = m["int_uniform"]
            meta[key] = rng.integers(lo, hi + 1, n).astype(np.int64)
    return names, meta


def make_cohort(cfg: dict, seed: int) -> Cohort:
    pos, ref, alt = make_sites(cfg, seed)
    names, meta = make_samples(cfg, seed)
    return Cohort(make_codes(cfg, seed), pos, ref, alt, names, meta,
                  cfg["chrom"], cfg["chrom_len"])
