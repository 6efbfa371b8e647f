"""Allele atomizer: decompose VCF records into atomic SNP/ins/del alleles.

Faithful reimplementation of the reference atomizer semantics (reference
atomic.c): CIGAR-or-length-difference decomposition of each ALT against REF
(atomic.c:98-179), per-atom 4-value genotype translation where overlapping
other alleles become code 3 (``<M>``) and missing stays 2 (atomic.c:15-76),
deduplication of identical atoms, and a sorted streaming merge across input
records that emits an atom only once the input has passed its position
(atomic.c:220-247).  Genotype codes: 0=ref, 1=this atom's alt, 2=missing,
3=a different overlapping alt.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from ..formats import bcf as bcflib
from ..formats.bcf import (BCF_BT_CHAR, BCF_BT_INT8, BCF_DT_ID, Bcf1,
                           enc_size, enc_vchar, enc_vint, enc_int1)


@dataclass
class Atom:
    rid: int
    pos: int
    rlen: int
    anum: int
    ref: str
    alt: str
    from_new: bool = True
    has_multi: bool = False
    phased: int = 0
    gt: list = field(default_factory=list)  # n_sample*2 codes in 0..3

    def key(self):
        return (self.rid, self.pos, self.rlen, self.alt)


def _atom_cmp_key(a: Atom):
    # bcf_atom_cmp2: (rid, pos, rlen, alt) then from_new (old before new)
    return (a.rid, a.pos, a.rlen, a.alt, a.from_new)


def _gen_at(h: bcflib.BcfHeader, b: Bcf1, atoms: list[Atom]) -> list[Atom]:
    """Sort, dedup, and fill genotypes for the new atoms (bcf_atom_gen_at)."""
    id_gt = h.id2int(BCF_DT_ID, "GT")
    assert id_gt >= 0
    fmts = b.unpack_fmt()
    gt = None
    for f in fmts:
        if f.id == id_gt:
            gt = f
            break
    assert gt is not None and gt.n == 2, "GT must be diploid"
    phased = b.indiv[gt.off] & 1 if b.n_sample > 0 else 0

    atoms.sort(key=_atom_cmp_key)
    n = len(atoms)
    eq = [0] * n
    has_dup = False
    for i in range(1, n):
        eq[i] = i if atoms[i - 1].key() != atoms[i].key() else eq[i - 1]
        if eq[i] == eq[i - 1]:
            has_dup = True

    indiv = b.indiv
    n_allele = b.n_allele
    for k in range(n):
        ak = atoms[k]
        if eq[k] != k or not ak.from_new:
            continue
        ak.has_multi = False
        ak.phased = phased
        tr = [0] * n_allele
        for i in range(n):
            ai = atoms[i]
            if not ai.from_new:
                continue
            if eq[i] == eq[k]:
                tr[ai.anum] = 1
            elif ai.pos < ak.pos + ak.rlen and ak.pos < ai.pos + ai.rlen:
                tr[ai.anum] = 3
        base = gt.off
        n_gt = b.n_sample * gt.n
        if gt.type == bcflib.BCF_BT_INT8:
            raw = np.frombuffer(bytes(indiv[base: base + n_gt]), dtype=np.uint8)
            from .. import native
            nat = native.translate_gt(raw, tr) if native.get_lib() else None
            if nat is not None:
                ak.gt, ak.has_multi = nat
                continue
            c = (raw.astype(np.int32) >> 1) - 1
            tr_arr = np.asarray(tr, dtype=np.uint8)
            codes = np.where(c < 0, np.uint8(2), tr_arr[np.clip(c, 0, None)])
        else:  # rare wide GT encodings fall back to the scalar walk
            vals = []
            for m in range(n_gt):
                v, _ = bcflib.dec_int1(indiv, base + m * (gt.size // gt.n), gt.type)
                c = (v >> 1) - 1
                vals.append(2 if c < 0 else tr[c])
            codes = np.asarray(vals, dtype=np.uint8)
        ak.has_multi = bool((codes == 3).any())
        ak.gt = codes

    if has_dup:
        atoms = [atoms[i] for i in range(n) if eq[i] == i]
    return atoms


def atomize(h: bcflib.BcfHeader, b: Bcf1, atoms: list[Atom],
            verbose: int = 3) -> list[Atom]:
    """Append the record's atoms to ``atoms`` and normalize (bcf_atomize)."""
    for a in atoms:
        a.from_new = False

    d = b.unpack()
    cid = h.id2int(BCF_DT_ID, "CIGAR")
    cigars = None
    if cid >= 0:
        for z in d.info:
            if z.key == cid and z.type == BCF_BT_CHAR:
                cigars = z.raw.decode("latin-1").split(",")
                break
    ref = d.alleles[0]
    l_ref = len(ref)
    ci = 0
    for i in range(1, b.n_allele):
        alt = d.alleles[i]
        l_alt = len(alt)
        if b.rlen != l_ref or (alt.startswith("<") and alt.endswith(">")):
            atoms.append(Atom(b.rid, b.pos, b.rlen, i, ref, alt))
            continue
        # build or take the CIGAR for this ALT
        if cigars is not None:
            cig = cigars[ci]
            ci += 1
            assert cig, "incomplete CIGAR"
        elif l_alt == b.rlen:
            cig = f"{b.rlen}M"
        else:
            l = l_alt - b.rlen
            if l > 0:
                cig = f"1M{l}I"
                rest = b.rlen - 1
            else:
                cig = f"1M{-l}D"
                rest = l_alt - 1
            if rest:
                cig += f"{rest}M"
        # walk the CIGAR, extracting differences
        x = y = 0
        p = 0
        while p < len(cig):
            q = p
            while q < len(cig) and cig[q].isdigit():
                q += 1
            l = int(cig[p:q])
            op = cig[q] if q < len(cig) else "?"
            if op in "M=X":
                for j in range(l):
                    if ref[x + j] != alt[y + j]:
                        atoms.append(Atom(b.rid, b.pos + x + j, 1, i,
                                          ref[x + j], alt[y + j]))
                x += l
                y += l
            elif op == "I":
                if x == 0 or y == 0:
                    if verbose >= 2:
                        chrom = h.id_name(bcflib.BCF_DT_CTG, b.rid)
                        print(f"[W::bcf_atomize] invalid insertion ({x},{y}) at "
                              f"{chrom}:{b.pos + 1}", file=sys.stderr)
                else:
                    atoms.append(Atom(b.rid, b.pos + x - 1, 1, i,
                                      ref[x - 1], alt[y - 1:y + l]))
                y += l
            elif op == "D":
                assert x > 0 and y > 0
                atoms.append(Atom(b.rid, b.pos + x - 1, l + 1, i,
                                  ref[x - 1:x + l], alt[y - 1]))
                x += l
            p = q + 1
    return _gen_at(h, b, atoms)


# GT byte tables (bcf_atom2bcf2, atomic.c:249-284)
_CONV = np.array([1 << 1, 2 << 1, 0 << 1, 3 << 1], dtype=np.uint8)
_CONV_NO_M = np.array([1 << 1, 2 << 1, 0 << 1, 1 << 1], dtype=np.uint8)
_CONV_NO_M_MISSING = np.array([1 << 1, 2 << 1, 0 << 1, 0 << 1], dtype=np.uint8)


def atom_to_bcf(a: Atom, b: Bcf1, write_m: bool, id_gt: int,
                use_missing: bool = True) -> None:
    """Re-encode an atom as a (site-only or GT-carrying) BCF record."""
    b.rid, b.pos, b.rlen = a.rid, a.pos, a.rlen
    b.qual_bits = 0
    b.n_info = b.n_fmt = b.n_sample = 0
    b.n_allele = 3 if write_m and a.has_multi else 2
    b.shared = bytearray()
    b.indiv = bytearray()
    enc_size(b.shared, 0, BCF_BT_CHAR)  # empty ID
    enc_vchar(b.shared, a.ref.encode("latin-1"))
    enc_vchar(b.shared, a.alt.encode("latin-1"))
    if b.n_allele > 2:
        enc_vchar(b.shared, b"<M>")
    enc_vint(b.shared, [], -1)  # empty FILTER
    b.mark_dirty()
    if id_gt >= 0:
        b.n_fmt = 1
        b.n_sample = len(a.gt) >> 1
        enc_int1(b.indiv, id_gt)
        enc_size(b.indiv, 2, BCF_BT_INT8)
        conv = _CONV if write_m else (_CONV_NO_M_MISSING if use_missing else _CONV_NO_M)
        codes = np.asarray(a.gt, dtype=np.uint8)
        b.indiv += (conv[codes] | np.uint8(a.phased)).tobytes()


class AtomBuffer:
    """Streaming atomizer over a record source (bcf_atombuf_t).

    ``source`` yields Bcf1 records; emits atoms in global sorted order, only
    once the input stream has passed their start position.
    """

    def __init__(self, h: bcflib.BcfHeader, source, keep_filtered: bool = False):
        self.h = h
        self._source = iter(source)
        self.keep_flt = keep_filtered
        self.atoms: list[Atom] = []
        self.start = 0
        self.b: Bcf1 | None = None
        self.no_vcf = False
        b = self._next_rec()
        if b is not None:
            self.atoms = atomize(self.h, b, self.atoms)
            self.b = self._next_rec()
            if self.b is None:
                self.no_vcf = True
        else:
            self.no_vcf = True

    def _next_rec(self):
        for b in self._source:
            if self.keep_flt or not b.is_filtered():
                return b
        return None

    def __iter__(self):
        return self

    def __next__(self) -> Atom:
        a = self.read()
        if a is None:
            raise StopIteration
        return a

    def read(self) -> Atom | None:
        if self.start == len(self.atoms):
            if self.no_vcf:
                return None
            self.atoms = []
            self.start = 0
            self.atoms = atomize(self.h, self.b, self.atoms)
            self.b = self._next_rec()
            if self.b is None:
                self.no_vcf = True
        assert self.start < len(self.atoms)
        while True:
            a0 = self.atoms[self.start]
            if self.no_vcf or a0.rid < self.b.rid or (
                a0.rid == self.b.rid and a0.pos < self.b.pos
            ):
                self.start += 1
                return a0
            if self.start:
                self.atoms = self.atoms[self.start:]
                self.start = 0
            self.atoms = atomize(self.h, self.b, self.atoms)
            self.b = self._next_rec()
            if self.b is None:
                self.no_vcf = True
