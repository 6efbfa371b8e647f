"""File-level helpers: VCF/BCF record sources and list parsing.

Mirrors the hts-lite conveniences the query language depends on
(reference hts.c:49-143): transparent gzip for text inputs, and
``readlines`` which accepts a file path or an inline ``,a,b``/ ``:a,b``
string and returns the first column of each line.
"""

from __future__ import annotations

import gzip
import io
import os
import re

from ..formats import bcf as bcflib
from .bgzf import BgzfReader

no_file = False  # bgt_no_file: disable file-path interpretation (server mode)


def open_text_auto(fn: str):
    if fn == "-":
        import sys
        return sys.stdin
    f = open(fn, "rb")
    if f.read(2) == b"\x1f\x8b":
        f.close()
        return gzip.open(fn, "rt", encoding="latin-1")
    f.seek(0)
    return io.TextIOWrapper(f, encoding="latin-1")


def contig_header_lines(fn_ref: str) -> list[str]:
    """``-t FILE`` contig list -> ``##contig=<ID=name,length=N>`` header lines.

    Token-stream semantics of the reference (vcf.c:382-401): whitespace-split
    tokens read in pairs (name, length); after the length token the rest of
    its line is skipped; length parsed with atol (leading integer else 0).
    """
    with open_text_auto(fn_ref) as fp:
        text = fp.read()
    i, n = 0, len(text)

    def getuntil():
        nonlocal i
        if i >= n:
            return None
        start = i
        while i < n and not text[i].isspace():
            i += 1
        tok = text[start:i]
        d = text[i] if i < n else ""
        if i < n:
            i += 1
        return tok, d

    out = []
    while True:
        t = getuntil()
        if t is None:
            break
        name, _d = t
        t2 = getuntil()
        length_s, d2 = t2 if t2 is not None else ("", "")
        m = re.match(r"[ \t\n\v\f\r]*[+-]?\d+", length_s)
        length = int(m.group()) if m else 0
        out.append(f"##contig=<ID={name},length={length}>")
        if d2 != "\n":
            while i < n and text[i] != "\n":
                i += 1
            i += 1
    return out


class VcfTextReader:
    """VCF text (optionally gzip) -> header + Bcf1 record stream."""

    def __init__(self, fn: str, fn_ref: str | None = None):
        self.fp = open_text_auto(fn)
        lines = []
        self._pending = None
        for line in self.fp:
            line = line.rstrip("\n")
            if not line:
                continue
            if not line.startswith("#"):
                raise ValueError("no sample line in VCF header")
            if not line.startswith("##") and fn_ref:
                # insert contigs just before the #CHROM line (vcf.c:382)
                lines.extend(contig_header_lines(fn_ref))
            lines.append(line)
            if not line.startswith("##"):
                break
        self.header = bcflib.BcfHeader.from_text("\n".join(lines))

    def __iter__(self):
        return self

    def __next__(self) -> bcflib.Bcf1:
        for line in self.fp:
            line = line.rstrip("\n")
            if not line:
                continue
            b = bcflib.Bcf1()
            bcflib.vcf_parse1(line, self.header, b)
            return b
        raise StopIteration

    def close(self):
        if self.fp is not None and self.fp is not __import__("sys").stdin:
            self.fp.close()
        self.fp = None


class BcfReader:
    """BCF (BGZF) -> header + Bcf1 record stream."""

    def __init__(self, fn: str):
        self.fp = BgzfReader(fn)
        self.header = bcflib.BcfHeader.read_bcf(self.fp)

    def __iter__(self):
        return self

    def __next__(self) -> bcflib.Bcf1:
        b = bcflib.Bcf1()
        if b.read(self.fp) < 0:
            raise StopIteration
        return b

    def close(self):
        self.fp.close()


def open_vcf(fn: str, is_vcf: bool | None = None, fn_ref: str | None = None):
    """Open a VCF/BCF by sniffing unless ``is_vcf`` is forced."""
    if is_vcf is None:
        with open(fn, "rb") as f:
            magic = f.read(4)
        if magic[:2] == b"\x1f\x8b":
            with BgzfReader(fn) as bg:
                is_vcf = bg.read(3) != b"BCF"
        else:
            is_vcf = True
    return VcfTextReader(fn, fn_ref) if is_vcf else BcfReader(fn)


def is_file(fn: str) -> bool:
    if no_file:
        return False
    return os.path.isfile(fn)


def readlines(expr: str) -> list[str] | None:
    """hts_readlines: file (first column per line) or inline ,a,b / :a,b."""
    if not no_file and os.path.isfile(expr):
        out = []
        with open_text_auto(expr) as fp:
            for line in fp:
                line = line.rstrip("\n")
                if not line:
                    continue
                out.append(line.split("\t", 1)[0])
        return out
    if expr[:1] in (":", ","):
        return expr[1:].split(",")
    return None
