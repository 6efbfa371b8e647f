"""A BCF2 writer in NumPy: biallelic SNPs with phased GT, in BGZF blocks.

Each record is 32 fixed bytes (lengths, contig, 0-based position, length 1,
missing QUAL, two alleles, no INFO, one FORMAT key, the sample count), the
shared part (missing ID, the two alleles as one-character strings, FILTER
PASS) and the GT bytes: ``(allele + 1) << 1``, with the phase bit on the
second allele and 0 (or 1 for the second) for a missing call.  The header's
dictionary holds PASS as 0 and GT as 1.  Blocks hold at most 0xff00 bytes,
and the file ends in the 28-byte EOF block.
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BLOCK = 0xFF00
EOF_BLOCK = bytes.fromhex("1f8b08040000000000ff0600424302001b0003000000000000000000")
QUAL_MISSING = 0x7F800001
GT_KEY = 1  # PASS is 0

# GT bytes of a sample's two codes (code0 + 256 * code1, little-endian):
# (allele + 1) << 1, the phase bit on the second, 0 (or 1) for a missing call
_FIRST = np.array([2, 4, 0], np.uint16)
_SECOND = np.array([3, 5, 1], np.uint16)
_PAIR = np.zeros(1 << 16, np.uint16)
for _a in range(3):
    for _b in range(3):
        _PAIR[_a + 256 * _b] = _FIRST[_a] | _SECOND[_b] << 8


def header_text(chrom: str, chrom_len: int, names: list) -> str:
    return ("##fileformat=VCFv4.2\n"
            '##FILTER=<ID=PASS,Description="All filters passed">\n'
            f"##contig=<ID={chrom},length={chrom_len}>\n"
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
            + "\t".join(names) + "\n")


_HEAD = 42  # the fixed fields, the shared part and the FORMAT key


def records(pos: np.ndarray, ref: np.ndarray, alt: np.ndarray,
            codes: np.ndarray) -> bytes:
    """The BCF records of sites ``pos`` (1-based) with ``codes`` (sites,
    haplotypes), contig 0."""
    k, n_hap = codes.shape
    if codes.max(initial=0) > 2:
        raise ValueError("only codes 0, 1 and 2 are written")
    head = np.zeros(_HEAD, np.uint8)
    head[0:32] = np.frombuffer(struct.pack(
        "<IIiiiIII", 24 + 7, 3 + n_hap, 0, 0, 1, QUAL_MISSING, 2 << 16,
        (1 << 24) | (n_hap // 2)), np.uint8)
    # missing ID, REF and ALT as one-character strings, FILTER PASS (one
    # int8), then the GT key and two int8 a sample
    head[32:42] = [0x07, 0x17, 0, 0x17, 0, 0x11, 0, 0x11, GT_KEY, 0x21]
    rec = np.empty((k, _HEAD + n_hap), np.uint8)
    rec[:, :_HEAD] = head
    rec[:, 12:16] = (pos - 1).astype("<i4").view(np.uint8).reshape(k, 4)
    rec[:, 34] = ref
    rec[:, 36] = alt
    rec[:, _HEAD:].view(np.uint16)[:] = _PAIR[codes.view(np.uint16)]
    return rec.tobytes()


def _block(payload: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    body = co.compress(payload) + co.flush()
    head = b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff\x06\x00BC\x02\x00"
    return (head + struct.pack("<H", len(body) + 25) + body
            + struct.pack("<II", zlib.crc32(payload), len(payload)))


def _blocks(data: bytes, level: int) -> bytes:
    return b"".join(_block(data[i:i + BLOCK], level)
                    for i in range(0, len(data), BLOCK))


def write_bcf(path: str, chrom: str, chrom_len: int, names: list,
              pos: np.ndarray, ref: np.ndarray, alt: np.ndarray,
              codes: np.ndarray, chunk_sites: int = 256, threads: int = 8,
              level: int = 1) -> None:
    """The header, then the records of each ``chunk_sites`` sites made and
    deflated by a pool of threads into blocks of their own (a BGZF block
    may end inside a record), written in order."""
    text = header_text(chrom, chrom_len, names).encode() + b"\0"

    def chunk(lo: int) -> bytes:
        hi = lo + chunk_sites
        return _blocks(records(pos[lo:hi], ref[lo:hi], alt[lo:hi], codes[lo:hi]),
                       level)

    with open(path, "wb") as fp, ThreadPoolExecutor(threads) as pool:
        fp.write(_blocks(b"BCF\x02\x02" + struct.pack("<I", len(text)) + text,
                         level))
        for data in pool.map(chunk, range(0, len(pos), chunk_sites)):
            fp.write(data)
        fp.write(EOF_BLOCK)
