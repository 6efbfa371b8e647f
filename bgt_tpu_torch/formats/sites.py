"""Flat memory-mapped site-table sidecar (``P.sites.bin``).

Replaces the ``.sites.npz`` sidecar: at 39.2M sites the npz cost ~8 s of
eager read + copy on first open, while this format memory-maps in O(1) and
a region query faults in only the pages it touches (region selection is
a searchsorted window over rid/pos with an rlen test inside it; the
concatenated allele text materializes lazily as bytes on the first
emitting query — native consumers that accept raw pointers read the mmap
directly).  Allele offsets are precomputed at build so open does no
cumsum pass.

Layout: 44-byte header (magic, version, n, ref_cat_len, alt_cat_len,
max_rlen) + 64-byte-aligned arrays in fixed order:
rid i32[n], pos i64[n], rlen i32[n], n_allele i32[n], ref_len i32[n],
alt_len i32[n], ref_off i64[n], alt_off i64[n], ref_cat u8, alt_cat u8.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"BGTSITE2"  # v2 added max_rlen to the header
_ARRAYS = (  # (name, dtype)
    ("rid", np.int32), ("pos", np.int64), ("rlen", np.int32),
    ("n_allele", np.int32), ("ref_len", np.int32), ("alt_len", np.int32),
    ("ref_off", np.int64), ("alt_off", np.int64),
)


def _align(x: int) -> int:
    return (x + 63) // 64 * 64


def write_sidecar(path: str, rid, pos, rlen, n_allele, ref_len, alt_len,
                  ref_cat, alt_cat) -> None:
    """Write the sidecar; inputs may be any integer dtype (cast on write).
    ``ref_cat``/``alt_cat``: bytes or uint8 arrays."""
    n = int(np.asarray(rid).size)
    ref_cat = np.frombuffer(ref_cat, np.uint8) \
        if isinstance(ref_cat, (bytes, bytearray)) else np.asarray(ref_cat)
    alt_cat = np.frombuffer(alt_cat, np.uint8) \
        if isinstance(alt_cat, (bytes, bytearray)) else np.asarray(alt_cat)
    ref_len64 = np.asarray(ref_len, np.int64)
    alt_len64 = np.asarray(alt_len, np.int64)
    ref_off = np.zeros(n, np.int64)
    alt_off = np.zeros(n, np.int64)
    if n:
        np.cumsum(ref_len64[:-1], out=ref_off[1:])
        np.cumsum(alt_len64[:-1], out=alt_off[1:])
    cols = {"rid": rid, "pos": pos, "rlen": rlen, "n_allele": n_allele,
            "ref_len": ref_len, "alt_len": alt_len,
            "ref_off": ref_off, "alt_off": alt_off}
    max_rlen = int(np.asarray(rlen).max()) if n else 0
    tmp = path + ".tmp"
    with open(tmp, "wb") as fp:
        fp.write(MAGIC)
        fp.write(struct.pack("<Iqqqq", 2, n, ref_cat.size, alt_cat.size,
                             max_rlen))
        off = _align(fp.tell())
        for name, dt in _ARRAYS:
            fp.seek(off)
            a = np.ascontiguousarray(np.asarray(cols[name]).astype(
                dt, copy=False))
            fp.write(a.tobytes())
            off = _align(off + a.nbytes)
        for cat in (ref_cat, alt_cat):
            fp.seek(off)
            fp.write(cat.tobytes())
            off = _align(off + cat.size)
    import os
    os.replace(tmp, path)


def load_sidecar(path: str) -> dict | None:
    """Memory-map the sidecar -> dict of array views (+ 'ref_cat'/'alt_cat'
    uint8 views), or None if the file is missing/not this format."""
    try:
        with open(path, "rb") as fp:
            hdr = fp.read(44)
    except OSError:
        return None
    if len(hdr) < 44 or hdr[:8] != MAGIC:
        return None
    _ver, n, rc_len, ac_len, max_rlen = struct.unpack("<Iqqqq", hdr[8:44])
    out = {"max_rlen": max_rlen}
    off = _align(44)
    for name, dt in _ARRAYS:
        # zero-length arrays: no mmap (mapping past EOF is invalid)
        out[name] = (np.zeros(0, dt) if n == 0 else
                     np.memmap(path, dtype=dt, mode="r", offset=off,
                               shape=(n,)))
        off = _align(off + n * np.dtype(dt).itemsize)
    for name, ln in (("ref_cat", rc_len), ("alt_cat", ac_len)):
        out[name] = (np.zeros(0, np.uint8) if ln == 0 else
                     np.memmap(path, dtype=np.uint8, mode="r", offset=off,
                               shape=(ln,)))
        off = _align(off + ln)
    out["n"] = n
    out["path"] = path
    # byte offsets of the pos/rlen arrays (regions prefault only the
    # searchsorted window of these; rid is probed via O(log n) faults)
    out["pos_base"] = _align(_align(44) + 4 * n)
    out["rlen_base"] = _align(out["pos_base"] + 8 * n)
    return out


def prefault_range(path: str, start: int, end: int,
                   chunk: int = 32 << 20) -> None:
    """Buffered sequential read of bytes [start, end) to warm the cache."""
    buf = bytearray(chunk)
    try:
        with open(path, "rb", buffering=0) as fp:
            fp.seek(start)
            left = end - start
            while left > 0:
                n = fp.readinto(memoryview(buf)[: min(chunk, left)])
                if not n:
                    break
                left -= n
    except OSError:
        pass
