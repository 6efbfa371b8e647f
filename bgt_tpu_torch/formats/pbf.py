"""PBF container: positional-BWT-transformed, run-length-encoded bit matrices.

Byte-compatible with the reference PBF format (reference pbwt.c):

- file = ``PBF\\1`` magic + int32 {m, g, shift}; then per row an optional
  ``S`` checkpoint record (the permutation arrays for each of the g bit
  planes, written every ``1<<shift`` rows) followed by a ``B`` record holding,
  per plane, int32 RLE length + RLE bytes; footer ``I`` + int64 n_rows +
  int32 n_idx + uint64 idx[] (offsets of the S records) + trailing uint64
  offset-of-footer (pbwt.c:199-311).
- RLE: one byte per run shorter than 16 (``len<<1|bit``); longer runs emit
  one byte per nonzero nibble of the 32-bit length, high nibble first, each
  byte ``(nibble_pos<<4|nibble)<<1|bit`` (pbwt.c:24-50).
- PBWT transform: row k is permuted by S_{k-1} before RLE; S_k is the stable
  partition of S_{k-1} by the permuted bits (pbwt.c:57-90).

The host codec here is vectorized numpy and serves as the import/export path
and the correctness oracle for the device kernels in :mod:`bgt_tpu_torch.ops`.
"""

from __future__ import annotations

import struct

import numpy as np

MAGIC = b"PBF\x01"


# ---------------------------------------------------------------------------
# Run-length coding (numpy-vectorized)
# ---------------------------------------------------------------------------

def rle_encode(u: np.ndarray) -> bytes:
    """Encode a 0/1 vector as reference RLE bytes (pbr_enc, pbwt.c:39-50)."""
    u = np.asarray(u, dtype=np.uint8)
    m = u.shape[0]
    if m == 0:
        return b""
    # run boundaries
    change = np.nonzero(u[1:] != u[:-1])[0] + 1
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [m]))
    lens = (ends - starts).astype(np.uint32)
    bits = u[starts]
    short = lens < 16
    # short runs: single byte len<<1|bit
    # long runs: one byte per nonzero nibble, high nibble position first
    n_runs = lens.shape[0]
    shifts = np.arange(28, -4, -4, dtype=np.uint32)  # 28,24,...,0
    nib = (lens[:, None] >> shifts[None, :]) & 0xF  # (runs, 8)
    pos = (shifts // 4).astype(np.uint32)  # 7..0
    long_bytes = (((pos[None, :] << 4) | nib) << 1) | bits[:, None].astype(np.uint32)
    keep = (nib != 0) & (~short[:, None])
    # short runs: place the single byte in the last (pos 0) slot for ordering
    short_byte = (lens << 1) | bits
    out = np.zeros((n_runs, 9), dtype=np.uint8)
    outmask = np.zeros((n_runs, 9), dtype=bool)
    out[:, :8] = long_bytes.astype(np.uint8)
    outmask[:, :8] = keep
    out[:, 8] = short_byte.astype(np.uint8)
    outmask[:, 8] = short
    return out[outmask].tobytes()


def rle_decode_runs(rle: bytes) -> tuple[np.ndarray, np.ndarray]:
    """Decode RLE bytes into (lengths, bits) arrays of per-byte runs."""
    v = np.frombuffer(rle, dtype=np.uint8).astype(np.uint32)
    t = v >> 1
    lens = (t & 0xF) << (4 * (t >> 4))
    bits = (v & 1).astype(np.uint8)
    return lens, bits


def rle_expand(rle: bytes, m: int) -> np.ndarray:
    """Expand RLE bytes to the transformed 0/1 vector of length m."""
    lens, bits = rle_decode_runs(rle)
    return np.repeat(bits, lens)[:m]


def rle_count1(rle: bytes) -> int:
    lens, bits = rle_decode_runs(rle)
    return int((lens * bits).sum())


# ---------------------------------------------------------------------------
# PBWT codec
# ---------------------------------------------------------------------------

class PbwtCodec:
    """One bit-plane codec: carries the running permutation S (pbc_t)."""

    def __init__(self, m: int):
        self.m = m
        self.S = np.arange(m, dtype=np.int32)

    def encode(self, a: np.ndarray) -> bytes:
        """Transform + RLE one row given in original column order."""
        S0 = self.S
        u = (np.asarray(a)[S0] != 0).astype(np.uint8)
        self.S = np.concatenate((S0[u == 0], S0[u == 1]))
        return rle_encode(u)

    def decode(self, rle: bytes) -> np.ndarray:
        """Inverse transform one row; returns bits in original column order."""
        m = self.m
        S0 = self.S
        u = rle_expand(rle, m)
        n1 = int(u.sum())
        if n1 == 0 or n1 == m:
            a = np.full(m, 1 if n1 == m else 0, dtype=np.uint8)
            # S unchanged (stable partition of constant bits is identity)
            return a
        a = np.zeros(m, dtype=np.uint8)
        a[S0] = u
        self.S = np.concatenate((S0[u == 0], S0[u == 1]))
        return a

    def set_S(self, S: np.ndarray) -> None:
        self.S = np.asarray(S, dtype=np.int32).copy()


# ---------------------------------------------------------------------------
# File container
# ---------------------------------------------------------------------------

class PbfWriter:
    def __init__(self, path: str, m: int, g: int, shift: int):
        self.fp = open(path, "wb")
        self.m, self.g, self.shift = m, g, shift
        self.codecs = [PbwtCodec(m) for _ in range(g)]
        self.n = 0
        self.idx: list[int] = []
        self.fp.write(MAGIC)
        self.fp.write(struct.pack("<3i", m, g, shift))

    def write_row(self, planes) -> None:
        """planes: sequence of g bit vectors (original column order)."""
        if self.n & ((1 << self.shift) - 1) == 0:
            self.idx.append(self.fp.tell())
            self.fp.write(b"S")
            for c in self.codecs:
                self.fp.write(c.S.astype("<i4").tobytes())
        self.fp.write(b"B")
        for c, a in zip(self.codecs, planes):
            rle = c.encode(a)
            self.fp.write(struct.pack("<i", len(rle)))
            self.fp.write(rle)
        self.n += 1

    def close(self) -> None:
        if self.fp is None:
            return
        off = self.fp.tell()
        self.fp.write(b"I")
        self.fp.write(struct.pack("<q", self.n))
        self.fp.write(struct.pack("<i", len(self.idx)))
        self.fp.write(np.asarray(self.idx, dtype="<u8").tobytes())
        self.fp.write(struct.pack("<Q", off))
        self.fp.close()
        self.fp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PbfReader:
    """Sequential/seekable PBF reader with optional column subsetting.

    Mirrors the reference reader (pbwt.c:221-262, 313-372): full decode keeps
    per-plane permutations; subset decode tracks the S-space ranks of the
    chosen columns and updates them per row without materializing S.
    """

    def __init__(self, path: str):
        self.fp = open(path, "rb")
        if self.fp.read(4) != MAGIC:
            raise ValueError("not a PBF file")
        self.m, self.g, self.shift = struct.unpack("<3i", self.fp.read(12))
        self.codecs = [PbwtCodec(self.m) for _ in range(self.g)]
        self.n = 0
        self.idx = np.zeros(0, dtype=np.uint64)
        self.k = 0  # rows decoded so far (next row index)
        self.sub_list: np.ndarray | None = None  # original column indices
        self._ranks: list[np.ndarray] | None = None  # per-plane S-space ranks
        # footer (tolerate files written to a non-seekable stream, where the
        # reference stores -1 offsets: no random access, sequential still OK)
        try:
            self.fp.seek(-8, 2)
            (off,) = struct.unpack("<Q", self.fp.read(8))
            if off < 1 << 62:
                self.fp.seek(off)
                if self.fp.read(1) == b"I":
                    (self.n,) = struct.unpack("<q", self.fp.read(8))
                    (n_idx,) = struct.unpack("<i", self.fp.read(4))
                    self.idx = np.frombuffer(self.fp.read(8 * n_idx), dtype="<u8")
                    if n_idx and int(self.idx[0]) >= 1 << 62:
                        self.idx = np.zeros(0, dtype=np.uint64)
        except (OSError, ValueError, struct.error):
            pass
        self.fp.seek(16)

    # --- subsetting --------------------------------------------------------

    def subset(self, cols) -> None:
        """Restrict decoding to the given original column indices."""
        cols = np.asarray(cols, dtype=np.int64)
        if cols.size == 0 or cols.size >= self.m:
            self.sub_list = None
            self._ranks = None
            return
        self.sub_list = cols
        self._ranks = [self._fill_ranks(c.S) for c in self.codecs]

    def _fill_ranks(self, S: np.ndarray) -> np.ndarray:
        invS = np.empty(self.m, dtype=np.int64)
        invS[S] = np.arange(self.m)
        return invS[self.sub_list]

    # --- reading -----------------------------------------------------------

    def read_row(self) -> list[np.ndarray] | None:
        """Decode the next row; returns g arrays (full m or n_sub wide)."""
        t = self.fp.read(1)
        if t == b"S":
            for gi in range(self.g):
                S = np.frombuffer(self.fp.read(4 * self.m), dtype="<i4")
                self.codecs[gi].set_S(S)
                if self._ranks is not None:
                    self._ranks[gi] = self._fill_ranks(S)
            t = self.fp.read(1)
        if t != b"B":
            return None
        out = []
        for gi in range(self.g):
            (l,) = struct.unpack("<i", self.fp.read(4))
            rle = self.fp.read(l)
            if self._ranks is not None:
                out.append(self._subset_decode(gi, rle))
            else:
                out.append(self.codecs[gi].decode(rle))
        self.k += 1
        return out

    def _subset_decode(self, gi: int, rle: bytes) -> np.ndarray:
        """Decode chosen columns only and advance their ranks (pbs_dec)."""
        m = self.m
        u = rle_expand(rle, m)
        n1 = int(u.sum())
        ranks = self._ranks[gi]
        if n1 == 0:
            return np.zeros(ranks.shape[0], dtype=np.uint8)
        if n1 == m:
            return np.ones(ranks.shape[0], dtype=np.uint8)
        vals = u[ranks]
        # rank update under the stable partition: zeros keep prefix-0 count,
        # ones go to (m - n1) + prefix-1 count
        ones_excl = np.cumsum(u, dtype=np.int64) - u  # prefix count of 1s
        c1 = ones_excl[ranks]
        c0 = ranks - c1
        self._ranks[gi] = np.where(vals == 0, c0, (m - n1) + c1)
        return vals.astype(np.uint8)

    def seek(self, row: int) -> int:
        """Position so the next read_row() returns row ``row`` (pbf_seek)."""
        if row == self.k:
            return 0
        if row > self.k and row - self.k <= (1 << self.shift):
            while self.k < row:
                if self.read_row() is None:
                    return -1
            return 0
        if self.idx.size == 0 or row >= self.n:
            return -1
        self.fp.seek(int(self.idx[row >> self.shift]))
        t = self.fp.read(1)
        assert t == b"S", "corrupted PBF: expected S record"
        for gi in range(self.g):
            S = np.frombuffer(self.fp.read(4 * self.m), dtype="<i4")
            self.codecs[gi].set_S(S)
            if self._ranks is not None:
                self._ranks[gi] = self._fill_ranks(S)
        self.k = row >> self.shift << self.shift
        for _ in range(row & ((1 << self.shift) - 1)):
            if self.read_row() is None:
                return -1
        return 0

    def close(self) -> None:
        if self.fp is not None:
            self.fp.close()
            self.fp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
