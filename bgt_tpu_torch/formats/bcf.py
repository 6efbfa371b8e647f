"""BCF2 codec and VCF text parse/format, byte-compatible with the reference.

Implements the on-disk BCF2 record layout, the three header dictionaries
(FILTER/INFO/FORMAT ids, contigs, samples), typed-value encoding, and the VCF
text round trip with the reference's exact emission rules (reference vcf.c;
typed-value encoders vcf.h:264-337).  All byte outputs (record `shared` /
`indiv` payloads, header text manipulation, VCF text lines) are replicated
exactly so that databases and query output are interchangeable with the
reference tool.
"""

from __future__ import annotations

import struct
import sys
from dataclasses import dataclass

# header line classes (vcf.h:14-17)
BCF_HL_FLT = 0
BCF_HL_INFO = 1
BCF_HL_FMT = 2
BCF_HL_CTG = 3

# header value types (vcf.h:19-22)
BCF_HT_FLAG = 0
BCF_HT_INT = 1
BCF_HT_REAL = 2
BCF_HT_STR = 3

# variable-length classes (vcf.h:24-28)
BCF_VL_FIXED = 0
BCF_VL_VAR = 1
BCF_VL_A = 2
BCF_VL_G = 3
BCF_VL_R = 4

# dictionary types (vcf.h:42-44)
BCF_DT_ID = 0
BCF_DT_CTG = 1
BCF_DT_SAMPLE = 2

# typed-value wire types (vcf.h:70-75)
BCF_BT_NULL = 0
BCF_BT_INT8 = 1
BCF_BT_INT16 = 2
BCF_BT_INT32 = 3
BCF_BT_FLOAT = 5
BCF_BT_CHAR = 7

BCF_TYPE_SHIFT = [0, 0, 1, 2, 0, 2, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]

INT8_MISSING = -128
INT16_MISSING = -32768
INT32_MISSING = -2147483648
INT8_END = -127
INT16_END = -32767
INT32_END = -2147483647

FLOAT_MISSING_BITS = 0x7F800001
FLOAT_END_BITS = 0x7F800002

# unpack stages (vcf.h:185-191)
BCF_UN_STR = 1
BCF_UN_FLT = 2
BCF_UN_INFO = 4
BCF_UN_SHR = BCF_UN_STR | BCF_UN_FLT | BCF_UN_INFO
BCF_UN_FMT = 8
BCF_UN_ALL = BCF_UN_SHR | BCF_UN_FMT


def fmt_g(x: float) -> str:
    """C printf %g formatting (matches glibc for the doubles we emit)."""
    return "%g" % x


# ---------------------------------------------------------------------------
# Typed-value encoders (byte-exact vs vcf.h:264-337, vcf.c:430-471)
# ---------------------------------------------------------------------------

def enc_size(out: bytearray, size: int, btype: int) -> None:
    if size >= 15:
        out.append(15 << 4 | btype)
        if size >= 128:
            if size >= 32768:
                out.append(1 << 4 | BCF_BT_INT32)
                out += struct.pack("<i", size)
            else:
                out.append(1 << 4 | BCF_BT_INT16)
                out += struct.pack("<h", size)
        else:
            out.append(1 << 4 | BCF_BT_INT8)
            out.append(size & 0xFF)
    else:
        out.append(size << 4 | btype)


def enc_int1(out: bytearray, x: int) -> None:
    if x == INT32_MISSING:
        enc_size(out, 1, BCF_BT_INT8)
        out.append(INT8_MISSING & 0xFF)
    elif -128 < x <= 127:
        enc_size(out, 1, BCF_BT_INT8)
        out.append(x & 0xFF)
    elif -32768 < x <= 32767:
        enc_size(out, 1, BCF_BT_INT16)
        out += struct.pack("<h", x)
    else:
        enc_size(out, 1, BCF_BT_INT32)
        out += struct.pack("<i", x)


def enc_vint(out: bytearray, vals, wsize: int = -1) -> None:
    n = len(vals)
    if n == 0:
        enc_size(out, 0, BCF_BT_NULL)
    elif n == 1:
        enc_int1(out, vals[0])
    else:
        if wsize <= 0:
            wsize = n
        vmax, vmin = -2147483647, 2147483647
        for v in vals:
            if v == INT32_MISSING or v == INT32_END:
                continue
            if v > vmax:
                vmax = v
            if v < vmin:
                vmin = v
        if vmax <= 127 and vmin > INT8_END:
            enc_size(out, wsize, BCF_BT_INT8)
            for v in vals:
                b = INT8_END if v == INT32_END else INT8_MISSING if v == INT32_MISSING else v
                out.append(b & 0xFF)
        elif vmax <= 32767 and vmin > INT16_END:
            enc_size(out, wsize, BCF_BT_INT16)
            for v in vals:
                b = INT16_END if v == INT32_END else INT16_MISSING if v == INT32_MISSING else v
                out += struct.pack("<h", b)
        else:
            enc_size(out, wsize, BCF_BT_INT32)
            for v in vals:
                out += struct.pack("<i", v)


def enc_vchar(out: bytearray, s: bytes) -> None:
    enc_size(out, len(s), BCF_BT_CHAR)
    out += s


def enc_vfloat(out: bytearray, vals) -> None:
    enc_size(out, len(vals), BCF_BT_FLOAT)
    for v in vals:
        out += struct.pack("<f", v)


def dec_int1(buf, off: int, btype: int):
    if btype == BCF_BT_INT8:
        return struct.unpack_from("<b", buf, off)[0], off + 1
    if btype == BCF_BT_INT16:
        return struct.unpack_from("<h", buf, off)[0], off + 2
    return struct.unpack_from("<i", buf, off)[0], off + 4


def dec_typed_int1(buf, off: int):
    return dec_int1(buf, off + 1, buf[off] & 0xF)


def dec_size(buf, off: int):
    """Return (size, new_off, type)."""
    btype = buf[off] & 0xF
    if buf[off] >> 4 != 15:
        return buf[off] >> 4, off + 1, btype
    size, noff = dec_typed_int1(buf, off + 1)
    return size, noff, btype


# ---------------------------------------------------------------------------
# Header
# ---------------------------------------------------------------------------

class IdInfo:
    __slots__ = ("info", "id")

    def __init__(self, info=None, id=-1):
        self.info = info if info is not None else [15, 15, 15]
        self.id = id


class BcfHeader:
    """The three header dictionaries plus the raw header text.

    ``raw`` models the reference's in-memory text buffer (it may contain a
    trailing NUL) and ``l_text`` its length accounting, including the
    reference's append quirk where the counted length stops covering the
    terminating NUL after the first ``append`` (vcf.c:210-231).  Byte output
    of headers is always ``raw[:l_text]``, exactly as the reference writes.
    """

    def __init__(self):
        self.raw = ""
        self.l_text = 0
        self.dicts: list[dict] = [{}, {}, {}]  # name -> IdInfo
        self.ids: list[list] = [[], [], []]  # id -> (name, IdInfo)

    @property
    def text(self) -> str:
        return self.raw.rstrip("\x00")

    # --- parsing -----------------------------------------------------------

    @staticmethod
    def _parse_line2(line: str):
        """Parse a ## header line; mirrors bcf_hdr_parse_line2 (vcf.c:29-106).

        Returns (ret, info, id_str): ret>0 => contig length; ret==0 => id line;
        ret<0 => skipped/error.
        """
        if not (line.startswith("#") and len(line) > 1 and line[1] == "#"):
            return -1, None, None
        p = 2
        eq = line.find("=", p)
        if eq < 0:
            return -2, None, None
        key = line[p:eq]
        if key == "INFO":
            ctype = BCF_HL_INFO
        elif key == "FILTER":
            ctype = BCF_HL_FLT
        elif key == "FORMAT":
            ctype = BCF_HL_FMT
        elif key == "contig":
            ctype = BCF_HL_CTG
        else:
            return -3, None, None
        lt = line.find("<", eq)
        if lt < 0:
            return -3, None, None
        p = lt + 1
        vid = None
        vtype = -1
        num = -1
        var = -1
        ctg_len = -1
        n = len(line)
        while p < n and line[p] != ">":
            q = line.find("=", p)
            if q < 0:
                break
            which = 0
            attr = line[p:q]
            if attr == "ID":
                which = 1
            elif attr == "Type":
                which = 2
            elif attr == "Number":
                which = 3
            elif attr == "length":
                which = 4
            val_start = q + 1
            if val_start < n and line[val_start] == '"':
                q = val_start + 1
                while q < n and line[q] != '"':
                    if line[q] == "\\" and q + 1 < n:
                        q += 1
                    q += 1
                if q >= n or line[q] != '"':
                    return -4, None, None
                p = q + 1
                if p < n and line[p] == ",":
                    p += 1
                continue
            q = val_start
            while q < n and line[q] not in ",>":
                q += 1
            val = line[val_start:q]
            if which == 1:
                vid = val
            elif which == 2:
                vtype = {"Integer": BCF_HT_INT, "Float": BCF_HT_REAL,
                         "String": BCF_HT_STR, "Flag": BCF_HT_FLAG}.get(val, -1)
            elif which == 3:
                if val[:1] == "A":
                    var = BCF_VL_A
                elif val[:1] == "G":
                    var = BCF_VL_G
                elif val[:1] == "R":
                    var = BCF_VL_R
                elif val[:1].isdigit():
                    var = BCF_VL_FIXED
                    num = int(val)
                else:
                    var = BCF_VL_VAR
                if var != BCF_VL_FIXED:
                    num = 0xFFFFF
            elif which == 4:
                if val[:1].isdigit():
                    ctg_len = int(val)
            p = q + 1
        if ctype == BCF_HL_CTG:
            return (ctg_len, None, vid) if ctg_len > 0 else (-5, None, None)
        if ctype == BCF_HL_FLT:
            num = 0
        if vtype == BCF_HT_FLAG:
            num, var = 0, BCF_VL_FIXED
        if num == 0:
            vtype, var = BCF_HT_FLAG, BCF_VL_FIXED
        if vid is None or vtype < 0 or num < 0 or var < 0:
            return -5, None, None
        info = (num & 0xFFFFF) << 12 | var << 8 | vtype << 4 | ctype
        return 0, info, vid

    def _parse1(self, line: str) -> int:
        if not line.startswith("#"):
            return -1
        if len(line) > 1 and line[1] == "#":
            ret, info, vid = self._parse_line2(line)
            if ret < 0:
                return -1
            if ret > 0:  # contig line
                d = self.dicts[BCF_DT_CTG]
                if vid not in d:
                    ii = IdInfo()
                    ii.id = len(d)
                    ii.info[0] = ret
                    d[vid] = ii
            else:
                d = self.dicts[BCF_DT_ID]
                ii = d.get(vid)
                if ii is None:
                    ii = IdInfo()
                    ii.id = len(d)
                    d[vid] = ii
                ii.info[info & 0xF] = info
        else:
            # sample line: fields after the 9th column are sample names
            d = self.dicts[BCF_DT_SAMPLE]
            shared_info = [15, 15, 15]  # sample entries never mutate info
            for fldval in line.split("\t")[9:]:
                if fldval not in d:
                    d[fldval] = IdInfo(shared_info, len(d))
        return 0

    def _sync(self) -> None:
        for i in range(3):
            pairs = sorted(self.dicts[i].items(), key=lambda kv: kv[1].id)
            self.ids[i] = [(k, v) for k, v in pairs]

    def parse(self) -> None:
        """Parse raw[:l_text] into the dictionaries (bcf_hdr_parse, vcf.c:193-208).

        Mirrors the reference's scan: a line is processed when terminated by
        a newline or NUL inside the counted region; scanning stops at the
        first NUL; a trailing unterminated segment is never parsed.
        """
        self._parse1('##FILTER=<ID=PASS,Description="All filters passed">')
        raw = self.raw
        limit = min(self.l_text, len(raw))
        # scanning stops at the first NUL inside the counted region
        nul = raw.find("\x00", 0, limit)
        if nul >= 0:
            limit = nul
            terminated = True
        else:
            terminated = False
        p = 0
        while p < limit:
            q = raw.find("\n", p, limit)
            if q < 0:
                # a trailing segment without newline parses only when it is
                # NUL-terminated inside the counted region
                if terminated and limit > p:
                    self._parse1(raw[p:limit])
                break
            if q > p:
                self._parse1(raw[p:q])
            p = q + 1
        self._sync()

    def append(self, line: str) -> int:
        """Insert a ## line just before the #CHROM line (bcf_hdr_append).

        Replicates the reference's buffer arithmetic: the inserted line plus
        its newline displaces raw[i:l_text], and l_text grows by len(line)
        only (vcf.c:210-231) — so the first append moves the NUL out of the
        counted region, and a second append drops the final counted byte.
        """
        line = line.rstrip("\n")
        raw = self.raw
        i = -1
        for j in range(self.l_text - 1, -1, -1):
            if raw[j] == "#" and (j == 0 or raw[j - 1] == "\n"):
                i = j
                break
        if i < 0:
            return -1
        self.raw = raw[:i] + line + "\n" + raw[i:self.l_text]
        self.l_text += len(line)
        self._parse1(line)
        self._sync()
        return 0

    # --- lookups -----------------------------------------------------------

    def id2int(self, which: int, name: str) -> int:
        ii = self.dicts[which].get(name)
        return -1 if ii is None else ii.id

    def name2id(self, name: str) -> int:
        return self.id2int(BCF_DT_CTG, name)

    def n(self, which: int) -> int:
        return len(self.dicts[which])

    def id_name(self, which: int, idx: int) -> str:
        return self.ids[which][idx][0]

    def id_val(self, which: int, idx: int) -> IdInfo:
        return self.ids[which][idx][1]

    @property
    def samples(self) -> list[str]:
        return [k for k, _ in self.ids[BCF_DT_SAMPLE]]

    @property
    def contigs(self) -> list[str]:
        return [k for k, _ in self.ids[BCF_DT_CTG]]

    # --- I/O ---------------------------------------------------------------

    _FROM_TEXT_CACHE: dict = {}

    @classmethod
    def from_text(cls, text: str) -> "BcfHeader":
        """Build from plain content; models kstring buffers: NUL-terminated,
        l_text counts the NUL (the vcf_hdr_read / bcf_hdr_subset convention)."""
        h = cls()
        h.raw = text + "\x00"
        h.l_text = len(text) + 1
        h.parse()
        return h

    @classmethod
    def from_text_cached(cls, text: str) -> "BcfHeader":
        """Memoized ``from_text`` for headers that stay READ-ONLY after
        construction (query output headers resynthesized per query in
        engine.prepare).  Callers must never ``append`` to the result."""
        h = cls._FROM_TEXT_CACHE.get(text)
        if h is None:
            h = cls.from_text(text)
            if len(cls._FROM_TEXT_CACHE) >= 64:
                cls._FROM_TEXT_CACHE.pop(next(iter(cls._FROM_TEXT_CACHE)))
            cls._FROM_TEXT_CACHE[text] = h
        return h

    @classmethod
    def read_bcf(cls, fp) -> "BcfHeader":
        magic = fp.read(5)
        if magic != b"BCF\x02\x02":
            raise ValueError("invalid BCF2 magic")
        (l_text,) = struct.unpack("<i", fp.read(4))
        h = cls()
        h.raw = fp.read(l_text).decode("latin-1")
        h.l_text = l_text
        h.parse()
        return h

    def write_bcf(self, fp) -> None:
        fp.write(b"BCF\x02\x02")
        data = self.raw[: self.l_text].encode("latin-1")
        fp.write(struct.pack("<i", len(data)))
        fp.write(data)

    def vcf_text(self) -> str:
        """Header text for VCF output (vcf_hdr_write, vcf.c:415-424)."""
        l = self.l_text
        while l and (l > len(self.raw) or self.raw[l - 1] == "\x00"):
            l -= 1
        if l and self.raw[l - 1] == "\n":
            l -= 1
        return self.raw[:l] + "\n"

    def subset(self, sample_names: list[str] | None = None) -> "BcfHeader":
        """Site-only (or sample-subset) header (bcf_hdr_subset, vcf.c:1044-1072)."""
        n = len(sample_names) if sample_names else 0
        if self.n(BCF_DT_SAMPLE) > 0:
            text0 = self.text
            pos = text0.find("#CHROM\t")
            while pos > 0 and text0[pos - 1] != "\n":
                pos = text0.find("#CHROM\t", pos + 1)
            if pos < 0:
                raise ValueError("no #CHROM line")
            end = 8 if n else 7
            p = pos
            i = 0
            while True:
                p = text0.find("\t", p)
                if p < 0 or i >= end:
                    break
                i += 1
                p += 1
            if i != end:
                raise ValueError("malformed header")
            text = text0[:p]
            if sample_names:
                for s in sample_names:
                    if self.id2int(BCF_DT_SAMPLE, s) >= 0:
                        text += "\t" + s
        else:
            text = self.raw[: self.l_text]
            return BcfHeader._from_raw(text, self.l_text)
        return BcfHeader.from_text(text)

    @classmethod
    def _from_raw(cls, raw: str, l_text: int) -> "BcfHeader":
        h = cls()
        h.raw = raw
        h.l_text = l_text
        h.parse()
        return h


# ---------------------------------------------------------------------------
# Record
# ---------------------------------------------------------------------------

class Bcf1:
    __slots__ = ("rid", "pos", "rlen", "qual_bits", "n_allele", "n_info",
                 "n_fmt", "n_sample", "shared", "indiv", "_d", "_unpacked")

    def __init__(self):
        self.rid = 0
        self.pos = 0
        self.rlen = 0
        self.qual_bits = 0  # float32 bit pattern
        self.n_allele = 0
        self.n_info = 0
        self.n_fmt = 0
        self.n_sample = 0
        self.shared = bytearray()
        self.indiv = bytearray()
        self._d = None
        self._unpacked = 0

    # --- qual helpers ------------------------------------------------------

    @property
    def qual(self) -> float:
        return struct.unpack("<f", struct.pack("<I", self.qual_bits))[0]

    @qual.setter
    def qual(self, v: float) -> None:
        self.qual_bits = struct.unpack("<I", struct.pack("<f", v))[0]

    @property
    def qual_missing(self) -> bool:
        return self.qual_bits == FLOAT_MISSING_BITS

    def set_qual_missing(self) -> None:
        self.qual_bits = FLOAT_MISSING_BITS

    def clear(self) -> None:
        self.rid = self.pos = self.rlen = 0
        self.qual_bits = 0
        self.n_allele = self.n_info = self.n_fmt = self.n_sample = 0
        self.shared = bytearray()
        self.indiv = bytearray()
        self.mark_dirty()

    def mark_dirty(self) -> None:
        self._d = None
        self._unpacked = 0

    def copy(self) -> "Bcf1":
        b = Bcf1()
        b.copy_from(self)
        return b

    def copy_from(self, src: "Bcf1") -> None:
        self.rid, self.pos, self.rlen = src.rid, src.pos, src.rlen
        self.qual_bits = src.qual_bits
        self.n_allele, self.n_info = src.n_allele, src.n_info
        self.n_fmt, self.n_sample = src.n_fmt, src.n_sample
        self.shared = bytearray(src.shared)
        self.indiv = bytearray(src.indiv)
        self.mark_dirty()

    # --- binary I/O (bcf_read1/bcf_write1, vcf.c:316-360) ------------------

    def read(self, fp) -> int:
        hdr = fp.read(32)
        if len(hdr) != 32:
            return -1 if len(hdr) == 0 else -2
        x = struct.unpack("<8I", hdr)
        l_shared = x[0] - 24
        l_indiv = x[1]
        self.rid = struct.unpack("<i", hdr[8:12])[0]
        self.pos = struct.unpack("<i", hdr[12:16])[0]
        self.rlen = struct.unpack("<i", hdr[16:20])[0]
        self.qual_bits = x[5]
        self.n_allele = x[6] >> 16
        self.n_info = x[6] & 0xFFFF
        self.n_fmt = x[7] >> 24
        self.n_sample = x[7] & 0xFFFFFF
        self.shared = bytearray(fp.read(l_shared))
        self.indiv = bytearray(fp.read(l_indiv))
        self.mark_dirty()
        return 0

    def write(self, fp) -> None:
        x = struct.pack(
            "<II", len(self.shared) + 24, len(self.indiv)
        ) + struct.pack("<iii", self.rid, self.pos, self.rlen) + struct.pack(
            "<I", self.qual_bits
        ) + struct.pack(
            "<II",
            (self.n_allele << 16 | (self.n_info & 0xFFFF)) & 0xFFFFFFFF,
            (self.n_fmt << 24 | (self.n_sample & 0xFFFFFF)) & 0xFFFFFFFF,
        )
        fp.write(x)
        fp.write(bytes(self.shared))
        fp.write(bytes(self.indiv))

    # --- lazy unpack (bcf_unpack, vcf.c:844-893) ---------------------------

    def unpack(self):
        if self._d is not None:
            return self._d
        d = _BcfDec()
        buf = self.shared
        off = 0

        def sized_str(off):
            # bcf_fmt_sized_array semantics: CHAR bytes up to the first NUL,
            # "." when empty (vcf.c:484-517)
            sz, noff, t = dec_size(buf, off)
            raw = bytes(buf[noff: noff + sz])
            noff += sz << BCF_TYPE_SHIFT[t]
            s = raw.split(b"\x00", 1)[0].decode("latin-1")
            return (s if s else "."), noff

        # ID
        d.id, off = sized_str(off)
        # alleles
        d.alleles = []
        for _ in range(self.n_allele):
            s, off = sized_str(off)
            d.alleles.append(s)
        # FILTER
        if buf[off] >> 4:
            sz, off, t = dec_size(buf, off)
            d.flt = []
            for _ in range(sz):
                v, off = dec_int1(buf, off, t)
                d.flt.append(v)
        else:
            off += 1
            d.flt = []
        # INFO
        d.info = []
        for _ in range(self.n_info):
            key, off = dec_typed_int1(buf, off)
            sz, off, t = dec_size(buf, off)
            nbytes = sz << BCF_TYPE_SHIFT[t]
            raw = bytes(buf[off: off + nbytes])
            off += nbytes
            v1 = 0
            if sz == 1:
                if t in (BCF_BT_INT8, BCF_BT_CHAR):
                    v1 = struct.unpack("<b", raw)[0]
                elif t == BCF_BT_INT16:
                    v1 = struct.unpack("<h", raw)[0]
                elif t == BCF_BT_INT32:
                    v1 = struct.unpack("<i", raw)[0]
                elif t == BCF_BT_FLOAT:
                    v1 = struct.unpack("<f", raw)[0]
            d.info.append(_BcfInfo(key, t, sz, v1, raw))
        self._d = d
        return d

    def unpack_fmt(self):
        """Unpack FORMAT descriptors from indiv (bcf_unpack_fmt_core)."""
        fmts = []
        buf = self.indiv
        off = 0
        for _ in range(self.n_fmt):
            fid, off = dec_typed_int1(buf, off)
            sz, off, t = dec_size(buf, off)
            size = sz << BCF_TYPE_SHIFT[t]
            fmts.append(_BcfFmt(fid, sz, t, size, off))
            off += self.n_sample * size
        return fmts

    # --- info helpers ------------------------------------------------------

    def get_info_int(self, hdr: BcfHeader, key: str):
        kid = hdr.id2int(BCF_DT_ID, key)
        if kid < 0:
            return None
        for z in self.unpack().info:
            if z.key == kid:
                return z.v1
        return None

    def append_info_ints(self, hdr: BcfHeader, key: str, vals) -> int:
        kid = hdr.id2int(BCF_DT_ID, key)
        if kid < 0:
            return -1
        self.n_info += 1
        enc_int1(self.shared, kid)
        enc_vint(self.shared, vals, -1)
        self._d = None
        return 0

    def get_ref_alt1(self):
        """(ref, alt1) without full unpack (bcf_get_ref_alt1, vcf.c:1129-1142)."""
        buf = self.shared
        sz, off, t = dec_size(buf, 0)
        off += sz << BCF_TYPE_SHIFT[t]
        sz, off, t = dec_size(buf, off)
        ref = bytes(buf[off: off + sz])
        off += sz << BCF_TYPE_SHIFT[t]
        sz, off, t = dec_size(buf, off)
        alt = bytes(buf[off: off + sz])
        return ref, alt

    def is_filtered(self) -> bool:
        d = self.unpack()
        if len(d.flt) == 0:
            return False
        if len(d.flt) == 1 and d.flt[0] == 0:
            return False
        return True


@dataclass
class _BcfInfo:
    key: int
    type: int
    len: int
    v1: object
    raw: bytes


@dataclass
class _BcfFmt:
    id: int
    n: int
    type: int
    size: int
    off: int


class _BcfDec:
    __slots__ = ("id", "alleles", "flt", "info")

    def __init__(self):
        self.id = ""
        self.alleles = []
        self.flt = []
        self.info = []


def bcfcmp(a: Bcf1, b: Bcf1) -> int:
    """Record ordering used by the k-way merge (vcf.c:1152-1164)."""
    if a.rid != b.rid:
        return a.rid - b.rid
    if a.pos != b.pos:
        return a.pos - b.pos
    if a.rlen != b.rlen:
        return a.rlen - b.rlen
    _, alt_a = a.get_ref_alt1()
    _, alt_b = b.get_ref_alt1()
    la, lb = len(alt_a), len(alt_b)
    m = min(la, lb)
    if alt_a[:m] != alt_b[:m]:
        return -1 if alt_a[:m] < alt_b[:m] else 1
    return la - lb


def bcfcpy_min(b: Bcf1, b0: Bcf1, alt2: str | None) -> int:
    """Minimal site copy: ID/REF/ALT[+<M>]/FILTER only (vcf.c:1166-1182)."""
    ref, alt = b0.get_ref_alt1()
    b.rid, b.pos, b.rlen = b0.rid, b0.pos, b0.rlen
    b.qual_bits = 0
    b.n_info = b.n_fmt = b.n_sample = 0
    b.n_allele = 3 if alt2 else 2
    b.shared = bytearray()
    b.indiv = bytearray()
    enc_size(b.shared, 0, BCF_BT_CHAR)
    enc_vchar(b.shared, ref)
    enc_vchar(b.shared, alt)
    if alt2:
        enc_vchar(b.shared, alt2.encode("latin-1"))
    enc_vint(b.shared, [], -1)
    b.mark_dirty()
    return len(ref)


# ---------------------------------------------------------------------------
# VCF text parsing (vcf_parse1, vcf.c:539-797)
# ---------------------------------------------------------------------------

def vcf_parse1(line: str, h: BcfHeader, v: Bcf1, verbose: int = 3) -> int:
    v.shared = bytearray()
    v.indiv = bytearray()
    v.n_fmt = 0
    v.n_info = 0
    v.n_sample = 0
    v.mark_dirty()
    # keep the (usually huge) sample section as one unsplit string
    fields = line.rstrip("\n").split("\t", 9)
    out = v.shared
    # CHROM
    rid = h.id2int(BCF_DT_CTG, fields[0])
    if rid < 0:
        if verbose >= 2:
            print(f"[W::vcf_parse1] can't find '{fields[0]}' in the sequence dictionary",
                  file=sys.stderr)
        return 0
    v.rid = rid
    # POS
    v.pos = int(fields[1]) - 1
    # ID
    if fields[2] != ".":
        enc_vchar(out, fields[2].encode("latin-1"))
    else:
        enc_size(out, 0, BCF_BT_CHAR)
    # REF
    ref = fields[3]
    enc_vchar(out, ref.encode("latin-1"))
    v.n_allele = 1
    v.rlen = len(ref)
    # ALT
    if fields[4] != ".":
        for alt in fields[4].split(","):
            enc_vchar(out, alt.encode("latin-1"))
            v.n_allele += 1
    # QUAL
    if fields[5] != ".":
        v.qual = float(fields[5])
    else:
        v.qual_bits = FLOAT_MISSING_BITS
    # FILTER
    if fields[6] != ".":
        flts = []
        ftxt = fields[6]
        if ftxt.endswith(";"):
            ftxt = ftxt[:-1]
        for t in ftxt.split(";"):
            fid = h.id2int(BCF_DT_ID, t)
            if fid < 0:
                if verbose >= 2:
                    print(f"[W::vcf_parse1] undefined FILTER '{t}'", file=sys.stderr)
            else:
                flts.append(fid)
        enc_vint(out, flts, -1)
    else:
        enc_vint(out, [], -1)
    # INFO
    if len(fields) > 7 and fields[7] != ".":
        itxt = fields[7]
        if itxt.endswith(";"):
            itxt = itxt[:-1]
        for item in itxt.split(";"):
            if "=" in item:
                key, val = item.split("=", 1)
            else:
                key, val = item, None
            ii = h.dicts[BCF_DT_ID].get(key)
            if ii is None or ii.info[BCF_HL_INFO] == 15:
                if verbose >= 2:
                    print(f"[W::vcf_parse1] undefined INFO '{key}'", file=sys.stderr)
                continue
            y = ii.info[BCF_HL_INFO]
            v.n_info += 1
            enc_int1(out, ii.id)
            ht = (y >> 4) & 0xF
            if val is None:
                enc_size(out, 0, BCF_BT_NULL)
            elif ht in (BCF_HT_FLAG, BCF_HT_STR):
                enc_vchar(out, val.encode("latin-1"))
            elif ht == BCF_HT_INT:
                z = [_strtol(x) for x in val.split(",")]
                enc_vint(out, z, -1)
                if key == "END":
                    v.rlen = z[0] - v.pos
            elif ht == BCF_HT_REAL:
                z = [float(x) for x in val.split(",")]
                enc_vfloat(out, z)
    # FORMAT + samples: fast path for the dominant all-diploid single-digit
    # GT-only shape ("a|b" / "a/b" / "." cells), vectorized with numpy
    if len(fields) > 9 and fields[8] == "GT" and v.n_allele <= 10:
        if _parse_gt_fast(fields[9], h, v):
            return 0
    if len(fields) > 9:
        fields = fields[:9] + fields[9].split("\t")
    if len(fields) > 8:
        fmt_keys = fields[8].split(":")
        n_fmt = len(fmt_keys)
        fmt_meta = []
        ok = True
        for t in fmt_keys:
            ii = h.dicts[BCF_DT_ID].get(t)
            if ii is None or ii.info[BCF_HL_FMT] == 15:
                if verbose >= 2:
                    print(f"[W::vcf_parse1] FORMAT '{t}' is not defined in the header",
                          file=sys.stderr)
                ok = False
                break
            fmt_meta.append((ii.id, t == "GT", ii.info[BCF_HL_FMT]))
        if not ok:
            v.n_fmt = 0
            return 0
        v.n_fmt = n_fmt
        samples = fields[9:]
        v.n_sample = len(samples)
        # first pass: compute max arity per fmt
        max_m = [1] * n_fmt
        max_l = [0] * n_fmt
        max_g = [0] * n_fmt
        cells: list[list[str]] = []
        for s in samples:
            parts = s.split(":")
            cells.append(parts)
            for j, cell in enumerate(parts):
                if j >= n_fmt:
                    break
                m = cell.count(",") + 1
                g = cell.count("|") + cell.count("/") + 1
                if max_m[j] < m:
                    max_m[j] = m
                if max_l[j] < len(cell):
                    max_l[j] = len(cell)
                if fmt_meta[j][1] and max_g[j] < g:
                    max_g[j] = g
        # second pass: fill per-fmt arrays
        arrays: list[list] = []
        for j in range(n_fmt):
            _, is_gt, y = fmt_meta[j]
            ht = (y >> 4) & 0xF
            if ht == BCF_HT_STR:
                size = max_g[j] * 4 if is_gt else max_l[j]
            elif ht in (BCF_HT_REAL, BCF_HT_INT):
                size = max_m[j] * 4
            else:
                raise ValueError("Flag in FORMAT")
            arrays.append([size, []])
        for parts in cells:
            for j in range(n_fmt):
                _, is_gt, y = fmt_meta[j]
                ht = (y >> 4) & 0xF
                size, data = arrays[j]
                if j < len(parts):
                    cell = parts[j]
                    if ht == BCF_HT_STR and is_gt:
                        vals = []
                        is_phased = 0
                        k = 0
                        while k <= len(cell):
                            if k < len(cell) and cell[k] == ".":
                                vals.append(is_phased)
                                k += 1
                            else:
                                e = k
                                while e < len(cell) and cell[e] not in "|/":
                                    e += 1
                                vals.append(((int(cell[k:e]) + 1) << 1) | is_phased)
                                k = e
                            if k < len(cell):
                                is_phased = 1 if cell[k] == "|" else 0
                                k += 1
                            else:
                                break
                        while len(vals) < size // 4:
                            vals.append(INT32_END)
                        data.append(vals)
                    elif ht == BCF_HT_STR:
                        raw = cell.encode("latin-1")[:size]
                        raw += b"\x00" * (size - len(raw))
                        data.append(raw)
                    elif ht == BCF_HT_INT:
                        vals = []
                        for x in cell.split(","):
                            vals.append(INT32_MISSING if x == "." else _strtol(x))
                        while len(vals) < size // 4:
                            vals.append(INT32_END)
                        data.append(vals)
                    elif ht == BCF_HT_REAL:
                        vals = []
                        for x in cell.split(","):
                            vals.append(("miss",) if x == "." else float(x))
                        while len(vals) < size // 4:
                            vals.append(("end",))
                        data.append(vals)
                else:  # entire trailing field missing -> end-of-vector fill
                    if ht == BCF_HT_STR and is_gt:
                        data.append([INT32_END] * (size // 4))
                    elif ht == BCF_HT_STR:
                        data.append(b"\x00" * size)
                    elif ht == BCF_HT_INT:
                        data.append([INT32_END] * (size // 4))
                    else:
                        data.append([("end",)] * (size // 4))
        # encode indiv
        out = v.indiv
        if v.n_sample > 0:
            for j in range(n_fmt):
                fid, is_gt, y = fmt_meta[j]
                ht = (y >> 4) & 0xF
                size, data = arrays[j]
                enc_int1(out, fid)
                if ht == BCF_HT_STR and not is_gt:
                    enc_size(out, size, BCF_BT_CHAR)
                    for raw in data:
                        out += raw
                elif ht == BCF_HT_INT or is_gt:
                    flat = [x for vals in data for x in vals]
                    enc_vint(out, flat, size // 4)
                else:
                    enc_size(out, size // 4, BCF_BT_FLOAT)
                    for vals in data:
                        for x in vals:
                            if x == ("miss",):
                                out += struct.pack("<I", FLOAT_MISSING_BITS)
                            elif x == ("end",):
                                out += struct.pack("<I", FLOAT_END_BITS)
                            else:
                                out += struct.pack("<f", x)
    return 0


def _parse_gt_fast(joined: str, h: BcfHeader, v: Bcf1) -> bool:
    """Vectorized GT-only sample parse for uniform 3-char diploid cells.

    ``joined`` is the whole tab-separated sample section.  Returns False
    (leaving v untouched) if the cells are not uniformly "x?y" with
    single-char alleles, in which case the caller falls back to the general
    parser.
    """
    import numpy as np
    ii = h.dicts[BCF_DT_ID].get("GT")
    if ii is None or ii.info[BCF_HL_FMT] == 15:
        return False
    if len(joined) % 4 != 3:
        return False
    from .. import native
    if native.get_lib() is not None:
        packed = native.parse_gt_cells(joined.encode("latin-1"), v.n_allele)
        if packed is None:
            return False
        v.n_fmt = 1
        v.n_sample = packed.size // 2
        out = v.indiv
        enc_int1(out, ii.id)
        enc_size(out, 2, BCF_BT_INT8)
        out += packed.tobytes()
        return True
    n = (len(joined) + 1) // 4
    raw = np.frombuffer((joined + "\t").encode("latin-1"), dtype=np.uint8)
    cells = raw.reshape(n, 4)
    c1, sep, c2, tabs = cells[:, 0], cells[:, 1], cells[:, 2], cells[:, 3]
    if not (tabs == 9).all():
        return False
    d1 = c1 - ord("0")
    d2 = c2 - ord("0")
    m1 = c1 == ord(".")
    m2 = c2 == ord(".")
    ok1 = m1 | (d1 < v.n_allele)
    ok2 = m2 | (d2 < v.n_allele)
    sep_ok = (sep == ord("|")) | (sep == ord("/"))
    if not (ok1.all() and ok2.all() and sep_ok.all()):
        return False
    phased = (sep == ord("|")).astype(np.uint8)
    x1 = np.where(m1, 0, (d1.astype(np.uint8) + 1) << 1)
    x2 = np.where(m2, phased, (((d2.astype(np.uint8) + 1) << 1) | phased))
    packed = np.empty(2 * n, dtype=np.uint8)
    packed[0::2] = x1
    packed[1::2] = x2
    v.n_fmt = 1
    v.n_sample = n
    out = v.indiv
    enc_int1(out, ii.id)
    enc_size(out, 2, BCF_BT_INT8)
    out += packed.tobytes()
    return True


def _strtol(s: str) -> int:
    """C strtol semantics: parse leading integer, 0 on failure."""
    i = 0
    n = len(s)
    if i < n and s[i] in "+-":
        i += 1
    j = i
    while j < n and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    return int(s[:j])


# ---------------------------------------------------------------------------
# VCF text formatting (vcf_format1, vcf.c:895-969)
# ---------------------------------------------------------------------------

def _fmt_array(parts: list, n: int, btype: int, data: bytes) -> None:
    if n == 0:
        parts.append(".")
        return
    j = 0
    if btype == BCF_BT_INT8:
        vals = struct.unpack(f"<{n}b", data[:n])
        for k in range(n):
            if vals[k] == INT8_END:
                break
            if k:
                parts.append(",")
            parts.append("." if vals[k] == INT8_MISSING else str(vals[k]))
            j = k + 1
    elif btype == BCF_BT_CHAR:
        for k in range(n):
            c = data[k]
            if c == 0:
                break
            parts.append(chr(c))
            j = k + 1
    elif btype == BCF_BT_INT32:
        vals = struct.unpack(f"<{n}i", data[: 4 * n])
        for k in range(n):
            if vals[k] == INT32_END:
                break
            if k:
                parts.append(",")
            parts.append("." if vals[k] == INT32_MISSING else str(vals[k]))
            j = k + 1
    elif btype == BCF_BT_FLOAT:
        for k in range(n):
            bits = struct.unpack_from("<I", data, 4 * k)[0]
            if bits == FLOAT_END_BITS:
                break
            if k:
                parts.append(",")
            if bits == FLOAT_MISSING_BITS:
                parts.append(".")
            else:
                parts.append(fmt_g(struct.unpack_from("<f", data, 4 * k)[0]))
            j = k + 1
    elif btype == BCF_BT_INT16:
        vals = struct.unpack(f"<{n}h", data[: 2 * n])
        for k in range(n):
            if vals[k] == INT16_END:
                break
            if k:
                parts.append(",")
            parts.append("." if vals[k] == INT16_MISSING else str(vals[k]))
            j = k + 1
    if n and j == 0:
        parts.append(".")


def vcf_format1(h: BcfHeader, v: Bcf1, gt_lut=None) -> str:
    d = v.unpack()
    parts: list[str] = []
    parts.append(h.id_name(BCF_DT_CTG, v.rid))
    parts.append("\t")
    parts.append(str(v.pos + 1))
    parts.append("\t")
    parts.append(d.id)
    parts.append("\t")
    if v.n_allele > 0:
        parts.append(d.alleles[0])
    else:
        parts.append(".")
    parts.append("\t")
    if v.n_allele > 1:
        parts.append(",".join(d.alleles[1:]))
    else:
        parts.append(".")
    parts.append("\t")
    if v.qual_missing:
        parts.append(".")
    else:
        parts.append(fmt_g(v.qual))
    parts.append("\t")
    if d.flt:
        parts.append(";".join(h.id_name(BCF_DT_ID, f) for f in d.flt))
    else:
        parts.append(".")
    parts.append("\t")
    if v.n_info:
        for i, z in enumerate(d.info):
            if i:
                parts.append(";")
            parts.append(h.id_name(BCF_DT_ID, z.key))
            if z.len <= 0:
                continue
            parts.append("=")
            if z.len == 1:
                if z.type == BCF_BT_FLOAT:
                    parts.append(fmt_g(z.v1))
                elif z.type != BCF_BT_CHAR:
                    parts.append(str(z.v1))
                else:
                    parts.append(chr(z.v1 & 0xFF))
            else:
                _fmt_array(parts, z.len, z.type, z.raw)
    else:
        parts.append(".")
    # FORMAT + samples
    if v.n_sample and v.n_fmt:
        fmts = v.unpack_fmt()
        gt_i = -1
        for i, f in enumerate(fmts):
            parts.append(":" if i else "\t")
            key = h.id_name(BCF_DT_ID, f.id)
            parts.append(key)
            if key == "GT":
                gt_i = i
        buf = v.indiv
        for j in range(v.n_sample):
            parts.append("\t")
            for i, f in enumerate(fmts):
                if i:
                    parts.append(":")
                cell_off = f.off + j * f.size
                if gt_i == i:
                    cell = []
                    for k in range(f.n):
                        x = struct.unpack_from("<b", buf, cell_off + k)[0]
                        if x == INT8_END:
                            break
                        if k:
                            cell.append("|" if x & 1 else "/")
                        cell.append(str((x >> 1) - 1) if x >> 1 else ".")
                    parts.append("".join(cell) if cell else ".")
                else:
                    _fmt_array(parts, f.n, f.type, bytes(buf[cell_off: cell_off + f.size]))
    return "".join(parts)
