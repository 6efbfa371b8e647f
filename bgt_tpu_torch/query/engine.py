"""BGT query engine: single-database reader and multi-database merge.

Host-side twin of the reference query layer (reference bgt.c): database
handles (.bcf header + CSI/RNI + .spl FMF + per-sample MGS), sample-group
selection by name list or metadata expression, region/BED/allele-set site
selection, the k-way multi-database merge keyed on (rid,pos,rlen,alt), AC/AN
aggregation overall and per group, site filters, tabular output, haplotype
and carrier counting, and MGS privacy enforcement.

The genotype decode and counting path is vectorized (numpy here; the batched
device path lives in :mod:`bgt_tpu_torch.ops` and :mod:`bgt_tpu_torch.query.view`), but
all outputs are byte-compatible with the reference CLI.
"""

from __future__ import annotations

import numpy as np

from ..core import kexpr
from ..formats import bcf as bcflib
from ..formats.bcf import BCF_DT_CTG, BCF_DT_ID, Bcf1, bcfcmp, bcfcpy_min
from ..formats.csi import HtsIndex, parse_reg
from ..formats.fmf import FMF_INT, Fmf, FmfStream
from ..formats.pbf import PbfReader
from ..io import files
from ..io.bgzf import BgzfReader
from ..log import stage

# flags (bgt.h:8-11)
F_SET_AC = 0x0001
F_NO_GT = 0x0002
F_CNT_AL = 0x0004
F_CNT_HAP = 0x0008

MAX_GROUPS = 32
MAX_ALLELES = 64

BITS2GT = np.array([2, 4, 0, 6], dtype=np.uint8)  # bgt_bits2gt (bgt.c:250)


class BgtFile:
    """Shared read-only database handle (bgt_file_t, bgt.c:40-70)."""

    def __init__(self, prefix: str):
        with stage("db.open", always=True, db=prefix):
            self.prefix = prefix
            fp = BgzfReader(prefix + ".bcf")
            self.h0 = bcflib.BcfHeader.read_bcf(fp)
            fp.close()
            self.idx = HtsIndex.load(prefix + ".bcf.csi")
            self.f = Fmf.read(prefix + ".spl")
            self.mgs = np.full(self.f.n_rows, -1, dtype=np.int32)
            if "_mgs" in self.f._key_id:
                kid = self.f._key_id["_mgs"]
                for i, (_name, metas) in enumerate(self.f.rows):
                    for mk, t, v in metas:
                        if mk == kid and t == FMF_INT and v >= 0:
                            self.mgs[i] = v

    @property
    def n_samples(self) -> int:
        return self.f.n_rows


_HANDLE_CACHE: dict = {}
# the server is a ThreadingHTTPServer: refresh/evict on the shared handle
# cache must not race another request thread's eviction of the same key
_HANDLE_LOCK = __import__("threading").RLock()


def open_bgt_cached(prefix: str) -> BgtFile:
    """Shared read-only BgtFile handles, keyed on path+mtimes.

    Mirrors the reference server's process-wide bgt_file_t sharing
    (bgt-server.go:147-153): headers, CSI index, and .spl FMF are immutable
    per database version, so repeated queries skip the reopen/reparse.
    Handles open under the absolute path so they survive cwd changes.
    """
    import os
    path = os.path.abspath(prefix)

    def mt(p):
        try:
            return os.path.getmtime(p)
        except OSError:
            return 0

    key = (path, mt(path + ".bcf"), mt(path + ".spl"), mt(path + ".bcf.csi"))
    with _HANDLE_LOCK:
        bf = _HANDLE_CACHE.get(key)
        if bf is not None:
            _HANDLE_CACHE[key] = _HANDLE_CACHE.pop(key)
            return bf
    # build outside the lock (parsing a big .spl can take a while); a racing
    # duplicate build is harmless — last one in wins, the loser is collected
    bf = BgtFile(path)
    with _HANDLE_LOCK:
        _HANDLE_CACHE[key] = bf
        # LRU bound: a long-lived process over many databases must not
        # accumulate handles without limit (BgtFile holds no open fds, so
        # dropping the reference is a complete release)
        while len(_HANDLE_CACHE) > 64:
            _HANDLE_CACHE.pop(next(iter(_HANDLE_CACHE)))
    return bf


class _Iter:
    """Region iterator state over CSI chunks (hts_itr_t, hts.c:868-900)."""

    def __init__(self, tid, beg, end, chunks, read_rest=False, curr_off=0):
        self.tid, self.beg, self.end = tid, beg, end
        self.chunks = chunks or []
        self.i = -1
        self.curr_off = curr_off
        self.read_rest = read_rest
        self.finished = False


class BgtReader:
    """Cursor over one database (bgt_t, bgt.c:89-356)."""

    def __init__(self, bf: BgtFile):
        self.f = bf
        self.pb = PbfReader(bf.prefix + ".pbf")
        self.bcf = BgzfReader(bf.prefix + ".bcf")
        bcflib.BcfHeader.read_bcf(self.bcf)  # skip header
        self.b0 = Bcf1()
        self._b0_unread = True
        self.itr: _Iter | None = None
        self.bed = None
        self.bed_excl = False
        self.n_out = 0
        self.n_groups = 0
        self.group_path: str | None = None  # the last group's (add_group_core)
        self.mgs_def = 0
        self.out: np.ndarray | None = None
        self.group: np.ndarray | None = None
        self.gtag = np.zeros(bf.f.n_rows, dtype=np.uint32)
        self.h_out: bcflib.BcfHeader | None = None
        self.h_al: set | None = None
        self._ts: object = False  # packed tile store, opened lazily
        self._sub_cols: np.ndarray | None = None
        self._sub_words: np.ndarray | None = None
        self._sub_shift: np.ndarray | None = None
        self._pb_subset = False
        self._seekn(0)

    def close(self):
        self.pb.close()
        self.bcf.close()

    # --- selection ---------------------------------------------------------

    def _seekn(self, n: int) -> int:
        hit = self.f.idx.seekn_voffset(n)
        if hit is None:
            return -1
        voff, skip = hit
        self.bcf.seek(voff)
        b = Bcf1()
        ret = 0
        while skip > 0 and ret >= 0:
            ret = b.read(self.bcf)
            skip -= 1
        return ret

    def set_start(self, n: int) -> int:
        return self._seekn(n)

    def set_region(self, reg: str) -> int:
        name, beg, end = parse_reg(reg)
        tid = self.f.h0.name2id(name)
        if tid < 0:
            tid = self.f.h0.name2id(reg)
            if tid < 0:
                return -1
            beg, end = 0, 1 << 29
        chunks = self.f.idx.query_chunks(tid, beg, end)
        if chunks is None:
            return -1
        self.itr = _Iter(tid, beg, end, chunks)
        self._b0_unread = True
        return 0

    def set_bed(self, bed, excl: bool) -> None:
        self.bed = bed
        self.bed_excl = excl

    def add_group_core(self, names: list[str] | None, expr: str | None) -> int:
        f = self.f.f
        if names is None and expr is None:  # ALL samples
            self.gtag[:] = 1
            self.n_groups = 1
            return f.n_rows
        add = np.zeros(f.n_rows, dtype=bool)
        self.group_path = None
        if expr is not None:
            ke, err = kexpr.parse(expr)
            if err or ke is None:
                return -1
            add, self.group_path = f.test_all(ke)
        if names:
            mgs = np.where(self.f.mgs >= 0, self.f.mgs, self.mgs_def)
            add = add | (f.name_rows(names) & ((mgs == 0) | (mgs == 1)))
        self.gtag[add] = self.n_groups + 1
        self.n_groups += 1
        return int(np.count_nonzero(add))

    def add_group(self, expr: str) -> int:
        if expr[:1] in (":", ",") or (expr[:1] != "?" and files.is_file(expr)):
            names = files.readlines(expr)
            return self.add_group_core(names, None)
        return self.add_group_core(None, expr)

    # --- prepare -----------------------------------------------------------

    def prepare(self) -> None:
        f = self.f.f
        if self.n_groups == 0:
            self.add_group_core(None, None)
        sel = np.nonzero(self.gtag > 0)[0]
        self.n_out = sel.size
        self.out = sel.astype(np.int64)
        self.group = self.gtag[sel].astype(np.uint32)
        # per-reader output header (bgt_prepare, bgt.c:222-236) — memoized
        # per (database handle, selection): building the 30k-name header
        # text costs ~14 ms at HRC width, which dominated warm -S/-H runs
        hkey = self.out.tobytes()
        hcache = getattr(self.f, "_hout_cache", None)
        if hcache is None:
            hcache = self.f._hout_cache = {}
        h_out = hcache.get(hkey)
        if h_out is None:
            raw = self.f.h0.raw[: self.f.h0.l_text]
            if raw and raw[-1] == "\x00":
                raw = raw[:-1]
            if self.n_out > 0:
                raw = "".join([raw, "\tFORMAT"]
                              + ["\t" + f.row_name(int(i)) for i in self.out])
            h_out = bcflib.BcfHeader.from_text_cached(raw)
            if len(hcache) < 8:
                hcache[hkey] = h_out
        self.h_out = h_out
        cols = np.empty(self.n_out * 2, dtype=np.int64)
        cols[0::2] = self.out * 2
        cols[1::2] = self.out * 2 + 1
        self._sub_cols = cols
        self._sub_words = None   # re-derived on next read
        self._pb_subset = False  # PbfReader subset applied lazily (fallback)
        self._b0_unread = True

    # --- reading -----------------------------------------------------------

    def _read_site0(self) -> int:
        """Next site record honoring the region iterator; returns _row or <0."""
        if self.itr is not None:
            it = self.itr
            if it.finished:
                return -1
            while True:
                if it.curr_off == 0 or (it.i >= 0 and it.curr_off >= it.chunks[it.i][1]):
                    if it.i == len(it.chunks) - 1:
                        it.finished = True
                        return -1
                    if it.i < 0 or it.chunks[it.i][1] != it.chunks[it.i + 1][0]:
                        self.bcf.seek(it.chunks[it.i + 1][0])
                        it.curr_off = self.bcf.tell()
                    it.i += 1
                if not it.chunks:
                    it.finished = True
                    return -1
                if self.b0.read(self.bcf) < 0:
                    it.finished = True
                    return -1
                it.curr_off = self.bcf.tell()
                beg, end = self.b0.pos, self.b0.pos + self.b0.rlen
                if self.b0.rid != it.tid or beg >= it.end:
                    it.finished = True
                    return -1
                if end > it.beg and it.end > beg:
                    break
        else:
            if self.b0.read(self.bcf) < 0:
                return -1
        assert self.b0.n_sample == 0
        row = self.b0.get_info_int(self.f.h0, "_row")
        assert row is not None and row >= 0
        return row

    def _read_site(self) -> int:
        """_read_site0 plus BED / allele-set prefilters (bgt_read_core)."""
        if self.bed is None and self.h_al is None:
            return self._read_site0()
        while True:
            row = self._read_site0()
            if row < 0:
                return row
            if self.bed is not None:
                chrom = self.h_out.id_name(BCF_DT_CTG, self.b0.rid)
                r = self.bed.overlap(chrom, self.b0.pos, self.b0.pos + self.b0.rlen)
                if self.bed_excl and r:
                    continue
                if not self.bed_excl and not r:
                    continue
            if self.h_al is not None and not al_present(self.h_al, self.h_out, self.b0):
                continue
            return row

    def read_rec(self):
        """(b0, a0, a1) for the next passing site, or None (bgt_read_rec).

        Genotypes come from the packed tile store when available (random
        row access at memory speed) instead of the sequential PBWT
        decode+seek; the bytes are identical (tests pin both paths).
        """
        if self.n_out == 0:
            return None
        row = self._read_site()
        if row < 0:
            return None
        ts = self._tiles()
        if ts is not None:
            # direct bit gather of just the subset columns (no full-row
            # unpack): word = col>>5, bit = col&31
            if self._sub_words is None:
                cols = self._sub_cols
                self._sub_words = (cols >> 5).astype(np.int64)
                self._sub_shift = (cols & 31).astype(np.uint32)
            w0 = ts.plane0[row][self._sub_words]
            w1 = ts.plane1[row][self._sub_words]
            a0 = ((w0 >> self._sub_shift) & 1).astype(np.uint8)
            a1 = ((w1 >> self._sub_shift) & 1).astype(np.uint8)
            return (self.b0, a0, a1)
        if not self._pb_subset and self._sub_cols is not None:
            self.pb.subset(self._sub_cols)
            self._pb_subset = True
        self.pb.seek(row)
        planes = self.pb.read_row()
        return (self.b0, planes[0], planes[1])

    def _tiles(self):
        """Lazily-opened packed tile store; None if unavailable."""
        if self._ts is False:
            try:
                from . import fastpath
                self._ts = fastpath.get_tiles(self.f)
            except Exception:  # noqa: BLE001 - PBWT reader remains the fallback
                self._ts = None
        return self._ts


# ---------------------------------------------------------------------------
# Allele-set parsing (bgt.c:975-1055)
# ---------------------------------------------------------------------------

class Allele:
    __slots__ = ("chrom", "pos", "rlen", "al", "rid")

    def __init__(self, chrom="", pos=-1, rlen=-1, al="", rid=-1):
        self.chrom, self.pos, self.rlen, self.al, self.rid = chrom, pos, rlen, al, rid

    def fmt(self) -> str:
        return f"{self.chrom}:{self.pos}:{self.rlen}:{self.al}"


def al_parse(s: str) -> Allele | None:
    """Parse 'chr:1basedPos:refLenOrSeq:seq' with normalization (bgt_al_parse)."""
    p = 0
    n = len(s)
    c = s.find(":")
    if c < 0:
        return None
    a = Allele(chrom=s[:c])
    p = c + 1
    if p >= n or not s[p].isdigit():
        return None
    q = p
    while q < n and s[q].isdigit():
        q += 1
    a.pos = int(s[p:q]) - 1
    if q >= n or s[q] != ":":
        return None
    p = q + 1
    ref = None
    if p < n and s[p].isdigit():
        q = p
        while q < n and s[q].isdigit():
            q += 1
        a.rlen = int(s[p:q])
        p = q
    elif p < n and s[p].isalpha():
        q = p
        while q < n and s[q].isalpha():
            q += 1
        ref = s[p:q]
        a.rlen = len(ref)
        p = q
    elif p < n and s[p] == ":":
        a.rlen = -1
    if p >= n or s[p] != ":":
        return None
    p += 1
    alt_start = p
    if a.rlen < 0:
        i = 0
        while alt_start + i < n and s[alt_start + i].isalpha():
            i += 1
        a.rlen = i
    # left-normalize against ref (case-insensitive)
    off = 0
    while p < n and s[p].isalpha():
        if ref is not None and off < len(ref) and s[p].upper() == ref[off].upper():
            off += 1
            p += 1
        else:
            break
    a.pos += off
    a.rlen -= off
    # the reference copies the rest of the string from alt+off
    alt = s[alt_start + off:]
    if ref is not None:
        ref2 = ref[off:]
        l_alt = len(alt)
        min_l = min(l_alt, a.rlen)
        off2 = 0
        while (off2 < min_l and a.rlen - 1 - off2 < len(ref2)
               and ref2[a.rlen - 1 - off2].isalpha()
               and ref2[a.rlen - 1 - off2].upper() == alt[l_alt - 1 - off2].upper()):
            off2 += 1
        a.rlen -= off2
        alt = alt[: l_alt - off2]
    a.al = alt
    return a


def al_from_bcf(h: bcflib.BcfHeader, b: Bcf1):
    """(alt_allele, ref_allele) keys for a record (bgt_al_from_bcf)."""
    ref, alt = b.get_ref_alt1()
    ref = ref.decode("latin-1")
    alt = alt.decode("latin-1")
    min_l = min(len(ref), len(alt))
    shift = 0
    while shift < min_l and ref[shift] == alt[shift]:
        shift += 1
    chrom = h.id_name(BCF_DT_CTG, b.rid)
    a = Allele(chrom, b.pos + shift, b.rlen - shift, alt[shift:], b.rid)
    r = Allele(chrom, b.pos + shift, b.rlen - shift, ref[shift:], b.rid)
    return a, r


class AlleleSet:
    """Set of canonical allele keys backed by the native hash set.

    Looks like the plain ``set`` of key strings that the engine used to
    build eagerly (``in`` / ``len`` / ``iter``), but construction is one
    native pass over the batch-parsed key arrays and membership probes go
    through ctypes — the 0.7s-per-query Python set build over genome-scale
    -d/-a sets disappears.  Iteration (only reached for small sets, e.g.
    the probe-per-key site prefilter) materializes lazily."""

    def __init__(self, key_cat: bytes, key_off):
        from .. import native
        self._cat = key_cat
        self._off = np.ascontiguousarray(key_off, dtype=np.int64)
        lib = native.get_lib()
        self._lib = lib
        self._h = lib.bgt_al_set_new(
            key_cat, self._off.ctypes.data_as(__import__("ctypes").c_void_p),
            self._off.size - 1)
        self._pyset: set | None = None

    def __del__(self):
        h = getattr(self, "_h", None)
        if h and self._lib is not None:
            self._lib.bgt_al_set_free(h)
            self._h = None

    def __len__(self) -> int:
        return int(self._lib.bgt_al_set_len(self._h))

    def __contains__(self, key) -> bool:
        k = key.encode("latin-1") if isinstance(key, str) else key
        return bool(self._lib.bgt_al_set_contains(self._h, k, len(k)))

    def _materialize(self) -> set:
        if self._pyset is None:
            off = self._off.tolist()
            self._pyset = {
                self._cat[off[i]: off[i + 1]].decode("latin-1")
                for i in range(len(off) - 1)
            }
        return self._pyset

    def __iter__(self):
        return iter(self._materialize())

    def match_sites(self, st, rows: np.ndarray, ctg_names: list[str]):
        """(len(rows),) uint8 kinds: 1 alt-key match, 2 ref-key match,
        0 none (al_present, bgt.c:252-270) — one native pass."""
        import ctypes
        names = [n.encode("latin-1") for n in ctg_names]
        ctg_cat = b"".join(names)
        ctg_len = np.array([len(x) for x in names], dtype=np.int64)
        ctg_off = np.zeros(len(names), dtype=np.int64)
        np.cumsum(ctg_len[:-1], out=ctg_off[1:])
        rows_c = np.ascontiguousarray(rows, np.int64)
        kinds = np.zeros(rows_c.size, dtype=np.uint8)

        def vp(a):
            return ctypes.c_void_p(a.ctypes.data)

        # gather only the selected rows' columns: a full-table
        # ascontiguousarray cast against a .sites.bin-backed (int32,
        # memory-mapped) table would copy+fault all 39.2M rows per call;
        # the allele offsets stay global, so the cat buffers pass whole
        # (raw mmap pointers when available — pages fault on demand)
        idx = rows_c
        rid = np.ascontiguousarray(np.asarray(st.rid)[idx], np.int32)
        pos = np.ascontiguousarray(np.asarray(st.pos)[idx], np.int64)
        rlen = np.ascontiguousarray(np.asarray(st.rlen)[idx], np.int64)
        roff = np.ascontiguousarray(np.asarray(st.ref_off)[idx], np.int64)
        rlen2 = np.ascontiguousarray(np.asarray(st.ref_len)[idx], np.int64)
        aoff = np.ascontiguousarray(np.asarray(st.alt_off)[idx], np.int64)
        alen = np.ascontiguousarray(np.asarray(st.alt_len)[idx], np.int64)
        seq = np.arange(rows_c.size, dtype=np.int64)

        def cat_vp(which):
            mm = getattr(st, f"_{which}_cat_mm", None)
            if mm is not None:
                return ctypes.c_void_p(mm.ctypes.data)
            return ctypes.cast(ctypes.c_char_p(getattr(st, f"{which}_cat")),
                               ctypes.c_void_p)

        self._lib.bgt_al_match(
            self._h, vp(seq), seq.size, vp(rid), vp(pos), vp(rlen),
            vp(roff), vp(rlen2), cat_vp("ref"),
            vp(aoff), vp(alen), cat_vp("alt"),
            ctypes.cast(ctypes.c_char_p(ctg_cat), ctypes.c_void_p),
            vp(ctg_off), vp(ctg_len), vp(kinds))
        return kinds


def al_present(h_al, h: bcflib.BcfHeader, b: Bcf1) -> int:
    a, r = al_from_bcf(h, b)
    if a.fmt() in h_al:
        return 1
    if r.fmt() in h_al:
        return 2
    return 0


# ---------------------------------------------------------------------------
# Multi-database merge reader (bgtm_t, bgt.c:364-888)
# ---------------------------------------------------------------------------

class SiteInfo:
    """AC/AN aggregate for one site (bgt_info_t)."""

    __slots__ = ("ac", "an", "n_groups", "gan", "gac")

    def __init__(self):
        self.ac = [0, 0]
        self.an = 0
        self.n_groups = 0
        self.gan = []
        self.gac = []


def _group_key(nc: str, g: int) -> str:
    return f"A{nc}{g + 1}"


class BgtmReader:
    def __init__(self, bfiles: list[BgtFile]):
        self.bgt = [BgtReader(bf) for bf in bfiles]
        self.n_bgt = len(bfiles)
        self.r = [None] * self.n_bgt  # lookahead: (b0_copy, a0, a1) or None
        self.flag = 0
        self.n_out = 0
        self.n_groups = 0
        self.group_path: str | None = None  # the last group's (add_group)
        self.mgs_def = 0
        self.n_gt_read = 0
        self.truncated = False  # set by the server fastpath quota cut
        self.site_flt: kexpr.Kexpr | None = None
        self.h_out: bcflib.BcfHeader | None = None
        self.a = [None, None]  # merged haplotype planes
        self.group: np.ndarray | None = None
        self.mgs: np.ndarray | None = None
        self.sample_idx: list | None = None
        self.fields: list[kexpr.Kexpr] | None = None
        self.tbl_line = ""
        self.h_al: set | None = None
        self.aal: list[Allele] = []
        self.alcnt: np.ndarray | None = None
        self.hap: np.ndarray | None = None
        self._prepared = False

    def close(self):
        for g in self.bgt:
            g.close()

    # --- configuration -----------------------------------------------------

    def set_flag(self, flag: int) -> None:
        self.flag = flag

    def set_flt_site(self, expr: str) -> int:
        ke, err = kexpr.parse(expr)
        if err:
            return err
        self.site_flt = ke
        return 0

    def set_region(self, reg: str) -> int:
        for g in self.bgt:
            if g.set_region(reg) < 0:
                return -1
        return 0

    def set_start(self, n: int) -> int:
        for g in self.bgt:
            g.set_start(n)
        return 0

    def set_bed(self, bed, excl: bool) -> None:
        for g in self.bgt:
            g.set_bed(bed, excl)

    def set_mgs(self, mgs_def: int) -> None:
        for g in self.bgt:
            g.mgs_def = mgs_def
        self.mgs_def = mgs_def

    def add_group(self, expr: str) -> int:
        """Add one sample group to every database; ``group_path`` says how
        its expression was evaluated (``Fmf.test_all``): ``scalar`` where
        any database's was, None for a name list."""
        self.group_path = None
        size = 0
        for g in self.bgt:
            ret = g.add_group(expr)
            if ret < 0:
                return ret
            size += ret
        paths = {g.group_path for g in self.bgt}
        self.group_path = ("scalar" if "scalar" in paths else
                           "vector" if "vector" in paths else None)
        self.n_groups += 1
        return size

    def set_table(self, fmt: str) -> int:
        fields = []
        depth = 0
        cur = ""
        parts = []
        for ch in fmt:
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            if ch == "," and depth == 0:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        parts.append(cur)
        if depth != 0:
            return -1
        for p in parts:
            ke, err = kexpr.parse(p)
            if err:
                return -1
            fields.append(ke)
        self.fields = fields
        return 0

    def set_alleles(self, expr: str, vardb: Fmf | None = None,
                    dbfn: str | None = None) -> int:
        """-a allele list/file/expression (bgtm_set_alleles, bgt.c:477-545)."""
        assert vardb is None or dbfn is None
        als: list[Allele] = []
        isf = files.is_file(expr)
        if expr[:1] in (":", ",") or (expr[:1] != "?" and isf) or (
            vardb is None and dbfn is None and isf
        ):
            for s in files.readlines(expr) or []:
                a = al_parse(s)
                if a is not None:
                    als.append(a)
        elif vardb is not None or dbfn is not None:
            ke, err = kexpr.parse(expr)
            if err:
                return -1
            if vardb is not None:
                for i in range(vardb.n_rows):
                    if vardb.test(i, ke):
                        a = al_parse(vardb.row_name(i))
                        if a is not None:
                            als.append(a)
            else:
                from .. import native
                from ..formats.fmf import scan_filter_raw
                fast = scan_filter_raw(dbfn, ke)
                batch = None
                if fast is not None:
                    cat, off, lens = fast
                    batch = native.al_parse_batch(cat, off, lens)
                if batch is not None:
                    # vectorized columnar scan + native batch
                    # canonicalization: finish set-building from the arrays
                    return self._set_alleles_batch(batch)
                fs = FmfStream(dbfn)
                while True:
                    s = fs.read(ke, True)
                    if s is None:
                        break
                    a = al_parse(s)
                    if a is not None:
                        als.append(a)
                fs.close()
        else:
            return -1
        if not als:
            return 0
        h: set = set()
        min_pos, max_pos = 1 << 62, -(1 << 62)
        diff_rid = False
        for a in als:
            key = a.fmt()
            if key not in h:
                h.add(key)
                min_pos = min(min_pos, a.pos)
                max_pos = max(max_pos, a.pos)
                if a.chrom != als[0].chrom:
                    diff_rid = True
        if not diff_rid and self.bgt[0].itr is None:
            self.set_region(f"{als[0].chrom}:{min_pos + 1}-{max_pos + 1}")
        self.h_al = h
        for g in self.bgt:
            g.h_al = h
        return len(h)

    def _set_alleles_batch(self, batch) -> int:
        """Finish set_alleles from native batch-parsed arrays (the tail of
        bgtm_set_alleles, bgt.c:513-543, without per-allele Python objects)."""
        key_cat, key_off, pos_a, rlen_a, chrom_len = batch
        n = pos_a.size
        if n == 0:
            return 0
        from .. import native
        if native.get_lib() is not None:
            h = AlleleSet(key_cat, key_off)
        else:
            off_l = key_off.tolist()
            h = {key_cat[off_l[i]: off_l[i + 1]].decode("latin-1")
                 for i in range(n)}
        # region autoset requires a single chromosome across the set
        L0 = int(chrom_len[0])
        chrom0 = key_cat[:L0].decode("latin-1")
        same_len = bool((chrom_len == L0).all())
        diff_rid = not same_len
        if same_len and n > 1:
            starts = key_off[:-1]
            idx = starts[:, None] + np.arange(L0)
            cat_arr = np.frombuffer(key_cat, dtype=np.uint8)
            chroms = cat_arr[idx]
            diff_rid = bool((chroms != chroms[0]).any())
        if not diff_rid and self.bgt[0].itr is None:
            min_pos = int(pos_a.min())
            max_pos = int(pos_a.max())
            self.set_region(f"{chrom0}:{min_pos + 1}-{max_pos + 1}")
        self.h_al = h
        for g in self.bgt:
            g.h_al = h
        return len(h)

    # --- prepare -----------------------------------------------------------

    def prepare(self) -> None:
        if self.n_bgt == 0:
            return
        self.n_out = 0
        for g in self.bgt:
            g.prepare()
            self.n_out += g.n_out
        mgs_parts = []
        group_parts = []
        idx_parts = []
        for i, g in enumerate(self.bgt):
            out = np.asarray(g.out, dtype=np.int64)
            m = np.asarray(g.f.mgs)[out].astype(np.int32)
            mgs_parts.append(np.where(m >= 0, m, np.int32(self.mgs_def)))
            group_parts.append(np.asarray(g.group, dtype=np.uint32)
                               if self.n_groups
                               else np.ones(out.size, np.uint32))
            fi = np.full(out.size, i, dtype=np.int64)
            idx_parts.append(np.stack([fi, out], axis=1))
        self.mgs = (np.concatenate(mgs_parts) if mgs_parts
                    else np.zeros(0, np.int32))
        self.group = (np.concatenate(group_parts) if group_parts
                      else np.zeros(0, np.uint32))
        self.sample_idx = (np.concatenate(idx_parts) if idx_parts
                           else np.zeros((0, 2), np.int64))
        if self.n_groups == 0:
            self.n_groups = 1
        if not (self.mgs <= 1).any():
            self.flag |= F_NO_GT

        # merged output header (bgtm_prepare, bgt.c:626-662)
        h0 = self.bgt[0].f.h0
        t = []
        t.append("##fileformat=VCFv4.1\n")
        t.append('##INFO=<ID=AC,Number=A,Type=String,Description="Count of alternate alleles">\n')
        t.append('##INFO=<ID=AN,Number=A,Type=String,Description="Count of total alleles">\n')
        for i in range(1, self.n_groups + 1):
            t.append(f'##INFO=<ID=AC{i},Number=A,Type=String,Description="Count of alternate alleles for sample group {i}">\n')
            t.append(f'##INFO=<ID=AN{i},Number=A,Type=String,Description="Count of total alleles for sample group {i}">\n')
        t.append('##INFO=<ID=END,Number=1,Type=Integer,Description="Ending position">\n')
        t.append('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        t.append('##ALT=<ID=M,Description="Multi-allele">\n')
        t.append('##ALT=<ID=DEL,Description="Deletion">\n')
        t.append('##ALT=<ID=DUP,Description="Duplication">\n')
        t.append('##ALT=<ID=INS,Description="Insertion">\n')
        t.append('##ALT=<ID=INV,Description="Inversion">\n')
        t.append('##ALT=<ID=DUP:TANDEM,Description="Tandem duplication">\n')
        t.append('##ALT=<ID=DEL:ME,Description="Deletion of mobile element">\n')
        t.append('##ALT=<ID=INS:ME,Description="Insertion of mobile element">\n')
        for name, ii in h0.ids[BCF_DT_CTG]:
            t.append(f"##contig=<ID={name},length={ii.info[0]}>\n")
        t.append("#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO")
        if not self.flag & F_NO_GT:
            t.append("\tFORMAT")
            m = 0
            for g in self.bgt:
                for j in range(g.n_out):
                    keep = self.mgs[m] <= 1
                    m += 1
                    if keep:
                        t.append("\t" + g.f.f.row_name(int(g.out[j])))
        self.h_out = bcflib.BcfHeader.from_text_cached("".join(t))
        self.a = [np.zeros(self.n_out * 2, np.uint8), np.zeros(self.n_out * 2, np.uint8)]
        if self.h_al is not None:
            if self.flag & F_CNT_AL:
                self.alcnt = np.zeros(self.n_out, dtype=np.int64)
            if self.flag & F_CNT_HAP:
                self.hap = np.zeros(self.n_out * 2, dtype=np.uint64)
        self._prepared = True

    def test_mgs(self) -> bool:
        cnt = np.zeros(MAX_GROUPS, dtype=np.int64)
        for gval in self.group:
            cnt[gval - 1] += 1
        for i in range(self.n_out):
            if self.mgs[i] > cnt[self.group[i] - 1]:
                return False
        return True

    # --- site statistics ---------------------------------------------------

    def cal_info(self) -> SiteInfo:
        ss = SiteInfo()
        ss.n_groups = self.n_groups
        codes = (self.a[1].astype(np.int64) << 1) | self.a[0]
        if self.n_groups > 1:
            gidx = np.repeat(self.group.astype(np.int64) - 1, 2)
            gcnt = np.zeros((self.n_groups, 4), dtype=np.int64)
            np.add.at(gcnt, (gidx, codes), 1)
            cnt = gcnt.sum(axis=0)
            ss.gan = (gcnt[:, 0] + gcnt[:, 1] + gcnt[:, 3]).tolist()
            ss.gac = [[int(gcnt[i, 1]), int(gcnt[i, 3])] for i in range(self.n_groups)]
        else:
            cnt = np.bincount(codes, minlength=4)
        ss.an = int(cnt[0] + cnt[1] + cnt[3])
        ss.ac = [int(cnt[1]), int(cnt[3])]
        return ss

    def _assign_expr(self, ke: kexpr.Kexpr, ss: SiteInfo) -> None:
        ke.set_int("AN", ss.an)
        ke.set_int("AC", ss.ac[0])
        for i in range(ss.n_groups):
            ke.set_int(_group_key("N", i), ss.gan[i] if ss.gan else 0)
            ke.set_int(_group_key("C", i), ss.gac[i][0] if ss.gac else 0)

    def pass_site_flt(self, ss: SiteInfo) -> bool:
        if self.site_flt is None:
            return True
        self._assign_expr(self.site_flt, ss)
        err, i = self.site_flt.eval_int()
        return False if err else bool(i)

    def fill_info(self, ss: SiteInfo, b: Bcf1) -> None:
        b.append_info_ints(self.h_out, "AN", [ss.an])
        b.append_info_ints(self.h_out, "AC", ss.ac[: b.n_allele - 1])
        if ss.n_groups > 1:
            for i in range(ss.n_groups):
                b.append_info_ints(self.h_out, _group_key("N", i), [ss.gan[i]])
                b.append_info_ints(self.h_out, _group_key("C", i),
                                   ss.gac[i][: b.n_allele - 1])

    def _assign_by_bcf(self, ke: kexpr.Kexpr, b: Bcf1) -> None:
        ke.set_str("CHROM", self.h_out.id_name(BCF_DT_CTG, b.rid))
        ke.set_int("POS", b.pos + 1)
        ke.set_int("END", b.pos + b.rlen)
        ref, alt = b.get_ref_alt1()
        ke.set_str("REF", ref.decode("latin-1"))
        ke.set_str("ALT", alt.decode("latin-1"))

    def gen_tbl_line(self, ss: SiteInfo, b: Bcf1) -> None:
        parts = []
        for ke in self.fields:
            self._assign_expr(ke, ss)
            self._assign_by_bcf(ke, b)
            err, i, r, s, t = ke.eval()
            if err:
                parts.append("*")
            elif t == kexpr.KEV_INT:
                parts.append(str(i))
            elif t == kexpr.KEV_REAL:
                parts.append(kexpr.fmt_real(r))
            else:
                parts.append(s)
        self.tbl_line = "\t".join(parts)

    # --- reading -----------------------------------------------------------

    def read_core(self, b: Bcf1) -> int:
        # fill lookahead
        n_rest = 0
        for i, g in enumerate(self.bgt):
            if self.r[i] is None:
                rec = g.read_rec()
                if rec is not None:
                    b0, a0, a1 = rec
                    self.r[i] = (b0.copy(), a0, a1)
            if self.r[i] is not None:
                n_rest += 1
                self.n_gt_read += g.n_out
        if n_rest == 0:
            return -1
        # smallest allele
        b0 = None
        max_allele = 0
        for i in range(self.n_bgt):
            if self.r[i] is None:
                continue
            rb = self.r[i][0]
            if b0 is None:
                b0, max_allele = rb, rb.n_allele
            else:
                c = bcfcmp(b0, rb)
                if c > 0:
                    b0, max_allele = rb, rb.n_allele
                elif c == 0:
                    max_allele = max(max_allele, rb.n_allele)
        assert b0 is not None and max_allele >= 2
        l_ref = bcfcpy_min(b, b0, "<M>" if max_allele > 2 else None)
        if l_ref != b.rlen:
            b.append_info_ints(self.h_out, "END", [b.pos + b.rlen])
        # gather haplotype planes
        off = 0
        for i, g in enumerate(self.bgt):
            if g.n_out == 0:
                continue
            w = g.n_out * 2
            rec = self.r[i]
            if rec is not None and bcfcmp(b, rec[0]) == 0:
                self.a[0][off: off + w] = rec[1]
                self.a[1][off: off + w] = rec[2]
                self.r[i] = None
            else:
                self.a[0][off: off + w] = 0
                self.a[1][off: off + w] = 1
            off += w
        al_ret = 0
        if self.h_al is not None:
            al_ret = al_present(self.h_al, self.h_out, b)
            if al_ret == 0:
                return 1
        if (self.flag & F_SET_AC) or self.site_flt is not None or self.fields or \
                self.n_groups > 1:
            ss = self.cal_info()
            self.fill_info(ss, b)
            if self.fields:
                self.gen_tbl_line(ss, b)
            if not self.pass_site_flt(ss):
                return 1
        if self.h_al is not None:
            if self.flag & F_CNT_AL and self.alcnt is not None:
                g1 = self.a[0][0::2] | (self.a[1][0::2] << 1)
                g2 = self.a[0][1::2] | (self.a[1][1::2] << 1)
                target = 0 if al_ret == 2 else 1
                self.alcnt += ((g1 == target) | (g2 == target))
            if self.flag & F_CNT_HAP and self.hap is not None:
                hit = (self.a[0] == 1) & (self.a[1] == 0)
                # x86 shift semantics (mod 64), as the reference's 1ULL<<n
                self.hap[hit] |= np.uint64(1 << (len(self.aal) & 63))
            self.aal.append(al_from_bcf(self.h_out, b)[0])
        return 0

    def read(self, b: Bcf1) -> int:
        if not self._prepared:
            self.prepare()
        while True:
            ret = self.read_core(b)
            if ret <= 0:
                break
        if not self.flag & F_NO_GT:
            gen_gt(self.h_out, b, self.n_out, self.a, self.mgs)
        return ret

    # --- epilogues ---------------------------------------------------------

    def hapcnt_print(self) -> str:
        """-H report (bgtm_hapcnt + bgtm_hapcnt_print_destroy, bgt.c:900-955).

        Vectorized aggregation (unique-mask ids in first-seen order, counts
        by bincount); the final small sort keeps the reference's unstable
        ks_introsort tie order byte-for-byte."""
        if self.hap is None or self.n_out == 0:
            return ""
        if len(self.aal) > 64:
            import sys
            print(f"[W::hapcnt] {len(self.aal)} alleles exceed the 64-bit "
                  "haplotype mask; bit columns alias modulo 64 (matching the "
                  "reference's 1ULL<<n overflow on x86)", file=sys.stderr)
        u, first, inv = np.unique(self.hap, return_index=True,
                                  return_inverse=True)
        n = u.size
        # renumber unique masks in order of first appearance (the reference
        # hash assigns ids as masks are first seen, bgt.c:905-913)
        order_seen = np.argsort(first, kind="stable")
        remap = np.empty(n, dtype=np.int64)
        remap[order_seen] = np.arange(n)
        t_of_hap = remap[inv]
        tot = np.bincount(t_of_hap, minlength=n)
        hap_group = np.repeat(self.group.astype(np.int64), 2)
        cnt = np.zeros((n, self.n_groups), dtype=np.int64)
        for j in range(self.n_groups):
            # reference quirk: the group number is tested as a bitmask here
            sel = (hap_group >> j) & 1
            cnt[:, j] = np.bincount(t_of_hap, weights=sel,
                                    minlength=n).astype(np.int64)
        from .. import native
        lib = native.get_lib()
        if lib is not None:
            import ctypes
            order_a = np.arange(n, dtype=np.int64)
            keys = np.ascontiguousarray(tot, dtype=np.int64)
            lib.bgt_introsort_desc(ctypes.c_void_p(order_a.ctypes.data), n,
                                   ctypes.c_void_p(keys.ctypes.data))
            order = order_a.tolist()
        else:
            order = list(range(n))
            from ..core.introsort import ks_introsort
            tot_l = tot.tolist()
            ks_introsort(order, lambda x, y: tot_l[x] > tot_l[y])
        haps = u[order_seen]
        out = [f"NA\t{len(self.aal)}"]
        for a in self.aal:
            out.append(f"AA\t{a.chrom}:{a.pos + 1}:{a.rlen}:{a.al}")
        out.append(f"NH\t{n}\t{self.n_groups}")
        cnt_l = cnt.tolist()
        # '0'/'1' digit matrix for all mask rows at once (shift counts wrap
        # at 64 as on x86, matching the accumulator)
        shifts = (np.arange(len(self.aal)) & 63).astype(np.uint64)
        digits = (48 + ((haps[:, None] >> shifts[None, :])
                        & np.uint64(1))).astype(np.uint8)
        blob = digits.tobytes().decode("latin-1")
        w = len(self.aal)
        if self.n_groups == 1:
            for t in order:
                out.append(f"HC\t{blob[t * w: (t + 1) * w]}\t{cnt_l[t][0]}")
        else:
            for t in order:
                bits = blob[t * w: (t + 1) * w]
                out.append("HC\t" + bits
                           + "".join(f"\t{c}" for c in cnt_l[t]))
        return "\n".join(out) + "\n"

    def alcnt_print(self) -> str:
        """-S report (bgtm_alcnt_print, bgt.c:957-969)."""
        out = []
        hits = np.nonzero((self.alcnt == len(self.aal))
                          & (self.mgs[: self.n_out] <= 1))[0]
        for i in hits.tolist():
            fi, row = self.sample_idx[i]
            name = self.bgt[fi].f.f.row_name(int(row))
            out.append(f"SP\t{name}\t{fi + 1}\n")
        return "".join(out)


def gen_gt(h: bcflib.BcfHeader, b: Bcf1, m: int, a, mgs=None) -> None:
    """Emit FORMAT/GT bytes from the 2 planes (bgt_gen_gt, bgt.c:290-313)."""
    b.indiv = bytearray()
    b.mark_dirty()
    if mgs is not None:
        keep = mgs <= 1
        m2 = int(keep.sum())
        if m2 == 0:
            return
    else:
        keep = None
        m2 = m
    gid = h.id2int(BCF_DT_ID, "GT")
    b.n_fmt = 1
    b.n_sample = m2
    bcflib.enc_int1(b.indiv, gid)
    bcflib.enc_size(b.indiv, 2, bcflib.BCF_BT_INT8)
    gt = BITS2GT[(a[1] << 1) | a[0]]
    if keep is not None:
        gt = gt.reshape(-1, 2)[keep].reshape(-1)
    b.indiv += gt.tobytes()
