"""FMF: flat metadata format (``name<TAB>key:T:value...`` rows).

Functional twin of the reference metadata store (reference fmf.c): an in-RAM
table with interned keys and string values plus row-vs-expression testing
(`fmf_test`), and a streaming variant that tokenizes and tests each line
without materializing the table (`fms_read`).  The quirks that affect query
results are preserved: ``_ROW_`` is only bound when a row has metadata (in
the in-RAM path), real-typed values bind through the integer setter in the
in-RAM path (truncation) but through the real setter in the streaming path,
and flag-typed keys bind nothing (fmf.c:140-156, 185-227).
"""

from __future__ import annotations

import gzip
import threading

from ..core import kexpr

FMF_FLAG = 0
FMF_INT = 1
FMF_REAL = 2
FMF_STR = 3

# ``Fmf.test_all`` calls by the path taken: ``vector`` evaluated the
# expression once over the table's columns, ``scalar`` ran ``test`` a row
GROUP_EVAL = {"vector": 0, "scalar": 0}
_GROUP_EVAL_LOCK = threading.Lock()
_MISSING = object()


def _open_text(fn: str):
    f = open(fn, "rb")
    if f.read(2) == b"\x1f\x8b":
        f.close()
        return gzip.open(fn, "rt", encoding="latin-1")
    f.seek(0)
    import io
    return io.TextIOWrapper(f, encoding="latin-1")


def _parse_meta(token: str):
    """Split 'key[:T:value]' -> (key, type, value-str)."""
    c = token.find(":")
    if c < 0:
        return token, FMF_FLAG, None
    key = token[:c]
    rest_len = len(token) - c
    if rest_len >= 3:
        tc = token[c + 1]
        val = token[c + 3:]
        if tc == "i":
            return key, FMF_INT, val
        if tc == "f":
            return key, FMF_REAL, val
        return key, FMF_STR, val
    return key, FMF_FLAG, None


def _strtol(s: str) -> int:
    """C strtol(.., base=0): optional sign, then decimal/hex/octal prefix."""
    i, n = 0, len(s)
    sign = 1
    if i < n and s[i] in "+-":
        sign = -1 if s[i] == "-" else 1
        i += 1
    if s[i:i + 2].lower() == "0x":
        j = i + 2
        while j < n and s[j].lower() in "0123456789abcdef":
            j += 1
        return sign * int(s[i + 2:j], 16) if j > i + 2 else 0
    j = i
    while j < n and s[j].isdigit():
        j += 1
    if j == i:
        return 0
    if s[i] == "0":
        return sign * int(s[i:j], 8)
    return sign * int(s[i:j])


def _strtod(s: str) -> float:
    import re
    m = re.match(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?", s)
    return float(m.group(0)) if m else 0.0


class Fmf:
    """In-RAM FMF table (fmf_t)."""

    def __init__(self):
        self.keys: list[str] = []
        self._key_id: dict[str, int] = {}
        self.vals: list[str] = []
        self._val_id: dict[str, int] = {}
        self.rows: list[tuple[str, list]] = []  # (name, [(key_id, type, value)])
        # built on first use and kept, as a server shares one table across
        # request threads: each key's column, the name -> rows index, and
        # whether every row binds (``_built``)
        self._memo: dict = {}
        self._lock = threading.Lock()

    @property
    def n_rows(self) -> int:
        return len(self.rows)

    @classmethod
    def read(cls, fn: str) -> "Fmf":
        f = cls()
        with _open_text(fn) as fp:
            for line in fp:
                line = line.rstrip("\n")
                if not line:
                    continue
                parts = line.split("\t")
                metas = []
                for token in parts[1:]:
                    key, t, val = _parse_meta(token)
                    kid = f._key_id.get(key)
                    if kid is None:
                        kid = len(f.keys)
                        f._key_id[key] = kid
                        f.keys.append(key)
                    if t == FMF_INT:
                        metas.append((kid, t, _strtol(val)))
                    elif t == FMF_REAL:
                        metas.append((kid, t, _strtod(val)))
                    elif t == FMF_STR:
                        vid = f._val_id.get(val)
                        if vid is None:
                            vid = len(f.vals)
                            f._val_id[val] = vid
                            f.vals.append(val)
                        metas.append((kid, t, vid))
                    else:
                        metas.append((kid, t, 0))
                f.rows.append((parts[0], metas))
        return f

    def row_name(self, r: int) -> str:
        return self.rows[r][0]

    def get_meta(self, r: int, key: str):
        """(type, value) of the LAST meta with this key, or None."""
        kid = self._key_id.get(key)
        if kid is None:
            return None
        out = None
        for mkid, t, v in self.rows[r][1]:
            if mkid == kid:
                out = (t, self.vals[v] if t == FMF_STR else v)
        return out

    def test(self, r: int, ke: kexpr.Kexpr) -> bool:
        """fmf_test semantics (fmf.c:140-156)."""
        if r >= len(self.rows):
            return False
        name, metas = self.rows[r]
        ke.unset()
        for kid, t, v in metas:
            ke.set_str("_ROW_", name)
            if t == FMF_STR:
                ke.set_str(self.keys[kid], self.vals[v])
            elif t == FMF_INT:
                ke.set_int(self.keys[kid], v)
            elif t == FMF_REAL:
                ke.set_int(self.keys[kid], int(v))  # reference truncates here
        err, i = ke.eval_int()
        return not (err or not i)

    def test_all(self, ke: kexpr.Kexpr):
        """``[self.test(i, ke) for i in range(self.n_rows)]`` as a bool
        array, and the path that computed it: ``vector`` evaluates the
        expression once over the table's columns (``Kexpr.eval_rows``),
        ``scalar`` falls back to ``test`` a row, where the columns cannot
        reproduce it (``_ROW_``, a column of strings and numbers, a value
        beyond int64 or a real that does not bind, ``eval_rows``'s
        ``NotExact``)."""
        import numpy as np
        mask = self._test_columns(ke)
        path = "scalar" if mask is None else "vector"
        with _GROUP_EVAL_LOCK:
            GROUP_EVAL[path] += 1
        if mask is None:
            mask = np.fromiter((self.test(i, ke) for i in range(self.n_rows)),
                               dtype=bool, count=self.n_rows)
        return mask, path

    def _test_columns(self, ke: kexpr.Kexpr):
        """``test_all``'s mask from the columns, or None (the loop's)."""
        import numpy as np
        names = ke.var_names
        if "_ROW_" in names or not self._all_bindable():
            return None
        valid = np.ones(self.n_rows, dtype=bool)  # every variable bound
        env = {}
        for key in names:
            col = self._column(key)
            if col is None:
                return None
            valid &= col[0]
            env[key] = col[1]
        try:
            with np.errstate(all="ignore"):
                i = ke.eval_rows(env, valid)
        except (kexpr.NotExact, IndexError):  # IndexError: an RPN that
            return None                          # underflows, as "abs()1"
        if any(e.ttype == kexpr._FUNC and e.func is None and e.name != "abs"
               for e in ke.rpn):
            return np.zeros(self.n_rows, dtype=bool)  # KEE_UNFUNC
        return valid & (i != 0)

    def _built(self, key, build):
        """``build()`` once under the table's lock, kept under ``key``."""
        got = self._memo.get(key, _MISSING)
        if got is _MISSING:
            with self._lock:
                got = self._memo.get(key, _MISSING)
                if got is _MISSING:
                    got = self._memo[key] = build()
        return got

    def _all_bindable(self) -> bool:
        """Whether ``test`` binds every row: it raises on a real that is
        not finite (``int(v)``), whatever the expression names."""
        import math
        return self._built(("bindable",), lambda: all(
            t != FMF_REAL or math.isfinite(v)
            for _name, metas in self.rows for _k, t, v in metas))

    def _column(self, key: str):
        return self._built(key, lambda: self._build_column(key))

    def _build_column(self, key: str):
        """(present, values) of ``key`` as ``test`` binds it on each row: the
        row's last typed meta of the key (a flag binds nothing), an int64
        array (a real truncated, as ``set_int`` does) or a
        :class:`kexpr.Categorical` over the column's sorted strings; None
        for a column of strings and numbers or an int beyond int64."""
        import numpy as np
        n = self.n_rows
        present = np.zeros(n, dtype=bool)
        kid = self._key_id.get(key)
        if kid is None:
            return present, np.zeros(n, dtype=np.int64)
        rows, types, vals = [], set(), []
        for r, (_name, metas) in enumerate(self.rows):
            last = None
            for mkid, t, v in metas:
                if mkid == kid and t != FMF_FLAG:
                    last = t, v
            if last is not None:
                rows.append(r)
                types.add(last[0] == FMF_STR)
                vals.append(last[1])
        present[rows] = True
        if types == {True, False}:
            return None
        if types == {True}:
            uniq = sorted(set(vals), key=self.vals.__getitem__)
            rank = {v: k for k, v in enumerate(uniq)}
            ids = np.zeros(n, dtype=np.int64)
            ids[rows] = [rank[v] for v in vals]
            return present, kexpr.Categorical(ids, [self.vals[v] for v in uniq])
        values = np.zeros(n, dtype=np.int64)
        try:
            values[rows] = [int(v) for v in vals]
        except OverflowError:
            return None
        return present, values

    def name_rows(self, names) -> "np.ndarray":
        """The rows whose name is in ``names``, as a bool array."""
        import numpy as np

        def index():
            out: dict = {}
            for r, (name, _metas) in enumerate(self.rows):
                out.setdefault(name, []).append(r)
            return out

        idx = self._built(("names",), index)
        mask = np.zeros(self.n_rows, dtype=bool)
        mask[[r for name in set(names) for r in idx.get(name, ())]] = True
        return mask

    def write_row(self, r: int) -> str:
        """Round-trip a row back to text (fmf_write)."""
        name, metas = self.rows[r]
        parts = [name]
        for kid, t, v in metas:
            if t == FMF_FLAG:
                parts.append(self.keys[kid])
            elif t == FMF_INT:
                parts.append(f"{self.keys[kid]}:i:{v}")
            elif t == FMF_REAL:
                parts.append(f"{self.keys[kid]}:f:{'%g' % v}")
            else:
                parts.append(f"{self.keys[kid]}:Z:{self.vals[v]}")
        return "\t".join(parts)


def _col_kind(vtype) -> int:
    """Classify a column: 1=int, 2=real(or int/real mix), 3=string,
    0=never present, -1=mixed string/numeric (uncachable fast path)."""
    import numpy as np
    kinds = set(np.unique(vtype).tolist()) - {0}
    if not kinds:
        return 0
    if kinds <= {1}:
        return 1
    if kinds <= {1, 2}:
        return 2
    if kinds == {3}:
        return 3
    return -1


_SIDE_MAGIC = b"BFI\x02"


class _SidecarFile:
    """Lazy reader for the ``.fmfidx`` sidecar: a JSON index over raw
    little-endian array sections, each accessed via np.memmap so a query
    only faults in the columns it evaluates."""

    def __init__(self, path: str):
        import json
        self.path = path
        with open(path, "rb") as fp:
            if fp.read(4) != _SIDE_MAGIC:
                raise ValueError("bad sidecar magic")
            import struct
            (jlen,) = struct.unpack("<I", fp.read(4))
            self.idx = json.loads(fp.read(jlen).decode())
            self.data_start = (fp.tell() + 63) // 64 * 64

    def arr(self, name: str):
        import numpy as np
        dt, count, off = self.idx["sections"][name]
        if count == 0:
            return np.zeros(0, dtype=np.dtype(dt))
        return np.memmap(self.path, dtype=np.dtype(dt), mode="r",
                         offset=self.data_start + off, shape=(count,))

    def uniq(self, key: str) -> list[str]:
        ucat = bytes(self.arr(f"c:{key}:ucat"))
        uoff = self.arr(f"c:{key}:uoff")
        return [ucat[uoff[i]: uoff[i + 1]].decode("latin-1")
                for i in range(uoff.size - 1)]


def _sidecar_save(side: str, st, shared, cached: dict) -> None:
    """Write the sidecar atomically: magic + u32 json-length + JSON index
    + 64-aligned raw array sections."""
    import json
    import os
    import struct

    import numpy as np
    n, name_cat, name_off, name_len, line_off, line_len = shared
    sections: dict[str, np.ndarray] = {
        "name_cat": np.frombuffer(name_cat, np.uint8),
        "name_off": np.ascontiguousarray(name_off, np.int64),
        "name_len": np.ascontiguousarray(name_len, np.int32),
        "line_off": np.ascontiguousarray(line_off, np.int64),
        "line_len": np.ascontiguousarray(line_len, np.int32),
    }
    keys = {}
    for k, (kind, vtype, val, uniq) in cached.items():
        keys[k] = kind
        sections[f"c:{k}:vtype"] = np.ascontiguousarray(vtype, np.uint8)
        sections[f"c:{k}:val"] = np.ascontiguousarray(val)
        if kind == 3:
            parts = [u.encode("latin-1") for u in uniq]
            uoff = np.zeros(len(parts) + 1, np.int64)
            np.cumsum([len(p) for p in parts], out=uoff[1:])
            sections[f"c:{k}:ucat"] = np.frombuffer(b"".join(parts), np.uint8)
            sections[f"c:{k}:uoff"] = uoff
    idx = {"mtime_ns": st.st_mtime_ns, "size": st.st_size, "n": n,
           "keys": keys, "sections": {}}
    pos = 0
    for name, a in sections.items():
        idx["sections"][name] = [a.dtype.str, int(a.size), pos]
        pos = (pos + a.nbytes + 63) // 64 * 64
    blob = json.dumps(idx, separators=(",", ":")).encode()
    tmp = side + f".tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as fp:
            fp.write(_SIDE_MAGIC)
            fp.write(struct.pack("<I", len(blob)))
            fp.write(blob)
            data_start = (fp.tell() + 63) // 64 * 64
            for name, a in sections.items():
                fp.seek(data_start + idx["sections"][name][2])
                a.tofile(fp)
        os.replace(tmp, side)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass


def _cached_scan_columns(fn: str, names: list[str]):
    """``native.fmf_scan_columns`` behind an mtime-keyed ``.fmfidx``
    sidecar (the reference re-parses the whole annotation file per query,
    its own dominant cost for real queries — tex/bgt.tex:214-217).

    The sidecar accumulates columns across queries: a scan triggered by a
    missing key merges the fresh columns into the existing file.  Returns
    the same tuple as fmf_scan_columns, None when native is unavailable, or
    the string "mixed" when a requested key is cached as mixed-type (the
    caller falls back to the scalar path without rescanning).
    """
    import os

    import numpy as np

    from .. import native
    fn = os.fspath(fn)
    if os.environ.get("BGT_TPU_FMF_CACHE", "1") == "0" or not os.path.isfile(fn):
        return native.fmf_scan_columns(fn, names)
    st = os.stat(fn)
    side = fn + ".fmfidx"
    sc = None
    if os.path.exists(side):
        try:
            sc = _SidecarFile(side)
            if (sc.idx["mtime_ns"] != st.st_mtime_ns
                    or sc.idx["size"] != st.st_size):
                sc = None
        except (OSError, ValueError, KeyError):
            sc = None
    kinds = dict(sc.idx["keys"]) if sc is not None else {}
    missing = [k for k in names if k not in kinds]
    if missing or sc is None:
        res = native.fmf_scan_columns(fn, missing)
        if res is None:
            return None
        n, name_cat, name_off, name_len, line_off, line_len, fresh = res
        if sc is not None and sc.idx["n"] != n:
            # stale sidecar despite the stat match (replaced file, crashed
            # writer): discard it and rescan every requested key
            sc = None
            kinds = {}
            missing = list(names)
            res = native.fmf_scan_columns(fn, missing)
            if res is None:
                return None
            n, name_cat, name_off, name_len, line_off, line_len, fresh = res
        cached: dict[str, tuple] = {}
        if sc is not None:
            # merge: carry the existing columns over (materialized)
            for k, kind in kinds.items():
                cached[k] = (kind, np.array(sc.arr(f"c:{k}:vtype")),
                             np.array(sc.arr(f"c:{k}:val")),
                             sc.uniq(k) if kind == 3 else [])
        shared = (n, name_cat, name_off, name_len, line_off, line_len)
        for k in missing:
            vtype, iv, rv, sid, uniq = fresh[k]
            kind = _col_kind(vtype)
            val = (iv if kind == 1 else rv if kind == 2 else
                   sid if kind == 3 else np.zeros(0, np.int64))
            cached[k] = (kind, vtype, val, uniq if kind == 3 else [])
        _sidecar_save(side, st, shared, cached)
        cols = {}
        z64 = np.zeros(0, np.int64)
        zf = np.zeros(0, np.float64)
        z32 = np.zeros(0, np.int32)
        for k in names:
            kind, vtype, val, uniq = cached[k]
            if kind == -1:
                return "mixed"
            iv = val if kind == 1 else np.zeros(n, np.int64) if kind == 0 else z64
            cols[k] = (vtype, iv, val if kind == 2 else zf,
                       val if kind == 3 else z32, uniq)
        return n, name_cat, name_off, name_len, line_off, line_len, cols
    # pure cache hit: serve from memmaps, faulting in only what's evaluated
    n = sc.idx["n"]
    cols = {}
    z64 = np.zeros(0, np.int64)
    zf = np.zeros(0, np.float64)
    z32 = np.zeros(0, np.int32)
    for k in names:
        kind = kinds[k]
        if kind == -1:
            return "mixed"
        vtype = sc.arr(f"c:{k}:vtype")
        val = sc.arr(f"c:{k}:val")
        iv = val if kind == 1 else np.zeros(n, np.int64) if kind == 0 else z64
        cols[k] = (vtype, iv, val if kind == 2 else zf,
                   val if kind == 3 else z32,
                   sc.uniq(k) if kind == 3 else [])
    return (n, _LazyBytes(sc, "name_cat"), sc.arr("name_off"),
            sc.arr("name_len"), sc.arr("line_off"), sc.arr("line_len"), cols)


class _LazyBytes:
    """bytes-like view over a sidecar section, materialized on first use
    (the names blob is only needed to emit passing rows)."""

    def __init__(self, sc: "_SidecarFile", name: str):
        self._sc = sc
        self._name = name
        self._b: bytes | None = None

    def _get(self) -> bytes:
        if self._b is None:
            self._b = bytes(self._sc.arr(self._name))
        return self._b

    def __getitem__(self, i):
        return self._get()[i]

    def __len__(self):
        return len(self._get())

    def __bytes__(self):
        return self._get()


def scan_filter_raw(fn: str, ke):
    """Like :func:`scan_filter` but returns the passing rows' raw name
    bytes as (name_cat, name_off i64, name_len i32) without decoding, for
    native downstream batch processing; None when inapplicable."""
    return scan_filter(fn, ke, name_only=True, raw=True)


def scan_filter(fn: str, ke, name_only: bool = True, raw: bool = False):
    """Vectorized streaming FMF filter: list of passing row names (or whole
    lines), or None when the fast path does not apply (caller falls back to
    the per-row :class:`FmfStream` loop).

    Semantics mirror ``fms_read`` (reference fmf.c:185-227): per row, bind
    the typed keys present, evaluate; rows that reference an unbound
    variable or call any function fail (KEE_UNVAR/KEE_UNFUNC).  The native
    scanner extracts only the expression's variables into columnar arrays;
    the expression evaluates once, vectorized.
    """
    import numpy as np
    if ke is None:
        return None  # unfiltered pass-through: the plain loop is IO-bound
    if any(e.ttype == kexpr._FUNC for e in ke.rpn):
        # functions are unbound in FMF scans -> every row fails
        return (b"", np.zeros(0, np.int64), np.zeros(0, np.int32)) if raw else []
    names = sorted(ke.var_names)
    if "_ROW_" in names:
        return None
    res = _cached_scan_columns(fn, names)
    if res is None or res == "mixed":
        return None
    n, name_cat, name_off, name_len, line_off, line_len, cols = res

    def empty():
        return (b"", np.zeros(0, np.int64), np.zeros(0, np.int32)) if raw else []

    if n == 0:
        return empty()
    env = {}
    present = np.ones(n, dtype=bool)
    for key in names:
        vtype, iv, rv, sid, uniq = cols[key]
        present &= vtype != 0
        kinds = set(np.unique(vtype).tolist()) - {0}
        if kinds <= {1}:
            env[key] = iv
        elif kinds <= {1, 2}:
            env[key] = rv
        elif kinds == {3}:
            from ..core.kexpr import Categorical
            env[key] = Categorical(np.maximum(sid, 0), uniq)
        elif not kinds:  # key never present: every row fails on KEE_UNVAR
            return empty()
        else:
            return None  # mixed string/numeric column: scalar fallback
    try:
        with np.errstate(all="ignore"):
            _t, vec = ke.compile_vector(np)(env)
    except (TypeError, KeyError, ValueError):
        return None
    passing = np.nonzero(present & (np.asarray(vec) != 0))[0]
    if raw:
        if not isinstance(name_cat, bytes):
            name_cat = bytes(name_cat)
        return name_cat, name_off[passing], name_len[passing]
    if name_only:
        return [
            name_cat[name_off[i]: name_off[i] + name_len[i]].decode("latin-1")
            for i in passing.tolist()
        ]
    return _read_lines_at(fn, line_off[passing], line_len[passing])


def _read_lines_at(fn: str, offsets, lens) -> list:
    """Whole lines at the given uncompressed offsets (plain or gzip file),
    read in binary with ascending forward seeks."""
    with open(fn, "rb") as probe:
        is_gz = probe.read(2) == b"\x1f\x8b"
    fp = gzip.open(fn, "rb") if is_gz else open(fn, "rb")
    out = []
    try:
        for off, ln in zip(offsets.tolist(), lens.tolist()):
            fp.seek(off)
            out.append(fp.read(ln).decode("latin-1"))
    finally:
        fp.close()
    return out


class FmfStream:
    """Streaming FMF scan (fms_t): test each row against an expression."""

    def __init__(self, fn: str):
        self._fp = _open_text(fn)

    def close(self):
        self._fp.close()

    def read(self, ke: kexpr.Kexpr | None, name_only: bool) -> str | None:
        """Next passing row (name or whole line); None at EOF (fms_read)."""
        for line in self._fp:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            if ke is not None:
                ke.unset()
                ke.set_str("_ROW_", parts[0])
                for token in parts[1:]:
                    key, t, val = _parse_meta(token)
                    if t == FMF_INT:
                        ke.set_int(key, _strtol(val))
                    elif t == FMF_REAL:
                        ke.set_real(key, _strtod(val))
                    elif t == FMF_STR:
                        ke.set_str(key, val)
                err, i = ke.eval_int()
                if err or not i:
                    continue
            return parts[0] if name_only else line
        return None

    def __iter__(self):
        return self

    def __next__(self):
        raise TypeError("use read()")
