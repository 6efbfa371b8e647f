"""ctypes bindings for the native host runtime (libbgt_host.so).

The C++ library implements the sequential PBWT codec loops (PBF encode for
import, PBF->tile decode for device loading).  Everything degrades to the
vectorized-numpy implementations when the library is missing; tests assert
both paths produce identical bytes.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

_REPO = Path(__file__).resolve().parent.parent
_SO = _REPO / "build" / "lib" / "libbgt_host.so"
_lib = None
_tried = False


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("BGT_TPU_NO_NATIVE"):
        return None
    try:
        override = os.environ.get("BGT_TPU_NATIVE_LIB")
        if override:
            lib = ctypes.CDLL(override)  # e.g. a sanitizer build
        else:
            if not _SO.exists() or _SO.stat().st_mtime < (
                _REPO / "native" / "bgt_host.cpp"
            ).stat().st_mtime:
                subprocess.run(["sh", str(_REPO / "tools" / "build_native.sh")],
                               check=True, capture_output=True, timeout=120)
            lib = ctypes.CDLL(str(_SO))
    except (OSError, subprocess.SubprocessError):
        return None
    lib.bgt_pbf_writer_open.restype = ctypes.c_void_p
    lib.bgt_pbf_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                        ctypes.c_int32, ctypes.c_int32]
    lib.bgt_pbf_writer_write.restype = ctypes.c_int64
    lib.bgt_pbf_writer_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                         ctypes.c_int64]
    lib.bgt_pbf_writer_close.restype = ctypes.c_int
    lib.bgt_pbf_writer_close.argtypes = [ctypes.c_void_p]
    lib.bgt_gtc_from_pbf.restype = ctypes.c_int64
    lib.bgt_gtc_from_pbf.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_int32]
    lib.bgt_emit_vcf_lines.restype = ctypes.c_int64
    lib.bgt_emit_vcf_lines.argtypes = [
        ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,  # chrom
        ctypes.c_void_p,                                    # pos1
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,  # ref
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,  # alt
        ctypes.c_void_p, ctypes.c_void_p,                   # n_allele, end
        ctypes.c_int32, ctypes.c_int32,                     # info_on, groups
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # an, ac, ac_m
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # gan, gac, gac_m
        ctypes.c_char_p, ctypes.c_int64,                    # gt cells
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,   # gt planes
        ctypes.c_void_p, ctypes.c_int64,                    # gt cols
        ctypes.c_char_p, ctypes.c_int64,                    # out buf
    ]
    lib.bgt_emit_vcf_lines_mt.restype = ctypes.c_int64
    lib.bgt_emit_vcf_lines_mt.argtypes = (
        lib.bgt_emit_vcf_lines.argtypes
        + [ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    lib.bgt_import_open.restype = ctypes.c_void_p
    lib.bgt_import_open.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                    ctypes.c_char_p, ctypes.c_int64,
                                    ctypes.c_int32, ctypes.c_int32,
                                    ctypes.c_int32, ctypes.c_int32,
                                    ctypes.c_char_p]
    lib.bgt_import_add_text.restype = ctypes.c_int32
    lib.bgt_import_add_text.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_char_p, ctypes.c_int32,
                                        ctypes.c_char_p, ctypes.c_void_p,
                                        ctypes.c_int32, ctypes.c_int32,
                                        ctypes.c_int32, ctypes.c_int32]
    lib.bgt_import_add_bcf.restype = ctypes.c_int32
    lib.bgt_import_add_bcf.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_void_p, ctypes.c_int32,
                                       ctypes.c_int32, ctypes.c_int32,
                                       ctypes.c_int32, ctypes.c_int32]
    lib.bgt_import_finish.restype = ctypes.c_void_p
    lib.bgt_import_finish.argtypes = [ctypes.c_void_p]
    lib.bgt_import_abort.restype = None
    lib.bgt_import_abort.argtypes = [ctypes.c_void_p]
    lib.bgt_introsort_desc.restype = None
    lib.bgt_introsort_desc.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                       ctypes.c_void_p]
    lib.bgt_bgzf_deflate.restype = ctypes.c_int64
    lib.bgt_bgzf_deflate.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_int32, ctypes.c_int32,
                                     ctypes.c_void_p]
    lib.bgt_parse_gt_cells.restype = ctypes.c_int64
    lib.bgt_parse_gt_cells.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                       ctypes.c_int32, ctypes.c_void_p]
    lib.bgt_translate_gt.restype = ctypes.c_int32
    lib.bgt_translate_gt.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                     ctypes.c_char_p, ctypes.c_int32,
                                     ctypes.c_void_p]
    lib.bgt_fmf_scan.restype = ctypes.c_void_p
    lib.bgt_fmf_scan.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                 ctypes.c_int32, ctypes.c_int32]
    lib.bgt_fmf_scan_nrows.restype = ctypes.c_int64
    lib.bgt_fmf_scan_nrows.argtypes = [ctypes.c_void_p]
    lib.bgt_fmf_scan_names.restype = None
    lib.bgt_fmf_scan_names.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 3
    lib.bgt_fmf_scan_lines.restype = None
    lib.bgt_fmf_scan_lines.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 2
    lib.bgt_fmf_scan_col.restype = None
    lib.bgt_fmf_scan_col.argtypes = [ctypes.c_void_p, ctypes.c_int32] + \
        [ctypes.c_void_p] * 4
    lib.bgt_fmf_scan_uniq.restype = ctypes.c_int32
    lib.bgt_fmf_scan_uniq.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                      ctypes.c_void_p, ctypes.c_void_p]
    lib.bgt_fmf_scan_free.restype = None
    lib.bgt_fmf_scan_free.argtypes = [ctypes.c_void_p]
    lib.bgt_site_scan.restype = ctypes.c_void_p
    lib.bgt_site_scan.argtypes = [ctypes.c_char_p]
    lib.bgt_site_scan_n.restype = ctypes.c_int64
    lib.bgt_site_scan_n.argtypes = [ctypes.c_void_p]
    lib.bgt_site_scan_data.restype = None
    lib.bgt_site_scan_data.argtypes = [ctypes.c_void_p] + \
        [ctypes.c_void_p] * 7 + [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_void_p]
    lib.bgt_site_scan_free.restype = None
    lib.bgt_site_scan_free.argtypes = [ctypes.c_void_p]
    lib.bgt_import_text.restype = ctypes.c_void_p
    lib.bgt_import_text.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,  # paths
        ctypes.c_char_p, ctypes.c_int64,                    # header blob
        ctypes.c_char_p, ctypes.c_int32,                    # contigs
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int32,   # filters
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,     # n_smp/keep/clevel
        ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,     # row_kid/end/cigar
        ctypes.c_int32,                                     # shift
    ]
    lib.bgt_import_n.restype = ctypes.c_int64
    lib.bgt_import_n.argtypes = [ctypes.c_void_p]
    lib.bgt_import_voff0.restype = ctypes.c_uint64
    lib.bgt_import_voff0.argtypes = [ctypes.c_void_p]
    lib.bgt_import_meta.restype = None
    lib.bgt_import_meta.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 4
    lib.bgt_import_sites.restype = None
    lib.bgt_import_sites.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 8
    lib.bgt_import_csi_init.restype = None
    lib.bgt_import_csi_init.argtypes = [ctypes.c_void_p] + [ctypes.c_int32] * 3
    lib.bgt_import_csi_ok.restype = ctypes.c_int32
    lib.bgt_import_csi_ok.argtypes = [ctypes.c_void_p]
    lib.bgt_import_csi_state.restype = None
    lib.bgt_import_csi_state.argtypes = [ctypes.c_void_p] * 3
    lib.bgt_import_csi_ctg.restype = None
    lib.bgt_import_csi_ctg.argtypes = ([ctypes.c_void_p, ctypes.c_int32]
                                       + [ctypes.c_void_p] * 6)
    lib.bgt_import_free.restype = None
    lib.bgt_import_free.argtypes = [ctypes.c_void_p]
    lib.bgt_merge_sites.restype = ctypes.c_void_p
    lib.bgt_merge_sites.argtypes = [ctypes.c_int32] + [ctypes.c_void_p] * 12
    lib.bgt_merge_n.restype = ctypes.c_int64
    lib.bgt_merge_n.argtypes = [ctypes.c_void_p]
    lib.bgt_merge_data.restype = None
    lib.bgt_merge_data.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 7 \
        + [ctypes.c_void_p] * 4
    lib.bgt_merge_free.restype = None
    lib.bgt_merge_free.argtypes = [ctypes.c_void_p]
    lib.bgt_al_set_new.restype = ctypes.c_void_p
    lib.bgt_al_set_new.argtypes = [ctypes.c_char_p, ctypes.c_void_p,
                                   ctypes.c_int64]
    lib.bgt_al_set_len.restype = ctypes.c_int64
    lib.bgt_al_set_len.argtypes = [ctypes.c_void_p]
    lib.bgt_al_set_contains.restype = ctypes.c_int32
    lib.bgt_al_set_contains.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                        ctypes.c_int64]
    lib.bgt_al_set_free.restype = None
    lib.bgt_al_set_free.argtypes = [ctypes.c_void_p]
    lib.bgt_al_match.restype = None
    lib.bgt_al_match.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int64] + [ctypes.c_void_p] * 13
    lib.bgt_host_counts.restype = ctypes.c_int64
    lib.bgt_host_counts.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_void_p, ctypes.c_int32, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int32,
    ]
    lib.bgt_emit_bcf_records.restype = ctypes.c_int64
    lib.bgt_emit_bcf_records.argtypes = (
        [ctypes.c_int64] + [ctypes.c_void_p] * 3            # rid, pos, rlen
        + [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p] * 2  # ref, alt
        + [ctypes.c_void_p] * 2                             # n_allele, end
        + [ctypes.c_int32] * 2                              # info_on, groups
        + [ctypes.c_void_p] * 6                             # an..gac_m
        + [ctypes.c_int32] * 3 + [ctypes.c_void_p] * 2      # ids
        + [ctypes.c_int32]                                  # gt_id
        + [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]  # planes
        + [ctypes.c_void_p, ctypes.c_int64]                 # cols
        + [ctypes.c_char_p, ctypes.c_int64])                # out
    lib.bgt_emit_bcf_records_mt.restype = ctypes.c_int64
    lib.bgt_emit_bcf_records_mt.argtypes = (
        lib.bgt_emit_bcf_records.argtypes
        + [ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p])
    lib.bgt_al_parse_batch.restype = ctypes.c_void_p
    lib.bgt_al_parse_batch.argtypes = [ctypes.c_char_p] + [ctypes.c_void_p] * 2 \
        + [ctypes.c_int64]
    lib.bgt_al_batch_n.restype = ctypes.c_int64
    lib.bgt_al_batch_n.argtypes = [ctypes.c_void_p]
    lib.bgt_al_batch_data.restype = None
    lib.bgt_al_batch_data.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 5
    lib.bgt_al_batch_free.restype = None
    lib.bgt_al_batch_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def emit_bcf_records(rid, pos, rlen, ref_cat, ref_off, ref_len,
                     alt_cat, alt_off, alt_len, n_allele, end_val,
                     info_on, n_groups, an, ac, ac_m, gan, gac, gac_m,
                     end_id, an_id, ac_id, gan_ids, gac_ids,
                     gt_id, gt_planes):
    """Native batched BCF record serialization; returns a list of byte
    chunks (uint8 views into the reusable emit buffer) whose concatenation
    is the record stream, or None when the library is unavailable.
    ``gt_planes``: (p0_rows, p1_rows, cols) or None for no-genotype
    records."""
    import numpy as np
    lib = get_lib()
    if lib is None:
        return None
    n = len(pos)

    arrs64 = [np.ascontiguousarray(a, dtype=np.int64) for a in
              (pos, rlen, ref_off, alt_off, end_val, an, ac, ac_m)]
    arrs32 = [np.ascontiguousarray(a, dtype=np.int32) for a in
              (rid, ref_len, alt_len, n_allele)]
    gptr = [None, None, None]
    if gan is not None:
        for j, g in enumerate((gan, gac, gac_m)):
            ga = np.ascontiguousarray(g, dtype=np.int64)
            arrs64.append(ga)
            gptr[j] = ga.ctypes.data_as(ctypes.c_void_p)
    gid_arrs = [np.ascontiguousarray(a, dtype=np.int32)
                for a in (gan_ids, gac_ids)]
    gp0 = gp1 = gcols = None
    gt_words = 0
    n_pairs = 0
    if gt_planes is not None:
        p0_rows, p1_rows, cols = gt_planes
        p0_rows = np.ascontiguousarray(p0_rows, dtype=np.uint32)
        p1_rows = np.ascontiguousarray(p1_rows, dtype=np.uint32)
        cols32 = np.ascontiguousarray(cols, dtype=np.int32)
        arrs64 += [p0_rows, p1_rows]
        arrs32.append(cols32)
        gp0 = p0_rows.ctypes.data_as(ctypes.c_void_p)
        gp1 = p1_rows.ctypes.data_as(ctypes.c_void_p)
        gcols = cols32.ctypes.data_as(ctypes.c_void_p)
        gt_words = p0_rows.shape[1]
        n_pairs = cols32.size // 2
    fixed = 80 + (n_groups + 1) * 40 + (2 * n_pairs + 8 if n_pairs else 0)
    common = (
        arrs32[0].ctypes.data_as(ctypes.c_void_p),
        arrs64[0].ctypes.data_as(ctypes.c_void_p),
        arrs64[1].ctypes.data_as(ctypes.c_void_p),
        ref_cat, arrs64[2].ctypes.data_as(ctypes.c_void_p),
        arrs32[1].ctypes.data_as(ctypes.c_void_p),
        alt_cat, arrs64[3].ctypes.data_as(ctypes.c_void_p),
        arrs32[2].ctypes.data_as(ctypes.c_void_p),
        arrs32[3].ctypes.data_as(ctypes.c_void_p),
        arrs64[4].ctypes.data_as(ctypes.c_void_p),
        int(info_on), int(n_groups),
        arrs64[5].ctypes.data_as(ctypes.c_void_p),
        arrs64[6].ctypes.data_as(ctypes.c_void_p),
        arrs64[7].ctypes.data_as(ctypes.c_void_p),
        gptr[0], gptr[1], gptr[2],
        int(end_id), int(an_id), int(ac_id),
        gid_arrs[0].ctypes.data_as(ctypes.c_void_p),
        gid_arrs[1].ctypes.data_as(ctypes.c_void_p),
        int(gt_id),
        gp0, gp1, gt_words, gcols, n_pairs,
    )
    import os as _os
    n_threads = 1 if n * fixed < (8 << 20) else min(_os.cpu_count() or 1, 16)
    n_threads = max(1, min(n_threads, n or 1))
    if n_threads == 1:
        cap = int(arrs32[1].sum() + arrs32[2].sum() + n * fixed + 1024)
        buf = _emit_buffer(cap)
        ret = lib.bgt_emit_bcf_records(
            n, *common, buf.ctypes.data_as(ctypes.c_char_p), cap)
        if ret < 0:
            raise OSError("bcf emit buffer overflow")
        return [buf[:ret]]
    bounds = (arrs32[1].astype(np.int64) + arrs32[2] + fixed)
    cum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(bounds, out=cum[1:])
    chunk_bounds = np.linspace(0, n, n_threads + 1).astype(np.int64)
    chunk_caps = cum[chunk_bounds[1:]] - cum[chunk_bounds[:-1]] + 1024
    chunk_offs = np.zeros(n_threads, dtype=np.int64)
    np.cumsum(chunk_caps[:-1], out=chunk_offs[1:])
    cap = int(chunk_offs[-1] + chunk_caps[-1])
    buf = _emit_buffer(cap)
    chunk_lens = np.empty(n_threads, dtype=np.int64)
    ret = lib.bgt_emit_bcf_records_mt(
        n, *common, buf.ctypes.data_as(ctypes.c_char_p), cap,
        n_threads, chunk_bounds.ctypes.data_as(ctypes.c_void_p),
        chunk_offs.ctypes.data_as(ctypes.c_void_p),
        chunk_lens.ctypes.data_as(ctypes.c_void_p))
    if ret < 0:
        raise OSError("bcf emit buffer overflow")
    return [buf[int(chunk_offs[c]): int(chunk_offs[c] + chunk_lens[c])]
            for c in range(n_threads)]


def bgzf_deflate(data, level: int, threads: int):
    """Multithreaded BGZF block compression of ``data`` (bytes-like).

    Returns a uint8 array holding the concatenated framed blocks (byte-
    identical to the sequential zlib stream at the same level), or None when
    the library is unavailable or deflate failed (caller falls back to the
    Python pool).  The native equivalent of the reference's bgzf_mt write
    pool (bgzf.c:381-535)."""
    import numpy as np
    lib = get_lib()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    if src.size == 0:
        return src.copy()
    n_blocks = (src.size + 0xFEFF) // 0xFF00
    out = np.empty(n_blocks * 0x10000, dtype=np.uint8)
    n = lib.bgt_bgzf_deflate(
        ctypes.c_void_p(src.ctypes.data), src.size, level, threads,
        ctypes.c_void_p(out.ctypes.data))
    if n < 0:
        return None
    return out[:n]


def al_parse_batch(cat: bytes, off, lens):
    """Batch-canonicalize allele specs (bgt_al_parse semantics).

    Returns (key_cat: bytes, key_off i64[n+1], pos i64, rlen i32,
    chrom_len i32) for the successfully parsed specs, or None if the
    native library is unavailable.
    """
    import numpy as np
    lib = get_lib()
    if lib is None:
        return None
    off = np.ascontiguousarray(off, dtype=np.int64)
    lens = np.ascontiguousarray(lens, dtype=np.int32)
    h = lib.bgt_al_parse_batch(cat, off.ctypes.data_as(ctypes.c_void_p),
                               lens.ctypes.data_as(ctypes.c_void_p), off.size)
    try:
        n = lib.bgt_al_batch_n(h)
        kc_p = ctypes.c_void_p()
        ko_p = ctypes.c_void_p()
        pos_p = ctypes.c_void_p()
        rl_p = ctypes.c_void_p()
        cl_p = ctypes.c_void_p()
        lib.bgt_al_batch_data(h, ctypes.byref(kc_p), ctypes.byref(ko_p),
                              ctypes.byref(pos_p), ctypes.byref(rl_p),
                              ctypes.byref(cl_p))

        def arr(ptr, dtype, count):
            if count == 0:
                return np.zeros(0, dtype=dtype)
            ct = np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
                shape=(count * np.dtype(dtype).itemsize,))
            return ct.view(dtype).copy()

        key_off = arr(ko_p, np.int64, n + 1)
        key_cat = ctypes.string_at(kc_p, int(key_off[-1])) if n else b""
        return (key_cat, key_off, arr(pos_p, np.int64, n),
                arr(rl_p, np.int32, n), arr(cl_p, np.int32, n))
    finally:
        lib.bgt_al_batch_free(h)


def fmf_scan_columns(path: str, keys: list[str]):
    """Columnar scan of an FMF file extracting only ``keys``.

    Returns (n_rows, name_cat: bytes, name_off, name_len, line_off,
    line_len, cols) where cols[key] = (vtype u8, iv i64, rv f64, sid i32,
    uniq: list[str]); or None when the native library is unavailable.
    All arrays are copies owned by Python.
    """
    import numpy as np
    lib = get_lib()
    if lib is None:
        return None
    keys_cat = b"\x00".join(k.encode("latin-1") for k in keys) + b"\x00"
    n_threads = int(os.environ.get("BGT_TPU_FMF_THREADS", "1"))
    h = lib.bgt_fmf_scan(path.encode(), keys_cat, len(keys), n_threads)
    if not h:
        raise OSError(f"cannot scan FMF file '{path}'")
    try:
        n = lib.bgt_fmf_scan_nrows(h)

        def arr(ptr, dtype, count):
            if count == 0:
                return np.zeros(0, dtype=dtype)
            # single copy straight out of the C buffers
            ct = np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
                shape=(count * np.dtype(dtype).itemsize,))
            return ct.view(dtype).copy()

        cat_p = ctypes.c_void_p()
        off_p = ctypes.c_void_p()
        len_p = ctypes.c_void_p()
        lib.bgt_fmf_scan_names(h, ctypes.byref(cat_p), ctypes.byref(off_p),
                               ctypes.byref(len_p))
        name_off = arr(off_p, np.int64, n)
        name_len = arr(len_p, np.int32, n)
        total = int(name_off[-1] + name_len[-1]) if n else 0
        name_cat = ctypes.string_at(cat_p, total) if total else b""
        lo_p = ctypes.c_void_p()
        ll_p = ctypes.c_void_p()
        lib.bgt_fmf_scan_lines(h, ctypes.byref(lo_p), ctypes.byref(ll_p))
        line_off = arr(lo_p, np.int64, n)
        line_len = arr(ll_p, np.int32, n)
        cols = {}
        for k, key in enumerate(keys):
            vt_p = ctypes.c_void_p()
            iv_p = ctypes.c_void_p()
            rv_p = ctypes.c_void_p()
            sid_p = ctypes.c_void_p()
            lib.bgt_fmf_scan_col(h, k, ctypes.byref(vt_p), ctypes.byref(iv_p),
                                 ctypes.byref(rv_p), ctypes.byref(sid_p))
            ucat_p = ctypes.c_void_p()
            uoff_p = ctypes.c_void_p()
            n_uniq = lib.bgt_fmf_scan_uniq(h, k, ctypes.byref(ucat_p),
                                           ctypes.byref(uoff_p))
            uoff = arr(uoff_p, np.int64, n_uniq + 1)
            ucat = ctypes.string_at(ucat_p, int(uoff[-1])) if n_uniq else b""
            uniq = [ucat[uoff[i]: uoff[i + 1]].decode("latin-1")
                    for i in range(n_uniq)]
            cols[key] = (arr(vt_p, np.uint8, n), arr(iv_p, np.int64, n),
                         arr(rv_p, np.float64, n), arr(sid_p, np.int32, n),
                         uniq)
        return n, name_cat, name_off, name_len, line_off, line_len, cols
    finally:
        lib.bgt_fmf_scan_free(h)


def parse_gt_cells(section: bytes, n_allele: int):
    """Packed GT bytes for a uniform diploid GT sample section, or None."""
    import numpy as np
    lib = get_lib()
    if lib is None:
        return None
    n_max = (len(section) + 1) // 4
    out = np.empty(2 * n_max, dtype=np.uint8)
    n = lib.bgt_parse_gt_cells(section, len(section), n_allele,
                               out.ctypes.data_as(ctypes.c_void_p))
    if n < 0:
        return None
    return out[: 2 * n]


def translate_gt(gt_packed, tr) -> tuple:
    """(codes, has_multi) through the atomizer allele map; None if no lib."""
    import numpy as np
    lib = get_lib()
    if lib is None:
        return None
    gt_packed = np.ascontiguousarray(gt_packed, dtype=np.uint8)
    tr_b = bytes(tr)
    codes = np.empty(gt_packed.size, dtype=np.uint8)
    hm = lib.bgt_translate_gt(gt_packed.ctypes.data_as(ctypes.c_void_p),
                              gt_packed.size, tr_b, len(tr),
                              codes.ctypes.data_as(ctypes.c_void_p))
    return codes, bool(hm)


import threading as _threading

_EMIT_BUF = _threading.local()


def _emit_buffer(cap: int):
    """Reusable grow-only output buffer (page faults on fresh GB-sized
    allocations dominate emission cost otherwise).  Thread-local: concurrent
    server queries each emit into their own buffer."""
    import numpy as np
    buf = getattr(_EMIT_BUF, "buf", None)
    if buf is None or buf.size < cap:
        buf = np.empty(int(cap * 1.2), dtype=np.uint8)
        _EMIT_BUF.buf = buf
    return buf


def emit_vcf_lines(chrom_cat, chrom_off, chrom_len, pos1,
                   ref_cat, ref_off, ref_len, alt_cat, alt_off, alt_len,
                   n_allele, end_val, info_on, n_groups,
                   an, ac, ac_m, gan, gac, gac_m, cells,
                   gt_planes=None, n_threads: int = 0):
    """Native VCF line assembly; returns a list of byte chunks (uint8 array
    views into a reusable buffer) whose concatenation is the output.

    ``cells``: prebuilt GT cell matrix (uint32 LUT entries), or None.
    ``gt_planes``: (p0_rows, p1_rows, cols) packed planes for the selected
    sites — GT text is generated inside the C call (preferred for dumps).
    ``n_threads``: emission threads (0 = auto: 1 for small outputs, up to
    ``os.cpu_count()`` for matrix dumps).
    """
    import numpy as np
    lib = get_lib()
    n = len(pos1)

    def p64(a):
        return np.ascontiguousarray(a, dtype=np.int64).ctypes.data_as(ctypes.c_void_p)

    def p32(a):
        return np.ascontiguousarray(a, dtype=np.int32).ctypes.data_as(ctypes.c_void_p)

    # hold contiguous arrays alive for the call
    arrs = [np.ascontiguousarray(a, dtype=np.int64) for a in
            (chrom_off, pos1, ref_off, alt_off, end_val, an, ac, ac_m)]
    arrs32 = [np.ascontiguousarray(a, dtype=np.int32) for a in
              (chrom_len, ref_len, alt_len, n_allele)]
    gptr = [None, None, None]
    if gan is not None:
        for j, g in enumerate((gan, gac, gac_m)):
            ga = np.ascontiguousarray(g, dtype=np.int64)
            arrs.append(ga)
            gptr[j] = ga.ctypes.data_as(ctypes.c_void_p)
    gt_bytes = None
    gt_width = 0
    gp0 = gp1 = gcols = None
    gt_words = 0
    n_pairs = 0
    if cells is not None:
        gt_bytes = np.ascontiguousarray(cells).tobytes()
        gt_width = 4 * cells.shape[1]
    elif gt_planes is not None:
        p0_rows, p1_rows, cols = gt_planes
        p0_rows = np.ascontiguousarray(p0_rows, dtype=np.uint32)
        p1_rows = np.ascontiguousarray(p1_rows, dtype=np.uint32)
        cols32 = np.ascontiguousarray(cols, dtype=np.int32)
        arrs.append(p0_rows)
        arrs.append(p1_rows)
        arrs32.append(cols32)
        gp0 = p0_rows.ctypes.data_as(ctypes.c_void_p)
        gp1 = p1_rows.ctypes.data_as(ctypes.c_void_p)
        gcols = cols32.ctypes.data_as(ctypes.c_void_p)
        gt_words = p0_rows.shape[1]
        n_pairs = cols32.size // 2
        gt_width = 4 * n_pairs
    # per-line worst-case bound, mirrored from emit_range's `bound`
    fixed = 64 + (n_groups + 1) * 96 + (gt_width + 3 if gt_width else 0) + 8
    if n_threads <= 0:
        import os as _os
        est = int(arrs32[0].sum(dtype=np.int64) + arrs32[1].sum(dtype=np.int64)
                  + arrs32[2].sum(dtype=np.int64)) + n * fixed
        n_threads = 1 if est < (8 << 20) else min(_os.cpu_count() or 1, 16)
    n_threads = max(1, min(int(n_threads), n if n else 1))
    common_args = (
        chrom_cat, arrs[0].ctypes.data_as(ctypes.c_void_p),
        arrs32[0].ctypes.data_as(ctypes.c_void_p),
        arrs[1].ctypes.data_as(ctypes.c_void_p),
        ref_cat, arrs[2].ctypes.data_as(ctypes.c_void_p),
        arrs32[1].ctypes.data_as(ctypes.c_void_p),
        alt_cat, arrs[3].ctypes.data_as(ctypes.c_void_p),
        arrs32[2].ctypes.data_as(ctypes.c_void_p),
        arrs32[3].ctypes.data_as(ctypes.c_void_p),
        arrs[4].ctypes.data_as(ctypes.c_void_p),
        info_on, n_groups,
        arrs[5].ctypes.data_as(ctypes.c_void_p),
        arrs[6].ctypes.data_as(ctypes.c_void_p),
        arrs[7].ctypes.data_as(ctypes.c_void_p),
        gptr[0], gptr[1], gptr[2],
        gt_bytes, gt_width,
        gp0, gp1, gt_words, gcols, n_pairs,
    )
    if n_threads == 1:
        cap = int(arrs32[0].sum() + arrs32[1].sum() + arrs32[2].sum()
                  + n * fixed + 1024)
        buf = _emit_buffer(cap)
        ret = lib.bgt_emit_vcf_lines(
            n, *common_args, buf.ctypes.data_as(ctypes.c_char_p), cap)
        if ret < 0:
            raise OSError("emit buffer overflow")
        return [buf[:ret]]  # zero-copy view, writable straight to a sink
    # multithreaded: equal site ranges; per-chunk capacity from exact
    # per-line bounds so no chunk can overflow
    bounds = (arrs32[0].astype(np.int64) + arrs32[1] + arrs32[2] + fixed)
    cum = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(bounds, out=cum[1:])
    chunk_bounds = np.linspace(0, n, n_threads + 1).astype(np.int64)
    chunk_caps = cum[chunk_bounds[1:]] - cum[chunk_bounds[:-1]] + 1024
    chunk_offs = np.zeros(n_threads, dtype=np.int64)
    np.cumsum(chunk_caps[:-1], out=chunk_offs[1:])
    cap = int(chunk_offs[-1] + chunk_caps[-1])
    buf = _emit_buffer(cap)
    chunk_lens = np.empty(n_threads, dtype=np.int64)
    ret = lib.bgt_emit_vcf_lines_mt(
        n, *common_args, buf.ctypes.data_as(ctypes.c_char_p), cap,
        n_threads, chunk_bounds.ctypes.data_as(ctypes.c_void_p),
        chunk_offs.ctypes.data_as(ctypes.c_void_p),
        chunk_lens.ctypes.data_as(ctypes.c_void_p))
    if ret < 0:
        raise OSError("emit buffer overflow")
    return [buf[int(chunk_offs[c]): int(chunk_offs[c] + chunk_lens[c])]
            for c in range(n_threads)]


class NativePbfWriter:
    """Streaming PBF writer backed by the C++ codec."""

    def __init__(self, path: str, m: int, g: int, shift: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.m = m
        self._h = lib.bgt_pbf_writer_open(path.encode(), m, g, shift)
        if not self._h:
            raise OSError(f"cannot open {path}")
        self.n = 0

    def write_codes(self, codes) -> None:
        """codes: (n_rows, m) or (m,) uint8 genotype codes."""
        import numpy as np
        arr = np.ascontiguousarray(codes, dtype=np.uint8)
        if arr.ndim == 1:
            arr = arr[None, :]
        assert arr.shape[1] == self.m
        ret = self._lib.bgt_pbf_writer_write(
            self._h, arr.ctypes.data_as(ctypes.c_char_p), arr.shape[0])
        if ret < 0:
            raise OSError("native PBF write failed")
        self.n = ret

    def close(self) -> None:
        if self._h:
            self._lib.bgt_pbf_writer_close(self._h)
            self._h = None


def import_text(vcf_path: str, pbf_path: str, bcf_path: str,
                bcf_hdr_blob: bytes, contigs: list[str],
                filters: list[tuple[str, int]], n_samples: int,
                keep_flt: bool, clevel: int, row_kid: int,
                end_defined: bool, cigar_defined: bool, shift: int):
    """One-pass native text-VCF import (parse + atomize + .bcf/.pbf write).

    Returns an :class:`ImportResult` (zero-copy views; call .free()) for
    CSI construction, or None when the native library is unavailable or
    the input needs the Python path (caller falls back)."""
    import numpy as np
    lib = get_lib()
    if lib is None:
        return None
    contigs_cat = b"\x00".join(c.encode("latin-1") for c in contigs) + b"\x00"
    fnames = b"\x00".join(f.encode("latin-1") for f, _ in filters) + b"\x00"
    fids = np.array([i for _, i in filters], dtype=np.int32)
    h = lib.bgt_import_text(
        vcf_path.encode(), pbf_path.encode(), bcf_path.encode(),
        bcf_hdr_blob, len(bcf_hdr_blob), contigs_cat, len(contigs),
        fnames, fids.ctypes.data_as(ctypes.c_void_p), fids.size,
        n_samples, int(keep_flt), clevel, row_kid,
        int(end_defined), int(cigar_defined), shift)
    return _import_result(lib, h)


class ImportResult:
    """Zero-copy view of a finished native import.

    Attributes are numpy views directly into the C++ result buffers (the
    large record/site columns total ~2.6 GB at the 39.2M-row shape —
    copying them cost multiple seconds of the import budget).  The caller
    must invoke :meth:`free` (idempotent; also runs at GC) when done; the
    views die with it.
    """

    __slots__ = ("_lib", "_h", "n", "rid", "pos", "end", "voff", "voff0",
                 "sites", "csi")

    def __init__(self, lib, h):
        self._lib = lib
        self._h = h

    def free(self) -> None:
        if self._h:
            self._lib.bgt_import_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.free()
        except Exception:  # noqa: BLE001 - interpreter shutdown
            pass


def _import_result(lib, h):
    """Wrap an ImportResult handle -> :class:`ImportResult` or None.
    ``sites`` is the dict of site-table sidecar columns (rlen, n_allele,
    ref_len, alt_len, ref_cat, alt_cat) collected while emitting, so the
    importer can write ``.sites.bin`` without re-scanning the BCF it just
    wrote; ``csi`` the in-job CSI builder's output (or None)."""
    import numpy as np
    if not h:
        return None
    res = ImportResult(lib, h)
    try:
        n = lib.bgt_import_n(h)
        voff0 = lib.bgt_import_voff0(h)
        p_rid = ctypes.c_void_p()
        p_pos = ctypes.c_void_p()
        p_end = ctypes.c_void_p()
        p_voff = ctypes.c_void_p()
        lib.bgt_import_meta(h, ctypes.byref(p_rid), ctypes.byref(p_pos),
                            ctypes.byref(p_end), ctypes.byref(p_voff))

        def arr(ptr, dtype, cnt=None):
            cnt = n if cnt is None else cnt
            if cnt == 0:
                return np.zeros(0, dtype=dtype)
            ct = np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
                shape=(cnt * np.dtype(dtype).itemsize,))
            return ct.view(dtype)

        p_rlen = ctypes.c_void_p()
        p_nal = ctypes.c_void_p()
        p_rl = ctypes.c_void_p()
        p_al = ctypes.c_void_p()
        p_rc = ctypes.c_void_p()
        p_ac = ctypes.c_void_p()
        rc_len = ctypes.c_int64()
        ac_len = ctypes.c_int64()
        lib.bgt_import_sites(h, ctypes.byref(p_rlen), ctypes.byref(p_nal),
                             ctypes.byref(p_rl), ctypes.byref(p_al),
                             ctypes.byref(p_rc), ctypes.byref(rc_len),
                             ctypes.byref(p_ac), ctypes.byref(ac_len))
        sites = {
            "rlen": arr(p_rlen, np.int64),
            "n_allele": arr(p_nal, np.int32),
            "ref_len": arr(p_rl, np.int64),
            "alt_len": arr(p_al, np.int64),
            "ref_cat": arr(p_rc, np.uint8, int(rc_len.value)),
            "alt_cat": arr(p_ac, np.uint8, int(ac_len.value)),
        }
        csi = None
        if lib.bgt_import_csi_ok(h):
            vals = np.zeros(9, dtype=np.int64)
            p_ridx = ctypes.c_void_p()
            lib.bgt_import_csi_state(
                h, ctypes.c_void_p(vals.ctypes.data), ctypes.byref(p_ridx))
            csi = {
                "n_ctg": int(vals[0]), "n_rec": int(vals[1]),
                "save_tid": int(vals[2]), "save_bin": int(vals[3]),
                "save_off": int(vals[4]), "off_beg": int(vals[5]),
                "n_mapped": int(vals[6]), "n_unmapped": int(vals[7]),
                "ridx": arr(p_ridx, np.uint64, int(vals[8])),
                "ctg": [],
            }
            for i in range(csi["n_ctg"]):
                p_rb = ctypes.c_void_p()
                p_ru = ctypes.c_void_p()
                p_rv = ctypes.c_void_p()
                p_li = ctypes.c_void_p()
                n_runs = ctypes.c_int64()
                n_lidx = ctypes.c_int64()
                lib.bgt_import_csi_ctg(
                    h, i, ctypes.byref(p_rb), ctypes.byref(p_ru),
                    ctypes.byref(p_rv), ctypes.byref(n_runs),
                    ctypes.byref(p_li), ctypes.byref(n_lidx))
                csi["ctg"].append((
                    arr(p_rb, np.int64, int(n_runs.value)),
                    arr(p_ru, np.uint64, int(n_runs.value)),
                    arr(p_rv, np.uint64, int(n_runs.value)),
                    arr(p_li, np.int64, int(n_lidx.value))))
        res.n = int(n)
        res.rid = arr(p_rid, np.int32)
        res.pos = arr(p_pos, np.int64)
        res.end = arr(p_end, np.int64)
        res.voff = arr(p_voff, np.uint64)
        res.voff0 = int(voff0)
        res.sites = sites
        res.csi = csi
        return res
    except Exception:
        res.free()
        raise


def import_open(pbf_path: str, bcf_path: str, bcf_hdr_blob: bytes,
                n_samples: int, clevel: int, row_kid: int, shift: int,
                pb1_path: str | None = None):
    """Open a native import job (shared writers across input files);
    returns an opaque handle or None.  ``pb1_path``: also emit the
    single-plane .pb1 (import -1, reference import.c:24,37)."""
    lib = get_lib()
    if lib is None:
        return None
    h = lib.bgt_import_open(pbf_path.encode(), bcf_path.encode(),
                            bcf_hdr_blob, len(bcf_hdr_blob), n_samples,
                            clevel, row_kid, shift,
                            pb1_path.encode() if pb1_path else None)
    return h or None


def import_add_text(job, vcf_path: str, contigs: list[str],
                    filters: list[tuple[str, int]], keep_flt: bool,
                    end_defined: bool, cigar_defined: bool) -> bool:
    import numpy as np
    lib = get_lib()
    contigs_cat = b"\x00".join(c.encode("latin-1") for c in contigs) + b"\x00"
    fnames = b"\x00".join(f.encode("latin-1") for f, _ in filters) + b"\x00"
    fids = np.array([i for _, i in filters], dtype=np.int32)
    return lib.bgt_import_add_text(
        job, vcf_path.encode(), contigs_cat, len(contigs), fnames,
        fids.ctypes.data_as(ctypes.c_void_p), fids.size, int(keep_flt),
        int(end_defined), int(cigar_defined)) == 0


def import_add_bcf(job, bcf_path: str, rid_map, gt_kid: int,
                   cigar_kid: int, pass_fid: int, keep_flt: bool) -> bool:
    import numpy as np
    lib = get_lib()
    rm = np.ascontiguousarray(rid_map, dtype=np.int32)
    return lib.bgt_import_add_bcf(
        job, bcf_path.encode(), ctypes.c_void_p(rm.ctypes.data), rm.size,
        gt_kid, cigar_kid, pass_fid, int(keep_flt)) == 0


def import_csi_init(job, n_ctg: int, min_shift: int, n_lvls: int) -> None:
    """Enable the in-job CSI builder (call before any add)."""
    get_lib().bgt_import_csi_init(job, n_ctg, min_shift, n_lvls)


def import_abort(job) -> None:
    """Poison the job so finish removes the partial outputs."""
    get_lib().bgt_import_abort(job)


def import_finish(job):
    """Finalize the job; returns an :class:`ImportResult` or None
    (partial outputs removed natively on failure)."""
    lib = get_lib()
    return _import_result(lib, lib.bgt_import_finish(job))


def merge_sites(dbs, rows_per_db):
    """Streaming k-way union merge of key-sorted per-DB site selections.

    ``dbs``: per-DB site-table-like objects exposing rid/pos/rlen/n_allele/
    alt_off/alt_len/alt_cat/ref_off/ref_len/ref_cat; ``rows_per_db``:
    ascending selected row ids.  Returns (n, rid, pos, rlen, n_allele,
    ref_len, alt_len, pres, ref_cat, alt_cat) or None without the library.
    """
    import numpy as np
    lib = get_lib()
    if lib is None:
        return None
    n_db = len(dbs)
    keep = []  # keep contiguous temporaries alive across the call

    def contig(a, dtype):
        c = np.ascontiguousarray(a, dtype=dtype)
        keep.append(c)
        return c

    rows_cat = contig(np.concatenate(
        [np.asarray(r, np.int64) for r in rows_per_db])
        if rows_per_db else np.zeros(0, np.int64), np.int64)
    nrows = contig([len(r) for r in rows_per_db], np.int64)

    def ptrs(field, dtype):
        arr = (ctypes.c_void_p * n_db)()
        for d, st in enumerate(dbs):
            arr[d] = contig(getattr(st, field), dtype).ctypes.data
        keep.append(arr)
        return arr

    def cat_ptrs(field):
        arr = (ctypes.c_void_p * n_db)()
        for d, st in enumerate(dbs):
            b = getattr(st, field)
            keep.append(b)
            arr[d] = ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p)
        keep.append(arr)
        return arr

    h = lib.bgt_merge_sites(
        n_db, nrows.ctypes.data, rows_cat.ctypes.data,
        ptrs("rid", np.int32), ptrs("pos", np.int64), ptrs("rlen", np.int64),
        ptrs("n_allele", np.int32), ptrs("alt_off", np.int64),
        ptrs("alt_len", np.int64), cat_ptrs("alt_cat"),
        ptrs("ref_off", np.int64), ptrs("ref_len", np.int64),
        cat_ptrs("ref_cat"))
    if not h:
        return None
    try:
        n = lib.bgt_merge_n(h)
        p = [ctypes.c_void_p() for _ in range(8)]
        rc_len = ctypes.c_int64()
        ac_len = ctypes.c_int64()
        lib.bgt_merge_data(h, ctypes.byref(p[0]), ctypes.byref(p[1]),
                           ctypes.byref(p[2]), ctypes.byref(p[3]),
                           ctypes.byref(p[4]), ctypes.byref(p[5]),
                           ctypes.byref(p[6]), ctypes.byref(p[7]),
                           ctypes.byref(rc_len),
                           ctypes.byref(pp := ctypes.c_void_p()),
                           ctypes.byref(ac_len))

        def arr(ptr, dtype, count):
            if count == 0:
                return np.zeros(0, dtype=dtype)
            ct = np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
                shape=(count * np.dtype(dtype).itemsize,))
            return ct.view(dtype).copy()

        rid = arr(p[0], np.int32, n)
        pos = arr(p[1], np.int64, n)
        rlen = arr(p[2], np.int64, n)
        nal = arr(p[3], np.int32, n)
        ref_len = arr(p[4], np.int64, n)
        alt_len = arr(p[5], np.int64, n)
        pres = arr(p[6], np.int64, n * n_db).reshape(n, n_db)
        ref_cat = ctypes.string_at(p[7], rc_len.value) if rc_len.value else b""
        alt_cat = ctypes.string_at(pp, ac_len.value) if ac_len.value else b""
        return n, rid, pos, rlen, nal, ref_len, alt_len, pres, ref_cat, alt_cat
    finally:
        lib.bgt_merge_free(h)


def site_scan(bcf_path: str):
    """Columnar scan of a site BCF: (rid i32, pos i64, rlen i64, n_allele
    i32, ref_len i64, alt_len i64, ref_cat bytes, alt_cat bytes) or None
    when the native library is unavailable.  Arrays are copies."""
    import numpy as np
    lib = get_lib()
    if lib is None:
        return None
    h = lib.bgt_site_scan(bcf_path.encode())
    if not h:
        raise OSError(f"cannot scan site BCF '{bcf_path}'")
    try:
        n = lib.bgt_site_scan_n(h)
        ptrs = [ctypes.c_void_p() for _ in range(8)]
        rc_len = ctypes.c_int64()
        ac_len = ctypes.c_int64()
        lib.bgt_site_scan_data(h, ctypes.byref(ptrs[0]), ctypes.byref(ptrs[1]),
                               ctypes.byref(ptrs[2]), ctypes.byref(ptrs[3]),
                               ctypes.byref(ptrs[4]), ctypes.byref(ptrs[5]),
                               ctypes.byref(ptrs[6]), ctypes.byref(rc_len),
                               ctypes.byref(ptrs[7]), ctypes.byref(ac_len))

        def arr(ptr, dtype):
            if n == 0:
                return np.zeros(0, dtype=dtype)
            ct = np.ctypeslib.as_array(
                ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint8)),
                shape=(n * np.dtype(dtype).itemsize,))
            return ct.view(dtype).copy()

        rid = arr(ptrs[0], np.int32)
        pos = arr(ptrs[1], np.int64)
        rlen = arr(ptrs[2], np.int64)
        nal = arr(ptrs[3], np.int32)
        ref_len = arr(ptrs[4], np.int64)
        alt_len = arr(ptrs[5], np.int64)
        ref_cat = ctypes.string_at(ptrs[6], rc_len.value) if rc_len.value else b""
        alt_cat = ctypes.string_at(ptrs[7], ac_len.value) if ac_len.value else b""
        return rid, pos, rlen, nal, ref_len, alt_len, ref_cat, alt_cat
    finally:
        lib.bgt_site_scan_free(h)


def gtc_from_pbf(pbf_path: str, gtc_path: str, col_align: int = 1024) -> int | None:
    """Native PBF -> GTC conversion; returns n_rows, or None if no library."""
    lib = get_lib()
    if lib is None:
        return None
    ret = lib.bgt_gtc_from_pbf(pbf_path.encode(), gtc_path.encode(), col_align)
    if ret < 0:
        raise OSError(f"native gtc conversion failed ({ret})")
    return int(ret)
