"""``bgt view``: query orchestration and VCF/table emission, with the count
tiers on a torch device.

The port's copy of ``bgt_tpu/query/view.py``: the reference CLI's semantics
and output bytes (reference view.c:14-183), with the batched branch run by
this package's ``FastView`` on ``device``.  Diploid GT cells are fixed 4-byte
strings, so a row's FORMAT section is one numpy LUT gather.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..formats.bcf import Bcf1, vcf_format1
from ..formats.bed import Bed
from ..formats.fmf import Fmf
from . import engine, fastpath
from .engine import (F_CNT_AL, F_CNT_HAP, F_NO_GT, F_SET_AC, MAX_GROUPS,
                     BgtmReader)

# 16 possible diploid cells "\t<a1>/<a2>" with allele chars indexed by code
_GT_CHARS = b"01.2"
_CELL_LUT = np.zeros(16, dtype="<u4")
for _c1 in range(4):
    for _c2 in range(4):
        _cell = bytes([9, _GT_CHARS[_c1], ord("/"), _GT_CHARS[_c2]])
        _CELL_LUT[_c1 * 4 + _c2] = np.frombuffer(_cell, dtype="<u4")[0]


def format_gt_fast(a0: np.ndarray, a1: np.ndarray, keep: np.ndarray | None) -> bytes:
    """The FORMAT/GT cells for one site as raw bytes (vectorized)."""
    codes = ((a1.astype(np.uint8) << 1) | a0).reshape(-1, 2)
    if keep is not None:
        codes = codes[keep]
    idx = codes[:, 0].astype(np.int64) * 4 + codes[:, 1]
    return _CELL_LUT[idx].tobytes()


class ViewOptions:
    def __init__(self):
        self.out_bcf = False
        self.clevel = -1
        self.multi_flag = 0
        self.excl = False
        self.not_vcf = False
        self.in_mem = False
        self.u_set = False
        self.seekn = -1
        self.n_rec = None
        self.reg = None
        self.site_flt = None
        self.bed = None
        self.groups: list[str] = []
        self.aexpr = None
        self.dbfn = None
        self.fmt = None
        self.prefixes: list[str] = []


def run_view(opt: ViewOptions, out=None, err=None,
             device: torch.device | str | None = None) -> int:
    """Run one view query; counts go to ``device`` (default ``cuda``)."""
    device = torch.device("cuda" if device is None else device)
    out = out or sys.stdout
    err = err or sys.stderr
    if opt.n_rec is not None and opt.n_rec < 0:
        print("[E::main_view] option -n must be at least 0.", file=err)
        return 1
    clevel = min(opt.clevel, 9)
    out_bcf = opt.out_bcf
    if opt.u_set:
        clevel, out_bcf = 0, True
    multi_flag = opt.multi_flag
    if len(opt.groups) > 1:
        multi_flag |= F_SET_AC

    vardb = None
    dbfn = opt.dbfn
    if dbfn and opt.in_mem:
        try:
            vardb = Fmf.read(dbfn)
        except OSError:
            print(f"[E::main_view] failed to open variant database '{dbfn}'",
                  file=err)
            return 1
        dbfn = None

    if (multi_flag & (F_CNT_AL | F_CNT_HAP)) and opt.aexpr is None:
        print("[E::main_view] -a must be specified when -S/-H is in use.", file=err)
        return 1

    bfiles = []
    for p in opt.prefixes:
        try:
            bfiles.append(engine.open_bgt_cached(p))
        except (OSError, ValueError):
            print(f"[E::main_view] failed to open BGT with prefix '{p}'",
                  file=err)
            return 1
    try:
        bm = BgtmReader(bfiles)
    except (OSError, ValueError) as e:
        print(f"[E::main_view] failed to open BGT: {e}", file=err)
        return 1
    bm.set_flag(multi_flag)
    if opt.site_flt is not None and bm.set_flt_site(opt.site_flt) != 0:
        print("[E::main_view] failed to set frequency filters. Syntax error?", file=err)
        return 1
    if opt.reg is not None and bm.set_region(opt.reg) < 0:
        print("[E::main_view] failed to set region. Region format error?", file=err)
        return 1
    if opt.bed is not None:
        try:
            bm.set_bed(Bed.read(opt.bed), opt.excl)
        except OSError:
            print(f"[E::main_view] failed to open BED file '{opt.bed}'",
                  file=err)
            return 1
    if opt.fmt is not None and bm.set_table(opt.fmt) < 0:
        print("[E::main_view] failed to set tabular output.", file=err)
        return 1
    if opt.seekn > 0:
        bm.set_start(opt.seekn)
    if opt.aexpr is not None:
        n_al = bm.set_alleles(opt.aexpr, vardb, dbfn)
        if n_al < 0:
            print("[E::main_view] failed to set alleles.", file=err)
            return 1
        if n_al == 0:
            print("[W::main_view] no alleles selected.", file=err)
    for gexpr in opt.groups[:MAX_GROUPS]:
        if bm.add_group(gexpr) < 0:
            print(f"[E::main_view] failed to add sample group '{gexpr}'.", file=err)
            return 1
    bm.prepare()

    wr = None
    bgzf_out = None
    if not opt.not_vcf:
        if out_bcf:
            import os

            from ..io.bgzf import BgzfWriter
            # the reference builds mode "wb%d" % clevel; mode2level picks the
            # first digit, so the default clevel=-1 yields level 1 (view.c:145)
            level = 1 if clevel < 0 else clevel
            raw = out.buffer if hasattr(out, "buffer") else out
            bgzf_out = BgzfWriter(raw, level,
                                  threads=min(os.cpu_count() or 1, 8))
            bm.h_out.write_bcf(bgzf_out)
        else:
            out.write(bm.h_out.vcf_text())
            wr = out

    def epilogues() -> None:
        # -H/-S reports after the read loop (view.c:158-174)
        if opt.not_vcf and len(bm.aal) > 0:
            if bm.flag & F_CNT_HAP:
                out.write(bm.hapcnt_print())
            if bm.flag & F_CNT_AL:
                s = bm.alcnt_print()
                if s:
                    out.write(s)

    # batched path (text always; binary BCF for single-DB native)
    if fastpath.applicable(opt, bm):
        if bgzf_out is None:
            fastpath.FastView(bm, opt, device).run(out)
            epilogues()
            bm.close()
            return 0
        from .. import native
        if len(bfiles) == 1 and native.get_lib() is not None:
            opt.bcf_writer = bgzf_out
            fastpath.FastView(bm, opt, device).run(out)
            bgzf_out.close()
            epilogues()
            bm.close()
            return 0

    b = Bcf1()
    n_read = 0
    n_rec = opt.n_rec if opt.n_rec is not None else float("inf")
    no_gt = bm.flag & F_NO_GT
    while True:
        # the reference reads first, then checks the record budget, so with
        # -n the (n+1)-th site still accumulates -S/-H counts (view.c:151)
        ret = bm.read(b)
        if ret < 0 or n_read >= n_rec:
            break
        if bgzf_out is not None:
            b.write(bgzf_out)
        elif wr is not None:
            if no_gt or b.n_sample == 0:
                wr.write(vcf_format1(bm.h_out, b) + "\n")
            else:
                ns = b.n_sample
                b.n_sample = 0
                prefix = vcf_format1(bm.h_out, b)
                b.n_sample = ns
                keep = bm.mgs <= 1 if (bm.mgs > 1).any() else None
                cells = format_gt_fast(bm.a[0], bm.a[1], keep)
                wr.write(prefix + "\tGT" + cells.decode("latin-1") + "\n")
        if opt.fmt is not None and bm.fields:
            out.write(bm.tbl_line + "\n")
        n_read += 1

    epilogues()

    if bgzf_out is not None:
        bgzf_out.close()
    bm.close()
    return 0


def main_view(argv: list[str], out=None, err=None,
              device: torch.device | str | None = None) -> int:
    """Parse ``bgt view`` style flags (view.c:28-47)."""
    import getopt as _getopt
    opt = ViewOptions()
    try:
        opts, args = _getopt.getopt(argv, "ubs:r:l:CMGB:ef:g:a:i:n:SHt:d:")
    except _getopt.GetoptError as e:
        print(f"[E::main_view] {e}", file=err or sys.stderr)
        return 1
    for c, val in opts:
        if c == "-b":
            opt.out_bcf = True
        elif c == "-r":
            opt.reg = val
        elif c == "-l":
            opt.clevel = int(val)
        elif c == "-e":
            opt.excl = True
        elif c == "-u":
            opt.u_set = True
        elif c == "-B":
            opt.bed = val
        elif c == "-C":
            opt.multi_flag |= F_SET_AC
        elif c == "-G":
            opt.multi_flag |= F_NO_GT
        elif c == "-S":
            opt.multi_flag |= F_NO_GT | F_CNT_AL
            opt.not_vcf = True
        elif c == "-H":
            opt.multi_flag |= F_NO_GT | F_CNT_HAP
            opt.not_vcf = True
        elif c == "-M":
            opt.in_mem = True
        elif c == "-i":
            opt.seekn = int(val) - 1
        elif c == "-n":
            opt.n_rec = int(val)
        elif c == "-f":
            opt.site_flt = val
        elif c == "-t":
            opt.fmt = val
            opt.not_vcf = True
        elif c == "-d":
            opt.dbfn = val
        elif c == "-s":
            if len(opt.groups) < MAX_GROUPS:
                opt.groups.append(val)
        elif c == "-a":
            opt.aexpr = val
    if not args:
        print("Usage: bgt view [options] <bgt-prefix> [...]", file=err or sys.stderr)
        return 1
    opt.prefixes = args
    return run_view(opt, out, err, device)
