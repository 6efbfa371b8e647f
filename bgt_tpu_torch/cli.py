"""``bgt`` command-line interface of the torch port (subcommands mirror
reference main.c).

The port's copy of ``bgt_tpu/cli.py``, every subcommand included; ``view``
and ``server`` count on a torch device (default ``cuda``).
"""

from __future__ import annotations

import getopt
import math
import sys

VERSION = "0.1.0 (bgt-compat 1.0-r284)"


def main_import(argv, out=None, err=None) -> int:
    from .query import importer
    err = err or sys.stderr
    is_vcf = None
    keep_flt = False
    clevel = -1
    fn_ref = None
    gen_pb1 = False
    try:
        opts, args = getopt.getopt(argv, "1l:SFt:")
    except getopt.GetoptError as e:
        print(f"[E::main_import] {e}", file=err)
        return 1
    for c, val in opts:
        if c == "-1":
            # single-plane .pb1 file ("not used for now", import.c:24,37)
            gen_pb1 = True
        elif c == "-S":
            is_vcf = True
        elif c == "-t":
            # list of contig names/lengths for headerless VCF (import.c:35)
            is_vcf = True
            fn_ref = val
        elif c == "-l":
            clevel = int(val)
        elif c == "-F":
            keep_flt = True
    if len(args) < 2:
        print("Usage: bgt import [options] <out-prefix> <in.bcf>|<in.vcf>|<in.vcf.gz>",
              file=err)
        return 1
    importer.import_vcf(args[0], args[1:], is_vcf, keep_flt, clevel,
                        fn_ref=fn_ref, gen_pb1=gen_pb1)
    return 0


def main_atomize(argv, out=None, err=None) -> int:
    from .query import importer
    err = err or sys.stderr
    is_vcf = None
    bcf_out = False
    write_m = False
    use_missing = True
    fn_ref = None
    try:
        opts, args = getopt.getopt(argv, "0bSMt:")
    except getopt.GetoptError as e:
        print(f"[E::main_atomize] {e}", file=err)
        return 1
    for c, val in opts:
        if c == "-S":
            is_vcf = True
        elif c == "-t":
            is_vcf = True
            fn_ref = val
        elif c == "-b":
            bcf_out = True
        elif c == "-M":
            write_m = True
        elif c == "-0":
            use_missing = False
    if not args:
        print("Usage: bgt atomize [options] <in.bcf>|<in.vcf>", file=err)
        return 1
    importer.atomize_cli(args[0], is_vcf, bcf_out, write_m, use_missing,
                         out_fp=out or sys.stdout, fn_ref=fn_ref)
    return 0


def main_bcfidx(argv, out=None, err=None) -> int:
    from .query import importer
    min_shift = 14
    opts, args = getopt.getopt(argv, "s:")
    for c, val in opts:
        if c == "-s":
            min_shift = int(val)
    if not args:
        print("Usage: bgt bcfidx [-s minShift] <in.bcf>", file=err or sys.stderr)
        return 1
    importer.build_bcf_index(args[0], min_shift)
    return 0


def main_getalt(argv, out=None, err=None) -> int:
    """Dump allele keys of a site BCF (view.c:185-228)."""
    from .formats import bcf as bcflib
    from .io.bgzf import BgzfReader
    out = out or sys.stdout
    if not argv:
        print("Usage: bgt getalt <bgt-base>", file=err or sys.stderr)
        return 1
    fp = BgzfReader(argv[0] + ".bcf")
    h = bcflib.BcfHeader.read_bcf(fp)
    b = bcflib.Bcf1()
    while b.read(fp) >= 0:
        ref, alt = b.get_ref_alt1()
        min_l = min(len(ref), len(alt))
        i = 0
        while i < min_l and ref[i] == alt[i]:
            i += 1
        chrom = h.id_name(bcflib.BCF_DT_CTG, b.rid)
        out.write(f"{chrom}:{b.pos + 1 + i}:{b.rlen - i}:"
                  f"{alt[i:].decode('latin-1')}\n")
    fp.close()
    return 0


def main_fmf(argv, out=None, err=None) -> int:
    """Standalone FMF filter (fmf.c:232-270)."""
    from .core import kexpr
    from .formats.fmf import Fmf, FmfStream
    out = out or sys.stdout
    in_mem = False
    name_only = False
    opts, args = getopt.getopt(argv, "mn")
    for c, _v in opts:
        if c == "-m":
            in_mem = True
        elif c == "-n":
            name_only = True
    if not args:
        print("Usage: bgt fmf [-mn] <in.fmf> [condition]", file=err or sys.stderr)
        return 1
    ke = None
    if len(args) >= 2:
        ke, _err = kexpr.parse(args[1])
    if in_mem:
        f = Fmf.read(args[0])
        for i in range(f.n_rows):
            if ke is not None and not f.test(i, ke):
                continue
            out.write((f.row_name(i) if name_only else f.write_row(i)) + "\n")
    else:
        from .formats.fmf import scan_filter
        fast = scan_filter(args[0], ke, name_only) if ke is not None else None
        if fast is not None:
            for s in fast:
                out.write(s + "\n")
            return 0
        fs = FmfStream(args[0])
        while True:
            s = fs.read(ke, name_only)
            if s is None:
                break
            out.write(s + "\n")
        fs.close()
    return 0


def main_pbfview(argv, out=None, err=None) -> int:
    """PBF <-> PIM converter and subset viewer (reference pbfview.c)."""
    import numpy as np
    from .formats.pbf import PbfReader, PbfWriter
    out = out or sys.stdout
    in_txt = False
    out_pbf = False
    shift = 13
    row_start = 0
    n_rec = None
    sub = []
    opts, args = getopt.getopt(argv, "Sbc:r:n:s:")
    for c, val in opts:
        if c == "-S":
            in_txt = True
        elif c == "-b":
            out_pbf = True
        elif c == "-r":
            row_start = int(val)
        elif c == "-n":
            n_rec = int(val)
        elif c == "-s":
            shift = int(val)
        elif c == "-c":
            sub.append(int(val))
    if not args:
        print("Usage: bgt pbfview [-Sb] [-s shift] [-r row] [-n rows] [-c col]... "
              "<in.pbf>|<in.pim>", file=err or sys.stderr)
        return 1

    def open_writer(m, g):
        raw = out.buffer if hasattr(out, "buffer") else out

        class _Stream:
            # non-seekable sink: like the reference writing to stdout, the
            # footer offsets become (uint64)-1 (pbwt.c ftell on a pipe)
            def write(self, b):
                raw.write(b)

            def tell(self):
                return (1 << 64) - 1

            def close(self):
                pass

        w = PbfWriter.__new__(PbfWriter)
        w.fp = _Stream()
        from .formats import pbf as pbfmod
        import struct as _struct
        w.m, w.g, w.shift = m, g, shift
        w.codecs = [pbfmod.PbwtCodec(m) for _ in range(g)]
        w.n = 0
        w.idx = []
        w.fp.write(pbfmod.MAGIC)
        w.fp.write(_struct.pack("<3i", m, g, shift))
        return w

    if in_txt:
        import sys as _sys
        fp = open(args[0]) if args[0] != "-" else _sys.stdin
        toks = fp.read().split()
        assert toks[0] == "PIM1"
        m, g = int(toks[1]), int(toks[2])
        vals = np.array([int(x) for x in toks[3:]], dtype=np.uint64)
        n_rows = vals.size // m
        vals = vals[: n_rows * m].reshape(n_rows, m)
        if out_pbf:
            w = open_writer(m, g)
            for row in vals:
                w.write_row([((row >> k) & 1).astype(np.uint8) for k in range(g)])
            w.close()
        else:
            out.write(f"PIM1 {m} {g}\n")
            for row in vals:
                out.write(" ".join(str(int(x)) for x in row) + "\n")
    else:
        r = PbfReader(args[0])
        m = len(sub) if sub else r.m
        g = r.g
        if row_start > 0:
            r.seek(row_start)
        if sub:
            r.subset(sub)
        if out_pbf:
            w = open_writer(m, g)
        else:
            w = None
            out.write(f"PIM1 {m} {g}\n")
        i = 0
        while n_rec is None or i < n_rec:
            planes = r.read_row()
            if planes is None:
                break
            if w is not None:
                w.write_row(planes)
            else:
                x = sum((p.astype(np.uint64) << k) for k, p in enumerate(planes))
                out.write(" ".join(str(int(v)) for v in x) + "\n")
            i += 1
        if w is not None:
            w.close()
        r.close()
    return 0


def main_gtcshard(argv, out=None, err=None) -> int:
    """Emit per-host column-slice tile shards (multi-host serving layout):
    host K of an N-process mesh then opens only its shard via
    BGT_TPU_TILE_SHARD=K:N (see docs/DESIGN.md §5)."""
    out = out or sys.stdout
    err = err or sys.stderr
    opts, args = getopt.getopt(argv, "")
    if len(args) != 3:
        print("Usage: bgt gtcshard <bgt-base> <n-processes> <n-devices-total>",
              file=err)
        return 1
    from .ops.tiles import TileStore
    paths = TileStore.emit_shards(args[0], int(args[1]), int(args[2]))
    for p in paths:
        print(p, file=out)
    return 0


def main_kexpr(argv, out=None, err=None) -> int:
    """Standalone expression evaluator (reference kexpr.c KE_MAIN)."""
    from .core import kexpr
    out = out or sys.stdout
    to_print = False
    opts, args = getopt.getopt(argv, "pi")
    for c, _v in opts:
        if c == "-p":
            to_print = True
    if not args:
        print("Usage: bgt kexpr [-pi] <expr> [var=value]...", file=err or sys.stderr)
        return 1
    ke, errflag = kexpr.parse(args[0])
    if errflag:
        print(f"Parse error: {errflag:#x}", file=err or sys.stderr)
        return 1
    ke.set_default_func()  # reference kexpr.c:556
    if to_print:
        toks = []
        for e in ke.rpn:
            if e.ttype == 1:
                toks.append(e.name if e.name else (
                    "%g" % e.r if e.vtype == kexpr.KEV_REAL
                    else str(e.i) if e.vtype == kexpr.KEV_INT else f'"{e.s}"'))
            else:
                toks.append(e.name)
        out.write(" ".join(toks) + "\n")
        return 0
    for a in args[1:]:
        if "=" in a:
            k, v = a.split("=", 1)
            try:
                ke.set_real(k, float(v))
            except ValueError:
                ke.set_real(k, 0.0)
    errflag, i, r, s, t = ke.eval()
    if errflag & kexpr.KEE_UNFUNC:
        print("Evaluation warning: an undefined function returns the first "
              "function argument.", file=err or sys.stderr)
    if errflag & kexpr.KEE_UNVAR:
        print("Evaluation warning: unassigned variables are set to 0.",
              file=err or sys.stderr)
    if t == kexpr.KEV_INT:
        out.write(f"{i}\n")
    elif t == kexpr.KEV_REAL:
        out.write(kexpr.fmt_real(r) + "\n")
    else:
        out.write(f"{s}\n")
    return 0


def _device_cmd(cmd: str, fn, argv, device) -> int:
    """``view``/``server`` on ``device``; a bad flag prints a message (the
    other subcommands raise ``getopt.GetoptError`` as ``bgt_tpu``'s do).
    Under torchrun (``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``)
    the process first joins its group, with NCCL between the ranks where
    each has cards of its own (bare ``cuda`` is then ``cuda:$LOCAL_RANK``),
    and the query runs on the mesh of every rank's slots."""
    from .parallel import distributed
    distributed.initialize(device=device)
    try:
        return fn(argv, device=device)
    except getopt.GetoptError as e:
        print(f"[E::main_{cmd}] {e}", file=sys.stderr)
        return 1


def main(argv=None, device=None) -> int:
    """Run one subcommand; ``view`` and ``server`` count on ``device``
    (default cuda)."""
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("Usage: bgt <command> <argument>\n"
              "Commands:\n"
              "  import       convert VCF to BGT\n"
              "  atomize      atomize VCF\n"
              "  view         extract from BGT\n"
              "  fmf          manipulate FMF files\n"
              "  bcfidx       (re)index BCF with record number index\n"
              "  server       run the query HTTP server\n"
              "  version      show version number", file=sys.stderr)
        return 1
    cmd, rest = argv[0], argv[1:]
    try:
        if cmd == "import":
            return main_import(rest)
        if cmd == "atomize":
            return main_atomize(rest)
        if cmd in ("view", "mview"):
            from .query.view import main_view
            return _device_cmd(cmd, main_view, rest, device)
        if cmd == "fmf":
            return main_fmf(rest)
        if cmd == "getalt":
            return main_getalt(rest)
        if cmd == "bcfidx":
            return main_bcfidx(rest)
        if cmd == "pbfview":
            return main_pbfview(rest)
        if cmd == "gtcshard":
            return main_gtcshard(rest)
        if cmd == "kexpr":
            return main_kexpr(rest)
        if cmd == "server":
            from .server.server import main_server
            return _device_cmd(cmd, main_server, rest, device)
        if cmd == "version":
            print(VERSION)
            return 0
    except BrokenPipeError:
        return 1
    except ZeroDivisionError:
        # the reference dies on SIGFPE here; a message is kinder
        print(f"[E::main_{cmd}] integer division by zero in expression",
              file=sys.stderr)
        return 1
    except (OSError, ValueError) as e:
        # bad inputs die with a message, not a traceback (the reference
        # prints [E::func] and exits, e.g. bgt.c:65-69)
        print(f"[E::main_{cmd}] {e}", file=sys.stderr)
        return 1
    print(f"[E::main] unrecognized command '{cmd}'", file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
