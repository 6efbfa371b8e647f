"""Randomized end-to-end parity soak: the port's device tier against an
oracle.

    python -m bgt_tpu_torch.tools.soak [seconds] [seed] [--device cuda]
                                       [--ref PATH]

The counterpart of ``tools/soak_parity.py``, with the same random cohorts
and query mix.  Each iteration generates a random cohort VCF (random shape,
multi-allelic/indel/missing/filter/phasing mix, optionally gzipped, as BCF,
or split over two files), imports it with the port and with the oracle
(every artifact byte-compared), then runs a random set of view queries
(regions, subsets, groups, filters, allele sets, -S/-H, tables, -b, paging)
through the port on ``device`` with the device tier forced
(``BGT_TPU_COUNT_TIER=device``, the memo cleared before each query) and
byte-compares each output with the oracle's.  A quarter of the iterations
query 2-3 databases jointly (the merge path).

The oracle answers "import these sources" and "view these args -> bytes":

- by default the port's host tier (``BGT_TPU_COUNT_TIER=host`` on the CPU
  device, its own import);
- with ``--ref PATH`` a built reference ``bgt`` binary, as the original;
- any object with the methods of :class:`Oracle` (the tests pass one that
  runs ``bgt_tpu`` in process).

Any divergence prints one repro line (the seed and the command that runs
that iteration alone) and exits 1.  ``seconds`` 0 runs one iteration.
"""

from __future__ import annotations

import argparse
import gzip
import io
import os
import random
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from bgt_tpu_torch import cli, testing
from bgt_tpu_torch.query import fastpath, importer
from bgt_tpu_torch.query.view import main_view


class Divergence(AssertionError):
    """The port's output or import differs from the oracle's."""

    def __init__(self, seed: int, what: str, detail):
        super().__init__(f"seed {seed}: {what} ({detail})")
        self.seed = seed


class _Bytes(io.TextIOBase):
    """A view's output, text and binary, as one byte string."""

    def __init__(self):
        self.buffer = io.BytesIO()

    def write(self, s):
        self.buffer.write(s.encode("latin-1"))
        return len(s)

    def value(self) -> bytes:
        return self.buffer.getvalue()


def port_view(args: list, cwd: Path, dbs: list, device, tier: str):
    """(exit code, output bytes) of the port's ``view`` in ``cwd`` on
    ``device`` with ``BGT_TPU_COUNT_TIER=tier`` and the memo cleared."""
    sink = _Bytes()
    old_dir, old_tier = os.getcwd(), os.environ.get("BGT_TPU_COUNT_TIER")
    os.environ["BGT_TPU_COUNT_TIER"] = tier
    fastpath._COUNT_MEMO.clear()
    os.chdir(cwd)
    try:
        ret = main_view(list(args) + list(dbs), out=sink, device=device)
    finally:
        os.chdir(old_dir)
        fastpath._COUNT_MEMO.clear()
        if old_tier is None:
            os.environ.pop("BGT_TPU_COUNT_TIER", None)
        else:
            os.environ["BGT_TPU_COUNT_TIER"] = old_tier
    return ret, sink.value()


class Oracle:
    """What the soak holds the port to.  This one is the port's host tier:
    its own import, and ``view`` on the CPU device counting on the host."""

    name = "the port's host tier"

    def import_(self, cwd: Path, prefix: str, srcs: list, is_vcf: bool,
                gen_pb1: bool) -> bool:
        """Import ``srcs`` (paths in ``cwd``; VCF text when ``is_vcf``, else
        BCF) into ``cwd/prefix``; False when the oracle refuses the input."""
        importer.import_vcf(str(cwd / prefix), [str(s) for s in srcs],
                            is_vcf=True if is_vcf else None, gen_pb1=gen_pb1)
        return True

    def view(self, cwd: Path, args: list, dbs: list) -> bytes | None:
        """The bytes of ``view args dbs`` in ``cwd``, or None when the
        oracle rejects the combination."""
        ret, out = port_view(args, cwd, dbs, "cpu", "host")
        return out if ret == 0 else None


class ReferenceOracle(Oracle):
    """A built reference ``bgt`` binary."""

    def __init__(self, exe: Path):
        self.exe = str(exe)
        self.name = f"the reference {exe}"

    def import_(self, cwd, prefix, srcs, is_vcf, gen_pb1):
        res = subprocess.run([self.exe, "import"] + (["-S"] if is_vcf else [])
                             + (["-1"] if gen_pb1 else [])
                             + [prefix] + [Path(s).name for s in srcs],
                             cwd=cwd, capture_output=True)
        if res.returncode != 0:
            # the reference aborts on some valid synthetic input (assert
            # atomic.c:25, seen at seed 25508): nothing to compare
            tail = (res.stderr.decode().splitlines() or [""])[-1][:90]
            print(f"[soak] reference import failed ({tail}); the port's "
                  "must still succeed", flush=True)
            return False
        return True

    def view(self, cwd, args, dbs):
        res = subprocess.run([self.exe, "view"] + list(args) + list(dbs),
                             cwd=cwd, capture_output=True)
        return res.stdout if res.returncode == 0 else None


def allele_keys(prefix: Path) -> list:
    buf = io.StringIO()
    if cli.main_getalt([str(prefix)], out=buf) != 0:
        raise RuntimeError(f"getalt {prefix} failed")
    return buf.getvalue().splitlines()


def compare(seed, what, oracle: Oracle, args, cwd, names, device):
    """The port's view of its databases ``our<name>`` against the oracle's
    of ``ref<name>``, when the oracle answers."""
    want = oracle.view(cwd, args, [f"ref{n}" for n in names])
    if want is None:
        return  # the oracle rejects the combination: nothing to compare
    ret, got = port_view(args, cwd, [f"our{n}" for n in names], device,
                         "device")
    if ret != 0:
        raise Divergence(seed, f"{what}: the port exited {ret}", args)
    if got != want:
        raise Divergence(seed, f"{what} divergence", args)


def multi_db_iter(rng, seed, tmp: Path, oracle: Oracle, device) -> None:
    """2-3 databases with distinct cohorts, queried jointly (the bgtm
    union-merge path)."""
    n_db = rng.randint(2, 3)
    names = []
    for d in range(n_db):
        n_samples = rng.randint(1, 40)
        vcf = testing.random_vcf(
            n_samples=n_samples, n_sites=rng.randint(20, 300),
            seed=seed * 7 + d, p_multi=rng.choice([0.0, 0.4]),
            p_indel=rng.choice([0.0, 0.3]),
            p_missing=rng.choice([0.0, 0.1]),
            sample_prefix=f"D{d}S")
        (tmp / f"in{d}.vcf").write_text(vcf)
        if not oracle.import_(tmp, f"ref{d}", [tmp / f"in{d}.vcf"], True,
                              False):
            return
        importer.import_vcf(str(tmp / f"our{d}"),
                            [str(tmp / f"in{d}.vcf")], is_vcf=True)
        names.append(d)
    for _q in range(4):
        args = []
        if rng.random() < 0.4:
            lo = rng.randint(1, 100_000_000)
            args += ["-r", f"11:{lo}-{lo + rng.randint(10_000, 60_000_000)}"]
        if rng.random() < 0.4:
            args += rng.choice([["-G"], ["-C"], ["-G", "-C"]])
        if rng.random() < 0.3:
            args += ["-f", rng.choice(["AC>0", "AN>2", "AC!=AN"])]
        if rng.random() < 0.25:
            args += ["-n", str(rng.randint(0, 200))]
        compare(seed, "multi-db", oracle, args, tmp, names, device)


def one_iter(seed: int, oracle: Oracle, device) -> None:
    rng = random.Random(seed)
    with tempfile.TemporaryDirectory() as td:
        tmp = Path(td)
        if rng.random() < 0.25:
            multi_db_iter(rng, seed, tmp, oracle, device)
            return
        n_samples = rng.randint(1, 120)
        n_sites = rng.randint(20, 800)
        kw = dict(
            n_samples=n_samples, n_sites=n_sites, seed=seed,
            p_multi=rng.choice([0.0, 0.1, 0.4, 0.7]),
            p_indel=rng.choice([0.0, 0.2, 0.5]),
            p_missing=rng.choice([0.0, 0.05, 0.3]),
            phased=rng.random() < 0.8,
            with_filter=rng.random() < 0.5,
        )
        vcf = testing.random_vcf(**kw)
        gen_pb1 = rng.random() < 0.2
        mode = rng.random()
        is_vcf = True
        ref_vcf = True
        if mode < 0.15:
            # binary BCF input (the native BCF front-end)
            src = tmp / "in.bcf"
            testing.vcf_text_to_bcf(vcf, str(src))
            srcs = ref_srcs = [src]
            is_vcf = ref_vcf = None
        elif mode < 0.30 and n_sites >= 6:
            # multi-file append (position-sorted split)
            head = [ln for ln in vcf.splitlines() if ln.startswith("#")]
            body = [ln for ln in vcf.splitlines()
                    if ln and not ln.startswith("#")]
            half = rng.randint(1, len(body) - 1)
            (tmp / "p1.vcf").write_text("\n".join(head + body[:half]) + "\n")
            (tmp / "p2.vcf").write_text("\n".join(head + body[half:]) + "\n")
            srcs = ref_srcs = [tmp / "p1.vcf", tmp / "p2.vcf"]
            if rng.random() < 0.4:
                # mixed append: the port's second file as BCF
                testing.vcf_text_to_bcf("\n".join(head + body[half:]) + "\n",
                                        str(tmp / "p2.bcf"))
                srcs = [tmp / "p1.vcf", tmp / "p2.bcf"]
                is_vcf = None
        else:
            src = tmp / "in.vcf"
            if rng.random() < 0.3:
                src = tmp / "in.vcf.gz"
                with gzip.open(src, "wt") as fp:
                    fp.write(vcf)
            else:
                src.write_text(vcf)
            srcs = ref_srcs = [src]
        ok = oracle.import_(tmp, "refdb", ref_srcs, ref_vcf, gen_pb1)
        importer.import_vcf(str(tmp / "ourdb"), [str(s) for s in srcs],
                            is_vcf=is_vcf, gen_pb1=gen_pb1)
        if not ok:
            return
        exts = [".bcf", ".pbf", ".spl", ".bcf.csi"] \
            + ([".pb1"] if gen_pb1 else [])
        for ext in exts:
            if (tmp / f"ourdb{ext}").read_bytes() != \
                    (tmp / f"refdb{ext}").read_bytes():
                raise Divergence(seed, f"import {ext} divergence", kw)
        spl = testing.random_spl(n_samples, seed=seed)
        (tmp / "ourdb.spl").write_text(spl)
        (tmp / "refdb.spl").write_text(spl)
        keys = allele_keys(tmp / "ourdb")

        def rand_query():
            args = []
            if rng.random() < 0.4:
                lo = rng.randint(1, 130_000_000)
                args += ["-r", f"11:{lo}-{lo + rng.randint(1000, 40_000_000)}"]
            if rng.random() < 0.35 and n_samples >= 3:
                picks = rng.sample(range(n_samples),
                                   rng.randint(1, min(5, n_samples)))
                args += ["-s", "," + ",".join(f"S{i:04d}" for i in picks)]
            elif rng.random() < 0.3:
                args += ["-s", 'population=="CEU"']
                if rng.random() < 0.5:
                    args += ["-s", 'gender=="M"']
            if rng.random() < 0.35:
                # group-indexed vars (AC1/AN1) only with explicit groups:
                # without -s the reference reads uninitialized memory for
                # them (bgt.c:706 vs 740)
                pool = ["AC>0", "AN>1&&AC*2<AN", "AC!=AN"]
                if args.count("-s") >= 2:
                    pool += ["AC1>=0", "AC1*3<AN1", "AC2>=0"]
                args += ["-f", rng.choice(pool)]
            if rng.random() < 0.3 and keys:
                pick = rng.sample(keys, rng.randint(1, min(12, len(keys))))
                args += ["-a," + ",".join(pick)]
                if rng.random() < 0.5:
                    args += rng.choice([["-S"], ["-H"], ["-S", "-H"]])
            if rng.random() < 0.3:
                args += rng.choice([["-G"], ["-C"], ["-G", "-C"]])
            if rng.random() < 0.25:
                args += ["-i", str(rng.randint(1, max(1, n_sites // 2)))]
            if rng.random() < 0.25:
                args += ["-n", str(rng.randint(0, n_sites))]
            if rng.random() < 0.15:
                tpool = ["AC,AN", "CHROM,POS,AC", "POS,END,REF"]
                if args.count("-s") >= 2:  # AC1 with <2 groups: ref uninit
                    tpool.append("POS,AC1")
                args += ["-t", rng.choice(tpool)]
            if rng.random() < 0.1:
                args += ["-M"]
            return args

        for _q in range(5):
            args = rand_query()
            if rng.random() < 0.15 and "-t" not in args:
                args = [a for a in args if a not in ("-S", "-H")] + ["-b"]
            compare(seed, "query", oracle, args, tmp, ["db"], device)


def run(budget: float, seed0: int, device="cuda", oracle: Oracle | None = None,
        repro: str = "") -> int:
    """Iterations from ``seed0`` until ``budget`` seconds have passed (at
    least one); 0 when no divergence, else 1 after the repro line.
    ``repro`` is appended to the repro command (the device and oracle)."""
    oracle = oracle or Oracle()
    t0 = time.time()
    i = 0
    while i == 0 or time.time() - t0 < budget:
        seed = seed0 + i
        try:
            one_iter(seed, oracle, device)
        except Divergence as e:
            print(f"[soak] DIVERGENCE against {oracle.name}: {e}; repro: "
                  f"python -m bgt_tpu_torch.tools.soak 0 {seed}{repro}",
                  flush=True)
            return 1
        except Exception:
            print(f"[soak] ERROR at seed {seed}; repro: python -m "
                  f"bgt_tpu_torch.tools.soak 0 {seed}{repro}", flush=True)
            raise
        i += 1
        if i % 10 == 0:
            print(f"[soak] {i} iters, {time.time() - t0:.0f}s", flush=True)
    print(f"[soak] PASS: {i} iterations, no divergence from {oracle.name} "
          f"(seed0={seed0}, device {device})", flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("seconds", nargs="?", type=float, default=300)
    ap.add_argument("seed", nargs="?", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the port's device tier")
    ap.add_argument("--ref", type=Path, metavar="PATH",
                    help="a built reference bgt binary as the oracle")
    args = ap.parse_args(argv)
    import torch
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        print("soak: no CUDA device (use --device cpu)", file=sys.stderr)
        return 2
    seed0 = args.seed if args.seed is not None else int(time.time())
    repro = f" --device {args.device}"
    oracle = None
    if args.ref is not None:
        oracle = ReferenceOracle(args.ref.resolve())
        repro += f" --ref {args.ref}"
    return run(args.seconds, seed0, args.device, oracle, repro)


if __name__ == "__main__":
    sys.exit(main())
