"""The port's benchmark: ``bench.py``'s queries on the card, gated without a
C reference.

    python -m bgt_tpu_torch.tools.bench [--device cuda] [--ref PATH]
    python -m bgt_tpu_torch.tools.bench --write-pins   # where bgt_tpu runs

The counterpart of ``bench.py`` (which stays ``bgt_tpu``'s).  Two databases,
built once and cached under ``build/bench_torch/`` behind stamps (never
``bench.py``'s ``build/bench/``), from the port's own ``testing``:

- 1kg11: 2,504 samples x 100k sites, seed 1337 (the canonical 1kg-chr11
  shape; 105,730 rows x 157 words);
- hrc: 32,488 samples x 30k sites, seed 2026 (HRC-shaped: the wide sample
  axis; ~31,716 rows x 2,031 words);

and, unless ``BGT_TPU_BENCH_FULL=0``, the HRC-scale block (``hrc_full``:
32,488 x 1M, a ~17 GB tile, its cohort drawn by
``testing.synth_gt_bcf_sparse_to_file``, and 1 x 39.2M sites).

Gates, each fatal: a failed gate or an exception in any block ends the run
with a nonzero exit and prints no JSON line.

- Every query's md5 equals the port's host tier's on the same database
  (``BGT_TPU_COUNT_TIER=host``, memo cleared), and the pin in
  ``bench_pins.json``: the md5 of ``bgt_tpu``'s CLI on that query, run as a
  subprocess by ``--write-pins``.  The import's files equal their pins too.
  ``hrc_full`` is too large for the CPU that writes the pins: it is gated
  on the host tier alone, and its JSON says so.
- With ``--ref PATH`` (a built reference ``bgt``) every md5 and the import's
  bytes must also equal the reference's, and the reference columns
  (``*_ref_s``, ``gc_speedup``, ``vs_baseline``) are timed; without it
  they are null.  The tool never builds the reference.

Every counted step records the tier that answered it (``fastpath.TIERS``:
rowstats, memo, host, device, stream, mesh) and kernel A's launches
(``counts.LAUNCHES``).  ``-G -C`` over all samples is answered by rowstats
and never reaches the card.  On CUDA a step that reached a device tier and
launched no A fails the run.

The card's blocks (CUDA only): the card tests (``BGT_TPU_DEVICE_TESTS=0``
skips them), kernel A's device time on the widest tile at 1 and 32 masks
beside its bytes bound, and ``bench_scaling``.  Prints one JSON line:
``{"metric", "value", "unit", "vs_baseline", "extra", "device"}``, the
value being the primary configuration's warm ``-G -C`` sites/s.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bgt_tpu_torch import cli, testing
from bgt_tpu_torch.ops import counts
from bgt_tpu_torch.ops.tiles import TileStore
from bgt_tpu_torch.query import engine, fastpath, importer
from bgt_tpu_torch.query.view import main_view
from bgt_tpu_torch.tools import measure

REPO = Path(__file__).resolve().parents[2]
BENCH_DIR = REPO / "build" / "bench_torch"
PINS_PATH = Path(__file__).with_name("bench_pins.json")

# the first configuration is the primary: its warm -G -C is the headline,
# and it alone runs the BCF-input import, the annotation join over
# ``anno_rows`` FMF filler rows, and the multi-database merge
CONFIGS = {
    "1kg11": dict(n_samples=2504, n_sites=100_000, seed=1337,
                  anno_rows=5_000_000),
    "hrc": dict(n_samples=32_488, n_sites=30_000, seed=2026),
}

HRC_FULL_CFGS = {
    # true-HRC sample width, 1M sites: a ~17 GB tile, resident on an 80 GB
    # card; the subset is also timed with the device budget below the tile,
    # where it streams row chunks (fastpath.stream_counts).  Its cohort is
    # drawn hit-only: the dense draws of synth_gt_bcf_to_file cost most of
    # its 489 chunks at this width
    "full": dict(n_samples=32488, n_sites=1_000_000, seed=2601,
                 gen="synth_gt_bcf_sparse_to_file"),
    # true-HRC site count (39.2M rows): the site table, the CSI build and
    # RNI paging at the real scale
    "site39m": dict(n_samples=1, n_sites=39_200_000, seed=2602,
                    gen="synth_gt_bcf_to_file"),
}
HRC_FULL_REGION = "11:10000001-20000000"

MULTIDB_REGION = "11:10000000-60000000"
MULTIDB_QUERIES = {
    "merge_gc": ["-G", "-C"],
    "merge_region_flt": ["-G", "-C", "-r", MULTIDB_REGION, "-f", "AC>10"],
}
IMPORT_EXTS = (".bcf", ".bcf.csi", ".pbf", ".spl")
N_GROUPS = 8
DEVICE_TILE_REPS = 20


_T0 = time.perf_counter()


def log(*a) -> None:
    """A progress line on stderr, with the seconds since the bench started:
    a run cut short by a time limit still shows how far it got."""
    print(f"[bench +{time.perf_counter() - _T0:.0f}s]", *a, file=sys.stderr,
          flush=True)


def log_block(extra: dict, name: str) -> None:
    log(f"block {name}: {json.dumps(extra[name])}")


class GateError(RuntimeError):
    """An output differs from what it is held to."""


def queries(primary: bool) -> dict:
    """Each gated query of a configuration, run in its directory on
    ``ourdb`` (the reference's and the pins' on ``refdb``)."""
    q = {"gc": ["-G", "-C"],
         "alcnt": ["-a", "alleles.txt", "-S", "-H"],
         "subset": ["-G", "-C", "-s", "subset.txt"],
         "groups8": ["-G", "-C"] + [a for k in range(N_GROUPS)
                                    for a in ("-s", f"group{k}.txt")]}
    if primary:
        q["anno"] = ["-d", "anno.fmf", "-a", 'impact=="HIGH"&&csq>11',
                     "-G", "-C"]
    q["bcf"] = ["-b"]
    q["dump"] = ["-C"]
    return q


def cfg_key(name: str, cfg: dict) -> str:
    return f"{name}-{cfg['n_samples']}x{cfg['n_sites']}-{cfg['seed']}"


def file_md5(path: Path) -> str:
    h = hashlib.md5()
    with open(path, "rb") as fp:
        for blk in iter(lambda: fp.read(1 << 24), b""):
            h.update(blk)
    return h.hexdigest()


# --- sinks -------------------------------------------------------------------

class _Null(io.TextIOBase):
    """Line-counting sink with a binary buffer (like a real stdout)."""

    def __init__(self):
        self.n = 0

        class B:
            def write(b, data):
                return len(data)  # timing sink: no byte scans on GB chunks

            def flush(b):
                pass

        self.buffer = B()

    def write(self, s):
        self.n += s.count("\n")
        return len(s)


class _FileSink(io.TextIOBase):
    """Text and the binary buffer into one open binary file."""

    def __init__(self, fp):
        self.buffer = fp

    def write(self, s):
        self.buffer.write(s.encode("latin-1"))
        return len(s)


class _Md5Sink(io.TextIOBase):
    def __init__(self):
        self.h = hashlib.md5()
        self.n = 0
        outer = self

        class B:
            def write(b, data):
                outer.h.update(data)
                outer.n += int(np.count_nonzero(
                    np.frombuffer(data, np.uint8) == 10))
                return len(data)

            def flush(b):
                pass

        self.buffer = B()

    def write(self, s):
        self.h.update(s.encode("latin-1"))
        self.n += s.count("\n")
        return len(s)


# --- the port's views --------------------------------------------------------

def view(d: Path, args: list, device, dbs=("ourdb",), sink=None):
    """One ``view`` through the port in ``d``: (sink, seconds)."""
    sink = _Md5Sink() if sink is None else sink
    old = os.getcwd()
    os.chdir(d)
    try:
        t0 = time.perf_counter()
        rc = main_view(list(args) + list(dbs), out=sink, device=device)
        dt = time.perf_counter() - t0
    finally:
        os.chdir(old)
    if rc != 0:
        raise RuntimeError(f"view {args} in {d} exited {rc}")
    return sink, dt


def counted(fn):
    """``fn()``'s result, the count tiers that answered it (nonzero deltas
    of ``fastpath.TIERS``) and kernel A's launches."""
    tiers0 = dict(fastpath.TIERS)
    launches0 = counts.LAUNCHES["count_codes"]
    res = fn()
    tiers = {k: v - tiers0[k] for k, v in fastpath.TIERS.items()
             if v != tiers0[k]}
    return res, tiers, counts.LAUNCHES["count_codes"] - launches0


def set_env(**kv) -> None:
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def host_md5(d: Path, args: list, device, dbs=("ourdb",)) -> str:
    """md5 of the query on the port's host tier, memo cleared."""
    old = os.environ.get("BGT_TPU_COUNT_TIER")
    set_env(BGT_TPU_COUNT_TIER="host")
    fastpath._COUNT_MEMO.clear()
    try:
        return view(d, args, device, dbs)[0].h.hexdigest()
    finally:
        set_env(BGT_TPU_COUNT_TIER=old)
        fastpath._COUNT_MEMO.clear()


class Step:
    """The timed, counted runs of one configuration: each step's seconds,
    tiers and A launches go into ``ex``."""

    def __init__(self, ex: dict, device: torch.device):
        self.ex = ex
        self.device = device
        ex.setdefault("tiers", {})
        ex.setdefault("launches", {})

    def __call__(self, name: str, d: Path, args: list, dbs=("ourdb",),
                 md5: bool = False, clear_memo: bool = False):
        """Run the query once as step ``name``: (its md5, or None without
        ``md5``; seconds).  ``self.lines``: the md5 run's output lines."""
        if clear_memo:
            fastpath._COUNT_MEMO.clear()
        (sink, dt), tiers, launches = counted(
            lambda: view(d, args, self.device, dbs,
                         None if md5 else _Null()))
        self.ex["tiers"][name] = tiers
        self.ex["launches"][name] = launches
        if (self.device.type == "cuda" and launches == 0
                and tiers.keys() & {"device", "stream", "mesh"}):
            raise RuntimeError(f"step {name} reached the device tier "
                               f"{tiers} but launched no kernel A")
        if not md5:
            return None, dt
        self.lines = sink.n
        return sink.h.hexdigest(), dt

    def best(self, name: str, d: Path, args: list, runs: int,
             dbs=("ourdb",)) -> float:
        """The least seconds of ``runs`` runs (steps ``name_0``, ...)."""
        return min(self(f"{name}_{i}", d, args, dbs)[1] for i in range(runs))


def need_device_pass(ex: dict, step: str) -> None:
    """A step that must have counted on the card (CUDA only)."""
    tiers = ex["tiers"][step]
    if not tiers.keys() & {"device", "stream", "mesh"} \
            or ex["launches"][step] < 1:
        raise RuntimeError(f"step {step}: tiers {tiers}, "
                           f"{ex['launches'][step]} launches of kernel A; "
                           "expected the card")


# --- a reference command line ------------------------------------------------

class Reference:
    """A ``bgt`` command line to hold the port to: a built reference binary
    (``--ref``), or ``bgt_tpu``'s CLI in a subprocess (``--write-pins``)."""

    def __init__(self, cmd: list, env: dict | None = None):
        self.cmd = list(cmd)
        self.env = env

    def run(self, d: Path, args: list, stdout=subprocess.DEVNULL) -> None:
        subprocess.run(self.cmd + list(args), cwd=d, env=self.env,
                       stdout=stdout, stderr=subprocess.PIPE, check=True)

    def md5(self, d: Path, args: list) -> str:
        h = hashlib.md5()
        with subprocess.Popen(self.cmd + ["view"] + list(args), cwd=d,
                              env=self.env, stdout=subprocess.PIPE) as p:
            for blk in iter(lambda: p.stdout.read(1 << 20), b""):
                h.update(blk)
        if p.returncode != 0:
            raise RuntimeError(f"reference view {args} exited {p.returncode}")
        return h.hexdigest()

    def time(self, d: Path, args: list, runs: int = 1) -> float:
        best = float("inf")
        for _ in range(runs):
            t0 = time.perf_counter()
            self.run(d, ["view"] + list(args))
            best = min(best, time.perf_counter() - t0)
        return best

    def import_(self, d: Path, prefix: str, inputs: list,
                vcf: bool) -> float:
        t0 = time.perf_counter()
        self.run(d, ["import"] + (["-S"] if vcf else []) + [prefix]
                 + list(inputs))
        return time.perf_counter() - t0


def bgt_tpu_reference() -> Reference:
    """``bgt_tpu``'s CLI on JAX-CPU, in a subprocess (never imported)."""
    return Reference([sys.executable, "-m", "bgt_tpu.cli"],
                     {**os.environ, "PYTHONPATH": str(REPO),
                      "JAX_PLATFORMS": "cpu"})


# --- databases and inputs ----------------------------------------------------

def ensure_db(bench_dir: Path, name: str, cfg: dict, primary: bool) -> dict:
    """The configuration's cohort VCF and the port's import of it, built
    once behind a stamp; returns the import's metadata."""
    d = bench_dir / name
    d.mkdir(parents=True, exist_ok=True)
    tag = f"{cfg['n_samples']}x{cfg['n_sites']}-{cfg['seed']}"
    stamp = d / f"stamp-{tag}"
    if stamp.exists():
        return json.loads(stamp.read_text())
    gen_stamp = d / f"genstamp-{tag}"
    if not gen_stamp.exists():
        log(f"[{name}] generating cohort VCF ({cfg['n_samples']} samples x "
            f"{cfg['n_sites']} sites)...")
        t0 = time.perf_counter()
        if primary:  # cohort_vcf, as bench.py makes its primary cohort
            (d / "in.vcf").write_text(testing.cohort_vcf(
                n_samples=cfg["n_samples"], n_sites=cfg["n_sites"],
                seed=cfg["seed"]))
        else:
            testing.cohort_vcf_to_file(str(d / "in.vcf"),
                                       n_samples=cfg["n_samples"],
                                       n_sites=cfg["n_sites"],
                                       seed=cfg["seed"])
        log(f"[{name}] generated in {time.perf_counter() - t0:.1f} s "
            f"({(d / 'in.vcf').stat().st_size / 1e9:.2f} GB)")
        gen_stamp.write_text("ok")
    # warm the input's page cache, so that the import is not timed on a cold
    # file (the reference's, when there is one, would find it warm)
    buf = bytearray(32 << 20)
    with open(d / "in.vcf", "rb", buffering=0) as fp:
        while fp.readinto(buf):
            pass
    t0 = time.perf_counter()
    n = importer.import_vcf(str(d / "ourdb"), [str(d / "in.vcf")],
                            is_vcf=True)
    meta = {"import_ours_s": time.perf_counter() - t0, "n_rows": n}
    log(f"[{name}] our import: {n} rows in {meta['import_ours_s']:.2f} s")
    stamp.write_text(json.dumps(meta))
    return meta


def ensure_inputs(d: Path, cfg: dict, primary: bool) -> None:
    """The queries' input files, from the port's own database: 40 allele
    keys (``getalt``), a third of the samples, eight groups of an eighth,
    and for the primary the annotation FMF (every key, then ``anno_rows``
    filler rows)."""
    keys = None

    def allele_keys():
        buf = io.StringIO()
        if cli.main_getalt([str(d / "ourdb")], out=buf) != 0:
            raise RuntimeError("getalt failed")
        return buf.getvalue().splitlines()

    if not (d / "alleles.txt").exists():
        keys = keys or allele_keys()
        (d / "alleles.txt").write_text("\n".join(keys[10:90:2]) + "\n")
    names = [ln.split("\t")[0] for ln in
             (d / "ourdb.spl").read_text().splitlines() if ln]
    if not (d / "subset.txt").exists():
        (d / "subset.txt").write_text("\n".join(names[::3]) + "\n")
    for k in range(N_GROUPS):
        if not (d / f"group{k}.txt").exists():
            (d / f"group{k}.txt").write_text(
                "\n".join(names[k::N_GROUPS]) + "\n")
    if primary and not (d / "anno.fmf").exists():
        keys = keys or allele_keys()
        imp = ["HIGH", "LOW", "MODERATE", "MODIFIER"]
        with open(d / "anno.fmf.tmp", "w") as fp:
            for i, k in enumerate(keys):
                fp.write(f"{k}\timpact:Z:{imp[i % 4]}\tcsq:i:{i % 23}\n")
            for i in range(cfg["anno_rows"]):  # genome-scale filler rows
                fp.write(f"99:{i + 1}:1:N\timpact:Z:{imp[(i + 1) % 4]}"
                         f"\tcsq:i:{i % 23}\n")
        os.replace(d / "anno.fmf.tmp", d / "anno.fmf")


def split_halves(src: Path, d: Path, n_samples: int) -> None:
    """The cohort VCF ``src`` split into two sample halves ``a.vcf`` and
    ``b.vcf`` (the multi-database merge's inputs)."""
    cut_col = 9 + n_samples // 2  # fixed VCF columns + the first half
    with open(src, "rb") as fin, \
            open(d / "a.vcf", "wb") as fa, open(d / "b.vcf", "wb") as fb:
        for line in fin:
            if line.startswith(b"##"):
                fa.write(line)
                fb.write(line)
                continue
            tabs = np.nonzero(np.frombuffer(line, np.uint8) == 9)[0]
            head_end = int(tabs[8])
            cut = int(tabs[cut_col - 1])
            fa.write(line[:cut])
            fa.write(b"\n")
            fb.write(line[:head_end])
            fb.write(line[cut:])


# --- pins --------------------------------------------------------------------

def write_pins(configs: dict, bench_dir: Path, path: Path) -> dict:
    """Run ``bgt_tpu``'s CLI (a subprocess on JAX-CPU) on every gated query
    and import of ``configs`` and write their md5s to ``path``."""
    ref = bgt_tpu_reference()
    pins = {}
    names = list(configs)
    for name in names:
        cfg = configs[name]
        primary = name == names[0]
        d = bench_dir / name
        ensure_db(bench_dir, name, cfg, primary)
        ensure_inputs(d, cfg, primary)
        log(f"[pins] {name}: bgt_tpu import")
        ref.import_(d, "refdb", ["in.vcf"], vcf=True)
        entry = {"import": {e: file_md5(d / f"refdb{e}")
                            for e in IMPORT_EXTS}, "views": {}}
        for q, args in queries(primary).items():
            entry["views"][q] = ref.md5(d, args + ["refdb"])
            log(f"[pins] {name} {q}: {entry['views'][q]}")
        if primary:
            with open(d / "in_gt_ref.bcf", "wb") as fp:
                ref.run(d, ["view", "-b", "-C", "refdb"], stdout=fp)
            ref.import_(d, "refdb_b", ["in_gt_ref.bcf"], vcf=False)
            entry["import_bcf"] = {".pbf": file_md5(d / "refdb_b.pbf")}
            md = bench_dir / "multidb"
            md.mkdir(exist_ok=True)
            split_halves(d / "in.vcf", md, cfg["n_samples"])
            for half in ("a", "b"):
                ref.import_(md, f"ref_{half}", [f"{half}.vcf"], vcf=True)
            pins["multidb:" + cfg_key(name, cfg)] = {"views": {
                q: ref.md5(md, args + ["ref_a", "ref_b"])
                for q, args in MULTIDB_QUERIES.items()}}
        pins[cfg_key(name, cfg)] = entry
    path.write_text(json.dumps(pins, indent=1, sort_keys=True) + "\n")
    return pins


def pinned(pins: dict, key: str, part: str, name: str) -> str:
    try:
        return pins[key][part][name]
    except KeyError:
        raise GateError(f"no pin for {key} {part} {name}") from None


def gate(what: str, got: str, want: str, against: str) -> None:
    if got != want:
        raise GateError(f"{what}: md5 {got} != {against} {want}")


# --- one configuration -------------------------------------------------------

def time_ours_cold(d: Path, args: list, device) -> dict:
    """TRUE cold: the query in a fresh interpreter after its imports (the
    tile's load included, and where the query reaches the card the CUDA
    context, the kernel library's load and the tile's H2D; the kernels are
    built beforehand, so no nvcc).  Its seconds, tiers, A launches and
    whether a CUDA context was made."""
    script = (
        "import io, json, os, sys, time\n"
        f"sys.path.insert(0, {str(REPO)!r})\n"
        f"os.chdir({str(d)!r})\n"
        "import torch\n"
        "from bgt_tpu_torch.ops import counts\n"
        "from bgt_tpu_torch.query import fastpath\n"
        "from bgt_tpu_torch.query.view import main_view\n"
        "class N(io.TextIOBase):\n"
        "    def write(self, s): return len(s)\n"
        "t0 = time.perf_counter()\n"
        f"assert main_view({list(args)!r} + ['ourdb'], out=N(), "
        f"device={str(device)!r}) == 0\n"
        "dt = time.perf_counter() - t0\n"
        "print('COLD ' + json.dumps({'s': dt, 'tiers': {k: v for k, v in "
        "fastpath.TIERS.items() if v}, 'launches': "
        "counts.LAUNCHES['count_codes'], 'cuda_context': "
        "torch.cuda.is_initialized()}))\n"
    )
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, check=True)
    for line in out.stdout.splitlines():
        if line.startswith("COLD "):
            return json.loads(line[5:])
    raise RuntimeError("cold run produced no timing")


def _timed_subprocess(cmd) -> float:
    t0 = time.perf_counter()
    subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL,
                   stderr=subprocess.DEVNULL)
    return time.perf_counter() - t0


def cold_floors(floors: dict) -> dict:
    """The structural floors of a cold query, measured once a run into
    ``floors``: a fresh interpreter importing numpy (bench.py's
    ``cold_floor_s``) and importing torch, which the port's CLI must."""
    if not floors:
        for key, mod in (("cold_floor_s", "numpy"),
                         ("cold_floor_torch_s", "torch")):
            floors[key] = min(_timed_subprocess(
                [sys.executable, "-c", f"import {mod}"]) for _ in range(3))
    return floors


def bench_config(name: str, cfg: dict, primary: bool, extra: dict,
                 device: torch.device, pins: dict, bench_dir: Path,
                 ref: Reference | None,
                 floors: dict) -> tuple[float, float | None]:
    """bench.py's ``bench_config`` and its subset step on the port; returns
    (warm -G -C sites/s, its speed-up over the reference or None)."""
    d = bench_dir / name
    meta = ensure_db(bench_dir, name, cfg, primary)
    ensure_inputs(d, cfg, primary)
    key = cfg_key(name, cfg)
    ex = extra.setdefault(name, {})
    ex["shape"] = f"{cfg['n_samples']}x{cfg['n_sites']}"
    ex["n_rows"] = meta["n_rows"]
    ex["import_ours_s"] = meta["import_ours_s"]
    ex["import_ref_s"] = None
    ex["gate"] = {"host_tier": True, "pins": True, "ref": ref is not None}
    step = Step(ex, device)

    for e in IMPORT_EXTS:
        gate(f"[{name}] import {e}", file_md5(d / f"ourdb{e}"),
             pinned(pins, key, "import", e), "pin")
    if ref is not None:
        ex["import_ref_s"] = ref.import_(d, "refdb", ["in.vcf"], vcf=True)
        for e in (".bcf", ".pbf"):
            gate(f"[{name}] import {e}", file_md5(d / f"ourdb{e}"),
                 file_md5(d / f"refdb{e}"), "reference")
    ex["parity_import"] = True

    if primary:
        # BCF-format input (the native BCF front-end), made by the port's
        # own `view -b -C`
        bcf_in = d / "in_gt.bcf"
        if not bcf_in.exists():
            with open(str(bcf_in) + ".tmp", "wb") as fp:
                view(d, ["-b", "-C"], device, sink=_FileSink(fp))
            os.replace(str(bcf_in) + ".tmp", bcf_in)
        t0 = time.perf_counter()
        importer.import_vcf(str(d / "ourdb_b"), [str(bcf_in)])
        ex["import_bcf_ours_s"] = time.perf_counter() - t0
        gate(f"[{name}] BCF-input import .pbf", file_md5(d / "ourdb_b.pbf"),
             pinned(pins, key, "import_bcf", ".pbf"), "pin")
        ex["import_bcf_ref_s"] = None
        if ref is not None:
            ex["import_bcf_ref_s"] = ref.import_(d, "refdb_b", ["in_gt.bcf"],
                                                 vcf=False)
            gate(f"[{name}] BCF-input import .pbf",
                 file_md5(d / "ourdb_b.pbf"), file_md5(d / "refdb_b.pbf"),
                 "reference")
        ex["parity_import_bcf"] = True
        log(f"[{name}] BCF-input import: {ex['import_bcf_ours_s']:.2f} s")

    # the gate: every query under the caller's tier (its first run), the
    # port's host tier, the pin and, with --ref, the reference
    ex["md5"] = {}
    qs = queries(primary)
    for q, args in qs.items():
        want = pinned(pins, key, "views", q)
        host = host_md5(d, args, device)
        gate(f"[{name}] {q} host tier", host, want, "pin")
        if q == "subset":  # its first run is the first device touch
            fastpath._DEVICE_CACHE.clear()
        got, dt = step(f"{q}_first", d, args, md5=True, clear_memo=True)
        gate(f"[{name}] {q}", got, host, "host tier")
        if ref is not None:
            gate(f"[{name}] {q}", got, ref.md5(d, args + ["refdb"]),
                 "reference")
        ex["md5"][q] = got
        ex[f"parity_{q}"] = True
        log(f"[{name}] {q}: md5 {got} (host tier, pin"
            + (", reference" if ref is not None else "") + ")")
        if q == "subset":
            # first (the tile's H2D included, under auto), memoized, and
            # the device pass with the memo cleared
            ex["subset_first_s"] = dt
            ex["subset_repeat_s"] = step("subset_repeat", d, args)[1]
            ex["subset_device_s"] = step("subset_device", d, args,
                                         clear_memo=True)[1]

    # --- the counting query (rowstats: the card is not used) ---
    runs = 3 if primary else 2
    t_warm = step.best("gc_warm", d, ["-G", "-C"], runs)
    n_sites = meta["n_rows"]
    ex["gc_warm_s"] = t_warm
    ex["gc_ref_s"] = ref.time(d, ["-G", "-C", "refdb"], runs) if ref else None
    ex["gc_speedup"] = ex["gc_ref_s"] / t_warm if ref else None
    cold = time_ours_cold(d, ["-G", "-C"], device)
    ex["gc_cold_s"] = cold["s"]
    ex["cold"] = {k: cold[k] for k in ("tiers", "launches", "cuda_context")}
    # rowstats answers -G -C cold without the card; the subset's cold run
    # is the first request that reaches it (the CUDA context, the kernel
    # library's load, the tile's H2D and kernel A)
    cold_sub = time_ours_cold(d, qs["subset"], device)
    ex["subset_cold_s"] = cold_sub["s"]
    ex["subset_cold"] = {k: cold_sub[k]
                         for k in ("tiers", "launches", "cuda_context")}
    if device.type == "cuda" and not (cold_sub["cuda_context"]
                                      and cold_sub["launches"] >= 1):
        raise RuntimeError(f"[{name}] the cold subset did not reach the "
                           f"card: {ex['subset_cold']}")
    ex.update(cold_floors(floors))
    log(f"[{name}] view -G -C: warm {t_warm:.4f} s ({n_sites / t_warm:,.0f} "
        f"sites/s, tiers {ex['tiers']['gc_warm_0']}), cold {cold['s']:.3f} s "
        f"(CUDA context: {cold['cuda_context']}); subset cold "
        f"{cold_sub['s']:.3f} s ({cold_sub['tiers']}, A +"
        f"{cold_sub['launches']}, CUDA context: {cold_sub['cuda_context']});"
        f" floor numpy {ex['cold_floor_s']:.3f} s, torch "
        f"{ex['cold_floor_torch_s']:.3f} s")

    # --- -S carrier query over a 40-allele set ---
    s_args = qs["alcnt"]
    t_s = min(step(f"alcnt_{i}", d, s_args)[1] for i in range(2))
    ex["alcnt_ours_s"] = t_s
    ex["alcnt_ref_s"] = ref.time(d, s_args + ["refdb"]) if ref else None
    log(f"[{name}] -S/-H carrier query (40 alleles): {t_s:.3f} s")

    # --- sample subset: first, memoized and device (timed above) ---
    sub = qs["subset"]
    ex["subset_ref_s"] = ref.time(d, sub + ["refdb"]) if ref else None
    if device.type == "cuda":
        need_device_pass(ex, "subset_device")
    log(f"[{name}] subset -G -C: first {ex['subset_first_s']:.4f} s (tiers "
        f"{ex['tiers']['subset_first']}), memoized "
        f"{ex['subset_repeat_s']:.4f} s ({ex['tiers']['subset_repeat']}), "
        f"device {ex['subset_device_s']:.4f} s "
        f"({ex['tiers']['subset_device']}, A +"
        f"{ex['launches']['subset_device']})")

    # --- eight groups: kernel A at 8 groups ---
    ex["groups8_s"] = step("groups8", d, qs["groups8"], clear_memo=True)[1]
    ex["groups8_ref_s"] = (ref.time(d, qs["groups8"] + ["refdb"]) if ref
                           else None)
    if device.type == "cuda":
        need_device_pass(ex, "groups8")
    log(f"[{name}] eight groups -G -C: {ex['groups8_s']:.4f} s (tiers "
        f"{ex['tiers']['groups8']}, A +{ex['launches']['groups8']})")

    # --- annotation-driven query over the genome-scale FMF ---
    if primary:
        # the first run pays page faults on the FMF
        ex["anno_ours_s"] = step.best("anno", d, qs["anno"], 2)
        ex["anno_ref_s"] = ref.time(d, qs["anno"] + ["refdb"]) if ref \
            else None
        log(f"[{name}] annotation join ({cfg['anno_rows']} filler rows): "
            f"{ex['anno_ours_s']:.2f} s")

    # --- binary BCF dump ---
    ex["bcf_ours_s"] = step.best("bcf", d, ["-b"], 2)
    ex["bcf_ref_s"] = ref.time(d, ["-b", "refdb"]) if ref else None
    # --- full genotype dump (run 1 faults the memory-mapped planes) ---
    ex["dump_ours_s"] = step.best("dump", d, ["-C"], 3)
    ex["dump_ref_s"] = ref.time(d, ["-C", "refdb"]) if ref else None
    log(f"[{name}] view -b {ex['bcf_ours_s']:.2f} s, -C dump "
        f"{ex['dump_ours_s']:.2f} s")
    return n_sites / t_warm, (ex["gc_speedup"] if ref else None)


# --- the other blocks --------------------------------------------------------

def bench_multidb(primary: str, cfg: dict, extra: dict, device, pins: dict,
                  bench_dir: Path, ref: Reference | None) -> None:
    """The primary cohort split into two half-sample databases and queried
    jointly (the bgtm merge path); builds stamped, queries gated every run."""
    src = bench_dir / primary / "in.vcf"
    d = bench_dir / "multidb"
    d.mkdir(parents=True, exist_ok=True)
    ex = extra.setdefault("multidb", {})
    step = Step(ex, device)
    key = "multidb:" + cfg_key(primary, cfg)
    stamp = d / f"stamp-split-{cfg_key(primary, cfg)}"
    if stamp.exists():
        ex.update(json.loads(stamp.read_text()))
    else:
        meta = {}
        t0 = time.perf_counter()
        split_halves(src, d, cfg["n_samples"])
        meta["split_s"] = time.perf_counter() - t0
        for half in ("a", "b"):
            t0 = time.perf_counter()
            importer.import_vcf(str(d / f"our_{half}"),
                                [str(d / f"{half}.vcf")], is_vcf=True)
            meta[f"import_ours_{half}_s"] = time.perf_counter() - t0
        stamp.write_text(json.dumps(meta))
        ex.update(meta)
    if ref is not None:
        for half in ("a", "b"):
            ex[f"import_ref_{half}_s"] = ref.import_(d, f"ref_{half}",
                                                     [f"{half}.vcf"], True)
            for e in (".bcf", ".pbf", ".bcf.csi"):
                gate(f"[multidb] import {half}{e}",
                     file_md5(d / f"our_{half}{e}"),
                     file_md5(d / f"ref_{half}{e}"), "reference")
    dbs = ("our_a", "our_b")
    ex["md5"] = {}
    for q, args in MULTIDB_QUERIES.items():
        host = host_md5(d, args, device, dbs)
        gate(f"[multidb] {q} host tier", host, pinned(pins, key, "views", q),
             "pin")
        got, first = step(f"{q}_first", d, args, dbs, md5=True,
                          clear_memo=True)
        gate(f"[multidb] {q}", got, host, "host tier")
        ex[f"q_{q}_first_s"] = first
        ex[f"q_{q}_warm_s"] = step(f"{q}_warm", d, args, dbs)[1]
        ex[f"q_{q}_ref_s"] = None
        if ref is not None:
            gate(f"[multidb] {q}", got, ref.md5(d, args + ["ref_a", "ref_b"]),
                 "reference")
            ex[f"q_{q}_ref_s"] = ref.time(d, args + ["ref_a", "ref_b"])
        ex[f"parity_{q}"] = True
        ex["md5"][q] = got
        log(f"[multidb] {q}: first {first:.3f} s, warm "
            f"{ex[f'q_{q}_warm_s']:.3f} s, md5 {got}")


def bench_hrc_full(extra: dict, device, bench_dir: Path,
                   ref: Reference | None, cfgs: dict = HRC_FULL_CFGS) -> None:
    """True-HRC scale: a 32,488-sample tile of ~17 GB and a 39.2M-row site
    table.  The databases are built once behind stamps; the queries run
    every time, gated on the port's host tier (and the reference with
    --ref).  The subset is timed under the caller's tier, on the device
    with the tile resident, and streamed with the device budget below the
    tile; each records its tiers and whether the planes stayed resident."""
    d = bench_dir / "hrc_full"
    d.mkdir(parents=True, exist_ok=True)
    ex = extra.setdefault("hrc_full", {})
    ex["gate"] = {"host_tier": True, "pins": False, "ref": ref is not None,
                  "why": "too large for the CPU that writes the pins"}
    region = HRC_FULL_REGION
    for name, cfg in cfgs.items():
        sub = ex.setdefault(name, {})
        sub["shape"] = f"{cfg['n_samples']}x{cfg['n_sites']}"
        sub["gen"] = cfg["gen"]
        step = Step(sub, device)
        # the generator is in the names: a cohort made by another is never
        # reused
        key = (f"{name}-{cfg['n_samples']}x{cfg['n_sites']}-{cfg['seed']}-"
               f"{cfg['gen']}")
        stamp = d / f"stamp-{key}"
        inp = d / f"{key}_in.bcf"
        our = f"{name}_ourdb"
        if stamp.exists():
            sub.update(json.loads(stamp.read_text()))
        else:
            meta = {}
            if not inp.exists():
                log(f"[hrc_full:{name}] generating input BCF "
                    f"({cfg['n_samples']} x {cfg['n_sites']}, "
                    f"{cfg['gen']})...")
                t0 = time.perf_counter()
                stages = getattr(testing, cfg["gen"])(
                    str(inp) + ".tmp", n_samples=cfg["n_samples"],
                    n_sites=cfg["n_sites"], seed=cfg["seed"], log_every=50)
                os.replace(str(inp) + ".tmp", inp)
                meta["gen_s"] = time.perf_counter() - t0
                chunks = -(-cfg["n_sites"] // 2048)  # the generators' chunk
                meta["gen_s_per_chunk"] = meta["gen_s"] / chunks
                if stages is not None:
                    meta["gen_stages_s"] = stages
                log(f"[hrc_full:{name}] generated in {meta['gen_s']:.1f} s, "
                    f"{meta['gen_s_per_chunk']:.3f} s a chunk "
                    f"({inp.stat().st_size / 1e9:.2f} GB); stages {stages}")
            t0 = time.perf_counter()
            n = importer.import_vcf(str(d / our), [str(inp)])
            dt = time.perf_counter() - t0
            meta.update(n_rows=n, import_ours_s=dt,
                        import_gt_per_s_m=n * 2 * cfg["n_samples"] / dt / 1e6)
            log(f"[hrc_full:{name}] our import: {n} rows in {dt:.0f} s")
            t0 = time.perf_counter()
            ts = TileStore.open_or_build(str(d / our))
            meta["gtc_build_s"] = time.perf_counter() - t0
            meta["gtc_bytes"] = int(ts.plane0.nbytes * 2)
            del ts
            stamp.write_text(json.dumps(meta))
            sub.update(meta)
        if ref is not None:
            sub["import_ref_s"] = ref.import_(d, f"{name}_refdb",
                                              [inp.name], vcf=False)
            for e in (".pbf", ".bcf"):
                gate(f"[hrc_full:{name}] import {e}",
                     file_md5(d / f"{our}{e}"),
                     file_md5(d / f"{name}_refdb{e}"), "reference")

        args = (["-G", "-C", "-r", region] if name == "full"
                else ["-G", "-r", region])
        dbs = (our,)
        host = host_md5(d, args, device, dbs)
        got, sub["q_region_first_s"] = step("region_first", d, args, dbs,
                                            md5=True, clear_memo=True)
        gate(f"[hrc_full:{name}] region", got, host, "host tier")
        n_lines = step.lines  # bench.py's count: the header's lines too
        best = step.best("region_warm", d, args, 3, dbs)
        sub["q_region_warm_s"] = best
        sub["q_region_sites"] = n_lines
        if name == "full":
            sub["q_region_gt_per_s_m"] = (n_lines * 2 * cfg["n_samples"]
                                          / best / 1e6)
        sub["q_region_ref_s"] = None
        if ref is not None:
            gate(f"[hrc_full:{name}] region", got,
                 ref.md5(d, args + [f"{name}_refdb"]), "reference")
            sub["q_region_ref_s"] = ref.time(d, args + [f"{name}_refdb"])
        sub["parity_region"] = True
        log(f"[hrc_full:{name}] region query: warm {best:.3f} s "
            f"({n_lines} sites)")
        if name == "site39m":
            # RNI paging deep into the 39.2M-record stream
            _md5, sub["q_paging_s"] = step(
                "paging", d, ["-G", "-i", "30000000", "-n", "100"], dbs)
        if name == "full":
            bench_hrc_full_subset(d, cfg, sub, step, device, ref)
        log(f"block hrc_full:{name}: {json.dumps(sub)}")


def region_rows(prefix: str, region: str) -> int:
    """The rows of database ``prefix`` that ``-r region`` selects (one
    contig, ``chrom:beg-end``, 1-based and inclusive)."""
    bf = engine.BgtFile(prefix)
    st = fastpath.get_site_table(bf)
    chrom, span = region.split(":")
    beg, end = (int(x) for x in span.split("-"))
    tid = bf.h0.name2id(chrom)
    return int(np.count_nonzero((st.rid == tid) & (st.pos < end)
                                & (st.pos + st.rlen > beg - 1)))


def bench_hrc_full_subset(d: Path, cfg: dict, sub: dict, step: Step, device,
                          ref: Reference | None) -> None:
    """hrc_full's subset counts (every 8th sample over the region): under
    the caller's tier, on the device with the tile resident, and streamed
    (``BGT_TPU_HBM_BUDGET`` below the tile), each gated on the host tier,
    and the device steps on where the planes were: resident, then not."""
    spl = d / "full_subset.txt"
    if not spl.exists():
        spl.write_text("".join(f"S{i:05d}\n"
                               for i in range(0, cfg["n_samples"], 8)))
    sargs = ["-G", "-C", "-s", str(spl), "-r", HRC_FULL_REGION]
    dbs = ("full_ourdb",)
    host = host_md5(d, sargs, device, dbs)
    tier0 = os.environ.get("BGT_TPU_COUNT_TIER")
    budget0 = os.environ.get("BGT_TPU_HBM_BUDGET")
    runs = [("subset_first", {}, True), ("subset_warm", {}, False),
            ("subset_device_first", {"BGT_TPU_COUNT_TIER": "device"}, True),
            ("subset_device", {"BGT_TPU_COUNT_TIER": "device"}, False),
            ("subset_streamed", {"BGT_TPU_COUNT_TIER": "device",
                                 "BGT_TPU_HBM_BUDGET": "1"}, True)]
    try:
        for label, env, clear_tiles in runs:
            set_env(BGT_TPU_COUNT_TIER=env.get("BGT_TPU_COUNT_TIER", tier0),
                    BGT_TPU_HBM_BUDGET=env.get("BGT_TPU_HBM_BUDGET", budget0))
            if clear_tiles:
                fastpath._DEVICE_CACHE.clear()
            got, dt = step(label, d, sargs, dbs, md5=True,
                           clear_memo=label != "subset_warm")
            gate(f"[hrc_full:full] {label}", got, host, "host tier")
            sub[f"q_{label}_s"] = dt
            sub[f"resident_{label}"] = any(
                v is not None for v in fastpath._DEVICE_CACHE.values())
            if device.type == "cuda" and label != "subset_warm" and env:
                need_device_pass(sub, label)
            log(f"[hrc_full:full] {label}: {dt:.3f} s, tiers "
                f"{sub['tiers'][label]}, A +{sub['launches'][label]}, "
                f"planes resident: {sub[f'resident_{label}']}")
    finally:
        set_env(BGT_TPU_COUNT_TIER=tier0, BGT_TPU_HBM_BUDGET=budget0)
        fastpath._DEVICE_CACHE.clear()
    if "stream" not in sub["tiers"]["subset_streamed"]:
        raise RuntimeError("the streamed subset did not stream")
    for label, want in (("subset_device_first", True),
                        ("subset_device", True), ("subset_streamed", False)):
        if sub[f"resident_{label}"] != want:
            raise RuntimeError(f"[hrc_full:full] {label}: planes resident "
                               f"{sub[f'resident_{label}']}, expected {want}")
    # what the streamed step gathers and copies: the region's rows of both
    # planes
    rows = region_rows(str(d / "full_ourdb"), HRC_FULL_REGION)
    nbytes = rows * sub["gtc_bytes"] // sub["n_rows"]
    sub.update(subset_streamed_rows=rows, subset_streamed_bytes=nbytes,
               subset_streamed_gbs=nbytes / sub["q_subset_streamed_s"] / 1e9,
               max_rss_gb=resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
               / 1e6)
    log(f"[hrc_full:full] streamed {rows} rows, {nbytes / 1e9:.3f} GB at "
        f"{sub['subset_streamed_gbs']:.2f} GB/s; peak RSS "
        f"{sub['max_rss_gb']:.1f} GB")
    sub["q_subset_ref_s"] = None
    if ref is not None:
        gate("[hrc_full:full] subset", host,
             ref.md5(d, sargs + ["full_refdb"]), "reference")
        sub["q_subset_ref_s"] = ref.time(d, sargs + ["full_refdb"])
    sub["parity_subset"] = True


def measure_device_kernel(extra: dict, name: str, bench_dir: Path,
                          device: torch.device) -> None:
    """Kernel A on the configuration's whole tile at 1 mask (all samples)
    and 32 random masks: exact against its plain version on the card, its
    device time (CUDA events behind a spin, ``measure.time_ms``) beside its
    bytes bound, the round trip (count and ``.cpu()``, host clock), and the
    probe's ``proxy_reduce2`` read rate.  The peak is the H100 SXM's, and
    the block raises on any other card."""
    from bgt_tpu_torch.tools.probe_roofline import (_loop_reduce2,
                                                    device_seconds_per_iter)

    kind, power = measure.describe(device)
    if not ("H100" in kind and "HBM3" in kind):
        raise RuntimeError(f"the device block's peak is the H100 SXM's; "
                           f"this card is {kind}")
    ex = extra.setdefault("device_kernel", {})
    ex.update(backend=device.type, device_kind=kind, power_limit=power,
              tile=name, hbm_peak_gbs=measure.HBM_BYTES_PER_S / 1e9)
    ts = TileStore.open_or_build(str(bench_dir / name / "ourdb"))
    p0 = counts.planes_to_torch(ts.plane0, device)
    p1 = counts.planes_to_torch(ts.plane1, device)
    rows, words = ts.plane0.shape
    plane_bytes = ts.plane0.nbytes * 2
    ex.update(rows=rows, words=words, launches=0)
    t = device_seconds_per_iter(_loop_reduce2, DEVICE_TILE_REPS, device, p0,
                                p1)
    ex["hbm_proxy_gbs"] = plane_bytes / t / 1e9
    rng = np.random.default_rng(0)
    for label, masks in (
            ("1mask", ts.all_mask()[None, :]),
            ("32mask", rng.integers(0, 2**32, (32, words), dtype=np.uint32))):
        dm = counts.planes_to_torch(masks, device)
        before = counts.LAUNCHES["count_codes"]
        got = counts.count_codes(p0, p1, dm)
        want = counts.count_codes_reference(p0, p1, dm)
        err = int((got - want).abs().max())
        if err:
            raise GateError(f"kernel A != plain at {label}: max |diff| {err}")
        ex["launches"] += counts.LAUNCHES["count_codes"] - before
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            counts.count_codes(p0, p1, dm).cpu()
            best = min(best, time.perf_counter() - t0)
        ex[f"s_per_call_{label}"] = best
        ex[f"count_bw_gbs_{label}"] = plane_bytes / best / 1e9
        ms = measure.time_ms(lambda: counts.count_codes(p0, p1, dm), device,
                             DEVICE_TILE_REPS)
        bound = measure.count_bound_ms(rows, words, masks.shape[0], 4)
        ex[f"s_per_call_{label}_device"] = ms / 1e3
        ex[f"count_bw_gbs_{label}_device"] = plane_bytes / ms / 1e6
        ex[f"roofline_frac_{label}"] = (plane_bytes / (ms * 1e-3)
                                        / measure.HBM_BYTES_PER_S)
        ex[f"bound_ms_{label}"] = bound
        ex[f"share_{label}"] = bound / ms
        ex[f"max_abs_err_{label}"] = err
        del dm
    ex["sites_per_s_1mask"] = rows / ex["s_per_call_1mask"]
    ex["gt_per_s_device_m"] = (rows * ts.m / ex["s_per_call_1mask_device"]
                               / 1e6)
    log(f"device kernel [{kind}, {power}] on {name} ({rows} x {words}): "
        f"1 mask {ex['s_per_call_1mask_device'] * 1e3:.4f} ms (bound "
        f"{ex['bound_ms_1mask']:.4f}, share {ex['share_1mask']:.3f}), 32 "
        f"masks {ex['s_per_call_32mask_device'] * 1e3:.4f} ms (bound "
        f"{ex['bound_ms_32mask']:.4f}, share {ex['share_32mask']:.3f}); "
        f"proxy {ex['hbm_proxy_gbs']:.1f} GB/s; round trip "
        f"{ex['s_per_call_1mask'] * 1e3:.3f} ms")
    del p0, p1
    torch.cuda.empty_cache()


def run_device_tests(extra: dict) -> None:
    """The card tests (``tests/test_torch_cuda.py``, the ``cuda`` marker)
    in a subprocess; ``--noconftest``, as ``tests/conftest.py`` imports
    JAX.  A failure fails the bench."""
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
         "-p", "no:cacheprovider", str(REPO / "tests" / "test_torch_cuda.py")],
        cwd=REPO, capture_output=True, text=True, timeout=1800)
    tail = (res.stdout or "").strip().splitlines()[-1:] or [""]
    extra["device_tests"] = {"passed": res.returncode == 0,
                             "seconds": time.perf_counter() - t0,
                             "summary": tail[0][:160]}
    log(f"device tests: {tail[0][:120]}")
    if res.returncode != 0:
        raise RuntimeError(f"card tests failed:\n{res.stdout[-3000:]}")


def run_scaling(extra: dict, device) -> None:
    """``bench_scaling`` on ``device`` in a subprocess; its JSON's
    ``scaling`` object, and a failure fails the bench."""
    res = subprocess.run(
        [sys.executable, "-m", "bgt_tpu_torch.tools.bench_scaling",
         "--device", str(device)], cwd=REPO, capture_output=True, text=True,
        timeout=1800)
    if res.returncode != 0:
        raise RuntimeError(f"bench_scaling failed:\n{res.stderr[-3000:]}")
    extra["scaling"] = json.loads(res.stdout.strip().splitlines()[-1])[
        "scaling"]


# --- the run -----------------------------------------------------------------

def run(configs: dict, device, pins: dict, ref: Reference | None = None,
        bench_dir: Path = BENCH_DIR,
        full: bool = True, device_tests: bool = True,
        scaling: bool = True) -> dict:
    """Every block of the bench on ``device``; returns the JSON object.
    Raises on any failed gate or error.  ``full`` runs ``hrc_full``;
    ``device_tests`` and ``scaling`` run on a CUDA device only."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the bench measures a card")
        from bgt_tpu_torch.ops import _kernels
        _kernels.library()  # nvcc before any timed (and the cold) run
    kind, power = measure.describe(device)
    extra: dict = {}
    names = list(configs)
    primary = names[0]
    headline = None
    floors: dict = {}
    for name in names:
        res = bench_config(name, configs[name], name == primary, extra,
                           device, pins, bench_dir, ref, floors)
        log_block(extra, name)
        if name == primary:
            headline = res
    if device.type == "cuda":
        if device_tests:
            run_device_tests(extra)
            log_block(extra, "device_tests")
        widest = max(names, key=lambda n: configs[n]["n_samples"])
        measure_device_kernel(extra, widest, bench_dir, device)
    else:
        extra["device_kernel"] = {"not_measured": f"device {device}: the "
                                  "block times kernel A on a card"}
    log_block(extra, "device_kernel")
    if full:
        extra["hrc_full"] = {}  # bench.py's place in the JSON; run last
    bench_multidb(primary, configs[primary], extra, device, pins, bench_dir,
                  ref)
    log_block(extra, "multidb")
    if scaling and device.type == "cuda":
        run_scaling(extra, device)
        log_block(extra, "scaling")
    if full:
        # the longest block last: a run cut short by a time limit has
        # measured every other block, and logged it, by then
        bench_hrc_full(extra, device, bench_dir, ref)
        log_block(extra, "hrc_full")
    value, vs = headline
    return {
        "metric": (f"sites/s, warm view -GC ({configs[primary]['n_samples']} "
                   f"samples x {extra[primary]['n_rows']} sites; answered "
                   "by rowstats on the host)"),
        "value": value,
        "unit": "sites/s",
        "vs_baseline": vs,
        "extra": extra,
        "device": {"torch": str(device), "kind": kind, "power_limit": power},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device the queries count on (default cuda)")
    ap.add_argument("--ref", type=Path, metavar="PATH",
                    help="a built reference bgt binary: also gate on it and "
                         "time it")
    ap.add_argument("--write-pins", action="store_true",
                    help="write bench_pins.json from bgt_tpu's CLI (needs "
                         "bgt_tpu and JAX) and exit")
    args = ap.parse_args(argv)
    if args.write_pins:
        write_pins(CONFIGS, BENCH_DIR, PINS_PATH)
        return 0
    ref = None
    if args.ref is not None:
        if not args.ref.is_file():
            ap.error(f"--ref {args.ref}: no such binary")
        ref = Reference([str(args.ref.resolve())])
    result = run(CONFIGS, args.device, json.loads(PINS_PATH.read_text()),
                 ref, BENCH_DIR,
                 full=os.environ.get("BGT_TPU_BENCH_FULL", "1") != "0",
                 device_tests=os.environ.get("BGT_TPU_DEVICE_TESTS",
                                             "1") != "0")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
