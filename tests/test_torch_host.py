"""bgt_tpu_torch owns its host layers: it imports nothing of bgt_tpu or jax,
and its copies write and print the same bytes as bgt_tpu's.

- Every ``.py`` of the package and ``chip_smoke.py`` is parsed with ``ast``:
  no ``import`` names ``bgt_tpu`` (other than ``bgt_tpu_torch``) or ``jax``.
- A fresh interpreter imports every module of the package (the mesh's
  ``parallel/mesh.py``, ``parallel/distributed.py`` and ``core/xp_torch.py``,
  the PBWT scan's ``ops/decode.py``, the ``misc/`` converters and the
  measurement tools of ``tools/`` among them)
  and finds neither ``bgt_tpu`` nor ``jax`` in ``sys.modules``.
- ``bgt import`` of one VCF through each package: every file of the two
  databases is the same bytes.
- The subcommands that never touch a device (``kexpr``, ``fmf``,
  ``pbfview``, ``getalt``, ``atomize``, ``bcfidx``, ``gtcshard``): each
  package's CLI in its own process, the same exit code and stdout bytes.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from bgt_tpu.query import importer as jax_importer
from bgt_tpu_torch import testing
from bgt_tpu_torch.query import importer

REPO = Path(__file__).resolve().parent.parent
SOURCES = sorted(p.relative_to(REPO).as_posix()
                 for p in (REPO / "bgt_tpu_torch").rglob("*.py")) + [
    "chip_smoke.py"]


def _foreign(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("bgt_tpu", "jax", "jaxlib")


@pytest.mark.parametrize("path", SOURCES)
def test_source_imports_no_bgt_tpu_or_jax(path):
    tree = ast.parse((REPO / path).read_text(), filename=path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _foreign(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if node.module and _foreign(node.module):
                bad.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None)
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)
              and _foreign(str(node.args[0].value))):
            bad.append(node.args[0].value)
    assert not bad, f"{path} imports {bad}"


_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import bgt_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(bgt_tpu_torch.__path__,
                                              "bgt_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
named = {"bgt_tpu_torch.parallel.mesh", "bgt_tpu_torch.parallel.distributed",
         "bgt_tpu_torch.core.xp_torch", "bgt_tpu_torch.ops.decode",
         "bgt_tpu_torch.misc.pop2region", "bgt_tpu_torch.misc.sgdp2fmf",
         "bgt_tpu_torch.misc.vep2sql", "bgt_tpu_torch.tools.bench",
         "bgt_tpu_torch.tools.soak", "bgt_tpu_torch.tools.bench_scaling",
         "bgt_tpu_torch.tools.bench_multiprocess"}
assert named <= set(mods), sorted(named - set(mods))
foreign = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("bgt_tpu", "jax", "jaxlib"))
assert not foreign, foreign
print("ISOLATED", len(mods))
"""


def test_every_module_imports_alone():
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL, str(REPO)],
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "ISOLATED" in res.stdout
    assert int(res.stdout.split()[-1]) >= 45


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torchhostdb")
    (tmp / "in.vcf").write_text(
        testing.random_vcf(n_samples=18, n_sites=250, seed=41, with_filter=True))
    (tmp / "jax").mkdir()
    (tmp / "port").mkdir()
    jax_importer.import_vcf(str(tmp / "jax" / "db"), [str(tmp / "in.vcf")],
                            is_vcf=True)
    importer.import_vcf(str(tmp / "port" / "db"), [str(tmp / "in.vcf")],
                        is_vcf=True)
    # what import wrote, before the .spl is replaced and later commands add
    # tiles or shards
    written = {d: {p.name: p.read_bytes() for p in (tmp / d).iterdir()}
               for d in ("jax", "port")}
    spl = testing.random_spl(18, seed=41)
    for d in ("jax", "port"):
        (tmp / d / "db.spl").write_text(spl)
    return tmp, written


# every file bgt import writes for a VCF
DB_FILES = ["db.bcf", "db.bcf.csi", "db.pbf", "db.sites.bin", "db.spl"]


@pytest.mark.parametrize("name", DB_FILES)
def test_import_writes_the_same_bytes(dbs, name):
    _tmp, written = dbs
    assert written["port"][name] == written["jax"][name]


def test_import_writes_no_other_file(dbs):
    _tmp, written = dbs
    assert sorted(written["port"]) == sorted(written["jax"]) == DB_FILES


def _cli(pkg: str, args: list, cwd: Path):
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env["PYTHONPATH"] = str(REPO)
    return subprocess.run([sys.executable, "-m", f"{pkg}.cli", *args],
                          capture_output=True, cwd=cwd, env=env, timeout=120)


# (subcommand arguments, with {db} for the database prefix of each package)
COMMANDS = [
    ["kexpr", "1+2*3"],
    ["kexpr", "-p", "(a+b)*sqrt(c)"],
    ["kexpr", "a>b && c<=4", "a=3", "b=2", "c=4.5"],
    ["fmf", "{db}.spl"],
    ["fmf", "{db}.spl", 'population=="CEU"'],
    ["fmf", "-n", "{db}.spl", 'population!="YRI"'],
    ["pbfview", "{db}.pbf"],
    ["pbfview", "-r", "7", "-n", "5", "-c", "3", "-c", "10", "{db}.pbf"],
    ["getalt", "{db}"],
    ["atomize", "in.vcf"],
    ["atomize", "-S", "in.vcf"],
    ["gtcshard", "{db}", "2", "2"],
    ["version"],
]


@pytest.mark.parametrize("args", COMMANDS, ids=[" ".join(c) for c in COMMANDS])
def test_host_subcommand_matches_jax_package(dbs, args):
    dbs, _written = dbs
    runs = []
    for pkg, d in (("bgt_tpu", "jax"), ("bgt_tpu_torch", "port")):
        argv = [a.replace("{db}", str(dbs / d / "db")) for a in args]
        res = _cli(pkg, argv, dbs)
        runs.append((res.returncode, res.stdout.replace(
            str(dbs / d).encode(), b"<dir>")))
        assert res.returncode == 0, res.stderr.decode()[-2000:]
    assert runs[1] == runs[0]
    assert runs[0][1]


def test_bcfidx_writes_the_same_index(dbs, tmp_path):
    dbs, _written = dbs
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "x.bcf").write_bytes((dbs / "port" / "db.bcf").read_bytes())
    for pkg, d in (("bgt_tpu", "jax"), ("bgt_tpu_torch", "port")):
        res = _cli(pkg, ["bcfidx", str(tmp_path / d / "x.bcf")], tmp_path)
        assert res.returncode == 0, res.stderr.decode()[-2000:]
    made = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert made == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert len(made) > 1
    for name in made:
        assert ((tmp_path / "port" / name).read_bytes()
                == (tmp_path / "jax" / name).read_bytes()), name
