"""The port's measurement tools (``bgt_tpu_torch/tools/``: ``bench``,
``soak``, ``bench_multiprocess``, ``bench_scaling``) held to ``bgt_tpu`` on
the CPU.

- ``testing.cohort_vcf_to_file`` and ``testing.vcf_text_to_bcf`` write the
  same bytes as ``bgt_tpu.testing``'s.
- ``bench.run`` at tiny configurations on the CPU device with the device
  tier forced: ``bench.py``'s keys; every query's md5 equal to ``bgt_tpu``'s
  ``main_view`` on the same database (its pins, made in process here), the
  import's files equal to ``bgt_tpu``'s importer's; the subset's device
  step and the eight groups counted by the device tier, ``-G -C`` by
  rowstats.  A pin that does not match ends the run with no JSON line.
- The soak against an oracle that runs ``bgt_tpu`` in process passes; a
  planted divergence fails it with its repro line.
- Two gloo ranks of ``bench_multiprocess`` and every step of
  ``bench_scaling`` on CPU slots: counts exact against the host popcount.
"""

import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from bgt_tpu import testing as jax_testing
from bgt_tpu.ops.tiles import TileStore as JaxTileStore
from bgt_tpu.query import fastpath as jax_fastpath
from bgt_tpu.query import importer as jax_importer
from bgt_tpu.query import view as jax_view
from bgt_tpu_torch import testing
from bgt_tpu_torch.tools import bench, bench_multiprocess, bench_scaling, soak

REPO = Path(__file__).resolve().parent.parent

# (samples, sites, seed, chunk_sites): one chunk, many chunks, a ragged one
COHORT_CASES = [(3, 40, 0, 2000), (17, 120, 5, 50), (64, 9, 11, 4)]
BCF_CASES = [
    dict(n_samples=5, n_sites=60, seed=1),
    dict(n_samples=30, n_sites=200, seed=2, p_multi=0.5, p_indel=0.4,
         p_missing=0.2, with_filter=True),
    dict(n_samples=1, n_sites=25, seed=3, phased=False),
]


@pytest.mark.parametrize("n_samples,n_sites,seed,chunk", COHORT_CASES)
def test_cohort_vcf_to_file_same_bytes(tmp_path, n_samples, n_sites, seed,
                                       chunk):
    kw = dict(n_samples=n_samples, n_sites=n_sites, seed=seed,
              chunk_sites=chunk)
    testing.cohort_vcf_to_file(str(tmp_path / "port.vcf"), **kw)
    jax_testing.cohort_vcf_to_file(str(tmp_path / "jax.vcf"), **kw)
    got = (tmp_path / "port.vcf").read_bytes()
    assert got == (tmp_path / "jax.vcf").read_bytes()
    assert got.count(b"\n") == n_sites + 4  # 3 meta lines, the header


@pytest.mark.parametrize("kw", BCF_CASES, ids=["plain", "mixed", "unphased"])
def test_vcf_text_to_bcf_same_bytes(tmp_path, kw):
    vcf = testing.random_vcf(**kw)
    assert vcf == jax_testing.random_vcf(**kw)
    testing.vcf_text_to_bcf(vcf, str(tmp_path / "port.bcf"))
    jax_testing.vcf_text_to_bcf(vcf, str(tmp_path / "jax.bcf"))
    assert (tmp_path / "port.bcf").read_bytes() == \
        (tmp_path / "jax.bcf").read_bytes()


# --- the bench ---------------------------------------------------------------

TINY = {"1kg11": dict(n_samples=40, n_sites=300, seed=1337, anno_rows=2000),
        "hrc": dict(n_samples=70, n_sites=150, seed=2026)}
PRIMARY_ONLY = {"import_bcf_ref_s", "import_bcf_ours_s", "parity_import_bcf",
                "anno_ours_s", "parity_anno", "anno_ref_s"}


def _jax_view(d: Path, args: list, dbs: list, sink):
    old = os.getcwd()
    os.chdir(d)
    try:
        assert jax_view.main_view(list(args) + list(dbs), out=sink) == 0
    finally:
        os.chdir(old)
    return sink


def _jax_md5(d: Path, args: list, dbs: list) -> str:
    jax_fastpath._COUNT_MEMO.clear()
    return _jax_view(d, args, dbs, bench._Md5Sink()).h.hexdigest()


@pytest.fixture(scope="module")
def tiny_bench(tmp_path_factory):
    """The tiny configurations' databases and inputs built by the bench,
    and their pins from bgt_tpu in process: its import of the same VCF,
    its md5 of every query, its import of its own ``-b -C`` output and its
    merge of the two halves."""
    bd = tmp_path_factory.mktemp("bench_torch")
    pins = {}
    for i, (name, cfg) in enumerate(TINY.items()):
        primary = i == 0
        d = bd / name
        bench.ensure_db(bd, name, cfg, primary)
        bench.ensure_inputs(d, cfg, primary)
        jax_importer.import_vcf(str(d / "refdb"), [str(d / "in.vcf")],
                                is_vcf=True)
        entry = {"import": {e: bench.file_md5(d / f"refdb{e}")
                            for e in bench.IMPORT_EXTS},
                 "views": {q: _jax_md5(d, args, ["refdb"])
                           for q, args in bench.queries(primary).items()}}
        if primary:
            with open(d / "in_gt_ref.bcf", "wb") as fp:
                _jax_view(d, ["-b", "-C"], ["refdb"], bench._FileSink(fp))
            jax_importer.import_vcf(str(d / "refdb_b"),
                                    [str(d / "in_gt_ref.bcf")])
            entry["import_bcf"] = {".pbf": bench.file_md5(d / "refdb_b.pbf")}
            md = bd / "multidb"
            md.mkdir()
            bench.split_halves(d / "in.vcf", md, cfg["n_samples"])
            for half in ("a", "b"):
                jax_importer.import_vcf(str(md / f"ref_{half}"),
                                        [str(md / f"{half}.vcf")],
                                        is_vcf=True)
            pins["multidb:" + bench.cfg_key(name, cfg)] = {"views": {
                q: _jax_md5(md, args, ["ref_a", "ref_b"])
                for q, args in bench.MULTIDB_QUERIES.items()}}
        pins[bench.cfg_key(name, cfg)] = entry
    return bd, pins


def _bench_py_keys() -> set:
    """The per-configuration keys of bench.py's ``extra`` (``bench_config``
    and ``measure_subsets``)."""
    tree = ast.parse((REPO / "bench.py").read_text())
    keys = set()
    for fn in tree.body:
        if isinstance(fn, ast.FunctionDef) and fn.name in (
                "bench_config", "measure_subsets"):
            for node in ast.walk(fn):
                if (isinstance(node, ast.Subscript)
                        and isinstance(node.value, ast.Name)
                        and node.value.id == "ex"
                        and isinstance(node.slice, ast.Constant)):
                    keys.add(node.slice.value)
    return {k for k in keys if not k.startswith("_")}


def test_bench_run_matches_bgt_tpu(tiny_bench, monkeypatch):
    bd, pins = tiny_bench
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    res = bench.run(TINY, "cpu", pins, bench_dir=bd, full=False)
    assert list(res) == ["metric", "value", "unit", "vs_baseline", "extra",
                         "device"]
    assert res["vs_baseline"] is None and res["value"] > 0
    assert res["device"] == {"torch": "cpu", "kind": "cpu",
                             "power_limit": None}
    extra = res["extra"]
    assert list(extra) == ["1kg11", "hrc", "device_kernel", "multidb"]
    assert "not_measured" in extra["device_kernel"]
    keys = _bench_py_keys()
    assert {"parity_gc", "gc_warm_s", "subset_device_s", "dump_ours_s",
            "anno_ours_s"} <= keys
    for i, (name, cfg) in enumerate(TINY.items()):
        ex = extra[name]
        want = keys if i == 0 else keys - PRIMARY_ONLY
        assert want <= set(ex), sorted(want - set(ex))
        # no reference: its columns are null
        assert ex["gc_ref_s"] is None and ex["import_ref_s"] is None
        key = bench.cfg_key(name, cfg)
        assert ex["md5"] == pins[key]["views"]
        d = bd / name
        for e in bench.IMPORT_EXTS:
            assert (d / f"ourdb{e}").read_bytes() == \
                (d / f"refdb{e}").read_bytes(), e
        # -G -C over all samples is rowstats' and never the device's
        assert set(ex["tiers"]["gc_warm_0"]) == {"rowstats"}
        assert ex["cold"]["tiers"] == {"rowstats": 1}
        assert ex["subset_cold"]["tiers"] == {"device": 1}
        for step in ("subset_first", "subset_device", "groups8"):
            assert ex["tiers"][step].get("device", 0) >= 1, step
        assert ex["tiers"]["subset_repeat"] == {"memo": 1}
        assert ex["launches"]["subset_device"] == 0  # the CPU's plain version
    assert (bd / "1kg11" / "ourdb_b.pbf").read_bytes() == \
        (bd / "1kg11" / "refdb_b.pbf").read_bytes()
    assert extra["multidb"]["md5"] == \
        pins["multidb:" + bench.cfg_key("1kg11", TINY["1kg11"])]["views"]


@pytest.mark.parametrize("part,query", [("views", "gc"), ("import", ".pbf")])
def test_bench_pin_mismatch_fails_without_json(tiny_bench, monkeypatch,
                                               tmp_path, capsys, part, query):
    bd, pins = tiny_bench
    bad = json.loads(json.dumps(pins))
    bad[bench.cfg_key("1kg11", TINY["1kg11"])][part][query] = "0" * 32
    (tmp_path / "pins.json").write_text(json.dumps(bad))
    monkeypatch.setattr(bench, "CONFIGS", TINY)
    monkeypatch.setattr(bench, "BENCH_DIR", bd)
    monkeypatch.setattr(bench, "PINS_PATH", tmp_path / "pins.json")
    monkeypatch.setenv("BGT_TPU_BENCH_FULL", "0")
    with pytest.raises(bench.GateError, match=f"{query}.*!= pin 0{{32}}"):
        bench.main(["--device", "cpu"])
    assert capsys.readouterr().out == ""


# --- the soak ----------------------------------------------------------------

class JaxOracle(soak.Oracle):
    """bgt_tpu in process: its importer and its ``main_view``."""

    name = "bgt_tpu"

    def import_(self, cwd, prefix, srcs, is_vcf, gen_pb1):
        jax_importer.import_vcf(str(cwd / prefix), [str(s) for s in srcs],
                                is_vcf=True if is_vcf else None,
                                gen_pb1=gen_pb1)
        return True

    def view(self, cwd, args, dbs):
        jax_fastpath._COUNT_MEMO.clear()
        sink = soak._Bytes()
        old = os.getcwd()
        os.chdir(cwd)
        try:
            ret = jax_view.main_view(list(args) + list(dbs), out=sink)
        finally:
            os.chdir(old)
        return sink.value() if ret == 0 else None


class Corrupting(soak.Oracle):
    """The host tier with one byte added to every output."""

    def view(self, cwd, args, dbs):
        out = super().view(cwd, args, dbs)
        return None if out is None else out + b"#"


# a merge of databases, a VCF with its .pb1, a BCF, two files with a .pb1,
# a small VCF (tools/soak_parity.py's modes)
SOAK_SEEDS = [1, 5, 9, 23, 2]


@pytest.mark.parametrize("seed", SOAK_SEEDS)
def test_soak_matches_bgt_tpu(seed, capsys):
    assert soak.run(0, seed, "cpu", JaxOracle()) == 0
    assert "PASS: 1 iterations, no divergence from bgt_tpu" in \
        capsys.readouterr().out


def test_soak_cli_host_tier(capsys):
    assert soak.main(["0", "2", "--device", "cpu"]) == 0
    assert "no divergence from the port's host tier" in capsys.readouterr().out


@pytest.mark.parametrize("seed", [1, 2])
def test_soak_divergence_exits_1_with_repro(seed, capsys):
    assert soak.run(0, seed, "cpu", Corrupting(), " --device cpu") == 1
    out = capsys.readouterr().out
    assert "DIVERGENCE" in out
    assert (f"repro: python -m bgt_tpu_torch.tools.soak 0 {seed} --device cpu"
            in out)


# --- multi-process and scaling -----------------------------------------------

def test_check_tiled_catches_one_wrong_count():
    blk, masks = bench_multiprocess.synth(37, 9, 3)
    ts = JaxTileStore(37, 9 * 32, blk, np.ascontiguousarray(blk[::-1]))
    want = jax_fastpath.host_counts(ts, np.arange(37), masks)
    out = np.concatenate([want, want, want[:5]])  # 79 rows tiling 37
    bench_multiprocess.check_tiled(out, blk, masks)
    out[40, 2, 1] += 1
    with pytest.raises(AssertionError, match="host popcount"):
        bench_multiprocess.check_tiled(out, blk, masks)


def test_bench_multiprocess_two_gloo_ranks(capsys):
    assert bench_multiprocess.main(["2", "--device", "cpu", "--rows", "5000",
                                    "--words", "96", "--iters", "2"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("RESULT 2 proc: ")
    assert "transport gloo, 2 ranks x 1 slots share cpu" in line


def test_bench_scaling_cpu_slots():
    res = bench_scaling.run("cpu")
    assert res["device"]["kind"] == "cpu"
    for block in ("dispatch_overhead_s", "strong_devices", "weak_devices"):
        assert list(res[block]) == ["1", "2", "4", "8"]
        for n, e in res[block].items():
            assert e["counts_exact"], (block, n)
            assert e["shared_card"] == (n != "1")
            assert "efficiency" not in e  # CPU slots share the CPU
    assert res["mesh2_2x2"]["counts_exact"]
    assert res["mesh2_2x2"]["shared_card"]
    cross = res["crossover"]
    assert list(cross["rows_vs_1dev"]) == ["512", "5000"]
    assert cross["crossover_rows"] is None  # shared slots decide nothing
    assert "default 65536" in cross["production_gate"]
    p = res["processes"]["2"]
    assert p["transport"] == "gloo" and p["shared_card"]
    assert "efficiency" not in p


def test_scaling_slots(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cuda = torch.device("cuda")
    assert bench_scaling.slots_for(2, cuda) == [torch.device("cuda", 0),
                                                torch.device("cuda", 1)]
    assert bench_scaling.slots_for(4, cuda) == "not run: 4 cards (2 visible)"
    one = torch.device("cuda", 0)
    assert bench_scaling.slots_for(3, one) == [one] * 3
    assert bench_scaling.shared([one] * 3)
    assert not bench_scaling.shared(bench_scaling.slots_for(2, cuda))
