"""The hit-only cohort generator (``testing.synth_gt_bcf_sparse_to_file``)
and the bench's HRC-scale block that uses it, on the CPU.

- The generator: the same seed gives the same bytes and another seed other
  bytes; its cohort, read back through the port's importer and
  ``TileStore`` at 400 samples x 4,096 sites, has strictly increasing
  positions, codes 0/1/2 only, and switch and missing shares within 5
  sigma of their rates.  ``_bernoulli_hits`` places exactly the successes
  of the trials.
- Its BCF imported by ``bgt_tpu``'s importer and by the port's gives the
  same ``.pbf`` and ``.bcf``; the region subset ``view`` on it gives the
  same bytes from the port's streamed tier and from ``bgt_tpu``.
- ``bench.bench_hrc_full`` at tiny configurations reaches every subset
  step, streams the streamed one, and never reuses a cohort made by
  another generator.
"""

import os
from pathlib import Path

import numpy as np
import pytest
import torch

from bgt_tpu.query import fastpath as jax_fastpath
from bgt_tpu.query import importer as jax_importer
from bgt_tpu.query import view as jax_view
from bgt_tpu_torch import testing
from bgt_tpu_torch.ops.tiles import TileStore
from bgt_tpu_torch.query import engine, fastpath, importer
from bgt_tpu_torch.tools import bench

RATE = 0.002  # the generators' switch_rate and p_missing
STATS = dict(n_samples=400, n_sites=4096, seed=7)


def _make(path: Path, **kw) -> bytes:
    testing.synth_gt_bcf_sparse_to_file(str(path), **kw)
    return path.read_bytes()


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """The 400 x 4,096 cohort, the hits each call of ``_bernoulli_hits``
    drew (a switch call, then a missing call, per chunk), and its import by
    the port (``ourdb``) and by ``bgt_tpu`` (``refdb``)."""
    d = tmp_path_factory.mktemp("synth")
    drawn = []
    draw = testing._bernoulli_hits

    def recording(rng, p, n):
        hits = draw(rng, p, n)
        drawn.append((n, hits))
        return hits

    mp = pytest.MonkeyPatch()
    mp.setattr(testing, "_bernoulli_hits", recording)
    try:
        stages = testing.synth_gt_bcf_sparse_to_file(str(d / "in.bcf"),
                                                     **STATS)
    finally:
        mp.undo()
    assert importer.import_vcf(str(d / "ourdb"), [str(d / "in.bcf")]) == \
        STATS["n_sites"]
    jax_importer.import_vcf(str(d / "refdb"), [str(d / "in.bcf")])
    return d, drawn, stages


@pytest.mark.parametrize("n_samples,n_sites,chunk", [
    (3, 10, 2048), (50, 3000, 2048), (17, 300, 64)])
def test_sparse_same_seed_same_bytes(tmp_path, n_samples, n_sites, chunk):
    kw = dict(n_samples=n_samples, n_sites=n_sites, chunk_sites=chunk)
    a = _make(tmp_path / "a.bcf", seed=5, **kw)
    assert a == _make(tmp_path / "b.bcf", seed=5, **kw)
    assert a != _make(tmp_path / "c.bcf", seed=6, **kw)


def test_sparse_cohort_reads_back(cohort):
    d, drawn, stages = cohort
    assert set(stages) == {"draws", "mosaic", "tiles", "emit", "write"}
    bf = engine.BgtFile(str(d / "ourdb"))
    pos = np.asarray(fastpath.get_site_table(bf).pos)
    assert pos.size == STATS["n_sites"] and np.all(np.diff(pos) > 0)
    ts = TileStore.open_or_build(str(d / "ourdb"))
    n_hap = 2 * STATS["n_samples"]
    codes = ts.codes(np.arange(ts.n_rows))[:, :n_hap]
    assert set(np.unique(codes)) <= {0, 1, 2}
    cells = codes.size
    sigma = (RATE * (1 - RATE) / cells) ** 0.5
    switch = sum(h.size for n, h in drawn[0::2])
    miss = sum(h.size for n, h in drawn[1::2])
    assert sum(n for n, h in drawn[0::2]) == cells
    assert abs(switch / cells - RATE) < 5 * sigma
    # every missing hit is a code 2 and nothing else is
    assert int(np.count_nonzero(codes == 2)) == miss
    assert abs(miss / cells - RATE) < 5 * sigma


@pytest.mark.parametrize("switch_rate", [0.0, RATE])
def test_sparse_switches_change_founders(tmp_path, switch_rate):
    """Without switches every haplotype copies one of the 64 founders; at
    RATE each switches ~4 times in 2,048 rows (none in e^-4 of them), and
    almost all of the 200 haplotypes differ."""
    n_samples, n_sites = 100, 2048
    testing.synth_gt_bcf_sparse_to_file(
        str(tmp_path / "in.bcf"), n_samples, n_sites, seed=9,
        switch_rate=switch_rate, p_missing=0.0)
    importer.import_vcf(str(tmp_path / "db"), [str(tmp_path / "in.bcf")])
    ts = TileStore.open_or_build(str(tmp_path / "db"))
    codes = ts.codes(np.arange(n_sites))[:, :2 * n_samples]
    distinct = np.unique(codes, axis=1).shape[1]
    if switch_rate:
        assert distinct >= 180
    else:
        assert distinct <= 64


def _all_ones(p, size):
    return np.ones(size, dtype=np.int64)


@pytest.mark.parametrize("p,n", [(0.002, 1_000_000), (0.3, 5_000),
                                 (0.0, 100), (0.5, 0)])
def test_bernoulli_hits_share(p, n):
    hits = testing._bernoulli_hits(np.random.default_rng(3), p, n)
    assert hits.dtype == np.int64
    assert np.all(np.diff(hits) > 0)
    assert hits.size == 0 or (hits[0] >= 0 and hits[-1] < n)
    if n and p:
        assert abs(hits.size / n - p) < 5 * (p * (1 - p) / n) ** 0.5
    else:
        assert hits.size == 0


def test_bernoulli_hits_draws_past_one_batch():
    # gaps of 1 put a hit on every trial: the batch of ~45 gaps runs out
    # many times before the 1,000 trials do
    rng = type("Ones", (), {"geometric": staticmethod(_all_ones)})()
    assert np.array_equal(testing._bernoulli_hits(rng, 0.01, 1000),
                          np.arange(1000))


@pytest.mark.parametrize("ext", [".pbf", ".bcf"])
def test_sparse_import_matches_bgt_tpu(cohort, ext):
    d = cohort[0]
    assert (d / f"ourdb{ext}").read_bytes() == (d / f"refdb{ext}").read_bytes()


def _view(run, d: Path, args: list, db: str) -> str:
    sink = bench._Md5Sink()
    old = os.getcwd()
    os.chdir(d)
    try:
        assert run(args + [db], sink) == 0
    finally:
        os.chdir(old)
    return sink.h.hexdigest()


@pytest.mark.parametrize("region", [bench.HRC_FULL_REGION,
                                    "11:1-135006516"])
def test_sparse_region_subset_streamed_matches_bgt_tpu(cohort, monkeypatch,
                                                       region):
    d = cohort[0]
    spl = d / "every8.txt"
    spl.write_text("".join(f"S{i:05d}\n"
                           for i in range(0, STATS["n_samples"], 8)))
    args = ["-G", "-C", "-s", str(spl), "-r", region]
    jax_fastpath._COUNT_MEMO.clear()
    want = _view(lambda a, s: jax_view.main_view(a, out=s), d, args, "refdb")
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    monkeypatch.setenv("BGT_TPU_HBM_BUDGET", "1")
    fastpath._COUNT_MEMO.clear()
    fastpath._DEVICE_CACHE.clear()
    tiers0 = dict(fastpath.TIERS)
    got = _view(lambda a, s: bench.main_view(a, out=s, device="cpu"), d,
                args, "ourdb")
    assert fastpath.TIERS["stream"] == tiers0["stream"] + 1
    assert got == want


# --- the bench's HRC-scale block ---------------------------------------------

TINY_FULL = {"full": dict(bench.HRC_FULL_CFGS["full"], n_samples=48,
                          n_sites=2500),
             "site39m": dict(bench.HRC_FULL_CFGS["site39m"], n_sites=3000)}
SUBSET_STEPS = ("subset_first", "subset_warm", "subset_device_first",
                "subset_device", "subset_streamed")


def test_bench_hrc_full_reaches_every_subset_step(tmp_path):
    extra = {}
    bench.bench_hrc_full(extra, torch.device("cpu"), tmp_path, None,
                         cfgs=TINY_FULL)
    full = extra["hrc_full"]["full"]
    assert full["gen"] == "synth_gt_bcf_sparse_to_file"
    assert set(full["gen_stages_s"]) == {"draws", "mosaic", "tiles", "emit",
                                         "write"}
    assert full["parity_region"] and full["parity_subset"]
    for label in SUBSET_STEPS:
        assert full[f"q_{label}_s"] > 0
    assert "stream" in full["tiers"]["subset_streamed"]
    assert full["tiers"]["subset_device_first"] == {"device": 1}
    assert full["resident_subset_device"]
    assert not full["resident_subset_streamed"]
    assert full["subset_streamed_rows"] == full["q_region_sites"] - \
        _header_lines(tmp_path)
    site = extra["hrc_full"]["site39m"]
    assert site["gen"] == "synth_gt_bcf_to_file"
    assert "gen_stages_s" not in site and site["n_rows"] == 3000


def _header_lines(bench_dir: Path) -> int:
    """The header lines of the block's region query (its line count, less
    the sites)."""
    sink = bench._Md5Sink()
    old = os.getcwd()
    os.chdir(bench_dir / "hrc_full")
    try:
        bench.main_view(["-G", "-C", "-r", "11:1-1", "full_ourdb"], out=sink,
                        device="cpu")
    finally:
        os.chdir(old)
    return sink.n


def test_bench_hrc_full_stamps_name_the_generator(tmp_path, monkeypatch):
    made = []

    def counting(gen):
        real = getattr(testing, gen)

        def made_by(*a, **kw):
            made.append(gen)
            return real(*a, **kw)
        return made_by

    for gen in ("synth_gt_bcf_sparse_to_file", "synth_gt_bcf_to_file"):
        monkeypatch.setattr(testing, gen, counting(gen))
    cfg = dict(bench.HRC_FULL_CFGS["full"], n_samples=16, n_sites=600)
    for gen in ("synth_gt_bcf_sparse_to_file", "synth_gt_bcf_sparse_to_file",
                "synth_gt_bcf_to_file"):
        bench.bench_hrc_full({}, torch.device("cpu"), tmp_path, None,
                             cfgs={"full": dict(cfg, gen=gen)})
    # the second run reuses the first's cohort; the third makes its own
    assert made == ["synth_gt_bcf_sparse_to_file", "synth_gt_bcf_to_file"]
    assert len(list((tmp_path / "hrc_full").glob("stamp-*"))) == 2
