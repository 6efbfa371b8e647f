"""bgt_tpu_torch's ``view`` path against bgt_tpu's, byte for byte.

A small cohort is imported once, by the port's own importer; each query
runs through the port's ``main_view`` on the CPU device with the device
count tier forced, through ``bgt_tpu``'s ``main_view`` on its JAX-CPU device
tier, and through ``bgt_tpu``'s host tier.  All three outputs must be the same bytes, and the
port's count op must have run (otherwise rowstats or a memo answered).
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bgt_tpu.ops.tiles import TileStore as JaxTileStore
from bgt_tpu.query import fastpath as jax_fastpath
from bgt_tpu.query import view as jax_view
from bgt_tpu_torch import testing
from bgt_tpu_torch.ops import counts
from bgt_tpu_torch.ops.tiles import TileStore
from bgt_tpu_torch.query import engine, fastpath, importer, view

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torchviewdb")
    (tmp / "in.vcf").write_text(
        testing.random_vcf(n_samples=24, n_sites=300, seed=7, with_filter=True))
    importer.import_vcf(str(tmp / "db"), [str(tmp / "in.vcf")], is_vcf=True)
    (tmp / "db.spl").write_text(testing.random_spl(24, seed=7))
    return str(tmp / "db")


@pytest.fixture
def count_calls(monkeypatch):
    """Counts the port's device-tier count passes (CPU or CUDA)."""
    calls = []
    real = counts.count_codes_range

    def spy(*args, **kw):
        calls.append(args[4] if len(args) > 4 else kw["length"])
        return real(*args, **kw)

    monkeypatch.setattr(counts, "count_codes_range", spy)
    return calls


def _clear():
    jax_fastpath._COUNT_MEMO.clear()
    fastpath._COUNT_MEMO.clear()
    fastpath._DEVICE_CACHE.clear()


def _run(main_view, args, db, **kw):
    _clear()
    buf, err = io.StringIO(), io.StringIO()
    assert main_view(args + [db], out=buf, err=err, **kw) == 0, err.getvalue()
    return buf.getvalue()


QUERIES = [
    ["-G", "-C", "-s", 'population=="CEU"'],
    ["-s", 'population=="CEU"', "-s", 'population=="YRI"',
     "-f", "AC1/AN1>=0.1&&AC2==0", "-G"],
    ["-s", 'population=="CEU"', "-s", 'population=="YRI"',
     "-f", "AC1>AC2", "-G", "-C"],
    ["-t", "CHROM,POS,AC,AN", "-r", "11:100000-200000",
     "-s", ",S0001,S0003,S0005"],
    ["-s", 'population=="CEU"', "-s", 'population=="TSI"',
     "-t", "POS,AC1,AN1,AC2,AN2"],
    ["-s", ",S0001,S0003,S0005", "-C", "-r", "11:10000-300000"],
]


@pytest.mark.parametrize("args", QUERIES, ids=[" ".join(q) for q in QUERIES])
@pytest.mark.parametrize("budget", [None, "1"], ids=["resident", "streamed"])
def test_view_matches_jax_package(db, monkeypatch, count_calls, args, budget):
    if budget is not None:
        monkeypatch.setenv("BGT_TPU_HBM_BUDGET", budget)
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "host")
    host = _run(jax_view.main_view, args, db)
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    jax_device = _run(jax_view.main_view, args, db)
    assert not count_calls
    ours = _run(view.main_view, args, db, device=CPU)
    assert count_calls, "the port's device count tier did not run"
    key = next(iter(fastpath._DEVICE_CACHE))
    assert (fastpath._DEVICE_CACHE[key] is None) == (budget is not None)
    assert len(host.splitlines()) > 3
    assert ours == jax_device == host


def test_view_two_groups_emits_records(db, monkeypatch):
    """The -f parity case above is not vacuous: records pass the filter."""
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    out = _run(view.main_view, QUERIES[2], db, device=CPU)
    assert sum(not line.startswith("#") for line in out.splitlines()) > 10


def test_stream_counts_chunks_match_host(db):
    ts = TileStore.open_or_build(db)
    rng = np.random.default_rng(1)
    rows = np.sort(rng.choice(ts.n_rows, size=157, replace=False))
    masks = rng.integers(0, 2**32, (3, ts.n_words), dtype=np.uint32)
    for chunk in (1, 16, 64, 1000):
        got = fastpath.stream_counts(ts, rows, masks, CPU, chunk_rows=chunk)
        np.testing.assert_array_equal(
            got, jax_fastpath.host_counts(JaxTileStore.open_or_build(db),
                                          rows, masks))
        np.testing.assert_array_equal(
            got, fastpath.host_counts(ts, rows, masks))
    empty = fastpath.stream_counts(ts, rows[:0], masks, CPU)
    assert empty.shape == (0, 3, 4)


def test_memo_answers_repeat_queries(db, monkeypatch, count_calls):
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    first = _run(view.main_view, QUERIES[0], db, device=CPU)
    assert count_calls == [TileStore.open_or_build(db).n_rows]  # full range
    buf = io.StringIO()
    assert view.main_view(QUERIES[0] + [db], out=buf, device=CPU) == 0
    assert buf.getvalue() == first
    assert len(count_calls) == 1  # the port's memo answered


def test_device_tier_without_cuda_raises(db, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    with pytest.raises(RuntimeError, match="not available"):
        _run(view.main_view, QUERIES[0], db)  # default device: cuda


def test_auto_tier_without_cuda_raises(db, monkeypatch, count_calls):
    """Under the default tier a CUDA device with no CUDA raises: the host
    never stands in for the card unasked.  Queries that rowstats answers
    still need no device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("BGT_TPU_COUNT_TIER", raising=False)
    with pytest.raises(RuntimeError, match="BGT_TPU_COUNT_TIER=auto"):
        _run(view.main_view, QUERIES[0], db)  # default device: cuda
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "host")
    want = _run(jax_view.main_view, ["-G", "-C"], db)
    monkeypatch.delenv("BGT_TPU_COUNT_TIER")
    assert _run(view.main_view, ["-G", "-C"], db) == want
    assert not count_calls


def _ctx(db, device):
    bm = engine.BgtmReader([engine.open_bgt_cached(db)])
    bm.prepare()
    return fastpath.DbCtx(bm.bgt[0], None, torch.device(device))


def test_count_tier_cuda_default_cut(db, monkeypatch):
    """On a CUDA device ``auto`` keeps the host tier only for work below one
    transfer of the planes (2 x plane0.nbytes), and takes the card above."""
    monkeypatch.delenv("BGT_TPU_COUNT_TIER", raising=False)
    monkeypatch.delenv("BGT_TPU_HOST_WORK_MAX", raising=False)
    monkeypatch.setattr(fastpath, "device_available", lambda device: True)
    fastpath._DEVICE_CACHE.clear()
    ctx = _ctx(db, "cuda")
    ts = ctx.ts
    one_transfer = 2 * ts.plane0.nbytes
    per_row = ts.plane0.shape[1] * 4 * 3  # three masked passes, one mask
    masks = np.zeros((1, ts.n_words), np.uint32)
    below = one_transfer // per_row      # rows whose work is <= the cut
    rows = np.arange(below)
    assert rows.size * per_row <= one_transfer
    assert ctx._count_tier(rows, masks, True) == "host"
    rows = np.arange(below + 1)
    assert rows.size * per_row > one_transfer
    assert ctx._count_tier(rows, masks, True) == "device"
    # the whole range with one mask is 1.5 transfers: the card
    assert ctx._count_tier(np.arange(ts.n_rows), masks, True) == "device"
    # the CPU device keeps bgt_tpu's 64 GiB default: the host tier
    assert _ctx(db, "cpu")._count_tier(np.arange(ts.n_rows), masks,
                                       True) == "host"


@pytest.mark.parametrize("limit,want", [(0, "device"), (1 << 40, "host")])
def test_count_tier_host_work_max_overrides(db, monkeypatch, limit, want):
    monkeypatch.delenv("BGT_TPU_COUNT_TIER", raising=False)
    monkeypatch.setenv("BGT_TPU_HOST_WORK_MAX", str(limit))
    monkeypatch.setattr(fastpath, "device_available", lambda device: True)
    fastpath._DEVICE_CACHE.clear()
    ctx = _ctx(db, "cuda")
    masks = np.zeros((2, ctx.ts.n_words), np.uint32)
    assert ctx._count_tier(np.arange(ctx.ts.n_rows), masks, True) == want


def test_count_tier_without_cuda_raises_under_auto(db, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.delenv("BGT_TPU_COUNT_TIER", raising=False)
    ctx = _ctx(db, "cuda")
    masks = np.zeros((1, ctx.ts.n_words), np.uint32)
    with pytest.raises(RuntimeError, match="not available"):
        ctx._count_tier(np.arange(4), masks, True)
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "host")
    assert ctx._count_tier(np.arange(4), masks, True) == "host"


def test_column_shard_tile_raises(db, monkeypatch):
    """With one slot and no process group there is no mesh: a column-shard
    tile store raises, as in ``bgt_tpu``; it does not count a slice of the
    columns."""
    TileStore.emit_shards(db, 2, 2)
    monkeypatch.setenv("BGT_TPU_TILE_SHARD", "0:2")
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    fastpath._TILE_CACHE.clear()
    try:
        with pytest.raises(ValueError, match="mesh"):
            _run(view.main_view, QUERIES[0], db, device=CPU)
    finally:
        fastpath._TILE_CACHE.clear()


def test_cli_server_usage(capsys):
    from bgt_tpu_torch import cli
    assert cli.main(["server"]) == 1
    assert "Usage: bgt server" in capsys.readouterr().err


def test_trace_writes_chrome_trace(db, monkeypatch, tmp_path, count_calls):
    """BGT_TPU_TRACE=<dir>: the query runs under torch.profiler, one Chrome
    trace lands in <dir>, and the output bytes do not change."""
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    plain = _run(view.main_view, QUERIES[1], db, device=CPU)
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("BGT_TPU_TRACE", str(trace_dir))
    traced = _run(view.main_view, QUERIES[1], db, device=CPU)
    assert traced == plain
    assert len(count_calls) == 2
    files = list(trace_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    assert trace["traceEvents"]


_NO_JAX = r"""
import importlib, io, os, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import bgt_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(bgt_tpu_torch.__path__,
                                              "bgt_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from bgt_tpu_torch import cli
from bgt_tpu_torch.ops import counts
calls = []
real = counts.count_codes_range
counts.count_codes_range = lambda *a: calls.append(1) or real(*a)
os.environ["BGT_TPU_COUNT_TIER"] = "device"
buf = io.StringIO()
sys.stdout, real_out = buf, sys.stdout
rc = cli.main(["view", "-G", "-C", "-s", 'population=="CEU"', sys.argv[2]],
              device="cpu")
sys.stdout = real_out
assert rc == 0 and calls and buf.getvalue().count("\n") > 3
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
assert not [m for m in sys.modules if m == "bgt_tpu" or m.startswith("bgt_tpu.")]
print("NO-JAX", len(mods))
"""


def test_port_never_imports_jax(db):
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    res = subprocess.run([sys.executable, "-c", _NO_JAX, str(REPO), db],
                         capture_output=True, text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "NO-JAX" in res.stdout
