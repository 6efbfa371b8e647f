"""bgt_tpu_torch's HTTP server against bgt_tpu's, byte for byte.

One small cohort, written by the port's own importer, is served in-process
by both servers, each from its own package's ``ServerConfig`` and
``BgtFile``: ``bgt_tpu``'s with ``BGT_TPU_COUNT_TIER=host`` and the port's on
the CPU device with ``BGT_TPU_COUNT_TIER=device``.  Each request of
``tests/test_server.py``'s query surface goes to both; status and body must
be equal, and on subset and group queries the port's count op must have run.
Requests go one at a time, except where a test fires them concurrently,
because the count tier is read from the process environment.
"""

import contextlib
import http.client
import io
import sys
import threading
import time
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from bgt_tpu.formats.fmf import Fmf as JaxFmf
from bgt_tpu.query import fastpath as jax_fastpath
from bgt_tpu.query.engine import BgtFile as JaxBgtFile
from bgt_tpu.server import server as jax_server
from bgt_tpu_torch import cli, testing
from bgt_tpu_torch.formats.fmf import Fmf
from bgt_tpu_torch.ops import counts
from bgt_tpu_torch.query import fastpath, importer
from bgt_tpu_torch.query.engine import BgtFile
from bgt_tpu_torch.server import server

N_SAMPLES = 12


class _Configs:
    """The two servers' configs: reads come from the port's, and a setting
    goes to both."""

    def __init__(self, jax_cfg, port_cfg):
        object.__setattr__(self, "pair", (jax_cfg, port_cfg))

    def __getattr__(self, name):
        return getattr(self.pair[1], name)

    def __setattr__(self, name, value):
        for c in self.pair:
            setattr(c, name, value)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torchsrvdb")
    (tmp / "in.vcf").write_text(
        testing.random_vcf(n_samples=N_SAMPLES, n_sites=120, seed=21))
    importer.import_vcf(str(tmp / "db"), [str(tmp / "in.vcf")], is_vcf=True)
    (tmp / "db.spl").write_text(testing.random_spl(N_SAMPLES, seed=21))
    jax_cfg = jax_server.ServerConfig()
    jax_cfg.files = [JaxBgtFile(str(tmp / "db"))]
    port_cfg = server.ServerConfig()
    port_cfg.files = [BgtFile(str(tmp / "db"))]
    cfg = _Configs(jax_cfg, port_cfg)
    cfg.port = 0
    cfg.prefixes = ["db"]
    servers = [jax_server.make_server(jax_cfg),
               server.make_server(port_cfg, "cpu")]
    threads = [threading.Thread(target=s.serve_forever, daemon=True)
               for s in servers]
    for t in threads:
        t.start()
    yield tmp, cfg, servers[0].server_address[1], servers[1].server_address[1]
    for s in servers:
        s.shutdown()
        s.server_close()


@pytest.fixture
def count_calls(monkeypatch):
    """The port's device-tier count passes, from any thread."""
    calls = []
    real = counts.count_codes_range

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(counts, "count_codes_range", spy)
    return calls


def fetch(port, query):
    url = f"http://127.0.0.1:{port}/{query}"
    try:
        with urllib.request.urlopen(url, timeout=60) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _clear():
    jax_fastpath._COUNT_MEMO.clear()
    fastpath._COUNT_MEMO.clear()


def both(served, query, monkeypatch):
    """(bgt_tpu's host-tier response, the port's device-tier response)."""
    _tmp, _cfg, jax_port, port = served
    _clear()
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "host")
    want = fetch(jax_port, query)
    _clear()
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    got = fetch(port, query)
    return want, got


def _getalt(tmp) -> list[str]:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(["getalt", str(tmp / "db")]) == 0
    return buf.getvalue().splitlines()


# (query, status, whether the port's count op runs on it); the all-samples
# queries are answered by the tile store's row statistics
QUERIES = [
    ("", 200, False),
    ("?C=", 200, False),
    ("?g=&C=", 200, False),
    ("?r=11:10000-100000&f=AC>0&C=", 200, False),
    ('?s=population=="CEU"&s=population=="YRI"&f=(AC1>0.and.AN2>0)', 200,
     True),
    ('?s=population=="TSI"&s=population=="YRI"&f=AC1>AC2.or.AN2==0', 200,
     True),
    ("?t=CHROM,POS,AC,AN", 200, False),
    ('?t=CHROM,POS,AC1,AN1,AC2,AN2&s=population=="TSI"&s=,S0001,S0002', 200,
     True),
    ("?s=,S0001,S0003,S0005&C=&r=11:10000-90000000", 200, True),
    ("?g=&r=11:1-50000000&s=,S0001,S0002,S0007", 200, True),
    ("?n=5&C=", 200, False),
    ('?n=5&s=population=="YRI"', 200, True),
    ("?i=3&n=4&s=,S0000,S0004", 200, True),
    ("?r=nonexistent:1-2", 400, False),
    ("?f=AC>)", 400, False),
    ("?i=0&C=", 400, False),
    ("?s=population=&C=", 400, False),
    ("?t=,", 400, False),
    ("?a=impact==&C=", 400, False),
]


@pytest.mark.parametrize("query,status,kernel", QUERIES,
                         ids=[q for q, _s, _k in QUERIES])
def test_query_matches_jax_server(served, monkeypatch, count_calls, query,
                                  status, kernel):
    want, got = both(served, query, monkeypatch)
    assert got == want
    assert want[0] == status
    assert bool(count_calls) == kernel


@pytest.mark.parametrize("max_gt", [1, 100, 1201, 10**9])
@pytest.mark.parametrize("query", ["?C=", "?C=&f=AC>3",
                                   '?s=population=="CEU"&f=AC>0'])
def test_quota_truncation_matches(served, monkeypatch, query, max_gt):
    _tmp, cfg, _jp, _p = served
    old = cfg.max_gt
    cfg.max_gt = max_gt
    try:
        want, got = both(served, query, monkeypatch)
    finally:
        cfg.max_gt = old
    assert want[0] == 200 and got == want
    if query == "?C=" and max_gt in (1, 10**9):
        assert want[1].endswith(b"*\n") == (max_gt == 1)


def test_mgs_forbidden_matches(served, monkeypatch):
    _tmp, cfg, _jp, _p = served
    old = cfg.min_group
    cfg.min_group = 100  # larger than any group
    try:
        want, got = both(served, '?s=population=="YRI"&C=', monkeypatch)
        assert want[0] == 403 and got == want
        # name lists of protected samples are dropped: empty, not an error
        want, got = both(served, "?s=,S0001,S0002&C=", monkeypatch)
        assert want[0] == 200 and got == want
    finally:
        cfg.min_group = old


def test_alcnt_hapcnt_matches(served, monkeypatch):
    tmp, _cfg, _jp, _p = served
    pick = ",".join(_getalt(tmp)[1:14:2])
    for query in (f"?a=,{pick}&S=1", f"?a=,{pick}&H=1",
                  f"?a=,{pick}&S=1&n=2", f"?a=,{pick}&H=1&s=,S0001,S0004"):
        want, got = both(served, query, monkeypatch)
        assert want[0] == 200 and got == want, query
        if "H=1" in query:  # no sample carries all 7 alleles: S is empty
            assert want[1].startswith(b"NA\t7\n")


def test_vardb_allele_expression_matches(served, monkeypatch):
    tmp, cfg, _jp, _p = served
    lines = [f"{k}\timpact:Z:{'HIGH' if i % 4 == 0 else 'LOW'}"
             for i, k in enumerate(_getalt(tmp))]
    (tmp / "anno.fmf").write_text("\n".join(lines) + "\n")
    old = cfg.vardb
    jax_cfg, port_cfg = cfg.pair
    jax_cfg.vardb = JaxFmf.read(str(tmp / "anno.fmf"))
    port_cfg.vardb = Fmf.read(str(tmp / "anno.fmf"))
    try:
        for expr, status in (('impact=="HIGH"', 200), ('impact=="NONE"', 204)):
            query = "?a=" + urllib.parse.quote(expr) + "&C="
            want, got = both(served, query, monkeypatch)
            assert want[0] == status and got == want
    finally:
        cfg.vardb = old


def test_response_streams_before_query_completes(served, monkeypatch):
    """The first chunk reaches the client while the port's producer is
    still blocked inside FastView.run."""
    _tmp, _cfg, _jp, port = served
    release = threading.Event()
    finished = threading.Event()

    class _SlowView:
        def __init__(self, bm, opt, device):
            pass

        def run(self, w):
            w.write("first-chunk\n")
            assert release.wait(timeout=30.0), "consumer never saw chunk 1"
            w.write("second-chunk\n")
            finished.set()

    monkeypatch.setattr(fastpath, "FastView", _SlowView)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/?r=11:10000-100000&C=1")
    resp = conn.getresponse()
    got = b""
    while b"first-chunk" not in got:
        got += resp.read1(65536)
    assert not finished.is_set(), "producer finished before first byte read"
    release.set()
    assert b"second-chunk" in resp.read()
    assert finished.is_set()
    conn.close()


def test_client_disconnect_releases_producer(served, monkeypatch):
    """An abandoned connection releases a producer blocked on the full
    queue: its next write raises."""
    _tmp, _cfg, _jp, port = served
    aborted = threading.Event()
    started = threading.Event()

    class _Flood:
        def __init__(self, bm, opt, device):
            pass

        def run(self, w):
            started.set()
            try:
                while True:  # far more than the queue holds
                    w.write("x" * 65536 + "\n")
            except BaseException:
                aborted.set()
                raise

    monkeypatch.setattr(fastpath, "FastView", _Flood)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    conn.request("GET", "/?r=11:10000-100000&C=1")
    resp = conn.getresponse()
    resp.read1(1024)
    assert started.wait(timeout=10.0)
    conn.close()  # abandon mid-stream
    assert aborted.wait(timeout=10.0), "producer still blocked after disconnect"


def test_stream_writer_bounds_and_wakes():
    """The queue holds at most maxsize chunks; the consumer's stop wakes a
    blocked producer once, with no polling."""
    w = server._StreamWriter(maxsize=3)
    outcome = []

    def produce():
        try:
            for i in range(10):
                w.write(f"{i}\n")
        except server._ClientGone:
            outcome.append("gone")
        finally:
            w.close_producer()

    t = threading.Thread(target=produce)
    t.start()
    chunks = w.drain()
    assert next(chunks) == b"0\n"
    deadline = time.monotonic() + 10
    while len(w._items) < 3 and time.monotonic() < deadline:
        time.sleep(0.01)
    time.sleep(0.05)
    assert len(w._items) == 3 and t.is_alive()  # blocked on the full queue
    w.stop()
    t.join(timeout=10)
    assert not t.is_alive() and outcome == ["gone"]
    assert list(chunks) == [b"1\n", b"2\n", b"3\n"]

    w = server._StreamWriter(maxsize=2)
    t = threading.Thread(target=lambda: (w.buffer.write(b"ab"), w.write("c"),
                                         w.write("d"), w.close_producer()))
    t.start()
    assert b"".join(w.drain()) == b"abcd"
    t.join(timeout=10)
    assert not t.is_alive()


class _CountedTiles(fastpath.DeviceTiles):
    """DeviceTiles that count their transfers and hold the first one open
    long enough for every other thread to arrive."""

    built = []

    def __init__(self, ts, device):
        self.built.append(1)
        time.sleep(0.2)
        super().__init__(ts, device)


def test_concurrent_first_queries_transfer_once(served, monkeypatch,
                                                count_calls):
    """8 concurrent first queries with distinct masks: every body equals
    bgt_tpu's, and the planes reach the device once."""
    _tmp, _cfg, jax_port, port = served
    queries = [f"?s=,S{i:04d},S{i + 3:04d}&C=" for i in range(8)]
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "host")
    _clear()
    want = {q: fetch(jax_port, q) for q in queries}
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    monkeypatch.setattr(fastpath, "DeviceTiles", _CountedTiles)
    _CountedTiles.built.clear()
    fastpath._DEVICE_CACHE.clear()
    _clear()
    results = {}
    start = threading.Barrier(len(queries))

    def worker(q):
        start.wait(timeout=30)
        results[q] = fetch(port, q)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(q,)) for q in queries]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert len(count_calls) == len(queries)
    assert _CountedTiles.built == [1]
    for q in queries:
        assert want[q][0] == 200 and results[q] == want[q], q


def test_get_device_tiles_two_threads(served, monkeypatch):
    """Two threads asking at once for uncached planes get one transfer and
    the same object; the entry stays cached and the build lock is gone."""
    _tmp, cfg, _jp, _p = served
    monkeypatch.setattr(fastpath, "DeviceTiles", _CountedTiles)
    _CountedTiles.built.clear()
    fastpath._DEVICE_CACHE.clear()
    got = []
    barrier = threading.Barrier(2)

    def ask():
        barrier.wait(timeout=30)
        got.append(fastpath.get_device_tiles(cfg.files[0], torch.device("cpu")))

    threads = [threading.Thread(target=ask) for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert _CountedTiles.built == [1]
    assert len(got) == 2 and got[0] is got[1] is not None
    assert not fastpath._BUILD_LOCKS
    assert fastpath.get_device_tiles(cfg.files[0], torch.device("cpu")) is got[0]
    assert _CountedTiles.built == [1]
    # over the budget: None is cached too, and nothing is transferred
    fastpath._DEVICE_CACHE.clear()
    monkeypatch.setenv("BGT_TPU_HBM_BUDGET", "1")
    assert fastpath.get_device_tiles(cfg.files[0], torch.device("cpu")) is None
    assert len(fastpath._DEVICE_CACHE) == 1
    assert _CountedTiles.built == [1]
    fastpath._DEVICE_CACHE.clear()


def test_cli_server_cuda_unavailable(served, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    tmp, _cfg, _jp, _p = served
    assert cli.main(["server", "-p", "0", str(tmp / "db")]) == 1
    assert "not available" in capsys.readouterr().err


def test_main_server_serves(served, monkeypatch):
    """``main_server`` on the CPU device serves the same bytes as
    bgt_tpu's server; ``files.no_file`` is restored afterwards."""
    from bgt_tpu_torch.io import files
    tmp, _cfg, jax_port, _p = served
    started = {}
    real_make = server.make_server

    def make(cfg, device=None):
        srv = real_make(cfg, device)
        started["srv"] = srv
        return srv

    monkeypatch.setattr(server, "make_server", make)
    monkeypatch.setattr(files, "no_file", files.no_file)
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    t = threading.Thread(target=cli.main, args=(
        ["server", "-p", "0", str(tmp / "db")],), kwargs={"device": "cpu"},
        daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while "srv" not in started and time.monotonic() < deadline:
        time.sleep(0.01)
    srv = started["srv"]
    try:
        query = '?s=population=="CEU"&C='
        _clear()
        got = fetch(srv.server_address[1], query)
        monkeypatch.setenv("BGT_TPU_COUNT_TIER", "host")
        _clear()
        assert got == fetch(jax_port, query)
        assert got[0] == 200
        status, body = fetch(srv.server_address[1], "")
        assert status == 200 and b"Accepted Parameters" in body
    finally:
        srv.shutdown()
        t.join(timeout=30)
    assert not t.is_alive()
    assert files.no_file is True  # set by main_server, restored after
