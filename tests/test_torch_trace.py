"""The port's spans (``bgt_tpu_torch.log``) in its server and view path.

A small cohort is imported by the port's importer and served in-process on
the CPU device.  With spans on, one request's spans from the handler and
the producer thread share one request id and form one tree under
``request``; the ``count`` span names the tier ``fastpath.TIERS`` counted;
``prepare.group`` counts the samples it evaluated and names the path that
evaluated them.  With spans off nothing
of a request is recorded and no ``record_function`` is entered; a
``torch.profiler`` window opened on another thread turns them on.  The
Chrome export lines the spans up with the profiler's own events, and the
``BGT_TPU_TRACE`` file holds the query's spans.
"""

import http.client
import io
import json
import re
import threading
import time
import urllib.parse

import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bgt_tpu_torch import log, testing
from bgt_tpu_torch.query import fastpath, importer, view
from bgt_tpu_torch.query.engine import BgtFile
from bgt_tpu_torch.server import server

N_SAMPLES = 12
CPU = torch.device("cpu")
# the spans a process records whether or not spans are on
LIFETIME = {"startup.kernel_library", "startup.cuda_context", "db.open",
            "tiles.build", "tiles.upload"}
REQUEST_SPANS = {"request", "server.queue", "reader.open", "prepare",
                 "prepare.group", "prepare.select", "producer.wait", "view",
                 "site-select", "merge", "device-counts[0]", "count",
                 "count.launch", "count.readback", "filter", "emit"}


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torchtracedb")
    (tmp / "in.vcf").write_text(
        testing.random_vcf(n_samples=N_SAMPLES, n_sites=120, seed=21))
    importer.import_vcf(str(tmp / "db"), [str(tmp / "in.vcf")], is_vcf=True)
    (tmp / "db.spl").write_text(testing.random_spl(N_SAMPLES, seed=21))
    return str(tmp / "db")


def _serve(prefixes):
    cfg = server.ServerConfig()
    cfg.port = 0
    cfg.files = [BgtFile(p) for p in prefixes]
    cfg.prefixes = [f"db{i}" for i in range(len(prefixes))]
    srv = server.make_server(cfg, CPU)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    return srv


@pytest.fixture(scope="module")
def servers(db):
    """{number of databases: server}: the cohort once, and twice."""
    out = {1: _serve([db]), 2: _serve([db, db])}
    yield out
    for srv in out.values():
        srv.shutdown()
        srv.server_close()


@pytest.fixture
def spans_on(monkeypatch):
    """Spans on without the cost of a profiler window."""
    monkeypatch.setattr(log, "recording", lambda: True)


@pytest.fixture
def device_tier(monkeypatch):
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    fastpath._COUNT_MEMO.clear()
    yield
    fastpath._COUNT_MEMO.clear()


def query(**params):
    """A request path: each value a list of that parameter's values."""
    return "/?" + urllib.parse.urlencode(
        [(k, v) for k, vs in params.items() for v in vs])


GROUPS = query(s=['gender=="M"'], f=["AC>0"])
TWO_GROUPS = query(s=['gender=="M"', 'gender=="F"'], C=["1"])


def get(srv, path):
    conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1],
                                      timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def served_request(since: int, timeout: float = 10.0) -> log.Span:
    """The first ``request`` span recorded after ``since`` (the handler
    records it after the client has the last byte)."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        got = [s for s in log.records()
               if s.name == "request" and s.t0 >= since]
        if got:
            return got[0]
        time.sleep(0.01)
    raise AssertionError("no request span was recorded")


def tree(request: log.Span) -> list:
    return [s for s in log.records() if s.request == request.request]


def test_one_request_is_one_tree_across_threads(servers, spans_on,
                                                device_tier):
    srv = servers[1]
    since = log.now()
    status, body = get(srv, GROUPS)
    assert status == 200
    req = served_request(since)
    spans = tree(req)
    names = {s.name for s in spans}
    assert REQUEST_SPANS <= names, REQUEST_SPANS - names
    by_id = {s.span: s for s in spans}
    assert [s for s in spans if s.parent == 0] == [req]
    for s in spans:  # every span reaches the request through its parents
        hops = 0
        while s.parent:
            s = by_id[s.parent]
            hops += 1
            assert hops < 10
        assert s is req
    one = {s.name: s for s in spans}
    assert one["view"].thread != req.thread
    assert one["producer.wait"].thread == one["view"].thread
    assert one["prepare"].thread == req.thread
    assert len({s.thread for s in spans}) == 2
    assert one["server.queue"].t1 == req.t0
    assert req.attrs == {"status": 200, "bytes": len(body)}
    records = [x for x in body.decode().splitlines()
               if x and not x.startswith("#")]
    assert one["emit"].attrs["lines"] == len(records)
    assert one["count.launch"].attrs["groups"] == 1
    assert one["count.readback"].attrs["bytes"] == (
        one["count.launch"].attrs["rows"] * 1 * 4 * 4)
    for s in spans:
        assert s.t0 <= s.t1
    assert srv.accepted == {}


@pytest.mark.parametrize("tier", ["device", "host", "memo", "rowstats"])
def test_count_span_names_the_tier(servers, spans_on, monkeypatch, tier):
    srv = servers[1]
    fastpath._COUNT_MEMO.clear()
    monkeypatch.setenv("BGT_TPU_COUNT_TIER",
                       "host" if tier == "host" else "device")
    path = query(r=["11"], C=["1"]) if tier == "rowstats" else GROUPS
    if tier == "memo":
        assert get(srv, path)[0] == 200
    try:
        tiers0 = dict(fastpath.TIERS)
        since = log.now()
        assert get(srv, path)[0] == 200
        spans = tree(served_request(since))
    finally:
        fastpath._COUNT_MEMO.clear()
    delta = {k: v - tiers0[k] for k, v in fastpath.TIERS.items()
             if v != tiers0[k]}
    assert delta == {tier: 1}
    counts = [s for s in spans if s.name == "count"]
    assert [s.attrs["tier"] for s in counts] == [tier]
    readbacks = [s for s in spans if s.name == "count.readback"]
    assert len(readbacks) == (tier == "device")
    assert all(s.parent == counts[0].span for s in readbacks)


@pytest.mark.parametrize("n_db", [1, 2])
def test_group_span_counts_the_samples_evaluated(servers, spans_on,
                                                 device_tier, n_db):
    since = log.now()
    assert get(servers[n_db], TWO_GROUPS)[0] == 200
    spans = tree(served_request(since))
    groups = [s for s in spans if s.name == "prepare.group"]
    assert len(groups) == 2
    assert all(s.attrs["samples"] == N_SAMPLES * n_db for s in groups)
    spl = [line.split("\t") for line in
           testing.random_spl(N_SAMPLES, seed=21).splitlines()]
    males = sum("gender:Z:M" in row for row in spl)
    assert [s.attrs["selected"] for s in groups] == [
        males * n_db, (N_SAMPLES - males) * n_db]
    prepare = [s for s in spans if s.name == "prepare"][0]
    assert all(s.parent == prepare.span for s in groups)
    assert [s.attrs["path"] for s in groups] == ["vector", "vector"]


@pytest.mark.parametrize("expr,path", [('gender=="F"||gender=="M"', "vector"),
                                       ('_ROW_=="S0001"', "scalar")])
def test_group_span_names_the_evaluation_path(servers, spans_on, device_tier,
                                              expr, path):
    since = log.now()
    assert get(servers[1], query(s=[expr], C=["1"]))[0] == 200
    groups = [s for s in tree(served_request(since))
              if s.name == "prepare.group"]
    assert [s.attrs["path"] for s in groups] == [path]


def test_spans_off_record_nothing_of_a_request(servers, device_tier,
                                               monkeypatch):
    entered = []
    real = record_function.__enter__

    def spy(self):
        entered.append(self)
        return real(self)

    monkeypatch.setattr(record_function, "__enter__", spy)
    assert not log.recording()
    before = len(log.records())
    assert get(servers[1], GROUPS)[0] == 200
    time.sleep(0.2)
    new = log.records()[before:]
    assert {s.name for s in new} <= LIFETIME
    assert all(s.request == 0 for s in new)
    assert entered == []
    assert servers[1].accepted == {}


def test_profiler_window_turns_spans_on_in_server_threads(servers,
                                                          device_tier):
    """Pins torch's process-wide ``_is_profiler_enabled``: the server's
    threads read it to record while a window is open on another thread."""
    assert not torch.autograd.profiler._is_profiler_enabled
    since = log.now()
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch.autograd.profiler._is_profiler_enabled
        assert get(servers[1], GROUPS)[0] == 200
        req = served_request(since)
    assert not log.recording()
    assert req.thread != threading.get_native_id()
    assert REQUEST_SPANS <= {s.name for s in tree(req)}


def test_exported_span_lines_up_with_record_function(tmp_path, spans_on):
    path = tmp_path / "t.pt.trace.json"
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bgt.warm"):  # a process's first one is slow
            pass
        with record_function("bgt.mark"), log.span("bgt.mark.span") as sp:
            time.sleep(0.005)
    prof.export_chrome_trace(str(path))
    mine = [s for s in log.records() if s.span == sp.span]
    log.export_chrome(str(path), mine)
    events = json.loads(path.read_text())["traceEvents"]
    mark = [e for e in events if e.get("name") == "bgt.mark"][0]
    ours = [e for e in events if e.get("name") == "bgt.mark.span"][0]
    assert ours["cat"] == "bgt_span" and ours["ph"] == "X"
    assert abs(ours["ts"] - mark["ts"]) < 2000
    assert abs(ours["dur"] - mark["dur"]) < 2000
    assert ours["args"]["span"] == sp.span


def test_export_writes_a_new_file(tmp_path, spans_on):
    with log.request_span("query"):
        with log.span("inner", rows=3):
            pass
    spans = log.records()[-2:]
    path = tmp_path / "spans.json"
    log.export_chrome(str(path), spans)
    trace = json.loads(path.read_text())
    got = {e["name"]: e for e in trace["traceEvents"]}
    assert got["inner"]["args"]["rows"] == 3
    assert got["inner"]["args"]["parent"] == got["query"]["args"]["span"]
    assert got["inner"]["args"]["request"] == got["query"]["args"]["request"]
    wall = trace["baseTimeNanoseconds"] + got["query"]["ts"] * 1e3
    assert abs(wall - time.time_ns()) < 60e9


def _trace_events(trace_dir) -> list:
    files = list(trace_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    return json.loads(files[0].read_text())["traceEvents"]


def _trace_spans(trace_dir) -> list:
    return [e for e in _trace_events(trace_dir) if e.get("cat") == "bgt_span"]


def test_view_trace_file_holds_the_querys_spans(db, monkeypatch, tmp_path,
                                                device_tier):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("BGT_TPU_TRACE", str(trace_dir))
    out, err = io.StringIO(), io.StringIO()
    assert view.main_view(["-G", "-C", "-s", 'gender=="M"', db], out=out,
                          err=err, device=CPU) == 0, err.getvalue()
    spans = _trace_spans(trace_dir)
    names = {e["name"] for e in spans}
    assert {"query", "view", "count", "count.launch", "count.readback",
            "emit"} <= names
    assert len({e["args"]["request"] for e in spans}) == 1
    assert [e["name"] for e in spans if e["args"]["parent"] == 0] == ["query"]


def test_server_trace_file_holds_the_request(servers, monkeypatch, tmp_path,
                                             device_tier):
    trace_dir = tmp_path / "trace"
    monkeypatch.setenv("BGT_TPU_TRACE", str(trace_dir))
    assert get(servers[1], GROUPS)[0] == 200
    end = time.monotonic() + 10
    while True:  # the handler writes the file after the last byte is sent
        try:
            spans = _trace_spans(trace_dir)
        except (AssertionError, ValueError):
            spans = []
        if any(e["name"] == "request" for e in spans):
            break
        assert time.monotonic() < end, "no trace file with the request"
        time.sleep(0.02)
    one = {e["name"]: e for e in spans}
    assert REQUEST_SPANS <= set(one)
    assert len({e["args"]["request"] for e in spans}) == 1
    assert one["prepare"]["tid"] == one["request"]["tid"]
    assert one["view"]["tid"] != one["request"]["tid"]
    assert one["request"]["ts"] <= one["prepare"]["ts"] <= one["view"]["ts"]
    # the profiler recorded every thread: the producer's torch ops are there
    ops = [e for e in _trace_events(trace_dir)
           if e.get("cat") == "cpu_op" and e.get("tid") == one["view"]["tid"]]
    assert any(e["name"].startswith("aten::") for e in ops)
    # the request's spans went to its file, not to the process's buffer
    request = one["request"]["args"]["request"]
    assert not [s for s in log.records() if s.request == request]


STAGE = re.compile(r"^\[T::(.+)\] (\d+\.\d\d) ms$")


@pytest.mark.parametrize("on", [False, True], ids=["spans_off", "spans_on"])
def test_stage_lines_at_verbosity_4(db, monkeypatch, capsys, device_tier,
                                    on):
    """``[T::name] x ms`` lines as ``chip_smoke.py`` parses them, whether
    or not the stages are recorded as spans; the lifetime spans print theirs
    too."""
    if on:
        monkeypatch.setattr(log, "recording", lambda: True)
    verbosity = log.verbosity()
    log.set_verbosity(4)
    before = len(log.records())
    try:
        BgtFile(db)
        out, err = io.StringIO(), io.StringIO()
        assert view.main_view(["-G", "-C", "-s", 'gender=="M"', db],
                              out=out, err=err, device=CPU) == 0
    finally:
        log.set_verbosity(verbosity)
    lines = [STAGE.match(x).group(1)
             for x in capsys.readouterr().err.splitlines()
             if x.startswith("[T::")]
    assert [x for x in lines if x not in LIFETIME] == [
        "site-select", "merge", "device-counts[0]", "emit"]
    assert "db.open" in lines
    stages = [s.name for s in log.records()[before:]
              if s.name in ("site-select", "merge", "device-counts[0]",
                            "emit")]
    assert stages == (["site-select", "merge", "device-counts[0]", "emit"]
                      if on else [])


def test_carry_hands_the_request_to_a_thread(spans_on):
    seen = []
    with log.request_span() as req, log.span("outer") as outer:
        t = threading.Thread(target=log.carry(
            lambda: seen.append(log.span("inner").__enter__())))
        t.start()
        t.join(timeout=10)
        bare = threading.Thread(target=lambda: seen.append(
            log.span("bare").__enter__()))
        bare.start()
        bare.join(timeout=10)
    assert not t.is_alive() and not bare.is_alive()
    inner, alone = seen
    assert (inner.request, inner.parent) == (req.request, outer.span)
    assert (alone.request, alone.parent) == (0, 0)
