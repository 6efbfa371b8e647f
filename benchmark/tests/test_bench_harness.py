"""The harness end to end on the CPU at a tiny size, with the program's
count path broken underneath in each way a cell can be broken: the
comparison has to find every fault.  A run with no card fails and prints no
result; on the card, every cell runs correct."""

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from benchmark import control, run, spec
from helpers import tiny_cell

SEED = 2 ** 31 + 99


@pytest.fixture
def device_tier(monkeypatch):
    """The CPU device's count pass (``count_codes_range``) answers, as the
    card's kernel does on the GPU machine."""
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")


def run_tiny(tmp_path, mix="tiny_open", config="tiny", trace=False):
    return run.run_cell(tiny_cell(mix, config), SEED, 2.0, trace, "cpu",
                        tmp_path, time.perf_counter())


@pytest.mark.parametrize("mix,config", [("tiny_open", "tiny"), ("tiny_scan", "tiny"),
                                        ("tiny_pop", "tiny1kg")])
def test_sound_run_is_correct(tmp_path, device_tier, mix, config):
    res = run_tiny(tmp_path, mix, config)
    assert res["checked"] == {"missing": 0, "wrong": 0}, res["why"]
    assert res["attempted"] > 0 and res["failed"] == 0
    names = {m["name"] for m in tiny_cell(mix, config).end_to_end}
    assert set(res["metrics"]) == names
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_traced_run_reads_its_layers(tmp_path, device_tier):
    res = run_tiny(tmp_path, trace=True)
    assert res["checked"] == {"missing": 0, "wrong": 0}, res["why"]
    got = res["metrics"]
    for name in ("prepare_ms.open", "view_ms.open", "count_ms.open", "tail_p95_ms.open"):
        assert got[name]["value"] > 0
    # no device on the CPU: no roofline, and the device idle throughout
    assert "count_roofline.open" not in got
    assert got["device_idle.open"]["value"] == 100.0
    assert res["device"]["window_s"] > 0
    assert res["breakdown"]["idle_gaps"]


def _altered(orig):
    def f(p0, p1, masks, start, length):
        out = orig(p0, p1, masks, start, length).clone()
        out[:, 0, 1] += 1  # an answer altered where it is produced
        return out
    return f


def _half(orig):
    def f(p0, p1, masks, start, length):
        m = masks.clone()
        m[:, m.shape[1] // 2:] = 0  # half of the samples left out ...
        return orig(p0, p1, m, start, length) * 2  # ... and scaled from the rest
    return f


def _unchanged(orig):
    first: dict = {}

    def f(p0, p1, masks, start, length):
        key = (length, masks.shape[0])  # the state of the first pass, kept
        if key not in first:
            first[key] = orig(p0, p1, masks, start, length)
        return first[key]
    return f


@pytest.mark.parametrize("fault", [_altered, _half, _unchanged],
                         ids=["altered", "half_left_out", "state_unchanged"])
def test_broken_count_is_not_correct(tmp_path, device_tier, monkeypatch, fault):
    from bgt_tpu_torch.ops import counts
    monkeypatch.setattr(counts, "count_codes_range", fault(counts.count_codes_range))
    res = run_tiny(tmp_path)
    assert res["checked"]["wrong"] > 0


def test_control_is_not_correct():
    res = control.control(tiny_cell("tiny_open"), SEED, 4.0)
    assert res["wrong"] > 0 and res["missing"] == 0


def _result_line(stdout: str):
    lines = stdout.strip().splitlines()
    try:
        return json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        return None


def test_no_card_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    env = {k: v for k, v in os.environ.items() if not k.startswith("BGT_TPU")}
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "hrc_r1.adhoc_af", "--seed", "7", "--seconds", "1",
                          "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300, env=env)
    assert res.returncode != 0 and _result_line(res.stdout) is None
    assert "no CUDA device" in res.stderr


def test_benchmark_alone_no_result(tmp_path):
    for p in spec.load()["paths"]:
        shutil.copytree(spec.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "hrc_r1.adhoc_af", "--seed", "7", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and _result_line(res.stdout) is None


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in spec.load()["workloads"]])
def test_cell_on_the_card(card, name):
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name,
                          "--seed", "424242", "--seconds", "5", "--trace", "0"],
                         cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    out = _result_line(res.stdout)
    assert res.returncode == 0 and out is not None, res.stderr[-2000:]
    assert out["correct"] and out["device"]["platform"] == "gpu"
    assert np.isfinite([m["value"] for m in out["metrics"].values()]).all()


@pytest.mark.parametrize("buf_bytes", [1 << 10, 1 << 20])
def test_client_reads_a_chunked_body_whole(buf_bytes):
    """A body arrives whole, read into the client's buffer or past its end."""
    import http.client
    import http.server
    import threading

    from benchmark import client

    chunks = [bytes([65 + k]) * (30000 + k) for k in range(3)]

    class Handler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_GET(self):
            self.send_response(200)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            for c in chunks:
                self.wfile.write(b"%x\r\n%s\r\n" % (len(c), c))
            self.wfile.write(b"0\r\n\r\n")

        def log_message(self, *args):
            pass

    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.server_address[1], timeout=30)
        conn.request("GET", "/")
        buf = bytearray(buf_bytes)
        n, rest = client.read_into(conn.getresponse(), buf)
        conn.close()
    finally:
        srv.shutdown()
        srv.server_close()
    assert bytes(buf[:n]) + rest == b"".join(chunks)
    assert (rest == b"") == (buf_bytes > 90003)
