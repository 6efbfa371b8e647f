"""The readers of the program's spans (``bgt_tpu_torch.log``), each on a
span buffer built by hand and a window of ``Readings``; and on a program
with no span recorder, each finds nothing to read."""

import pytest

from benchmark import spec
from benchmark.tracing import Readings, Spans
from bgt_tpu_torch import log

MS = 1_000_000  # ns
T0 = 1_000 * 1_000_000_000  # the window opens at 1,000 s on perf_counter
NAMES = ("queue_ms.open", "http_ms.open", "group_eval_us.open",
         "readback_ms.open", "tile_load_s.open")


def sp(name, t0_ms, t1_ms, request=0, **attrs):
    return log.Span(name, 0, 0, request, 1, T0 + int(t0_ms * MS),
                    T0 + int(t1_ms * MS), attrs)


def window(answered=2, seconds=10.0):
    return Readings(Spans(), answered, (T0 * 1e-9, T0 * 1e-9 + seconds))


@pytest.fixture
def buffer(monkeypatch):
    spans: list = []
    monkeypatch.setattr(log, "records", lambda: list(spans))
    return spans


def read(name, m):
    return spec.reader(name)(m)


def test_queue_ms(buffer):
    buffer += [sp("server.queue", 10, 11, 1), sp("producer.wait", 20, 20.5, 1),
               sp("server.queue", 100, 102, 2), sp("producer.wait", 200, 200.5, 2),
               sp("server.queue", -50, -10, 9)]  # before the window
    assert read("queue_ms.open", window()) == pytest.approx((1 + 0.5 + 2 + 0.5) / 2)


def test_http_ms_takes_the_union_of_the_parts(buffer):
    buffer += [
        sp("request", 0, 100, 1),
        sp("server.queue", -3, 0, 1),   # before the request: nothing within
        sp("prepare", 10, 40, 1),
        sp("view", 30, 80, 1),           # overlaps prepare: union 10-80
        sp("prepare.group", 12, 30, 1),  # not a part
        sp("request", 200, 250, 2),
        sp("view", 190, 240, 2),         # starts before the request: 200-240
        sp("prepare", 300, 400, 3),      # another request's
    ]
    # request 1: 100 - 70 = 30; request 2: 50 - 40 = 10; over 4 answered
    assert read("http_ms.open", window(answered=4)) == pytest.approx(40 / 4)


def test_http_ms_nested_and_disjoint_parts(buffer):
    buffer += [sp("request", 0, 100, 5), sp("prepare", 10, 20, 5),
               sp("view", 12, 15, 5), sp("view", 50, 60, 5),
               sp("request", 10_001, 10_002, 6)]  # after the window
    assert read("http_ms.open", window(answered=1)) == pytest.approx(80.0)


def test_group_eval_us(buffer):
    buffer += [sp("prepare.group", 0, 30, 1, samples=10_000, selected=5),
               sp("prepare.group", 40, 50, 2, samples=2_500, selected=7),
               sp("prepare.group", -90, -10, 0, samples=1, selected=1)]
    assert read("group_eval_us.open", window()) == pytest.approx(40_000 / 12_500)


def test_readback_ms_is_per_pass(buffer):
    buffer += [sp("count.readback", 5, 6, 1, bytes=16),
               sp("count.readback", 50, 53, 2, bytes=16),
               sp("count.readback", -5, -1, 0, bytes=16)]
    assert read("readback_ms.open", window(answered=7)) == pytest.approx(2.0)


def test_tile_load_s_reads_the_last_database_before_the_window(buffer):
    buffer += [sp("tiles.build", -9_000, -8_000, db="old"),
               sp("tiles.upload", -7_900, -7_000, db="old"),
               sp("tiles.build", -5_000, -3_000, db="cell"),
               sp("tiles.build", -2_900, -2_000, db="other"),
               sp("tiles.upload", -1_500, -1_000, db="cell"),
               sp("tiles.build", 100, 200, db="late")]  # in the window
    assert read("tile_load_s.open", window()) == pytest.approx(0.9)


def test_tile_load_s_leaves_out_an_earlier_load(buffer):
    buffer += [sp("tiles.build", -9_000, -8_000, db="cell"),
               sp("tiles.upload", -7_900, -7_000, db="cell"),
               sp("tiles.build", -5_000, -3_000, db="cell"),
               sp("tiles.upload", -2_500, -2_000, db="cell")]
    assert read("tile_load_s.open", window()) == pytest.approx(2.5)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_in_the_window_reads_none(buffer, name):
    buffer += [sp("request", 20_000, 20_010, 1)]
    assert read(name, window()) is None


@pytest.mark.parametrize("name", NAMES)
def test_a_program_with_no_recorder_reads_none(monkeypatch, name):
    monkeypatch.delattr(log, "records")
    assert read(name, window()) is None
