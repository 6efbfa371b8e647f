"""Spans and the device trace of a traced run (``--trace 1``).

Spans are recorded by the benchmark around the program's calls into each
layer, in the server's process, keyed by thread: ``prepare`` around
``server._prepare`` (request set-up: the groups, the filter, the region),
``view`` around ``fastpath.FastView.run`` (site selection, merge, the count
tiers and the emitted lines), ``count`` around ``fastpath.DbCtx.counts_for``
(whichever tier answers, to the counts on the host).  Each call of
``ops.counts.count_codes_range`` records the shape of its pass (rows, words,
groups).  Nothing is recorded outside the window.

The device trace is one ``torch.profiler`` window over the measured
seconds.  A ``record_function`` range opened and closed on the host clock
ties the trace's clock to the spans'.
"""

from __future__ import annotations

import functools
import json
import os
import threading
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    def __init__(self):
        self.records: list = []   # (name, thread, t0, t1), perf_counter s
        self.passes: list = []    # (rows, words, groups)
        self.on = False
        self._undo: list = []

    def _wrap(self, owner, attr: str, name: str) -> None:
        fn = getattr(owner, attr)
        spans = self

        @functools.wraps(fn)
        def wrapper(*a, **k):
            if not spans.on:
                return fn(*a, **k)
            t0 = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                spans.records.append((name, threading.get_ident(), t0,
                                      time.perf_counter()))

        setattr(owner, attr, wrapper)
        self._undo.append((owner, attr, fn))

    def install(self) -> None:
        from bgt_tpu_torch.ops import counts
        from bgt_tpu_torch.query import fastpath
        from bgt_tpu_torch.server import server
        self._wrap(server, "_prepare", "prepare")
        self._wrap(fastpath.FastView, "run", "view")
        self._wrap(fastpath.DbCtx, "counts_for", "count")
        orig = counts.count_codes_range
        spans = self

        @functools.wraps(orig)
        def count_pass(p0, p1, masks, start, length):
            if spans.on:
                spans.passes.append((int(length), int(p0.shape[1]),
                                     int(masks.shape[0])))
            return orig(p0, p1, masks, start, length)

        counts.count_codes_range = count_pass
        self._undo.append((counts, "count_codes_range", orig))

    def remove(self) -> None:
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()


class DeviceWindow:
    """A ``torch.profiler`` window with CPU and CUDA activity."""

    def __init__(self, cuda: bool):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if cuda:
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._mark = None
        self.host = (0.0, 0.0)

    def start(self) -> None:
        from torch.profiler import record_function
        self._prof.__enter__()
        self._mark = record_function("bench.window")
        self._mark.__enter__()
        self.host = (time.perf_counter(), 0.0)

    def stop(self) -> None:
        self.host = (self.host[0], time.perf_counter())
        self._mark.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)

    def events(self, scratch: str) -> tuple:
        """(device events, (ts, dur) of the window mark), in trace us."""
        path = os.path.join(scratch, "trace.json")
        self._prof.export_chrome_trace(path)
        try:
            with open(path) as fp:
                trace = json.load(fp)
        finally:
            os.remove(path)
        evs = trace["traceEvents"] if isinstance(trace, dict) else trace
        mark = None
        dev = []
        for e in evs:
            if e.get("ph") != "X":
                continue
            if e.get("name") == "bench.window" and e.get("cat") == "user_annotation":
                mark = (float(e["ts"]), float(e["dur"]))
            elif e.get("cat") in DEVICE_CATS:
                dev.append((e.get("cat"), e.get("name", ""), float(e["ts"]),
                            float(e.get("dur", 0.0))))
        if mark is None:
            raise RuntimeError("the trace holds no window mark")
        return dev, mark


def union_us(intervals: list) -> list:
    """Merged [start, end] intervals."""
    out: list = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


class Readings:
    """What the per-layer metrics read from a traced run: spans, count
    passes, answered requests, every request's latency in ms and the
    device's events in the window, on one clock (seconds on the host's
    ``perf_counter``)."""

    def __init__(self, spans: Spans, answered: int, window: tuple,
                 device_events: list | None = None, mark: tuple | None = None,
                 mark_host: tuple | None = None, latency_ms=None):
        self.spans = spans.records
        self.passes = spans.passes
        self.answered = answered
        self.latency_ms = latency_ms
        self.t0, self.t1 = window
        self.device = []
        if device_events is not None and mark is not None:
            ts, dur = mark
            h0, h1 = mark_host
            scale = (h1 - h0) / (dur * 1e-6) if dur > 0 else 1.0
            for cat, name, s, d in device_events:
                a = h0 + (s - ts) * 1e-6 * scale
                b = a + d * 1e-6 * scale
                a, b = max(a, self.t0), min(b, self.t1)
                if b > a:
                    self.device.append((cat, name, a, b))

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def span_mean_ms(self, name: str) -> float | None:
        d = [b - a for n, _t, a, b in self.spans if n == name]
        if not d or not self.answered:
            return None
        return sum(d) / self.answered * 1e3

    def busy(self) -> list:
        return union_us([[a, b] for _c, _n, a, b in self.device])

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy())

    def kernel_s(self, match) -> float:
        return sum(b - a for cat, name, a, b in self.device
                   if cat == "kernel" and match(name))

    def device_ops(self, top: int = 10) -> list:
        tot: dict = {}
        for cat, name, a, b in self.device:
            key = name if cat == "kernel" else f"{cat}:{name}"
            tot[key] = tot.get(key, 0.0) + (b - a)
        return sorted(([k, v] for k, v in tot.items()), key=lambda x: -x[1])[:top]

    def host_state(self, t: float) -> str:
        """The spans open at ``t``, by layer, or ``no request in a layer``."""
        open_ = sorted({n for n, _t, a, b in self.spans if a <= t < b})
        return "+".join(open_) if open_ else "no request in a layer"

    def idle_gaps(self, top: int = 10) -> list:
        edges = [self.t0] + [x for iv in self.busy() for x in iv] + [self.t1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_state((a + b) / 2), b - a] for a, b in gaps[:top]]
