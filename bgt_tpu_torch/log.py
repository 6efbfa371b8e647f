"""Logging, verbosity, spans and device tracing.

The port's copy of ``bgt_tpu/log.py``, and its one span recorder:

- ``verbosity()`` (env ``BGT_TPU_VERBOSE``, default 3) gates warnings as the
  reference's hts_verbose / fmf_verbose do;
- ``span(name, **attrs)`` records a span: its name, id, parent, request id,
  thread, start and end on ``time.perf_counter_ns`` and attributes, into a
  bounded in-memory buffer (``records()``).  Spans record while a
  ``torch.profiler`` window is open in any thread of the process; otherwise
  a span costs its site one check and records nothing.  The few spans of a
  process's life (start-up, opening a database, loading its tile) record
  always (``always=True``) and print their ``[T::name]`` line at verbosity
  >= 4;
- the request id and the open span live in a ``contextvars.ContextVar``: a
  new thread starts outside them unless its target is wrapped in
  ``carry``;
- ``stage(name)`` is a span whose wall time is also logged at verbosity >= 4
  as ``[T::name] x ms``;
- ``query(device)`` is the root span of one query, under a new request id;
  with ``BGT_TPU_TRACE=<dir>`` it runs the query inside
  ``torch.profiler.profile`` (CPU activity of every thread, plus CUDA
  activity on a CUDA device) and writes its Chrome trace into ``<dir>``,
  one file per query, with the query's spans from every thread added on the
  trace's clock; those spans go to the file alone, not to the buffer
  (``bgt_tpu`` uses ``jax.profiler`` there);
- ``export_chrome(path, spans)`` writes spans as Chrome-trace events.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools
import itertools
import json
import os
import sys
import threading
import time
from collections import deque
from typing import NamedTuple

import torch
import torch.autograd.profiler as _profiler

_verbose = None


def verbosity() -> int:
    global _verbose
    if _verbose is None:
        try:
            _verbose = int(os.environ.get("BGT_TPU_VERBOSE", "3"))
        except ValueError:
            _verbose = 3
    return _verbose


def set_verbosity(v: int) -> None:
    global _verbose
    _verbose = v


def warn(func: str, msg: str) -> None:
    if verbosity() >= 2:
        print(f"[W::{func}] {msg}", file=sys.stderr)


def info(func: str, msg: str) -> None:
    if verbosity() >= 3:
        print(f"[M::{func}] {msg}", file=sys.stderr)


# --- spans ------------------------------------------------------------------

class Span(NamedTuple):
    """One recorded span; times are ``time.perf_counter_ns``."""

    name: str
    span: int
    parent: int    # 0: a root
    request: int   # 0: outside any request
    thread: int    # native thread id, as in a torch.profiler trace
    t0: int
    t1: int
    attrs: dict


now = time.perf_counter_ns

_BUFFER: deque = deque(maxlen=1 << 20)
_BUFFER_LOCK = threading.Lock()
_IDS = itertools.count(1)
_CURRENT: contextvars.ContextVar = contextvars.ContextVar("bgt_tpu_span",
                                                          default=None)


def _anchor() -> tuple[int, int]:
    """(perf_counter_ns, time_ns) at one instant: the wall clock read
    between two counter reads, the closest pair of five."""
    best = None
    for _ in range(5):
        a = time.perf_counter_ns()
        wall = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, (a + b) // 2, wall)
    return best[1:]


# maps span times onto a Chrome trace's wall clock
_ANCHOR = _anchor()


def recording() -> bool:
    """True while spans record: while a ``torch.profiler`` window is open
    (torch's flag is process-wide, though its CPU recording is per
    thread)."""
    return _profiler._is_profiler_enabled


def _append(s: Span, sink: list | None) -> None:
    """Into ``sink``, a traced query's own list, else the buffer."""
    if sink is not None:
        sink.append(s)
        return
    with _BUFFER_LOCK:
        _BUFFER.append(s)


def records() -> list[Span]:
    """The recorded spans, oldest first."""
    with _BUFFER_LOCK:
        return list(_BUFFER)


def _up() -> tuple[int, int, list | None]:
    """(span id, request id, sink) of the open span."""
    up = _CURRENT.get()
    return (0, 0, None) if up is None else (up.span, up.request, up.sink)


class _Open:
    """A span being recorded, or only timed for its ``[T::name]`` line."""

    __slots__ = ("name", "attrs", "span", "parent", "request", "sink", "t0",
                 "_token", "_record", "_echo")

    def __init__(self, name: str, attrs: dict, request: int = 0,
                 record: bool = True, echo: bool = False,
                 sink: list | None = None):
        self.name, self.attrs, self.request = name, attrs, request
        self.sink, self._record, self._echo = sink, record, echo

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self):
        if self._record:
            self.span = next(_IDS)
            self.parent, request, sink = _up()
            self.request = self.request or request
            if self.sink is None:
                self.sink = sink
            self._token = _CURRENT.set(self)
        self.t0 = now()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = now()
        if self._record:
            _CURRENT.reset(self._token)
            _append(Span(self.name, self.span, self.parent, self.request,
                         threading.get_native_id(), self.t0, t1, self.attrs),
                    self.sink)
        if self._echo:
            print(f"[T::{self.name}] {(t1 - self.t0) / 1e6:.2f} ms",
                  file=sys.stderr)
        return False


class _Off:
    """What a span site gets while nothing records."""

    t0 = 0

    def set(self, **attrs) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


def span(name: str, *, always: bool = False, **attrs):
    """A context manager recording ``name`` under the open span, with
    ``attrs`` (more with ``.set``); ``always`` records it whether or not
    spans are on."""
    if always or recording():
        return _Open(name, attrs)
    return _OFF


def request_span(name: str = "request", **attrs):
    """A root span under a new request id."""
    if recording():
        return _Open(name, attrs, request=next(_IDS))
    return _OFF


def stage(name: str, *, always: bool = False, **attrs):
    """A pipeline stage: a span, whose wall time is also logged at
    verbosity >= 4."""
    if verbosity() >= 4:
        return _Open(name, attrs, record=always or recording(), echo=True)
    return span(name, always=always, **attrs)


def annotate(**attrs) -> None:
    """Set ``attrs`` on the open span, if one is."""
    up = _CURRENT.get()
    if up is not None:
        up.attrs.update(attrs)


def add(name: str, t0: int, t1: int | None = None, **attrs) -> None:
    """Record a span that has already ended (``t1`` default now) under the
    open span."""
    if not recording():
        return
    parent, request, sink = _up()
    _append(Span(name, next(_IDS), parent, request, threading.get_native_id(),
                 t0, now() if t1 is None else t1, attrs), sink)


def carry(fn):
    """``fn`` to run in another thread inside the open span (a thread starts
    in an empty context)."""
    if _CURRENT.get() is None:
        return fn
    return functools.partial(contextvars.copy_context().run, fn)


def export_chrome(path: str, spans: list[Span]) -> None:
    """Write ``spans`` as Chrome-trace ``X`` events, the request id, span
    ids and attributes in ``args``, into the trace at ``path``: among the
    events of the trace already there (a torch.profiler trace, on its wall
    clock ``baseTimeNanoseconds``), else into a new file."""
    trace = {"traceEvents": [], "baseTimeNanoseconds": _ANCHOR[1]}
    if os.path.exists(path):
        with open(path) as fp:
            trace = json.load(fp)
    p0, w0 = _ANCHOR
    base = int(trace.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    trace["traceEvents"].extend(
        {"ph": "X", "cat": "bgt_span", "name": s.name, "pid": pid,
         "tid": s.thread, "ts": (w0 + s.t0 - p0 - base) / 1e3,
         "dur": (s.t1 - s.t0) / 1e3,
         "args": {"request": s.request, "span": s.span, "parent": s.parent,
                  **s.attrs}} for s in spans)
    with open(path, "w") as fp:
        json.dump(trace, fp)


# --- device tracing --------------------------------------------------------

# The profiler is process-global: traced queries from several server
# threads run one at a time.  Untraced queries never take this lock.
_TRACE_LOCK = threading.Lock()


@contextlib.contextmanager
def query(device: torch.device, name: str = "query"):
    """The root span of one query, under a new request id; with
    ``BGT_TPU_TRACE=<dir>``, inside a torch.profiler window over every
    thread whose Chrome trace, with the query's spans, lands in
    ``<dir>``."""
    trace_dir = os.environ.get("BGT_TPU_TRACE")
    if not trace_dir:
        with request_span(name) as root:
            yield root
        return
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with _TRACE_LOCK:
        os.makedirs(trace_dir, exist_ok=True)
        # the producer thread's ops too: CPU recording is per thread
        every_thread = _ExperimentalConfig(profile_all_threads=True)
        with profile(activities=activities,
                     experimental_config=every_thread) as prof:
            with _Open(name, {}, request=next(_IDS), sink=[]) as root:
                yield root
        path = os.path.join(trace_dir, f"bgt_tpu_torch.{os.getpid()}."
                                       f"{time.time_ns()}.pt.trace.json")
        prof.export_chrome_trace(path)
        export_chrome(path, root.sink)


def device_trace(device: torch.device):
    """``query`` around a query run outside one (``FastView.run`` from the
    CLI); inside a query (the server's requests) it adds nothing."""
    if _CURRENT.get() is not None:
        return _OFF
    return query(device)
