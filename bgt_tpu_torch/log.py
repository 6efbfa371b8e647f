"""Logging, verbosity, stage timing and device tracing.

The port's copy of ``bgt_tpu/log.py``:

- ``verbosity()`` (env ``BGT_TPU_VERBOSE``, default 3) gates warnings as the
  reference's hts_verbose / fmf_verbose do;
- ``stage(name)`` logs the wall time of a pipeline stage at verbosity >= 4;
- ``BGT_TPU_TRACE=<dir>`` runs each query inside ``torch.profiler.profile``
  (CPU activity, plus CUDA activity on a CUDA device) and writes its Chrome
  trace into ``<dir>``, one file per query (``bgt_tpu`` uses
  ``jax.profiler`` there).
"""

from __future__ import annotations

import contextlib
import os
import sys
import threading
import time

import torch

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


@contextlib.contextmanager
def stage(name: str):
    """Time a pipeline stage; logged at verbosity >= 4."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if verbosity() >= 4:
            dt = time.perf_counter() - t0
            print(f"[T::{name}] {dt * 1000:.2f} ms", file=sys.stderr)


# The profiler is process-global: traced queries from several server
# threads run one at a time.  Untraced queries never take this lock.
_TRACE_LOCK = threading.Lock()


@contextlib.contextmanager
def device_trace(device: torch.device):
    """torch.profiler trace around a query when BGT_TPU_TRACE is set."""
    trace_dir = os.environ.get("BGT_TPU_TRACE")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with _TRACE_LOCK:
        os.makedirs(trace_dir, exist_ok=True)
        with profile(activities=activities) as prof:
            yield
        prof.export_chrome_trace(os.path.join(
            trace_dir, f"bgt_tpu_torch.{os.getpid()}.{time.time_ns()}"
                       ".pt.trace.json"))
