"""Device tracing of the port's queries.

The counterpart of ``bgt_tpu.log.device_trace``: with ``BGT_TPU_TRACE=<dir>``
set, each query runs inside ``torch.profiler.profile`` (CPU activity, plus
CUDA activity on a CUDA device) and its Chrome trace is written into
``<dir>``, one file per query.  Verbosity, warnings and stage timing stay
``bgt_tpu.log``'s.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time

import torch

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
