"""What a measurement ran on, and how a call is timed on it."""

from __future__ import annotations

import statistics
import subprocess
import time

import torch


def describe(device: torch.device) -> tuple[str, str | None]:
    """(kind, power limit) of ``device``.  For a CUDA device both come from
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` for the
    card's UUID (torch's ordinal may name another card under
    CUDA_VISIBLE_DEVICES); for any other device the kind is its type and
    there is no power limit."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type, None
    index = device.index if device.index is not None else torch.cuda.current_device()
    uuid = torch.cuda.get_device_properties(index).uuid
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", f"--id=GPU-{uuid}"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    name, power = res.stdout.strip().splitlines()[0].rsplit(",", 1)
    return name.strip(), power.strip()


def time_ms(fn, device: torch.device, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after one warm-up:
    CUDA events around each run on a CUDA device, the host clock elsewhere."""
    device = torch.device(device)
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)
