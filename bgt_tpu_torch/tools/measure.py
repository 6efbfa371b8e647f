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


def sm_clock_mhz(device: torch.device) -> float:
    """The SM clock of the CUDA ``device`` now, in MHz, as ``nvidia-smi
    --query-gpu=clocks.sm`` reads it for the card's UUID."""
    device = torch.device(device)
    index = device.index if device.index is not None else torch.cuda.current_device()
    uuid = torch.cuda.get_device_properties(index).uuid
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits", f"--id=GPU-{uuid}"],
                         capture_output=True, text=True, timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return float(res.stdout.strip().splitlines()[0])


# The H100 SXM's rates that bound the count kernels (NVIDIA's data sheet:
# 3.35 TB/s of device memory at a 700 W limit; 132 SMs, each issuing 64
# 32-bit logic operations per clock on its CUDA cores).
HBM_BYTES_PER_S = 3.35e12
SMS = 132
LOGIC_OPS_PER_CLOCK_PER_SM = 64


def count_bound_ms(rows: int, words: int, groups: int, out_ints: int) -> float:
    """The least time of a masked popcount count over (rows, words) planes
    and ``groups`` masks writing ``out_ints`` int32 per row and group: both
    planes and the masks read once and the counts written once, at the
    memory rate.  No operations term: the counting runs on the binary tensor
    cores (``mma ... b1 ... and.popc``), whose rate NVIDIA does not publish
    for the H100."""
    nbytes = (2 * rows + groups) * words * 4 + rows * groups * out_ints * 4
    return nbytes / HBM_BYTES_PER_S * 1e3


def decode_bound_ms(scans: int, rows: int, m: int, run_bytes: int) -> float:
    """The least time of a PBWT decode of ``scans`` scans with ``rows`` rows
    in all at ``m`` haplotypes from ``run_bytes`` bytes of runs (the RLE
    bytes and their int64 row offsets): the runs, each scan's S0 and offset
    read once, the (rows, m) uint8 rows and each scan's final S written
    once, at the memory rate.  No operations term: the work is integer logic
    and shared-memory lookups, for which the data sheet gives no peak."""
    nbytes = run_bytes + scans * (8 * m + 8) + rows * m
    return nbytes / HBM_BYTES_PER_S * 1e3


def cuda_core_logic_ms(rows: int, words: int, groups: int,
                       sm_mhz: float) -> float:
    """The time of the three masked ANDs per word per group (p0 & m, p1 & m,
    p0 & p1 & m) at the CUDA cores' logic rate at ``sm_mhz``: what a design
    that counts on the CUDA cores (kernels B and C) cannot beat.  A
    diagnostic, not a bound of the function."""
    return (3 * rows * words * groups
            / (SMS * LOGIC_OPS_PER_CLOCK_PER_SM * sm_mhz * 1e6) * 1e3)


# A spin of ~1 ms at 1.98 GHz queued ahead of each timed run, so that the
# host's work in ``fn`` before its launches overlaps the spin
_SPIN_CYCLES = 2_000_000


def time_ms(fn, device: torch.device, reps: int) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs after one warm-up.
    On a CUDA device: CUDA events around each run, queued behind a spin on
    the card, so that the events time the device's work and not the host's
    (argument checks, allocation, the ctypes call) before its first launch;
    the host clock elsewhere.  The spin and the events run on ``device``'s
    current stream, so ``fn`` must launch there."""
    device = torch.device(device)
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            with torch.cuda.device(device):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda._sleep(_SPIN_CYCLES)
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
