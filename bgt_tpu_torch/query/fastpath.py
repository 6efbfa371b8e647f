"""Device count tiers of the batched query path, on a torch device.

The counterpart of the device tiers of ``bgt_tpu/query/fastpath.py``
(DeviceTiles, _hbm_budget, device_available, get_device_tiles, stream_counts,
_DbCtx.counts_for).  Everything host-side -- site tables, tile stores, the
host popcount tier, merges, filters and emitters -- is ``bgt_tpu``'s own code,
imported, not copied.  The device is passed down explicitly from the entry
point; this slice runs on one device (no mesh).
"""

from __future__ import annotations

import contextlib
import os
import threading

import numpy as np
import torch

from bgt_tpu.ops.tiles import TileStore
from bgt_tpu.query import engine
from bgt_tpu.query import fastpath as base
from bgt_tpu.query.fastpath import _CACHE_LOCK, _cache_key, _lru_get, _lru_put

from ..log import device_trace
from ..ops import counts as counts_ops

# The port's own caches, so that the two packages never answer from each
# other's device buffers or memo.  Keys carry the device.
_DEVICE_CACHE: dict = {}
_DEVICE_CAP = 8
# key of _DEVICE_CACHE -> the lock its one transfer runs under, while it runs
_BUILD_LOCKS: dict = {}
# ((db_key, device), masks bytes) -> full-range (n_rows, groups, 4) counts
_COUNT_MEMO: dict = {}
_COUNT_MEMO_BYTES = 512 << 20


class DeviceTiles:
    """Tile planes resident on ``device`` as int32 tensors (transferred once
    per process, through pinned staging buffers)."""

    def __init__(self, ts: TileStore, device: torch.device):
        self.n_rows = ts.n_rows
        self.p0 = counts_ops.planes_to_torch(ts.plane0, device)
        self.p1 = counts_ops.planes_to_torch(ts.plane1, device)


def _hbm_budget(device: torch.device) -> int:
    """Bytes of device memory allowed for resident tiles:
    ``BGT_TPU_HBM_BUDGET``, else 60% of the card's memory."""
    env = os.environ.get("BGT_TPU_HBM_BUDGET")
    if env:
        return int(env)
    if device.type == "cuda":
        _free, total = torch.cuda.mem_get_info(device)
        return int(total * 0.6)
    return 8 << 30


def device_available(device: torch.device) -> bool:
    """True when ``device`` can run the count tier: a CUDA device needs
    ``torch.cuda.is_available()``; the CPU device always can."""
    return device.type != "cuda" or torch.cuda.is_available()


def get_device_tiles(bf: engine.BgtFile,
                     device: torch.device) -> DeviceTiles | None:
    """Device-resident planes, or None when they exceed the budget
    (queries then stream row chunks through the device instead).

    The planes of one (database, device) are transferred once however many
    threads ask at the same time: the first builds under that key's build
    lock, the others wait on it and then read the cache."""
    key = (_cache_key(bf), str(device))
    with _CACHE_LOCK:
        if key in _DEVICE_CACHE:
            return _lru_get(_DEVICE_CACHE, key)
        build = _BUILD_LOCKS.setdefault(key, threading.Lock())
    try:
        with build:
            with _CACHE_LOCK:
                if key in _DEVICE_CACHE:
                    return _lru_get(_DEVICE_CACHE, key)
            ts = base.get_tiles(bf)
            dt = None
            if ts.plane0.nbytes * 2 <= _hbm_budget(device):
                dt = DeviceTiles(ts, device)
            _lru_put(_DEVICE_CACHE, key, dt, _DEVICE_CAP)
            return dt
    finally:
        with _CACHE_LOCK:
            if _BUILD_LOCKS.get(key) is build:
                del _BUILD_LOCKS[key]


def stream_counts(ts: TileStore, rows: np.ndarray, masks: np.ndarray,
                  device: torch.device, chunk_rows: int = 16384) -> np.ndarray:
    """Counts for arbitrary row sets by streaming row chunks to the device.

    Rows are gathered into two host slots in turn.  On CUDA the slots are
    pinned, each has its own device buffers, and the copies run on a side
    stream, so chunk k+1's host-to-device copy overlaps chunk k's kernel.
    Events order each copy before its kernel, a device buffer's refill
    after the kernel that read it, and a host slot's refill after the copy
    that read it.  Only the count tensors come back, once, at the end.
    """
    g = masks.shape[0]
    if rows.size == 0:
        return np.zeros((0, g, 4), dtype=np.int32)
    cuda = device.type == "cuda"
    dm = counts_ops.planes_to_torch(masks, device)
    shape = (min(chunk_rows, rows.size), ts.plane0.shape[1])
    hosts = [[torch.empty(shape, dtype=torch.int32, pin_memory=cuda)
              for _plane in range(2)] for _slot in range(2)]
    devs = [[torch.empty(shape, dtype=torch.int32, device=device)
             for _plane in range(2)] for _slot in range(2)] if cuda else hosts
    copied: list = [None, None]  # per slot: its last copy has finished
    read: list = [None, None]    # per slot: its last kernel has finished
    pending = []
    with torch.cuda.device(device) if cuda else contextlib.nullcontext():
        main = torch.cuda.current_stream() if cuda else None
        side = torch.cuda.Stream(device) if cuda else None
        for i, lo in enumerate(range(0, rows.size, chunk_rows)):
            sl = rows[lo: lo + chunk_rows]
            n = sl.size
            k = i % 2
            if copied[k] is not None:
                copied[k].synchronize()
            for plane, host in zip((ts.plane0, ts.plane1), hosts[k]):
                np.take(plane, sl, axis=0,
                        out=host[:n].numpy().view(np.uint32))
            if cuda:
                with torch.cuda.stream(side):
                    if read[k] is not None:
                        side.wait_event(read[k])
                    for d, host in zip(devs[k], hosts[k]):
                        d[:n].copy_(host[:n], non_blocking=True)
                    copied[k] = torch.cuda.Event()
                    copied[k].record(side)
                main.wait_event(copied[k])
            a, b = devs[k]
            pending.append(counts_ops.count_codes_range(a, b, dm, 0, n))
            if cuda:
                read[k] = torch.cuda.Event()
                read[k].record(main)
        out = torch.cat(pending)
    return counts_ops.counts_to_numpy(out)


class DbCtx(base._DbCtx):
    """Per-database context whose device count tiers run on ``device``."""

    def __init__(self, g: engine.BgtReader, opt, device: torch.device):
        super().__init__(g, opt)
        self.device = device

    def _count_tier(self, rows: np.ndarray, masks: np.ndarray,
                    memo_ok: bool) -> str:
        """host vs device for a count pass; BGT_TPU_COUNT_TIER=host|device
        overrides, and ``device`` with no usable device raises."""
        env = os.environ.get("BGT_TPU_COUNT_TIER", "auto")
        if env == "device" and not device_available(self.device):
            raise RuntimeError(
                f"BGT_TPU_COUNT_TIER=device but {self.device} is not "
                "available (torch.cuda.is_available() is False)")
        if env in ("host", "device"):
            return env
        if not device_available(self.device):
            return "host"
        key = (_cache_key(self.bf), str(self.device))
        if _DEVICE_CACHE.get(key) is not None:
            return "device"  # planes already resident
        span = int(rows[-1]) + 1 - int(rows[0])
        work = span * masks.shape[0] * self.ts.plane0.shape[1] * 4 * 3
        budget = int(os.environ.get("BGT_TPU_HOST_WORK_MAX", 64 << 30))
        return "host" if work <= budget else "device"

    def counts_for(self, rows: np.ndarray, masks: np.ndarray,
                   sharding_cb=None) -> np.ndarray:
        """(len(rows), n_groups, 4) counts.

        Resolution order as in ``bgt_tpu``: (1) the all-columns rowstats
        aggregate; (2) the per-mask count memo; then the host popcount tier
        or (3) the count kernel over device-resident planes, or (4) streamed
        row chunks when the planes exceed the device budget.  The device
        tier counts the exact row span, or the full range for the memo.
        ``sharding_cb`` is accepted for the caller's signature and unused:
        this slice runs on one device.
        """
        if rows.size == 0:
            return np.zeros((0, masks.shape[0], 4), dtype=np.int32)
        ts = self.ts
        if (masks.shape[0] == 1 and ts.rowstats is not None
                and masks[0].tobytes() == ts.all_mask().tobytes()):
            return ts.rowstats[rows][:, None, :]
        memo_key = ((_cache_key(self.bf), str(self.device)), masks.tobytes())
        hit = _COUNT_MEMO.get(memo_key)
        if hit is not None:
            return hit[rows]
        if ts.is_shard:
            raise ValueError("column-shard tiles need the multi-device mesh, "
                             "which bgt_tpu_torch does not port yet")
        memo_ok = ts.n_rows * masks.shape[0] * 16 <= _COUNT_MEMO_BYTES
        span = int(rows[-1]) + 1 - int(rows[0])
        if self._count_tier(rows, masks, memo_ok) == "host":
            # the same host tier as bgt_tpu (fastpath.py:1033-1055), with
            # this package's memo
            memo_budget = int(os.environ.get("BGT_TPU_MEMO_WORK_MAX", 8 << 30))
            full_work = ts.n_rows * masks.shape[0] * ts.plane0.shape[1] * 12
            memo_ok = memo_ok and full_work <= memo_budget
            if (memo_ok or rows.size > ts.n_rows // 2) \
                    and ts.plane0.nbytes * 2 > 256 << 20:
                ts.prefault()
            elif span * ts.plane0.shape[1] * 8 > 256 << 20:
                ts.prefault_range(int(rows[0]), int(rows[-1]) + 1)
            counts = base.host_counts(
                ts, np.arange(ts.n_rows) if memo_ok else rows, masks)
            if memo_ok:
                with _CACHE_LOCK:
                    _COUNT_MEMO[memo_key] = counts
                return counts[rows]
            return counts
        dt = get_device_tiles(self.bf, self.device)
        if dt is None:  # planes exceed the device budget: stream row chunks
            return stream_counts(ts, rows, masks, self.device)
        start = 0 if memo_ok else int(rows[0])
        length = ts.n_rows if memo_ok else span
        dm = counts_ops.planes_to_torch(masks, self.device)
        counts = counts_ops.counts_to_numpy(counts_ops.count_codes_range(
            dt.p0, dt.p1, dm, start, length))
        if memo_ok:
            with _CACHE_LOCK:
                while (sum(v.nbytes for v in _COUNT_MEMO.values())
                       + counts.nbytes > _COUNT_MEMO_BYTES and _COUNT_MEMO):
                    _COUNT_MEMO.pop(next(iter(_COUNT_MEMO)))
                _COUNT_MEMO[memo_key] = counts
            return counts[rows]
        return counts[rows - start]

    def _pairs_sharded(self, rows: np.ndarray, cols: np.ndarray,
                       chunk_rows: int = 2048) -> np.ndarray:
        raise ValueError("GT output from a column-shard tile needs the "
                         "multi-device mesh, which bgt_tpu_torch does not "
                         "port yet")


class FastView(base.FastView):
    """``bgt_tpu``'s batched query executor with this package's count tiers
    on ``device``, single device."""

    def __init__(self, bm: engine.BgtmReader, opt, device: torch.device):
        self.bm = bm
        self.opt = opt
        self.device = device
        self.dbs = [DbCtx(g, opt, device) for g in bm.bgt]

    @property
    def sharding(self):
        return None

    def run(self, out) -> None:
        with device_trace(self.device):
            self._run(out)
