"""Sharding of the genotype matrix over a mesh of slots.

The counterpart of ``bgt_tpu/parallel/mesh.py``.  The sample-column axis
``'s'`` is the sharding seam: each slot holds a word-column slice of the
packed planes; per-site, per-group counts are each slot's local masked
popcount (kernel A on a CUDA slot, its plain version on a CPU slot) followed
by a sum over the sample axis, and genotype output gathers the column
slices only when it is requested.  On a 2-axis mesh the rows are also
sharded, along ``'r'``.

A :class:`Mesh` is the port's picture of JAX's device array: its axis names,
its global shape, and the *slots* this process owns (one ``torch.device``
per mesh position, several of which may name the same card), with the
process's rank and world size.  One process, or a ``torch.distributed``
process group of several, spans the mesh; positions are numbered row-major
over the axes and each process owns one contiguous stretch of them, in rank
order.  A sharded array is the list of this process's shards, one
contiguous int32 tensor per slot, in slot order.

The collectives:

- ``psum``: the slots' local results are summed in the process (exact
  int32), then ``all_reduce(SUM)`` across ranks when the world is larger
  than one;
- the column ``all_gather``: the slots' columns are concatenated in slot
  order, then ``all_gather`` across ranks in rank order.

In the process, slots on distinct cards meet on the first slot's card by
peer copies (PyTorch orders both cards' streams around each copy); the
host never sees them.  Across ranks the mesh takes the transport that
``distributed.initialize`` chose from the ranks' cards: NCCL on the device
tensors themselves where every rank is on CUDA and no card belongs to two
ranks, else gloo on host copies (gloo takes no CUDA tensor, and NCCL
refuses two ranks on one card).  ``COLLECTIVES`` counts each transport's
calls, wall ms and bytes.  The cross-rank collectives of one process run
under one lock, so that threads of one rank never interleave them; every
rank must still issue them in the same order (one query stream).

JAX compiles each body once per row-span or row-count bucket; PyTorch runs
eagerly, so the bodies here take the exact span and row list.
"""

from __future__ import annotations

import contextlib
import math
import os
import threading
import time

import numpy as np
import torch

from ..ops import counts as counts_ops

SAMPLE_AXIS = "s"
ROW_AXIS = "r"  # site-batch data axis

# One lock for every cross-rank collective of this process.
_COLLECTIVE_LOCK = threading.Lock()
_STATS_LOCK = threading.Lock()
# The collectives this process made, by transport ("nccl" and "gloo" across
# ranks, "peer" between this process's cards) and operation: calls, wall ms
# and the bytes of the result.  gloo's ms is the torch.distributed call
# alone (not the host copies around it); nccl's and peer's run from a
# synchronised start to a synchronised end on the cards involved.
TRANSPORTS = ("nccl", "gloo", "peer")
COLLECTIVES = {t: {op: {"calls": 0, "ms": 0.0, "bytes": 0}
                   for op in ("all_reduce", "all_gather")}
               for t in TRANSPORTS}


def reset_collectives() -> None:
    with _STATS_LOCK:
        for ops in COLLECTIVES.values():
            for stat in ops.values():
                stat.update(calls=0, ms=0.0, bytes=0)


class Mesh:
    """``shape`` positions over ``axis_names`` (row-major), of which this
    process owns ``slots``: positions ``first .. first + len(slots) - 1``.
    ``rank``/``world`` are the process's place in its process group (0/1
    without one); ``transport`` ("nccl" or "gloo") and ``group`` (None: the
    default group) are what the cross-rank collectives run on."""

    def __init__(self, axis_names, sizes, slots, first: int = 0,
                 rank: int = 0, world: int = 1, transport: str = "gloo",
                 group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in sizes)))
        self.size = math.prod(self.shape.values())
        self.slots = [torch.device(d) for d in slots]
        self.first = first
        self.rank = rank
        self.world = world
        self.transport = transport
        self.group = group
        if not self.slots or first + len(self.slots) > self.size:
            raise ValueError(f"{len(self.slots)} slots from position {first} "
                             f"do not fit a mesh of {self.size}")

    def coords(self, i: int) -> tuple[int, int]:
        """(row-axis index, sample-axis index) of local slot ``i``."""
        return divmod(self.first + i, self.shape[SAMPLE_AXIS])

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, slots={[str(d) for d in self.slots]}, "
                f"first={self.first}, rank={self.rank}/{self.world}, "
                f"{self.transport})")


def _in_group() -> bool:
    import torch.distributed as dist
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def local_slots(device=None) -> list[torch.device]:
    """This process's slots for an entry point's ``device`` (default
    ``cuda``).  ``BGT_TPU_MESH_DEVICES=N`` gives N slots on ``device``.
    Otherwise a device with an index (``cuda:k``, ``cpu``) is one slot, and
    bare ``cuda`` is every visible card, except inside a process group where
    torchrun set ``LOCAL_RANK``: there it is that one card."""
    device = torch.device("cuda" if device is None else device)
    env = os.environ.get("BGT_TPU_MESH_DEVICES")
    if env:
        n = int(env)
        if n < 1:
            raise ValueError(f"BGT_TPU_MESH_DEVICES={env}: need at least 1")
        return [device] * n
    if device.type != "cuda" or device.index is not None:
        return [device]
    n = torch.cuda.device_count()
    local = os.environ.get("LOCAL_RANK")
    if local and _in_group():
        k = int(local)
        if not 0 <= k < n:
            raise ValueError(f"LOCAL_RANK={local} but {n} cards are visible")
        return [torch.device("cuda", k)]
    return [torch.device("cuda", i) for i in range(n)]


def make_mesh(devices=None, axis: str = SAMPLE_AXIS) -> Mesh:
    """A 1-axis mesh over ``devices`` (default: :func:`local_slots`), all
    owned by this process."""
    devices = list(devices) if devices is not None else local_slots()
    return Mesh((axis,), (len(devices),), devices)


def make_mesh2(n_rows_axis: int, devices=None) -> Mesh:
    """2-axis (site-batch x sample-column) mesh in this process: rows shard
    along 'r', columns along 's'.  Counts sum over 's' only (each row
    block's counts stay with its row shard); GT gathers ride 's' within a
    row block."""
    devices = list(devices) if devices is not None else local_slots()
    n = len(devices)
    if n_rows_axis < 1 or n % n_rows_axis:
        raise ValueError(f"{n} slots do not split into {n_rows_axis} rows")
    return Mesh((ROW_AXIS, SAMPLE_AXIS), (n_rows_axis, n // n_rows_axis),
                devices)


def pad_words_for_mesh(n_words: int, n_dev: int) -> int:
    return (n_words + n_dev - 1) // n_dev * n_dev


def place(mesh: Mesh, arr: np.ndarray, rows_sharded: bool) -> list:
    """The shards of a global (rows, words) uint32 array that this process's
    slots hold: word-columns split over 's' and, with ``rows_sharded``, rows
    over 'r' (else every row block gets all rows).  ``arr``'s words (and
    sharded rows) must already divide by the axis sizes.  Each shard is a
    contiguous int32 tensor (kernel A refuses strided views), copied from
    its slice through ``planes_to_torch``."""
    s = mesh.shape[SAMPLE_AXIS]
    r = mesh.shape.get(ROW_AXIS, 1) if rows_sharded else 1
    per_w = arr.shape[1] // s
    per_r = arr.shape[0] // r
    out = []
    for i, dev in enumerate(mesh.slots):
        ri, si = mesh.coords(i)
        ri = ri if rows_sharded else 0
        piece = arr[ri * per_r: (ri + 1) * per_r, si * per_w: (si + 1) * per_w]
        out.append(counts_ops.planes_to_torch(piece, dev))
    return out


def pad_to(arr: np.ndarray, rows: int, words: int) -> np.ndarray:
    """``arr`` zero-padded at the end to (rows, words); itself if it is
    that shape already."""
    pr, pc = rows - arr.shape[0], words - arr.shape[1]
    return np.pad(arr, ((0, pr), (0, pc))) if pr or pc else arr


def shard_planes(mesh: Mesh, plane0: np.ndarray, plane1: np.ndarray,
                 masks: np.ndarray):
    """Place planes and masks on the mesh, sharded along the word axis
    (zero-padded to a multiple of the mesh size)."""
    words = pad_words_for_mesh(plane0.shape[1], mesh.size)
    return tuple(place(mesh, pad_to(a, a.shape[0], words), False)
                 for a in (plane0, plane1, masks))


def shard_planes2(mesh: Mesh, plane0: np.ndarray, plane1: np.ndarray,
                  masks: np.ndarray):
    """Place planes on a 2-axis mesh: rows over 'r', word-columns over 's';
    masks replicate along 'r' and shard along 's'.  Row/column counts pad
    to the axis sizes."""
    r, s = mesh.shape[ROW_AXIS], mesh.shape[SAMPLE_AXIS]
    words = pad_words_for_mesh(plane0.shape[1], s)
    rows = -(-plane0.shape[0] // r) * r
    p0, p1 = (place(mesh, pad_to(a, rows, words), True)
              for a in (plane0, plane1))
    return p0, p1, place(mesh, pad_to(masks, masks.shape[0], words), False)


def _sync(devices) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.current_stream(d).synchronize()


def _record(transport: str, op: str, t0: float, nbytes: int) -> None:
    ms = (time.perf_counter() - t0) * 1e3
    with _STATS_LOCK:
        stat = COLLECTIVES[transport][op]
        stat["calls"] += 1
        stat["ms"] += ms
        stat["bytes"] += nbytes


def _peer(op: str, tensors: list, dst: torch.device, fn):
    """``fn()``, which brings ``tensors`` to ``dst``; counted as a peer
    collective where some of them lie on another card."""
    far = {t.device for t in tensors if t.device != dst}
    if not far or dst.type != "cuda":
        return fn()
    cards = {dst, *far}
    _sync(cards)
    t0 = time.perf_counter()
    out = fn()
    _sync(cards)
    _record("peer", op, t0, out.nbytes)
    return out


def _local_sum(tensors: list) -> torch.Tensor:
    """Exact elementwise sum of same-shaped tensors, on the first one's
    device: the others are added in as peer copies."""
    dst = tensors[0].device

    def run():
        out = tensors[0].clone()
        for t in tensors[1:]:
            out += t.to(dst)
        return out

    return _peer("all_reduce", tensors, dst, run)


def _cat_cols(tensors: list, dst: torch.device) -> torch.Tensor:
    """``tensors`` concatenated along the columns on ``dst``."""
    return _peer("all_gather", tensors, dst,
                 lambda: torch.cat([t.to(dst) for t in tensors], dim=1))


def _guard(device: torch.device):
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def _across_ranks(mesh: Mesh, op: str, out: torch.Tensor) -> torch.Tensor:
    """``op`` ("all_reduce" or "all_gather") of this rank's ``out`` with
    every other rank's, on the mesh's transport: NCCL on ``out`` itself,
    gloo on a host copy.  A gather returns (world,) + out.shape, rank 0
    first."""
    import torch.distributed as dist
    out = out.contiguous()
    if mesh.transport == "nccl":
        res = (out if op == "all_reduce" else
               torch.empty((mesh.world, *out.shape), dtype=out.dtype,
                           device=out.device))
        with _COLLECTIVE_LOCK, _guard(out.device):
            _sync([out.device])
            t0 = time.perf_counter()
            if op == "all_reduce":
                dist.all_reduce(res, group=mesh.group)
            else:
                dist.all_gather_into_tensor(res, out, group=mesh.group)
            _sync([out.device])
            _record("nccl", op, t0, res.nbytes)
        return res
    host = out.cpu()
    parts = ([host] if op == "all_reduce" else
             [torch.empty_like(host) for _ in range(mesh.world)])
    with _COLLECTIVE_LOCK:
        t0 = time.perf_counter()
        if op == "all_reduce":
            dist.all_reduce(host, group=mesh.group)
        else:
            dist.all_gather(parts, host, group=mesh.group)
        _record("gloo", op, t0, sum(p.nbytes for p in parts))
    return (host if op == "all_reduce" else torch.stack(parts)).to(out.device)


def psum(mesh: Mesh, local: list) -> torch.Tensor:
    """Sum of the slots' ``local`` results over the whole mesh, on this
    process's first slot."""
    out = _local_sum(local)
    if mesh.world > 1:
        out = _across_ranks(mesh, "all_reduce", out)
    return out


def all_gather_cols(mesh: Mesh, local: list) -> torch.Tensor:
    """The slots' ``local`` (rows, cols_i) blocks concatenated along the
    columns in mesh order (slot order, then rank order), on this process's
    first slot."""
    out = _cat_cols(local, mesh.slots[0])
    if mesh.world > 1:
        parts = _across_ranks(mesh, "all_gather", out)
        out = parts.permute(1, 0, 2).reshape(out.shape[0], -1)
    return out


def _pairs(codes: torch.Tensor) -> torch.Tensor:
    """Diploid GT cell indices ``code(hap0) << 2 | code(hap1)``.  A slot's
    columns are whole words (32 haplotypes), so pairs never straddle two
    slots and are formed before the gather, which then moves one byte per
    sample."""
    return (codes[:, 0::2] << 2) | codes[:, 1::2]


def _sample_only(mesh: Mesh) -> None:
    if ROW_AXIS in mesh.shape:
        raise ValueError(f"a 1-axis body on a mesh of axes {mesh.axis_names}")


def sharded_count_fn(mesh: Mesh):
    """(p0, p1, masks) shards -> (rows, groups, 4) int32 counts, summed over
    the sample axis, on this process's first slot."""
    _sample_only(mesh)

    def call(p0, p1, masks):
        return psum(mesh, [counts_ops.count_codes(a, b, m)
                           for a, b, m in zip(p0, p1, masks)])

    return call


def sharded_count_range_fn(mesh: Mesh):
    """(p0, p1, masks, start, length) over resident shards: each slot counts
    the row slice [start, start+length) in place (``count_codes_range``
    takes the offset, so nothing is copied), then the sum over the sample
    axis.  The exact span is counted: no bucketing."""
    _sample_only(mesh)

    def call(p0, p1, masks, start: int, length: int):
        return psum(mesh, [counts_ops.count_codes_range(a, b, m, start, length)
                           for a, b, m in zip(p0, p1, masks)])

    return call


def _by_row_block(mesh: Mesh, local: list) -> list:
    """Group the slots' results by row block (a 2-axis mesh is one process):
    [[results of row block 0's slots, in column order], ...]."""
    blocks = [[] for _ in range(mesh.shape[ROW_AXIS])]
    for i, t in enumerate(local):
        blocks[mesh.coords(i)[0]].append(t)
    return blocks


def _single_process(mesh: Mesh) -> None:
    if mesh.world > 1 or len(mesh.slots) != mesh.size:
        raise ValueError("a 2-axis mesh runs in one process")


def sharded_count2_fn(mesh: Mesh):
    """(p0, p1, masks) shards on a 2-axis mesh -> the counts of each row
    block, summed over the sample axis only: a list of (rows / r, groups, 4)
    int32 tensors, row block 0 first, each on its first slot's device (the
    result stays row-sharded; ``torch.cat`` of their host copies is the
    full (padded rows, groups, 4) count)."""
    _single_process(mesh)

    def call(p0, p1, masks):
        local = [counts_ops.count_codes(a, b, m)
                 for a, b, m in zip(p0, p1, masks)]
        return [_local_sum(block) for block in _by_row_block(mesh, local)]

    return call


def _as_index(rows_idx, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(rows_idx, dtype=np.int64),
                           device=device)


def sharded_pairs_rows_fn(mesh: Mesh):
    """(p0, p1, rows) -> (len(rows), words*16) uint8 diploid GT pair indices
    (code0*4 + code1) on this process's first slot, the same on every rank.

    The caller behind GT-emitting queries on ``.gtc.shard`` stores: each slot
    decodes its own column slice of the requested rows and forms their
    pairs, and the column ``all_gather`` reassembles full rows.  ``rows`` is
    any int sequence of row ids, taken exactly (no bucket)."""
    _sample_only(mesh)

    def call(p0, p1, rows_idx):
        local = []
        for a, b in zip(p0, p1):
            idx = _as_index(rows_idx, a.device)
            local.append(_pairs(counts_ops.decode_codes(
                a.index_select(0, idx), b.index_select(0, idx))))
        return all_gather_cols(mesh, local)

    return call


def sharded_pairs_rows2_fn(mesh: Mesh):
    """The GT pair gather of a 2-axis mesh: rows sharded over 'r', columns
    over 's'.  Each slot contributes its rows of the requested row list,
    zeros elsewhere; a sum over 'r' assembles the requested rows of each
    column block, which is decoded, paired and gathered over 's'."""
    _single_process(mesh)

    def call(p0, p1, rows_idx):
        cols = [[] for _ in range(mesh.shape[SAMPLE_AXIS])]
        for i, (a, b) in enumerate(zip(p0, p1)):
            ri, si = mesh.coords(i)
            block = a.shape[0]
            loc = _as_index(rows_idx, a.device) - ri * block
            valid = ((loc >= 0) & (loc < block))[:, None]
            loc = loc.clamp(0, block - 1)
            cols[si].append(
                (torch.where(valid, a.index_select(0, loc), 0),
                 torch.where(valid, b.index_select(0, loc), 0)))
        local = [_pairs(counts_ops.decode_codes(
            _local_sum([x for x, _ in parts]),
            _local_sum([y for _, y in parts]))) for parts in cols]
        return _cat_cols(local, mesh.slots[0])

    return call


def sharded_gather_codes_fn(mesh: Mesh):
    """(p0, p1) shards -> (rows, words*32) uint8 codes, all-gathered over the
    sample axis, on this process's first slot."""
    _sample_only(mesh)

    def call(p0, p1):
        return all_gather_cols(mesh, [counts_ops.decode_codes(a, b)
                                      for a, b in zip(p0, p1)])

    return call
