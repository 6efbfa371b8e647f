"""Multi-process execution: the sample-column mesh across processes.

The counterpart of ``bgt_tpu/parallel/distributed.py`` over
``torch.distributed``.  Each process runs the same query stream; a gloo
process group stitches their slots into one mesh, and the collectives of
``mesh.psum``/``mesh.all_gather_cols`` run across it.  The layout follows
the single-process design:

- every process places (or loads, from a ``.gtc.shard-K-of-N`` file) only
  the word-column slice of the tile store that covers its own samples;
- host-side site selection (CSI regions, BED, FMF metadata, paging) is
  replicated: each process computes the identical site stream;
- per-site/per-group counts sum over the global sample axis; genotype
  output all-gathers only the sites that pass every filter.

Usage in each process:

    from bgt_tpu_torch.parallel import distributed
    distributed.initialize()               # torchrun's environment, or
    distributed.initialize("host:port", n, k)
    mesh = distributed.global_mesh(device="cuda")

then place this process's column slice with :func:`place_local_planes` and
hand the shards to :func:`bgt_tpu_torch.parallel.mesh.sharded_count_range_fn`.
The query path does this itself (``query/fastpath.py:ShardContext``).
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from . import mesh as meshlib

_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout_s: float = 300.0) -> None:
    """Join a gloo process group: at ``coordinator_address`` ("host:port")
    as ``process_id`` of ``num_processes``, or, with all three None, from
    torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``.
    With neither it does nothing (one process), and it does nothing when a
    group already exists.  A failure to join raises.  ``timeout_s`` bounds
    every wait of the group, its collectives included."""
    if dist.is_initialized():
        return
    timeout = datetime.timedelta(seconds=timeout_s)
    if coordinator_address is None and num_processes is None \
            and process_id is None:
        if not all(os.environ.get(k) for k in _ENV):
            return
        dist.init_process_group("gloo", init_method="env://", timeout=timeout)
        return
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timeout)


def world() -> int:
    """The process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(axis: str = meshlib.SAMPLE_AXIS, device=None) -> meshlib.Mesh:
    """One-axis mesh over every slot of every process (each process's
    :func:`mesh.local_slots` for ``device``), in rank order.  With a process
    group this is a collective: every rank must call it, and every rank must
    own the same number of slots."""
    slots = meshlib.local_slots(device)
    n = world()
    if n == 1:
        return meshlib.Mesh((axis,), (len(slots),), slots)
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(counts, torch.tensor([len(slots)], dtype=torch.int64))
    per_rank = [int(c) for c in counts]
    if len(set(per_rank)) != 1:
        raise ValueError(f"ranks own unequal slot counts {per_rank}: the "
                         "column all_gather needs equal slices")
    rank = dist.get_rank()
    return meshlib.Mesh((axis,), (n * len(slots),), slots,
                        first=rank * len(slots), rank=rank, world=n)


def local_column_range(n_words: int, mesh: meshlib.Mesh) -> tuple[int, int]:
    """The [start, stop) word-column range this process's slots own, by
    their positions in the mesh."""
    words = meshlib.pad_words_for_mesh(n_words, mesh.size)
    per_dev = words // mesh.size
    pos = [mesh.first + i for i in range(len(mesh.slots))]
    # the word partition assumes each process owns one contiguous stretch of
    # mesh positions (Mesh numbers them so); fail loudly if one ever does not
    assert pos and pos == list(range(pos[0], pos[-1] + 1)), (
        f"non-contiguous local mesh positions {pos}: the contiguous "
        "column partition does not apply to this topology")
    return pos[0] * per_dev, (pos[-1] + 1) * per_dev


def place_local(mesh: meshlib.Mesh, local: np.ndarray) -> list:
    """This process's shards from its column slice ``local`` (the columns of
    :func:`local_column_range` of a 2-D array): one contiguous int32 tensor
    per slot, in slot order, for the bodies of ``parallel/mesh.py``."""
    one = meshlib.Mesh(mesh.axis_names, (len(mesh.slots),), mesh.slots)
    return meshlib.place(one, local, False)


def place_local_planes(mesh: meshlib.Mesh, plane0: np.ndarray,
                       plane1: np.ndarray):
    """Two-plane convenience wrapper over :func:`place_local`."""
    return place_local(mesh, plane0), place_local(mesh, plane1)
