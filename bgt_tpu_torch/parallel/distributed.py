"""Multi-process execution: the sample-column mesh across processes.

The counterpart of ``bgt_tpu/parallel/distributed.py`` over
``torch.distributed``.  Each process runs the same query stream; a process
group stitches their slots into one mesh, and the collectives of
``mesh.psum``/``mesh.all_gather_cols`` run across it.  The layout follows
the single-process design:

- every process places (or loads, from a ``.gtc.shard-K-of-N`` file) only
  the word-column slice of the tile store that covers its own samples;
- host-side site selection (CSI regions, BED, FMF metadata, paging) is
  replicated: each process computes the identical site stream;
- per-site/per-group counts sum over the global sample axis; genotype
  output all-gathers only the sites that pass every filter.

Joining is two steps, both in :func:`initialize`.  The process joins the
default group on gloo, which carries the mesh's set-up (the slot counts of
:func:`global_mesh`).  Then the ranks exchange the UUIDs of their cards
over it and choose the transport of the mesh's collectives once, from that
layout: where every rank is on CUDA and no card belongs to two ranks, an
NCCL group over the same ranks, on the device tensors (each rank first
makes its first card current); else gloo on host copies (NCCL refuses two
ranks on one card).  The choice is logged and :func:`collective_backend`
returns it.  A failure to create the NCCL group raises: it never falls
back to gloo.

Usage in each process:

    from bgt_tpu_torch.parallel import distributed
    distributed.initialize(device="cuda")  # torchrun's environment, or
    distributed.initialize("host:port", n, k, device="cuda")
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

# the transport chosen at join ("nccl" or "gloo"), the NCCL group, and the
# cards (torch devices) the choice was made for
_STATE = {"backend": None, "group": None, "cards": None}


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout_s: float = 300.0, device=None) -> None:
    """Join a process group: at ``coordinator_address`` ("host:port") as
    ``process_id`` of ``num_processes``, or, with all three None, from
    torchrun's ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/``WORLD_SIZE``.
    With neither it does nothing (one process), and it joins nothing when a
    group already exists.  Then, once, it chooses the mesh's transport for
    this rank's slots on ``device`` (default ``cuda``; see the module
    docstring).  A failure to join or to create the NCCL group raises.
    ``timeout_s`` bounds every wait of both groups, their collectives
    included."""
    timeout = datetime.timedelta(seconds=timeout_s)
    if not dist.is_initialized():
        _STATE.update(backend=None, group=None, cards=None)
        if coordinator_address is None and num_processes is None \
                and process_id is None:
            if not all(os.environ.get(k) for k in _ENV):
                return
            dist.init_process_group("gloo", init_method="env://",
                                    timeout=timeout)
        else:
            dist.init_process_group(
                "gloo", init_method=f"tcp://{coordinator_address}",
                world_size=num_processes, rank=process_id, timeout=timeout)
    if _STATE["backend"] is None:
        _choose_transport(device, timeout)


def _card_uuids(slots: list) -> list[str] | None:
    """The UUIDs of the cards under ``slots``, or None where a slot is not
    a CUDA card."""
    if not slots or any(d.type != "cuda" for d in slots) \
            or not torch.cuda.is_available():
        return None
    return [str(torch.cuda.get_device_properties(d).uuid) for d in slots]


def transport_for(layouts: list) -> str:
    """"nccl" when every rank's entry of ``layouts`` (its cards' UUIDs, or
    None off CUDA) names cards and no card belongs to two ranks, else
    "gloo".  Slots of one rank may share a card: they meet in the process."""
    if any(cards is None for cards in layouts):
        return "gloo"
    owners: dict = {}
    for rank, cards in enumerate(layouts):
        for uuid in set(cards):
            if owners.setdefault(uuid, rank) != rank:
                return "gloo"
    return "nccl"


def _choose_transport(device, timeout) -> None:
    from .. import log
    slots = meshlib.local_slots(device)
    if slots and slots[0].type == "cuda" and torch.cuda.is_available():
        torch.cuda.set_device(slots[0])  # before any other CUDA work
    layouts = [None] * dist.get_world_size()
    dist.all_gather_object(layouts, _card_uuids(slots))
    backend = transport_for(layouts) if len(layouts) > 1 else "gloo"
    group = None
    if backend == "nccl":
        group = dist.new_group(backend="nccl", timeout=timeout)
        probe = torch.ones(1, dtype=torch.int32, device=slots[0])
        dist.all_reduce(probe, group=group)  # creates the communicator
        if int(probe) != dist.get_world_size():
            raise RuntimeError(f"NCCL group: a probe summed to {int(probe)}")
    _STATE.update(backend=backend, group=group, cards=slots)
    log.info("distributed", f"rank {dist.get_rank()} of "
             f"{dist.get_world_size()} on {[str(d) for d in slots]}: the "
             f"mesh's collectives run on {backend}")


def collective_backend() -> str | None:
    """The transport of the mesh's cross-rank collectives ("nccl" or
    "gloo"), None without a process group."""
    if not dist.is_initialized():
        return None
    return _STATE["backend"] or "gloo"


def world() -> int:
    """The process group's size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def global_mesh(axis: str = meshlib.SAMPLE_AXIS, device=None) -> meshlib.Mesh:
    """One-axis mesh over every slot of every process (each process's
    :func:`mesh.local_slots` for ``device``), in rank order, on the
    transport chosen at join.  With a process group this is a collective:
    every rank must call it, and every rank must own the same number of
    slots.  On NCCL the slots must be the cards the choice was made for."""
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
    backend = collective_backend()
    if backend == "nccl" and slots != _STATE["cards"]:
        raise ValueError(f"slots {[str(d) for d in slots]} are not the cards "
                         f"{[str(d) for d in _STATE['cards']]} NCCL was set "
                         "up for at join")
    rank = dist.get_rank()
    return meshlib.Mesh((axis,), (n * len(slots),), slots,
                        first=rank * len(slots), rank=rank, world=n,
                        transport=backend, group=_STATE["group"])


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
