"""Multi-process count-kernel scaling: N ranks of one sample-column mesh.

    python -m bgt_tpu_torch.tools.bench_multiprocess [N] [--device cuda]
        [--slots S] [--rows R] [--words W] [--groups G] [--iters K]

The counterpart of ``tools/bench_multiprocess.py`` on ``torch.distributed``.
N processes join one group through ``distributed.initialize``; each holds
its word-column slice of synthetic packed planes (a random block of up to
4,096 rows, seed 0, tiled over the rows) on its S slots, placed with
``distributed.place_local``, and times ``mesh.sharded_count_range_fn`` over
every row (the kernel on each slot, then the sum over the sample axis),
synchronised on its cards: K calls after a warm-up, their mean.  Every rank
holds the summed counts to a host popcount of the block; rank 0 prints

    RESULT N proc: <ms> ms/iter, <G> G genotype-counts/s, transport <t> ...

and then one ``JSON`` line with the same numbers.

Where the ranks run: ``--device cuda`` (the default) gives rank k the cards
k*S .. k*S+S-1 (``CUDA_VISIBLE_DEVICES``; N*S cards must be visible) and the
ranks talk over NCCL; a device with an index (``cuda:0``) puts every slot of
every rank on that card, where the ranks keep gloo (NCCL refuses two ranks
on one card) and the line says that they share it; ``cpu`` runs on CPU
slots over gloo.  One process (N = 1) joins no group.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[2]
BLOCK_ROWS = 4096
RANK_TIMEOUT_S = 600


def synth(rows: int, words: int, groups: int):
    """The block (up to BLOCK_ROWS x words) that every plane tiles over its
    rows (plane 1 from the block's rows reversed), and the masks; the
    kernel's work does not depend on the data, so this stands in for
    planes of any size at memcpy speed."""
    rng = np.random.default_rng(0)
    blk = rng.integers(0, 2**32, (min(rows, BLOCK_ROWS), words),
                       dtype=np.uint32)
    masks = rng.integers(0, 2**32, (groups, words), dtype=np.uint32)
    return blk, masks


def check_tiled(out: np.ndarray, blk: np.ndarray, masks: np.ndarray) -> None:
    """``out`` (rows, groups, 4) against the host popcount (the port's host
    tier, ``fastpath.host_counts``) of the block that its planes tile;
    raises on any difference."""
    from bgt_tpu_torch.ops.tiles import TileStore
    from bgt_tpu_torch.query.fastpath import host_counts

    b, words = blk.shape
    want = host_counts(TileStore(b, words * 32, blk,
                                 np.ascontiguousarray(blk[::-1])),
                       np.arange(b), masks)
    full = out.shape[0] // b * b
    ok = (np.array_equal(out[:full].reshape(-1, *want.shape),
                         np.broadcast_to(want, (full // b, *want.shape)))
          and np.array_equal(out[full:], want[: out.shape[0] - full]))
    if not ok:
        raise AssertionError("sharded counts differ from the host popcount")


def _sync(slots) -> None:
    import torch
    for d in slots:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def rank_main(a) -> int:
    """One rank: join, place, time, check; rank 0 prints the result."""
    from bgt_tpu_torch.ops import counts
    from bgt_tpu_torch.parallel import distributed
    from bgt_tpu_torch.parallel import mesh as meshlib

    if a.world > 1:
        distributed.initialize(f"127.0.0.1:{a.port}", a.world, a.rank,
                               timeout_s=RANK_TIMEOUT_S, device=a.device)
    mesh = distributed.global_mesh(device=a.device)
    words = meshlib.pad_words_for_mesh(a.words, mesh.size)
    blk, masks = synth(a.rows, words, a.groups)
    lo, hi = distributed.local_column_range(words, mesh)
    reps = -(-a.rows // blk.shape[0])
    p0 = distributed.place_local(mesh, np.tile(blk[:, lo:hi], (reps, 1))
                                 [:a.rows])
    p1 = distributed.place_local(mesh, np.tile(blk[::-1, lo:hi], (reps, 1))
                                 [:a.rows])
    mk = distributed.place_local(mesh, masks[:, lo:hi])
    fn = meshlib.sharded_count_range_fn(mesh)
    out = fn(p0, p1, mk, 0, a.rows)  # warm-up
    _sync(mesh.slots)
    launches0 = counts.LAUNCHES["count_codes"]
    t0 = time.perf_counter()
    for _ in range(a.iters):
        out = fn(p0, p1, mk, 0, a.rows)
    _sync(mesh.slots)
    dt = (time.perf_counter() - t0) / a.iters
    launches = counts.LAUNCHES["count_codes"] - launches0
    check_tiled(out.cpu().numpy(), blk, masks)
    cuda = all(d.type == "cuda" for d in mesh.slots)
    if cuda and launches != a.iters * len(mesh.slots):
        raise AssertionError(f"kernel A launched {launches} times for "
                             f"{a.iters} calls on {len(mesh.slots)} slots")
    transport = distributed.collective_backend() or "none (one process)"
    if a.rank == 0:
        gt = a.rows * words * 32 * a.groups
        res = {"processes": a.world, "slots": [str(d) for d in mesh.slots],
               "mesh": mesh.size, "rows": a.rows, "words": words,
               "groups": a.groups, "iters": a.iters, "s_per_iter": dt,
               "gcounts_per_s": gt / dt / 1e9, "transport": transport,
               "kernel_launches": launches, "counts_exact": True}
        shared = f", {a.shared}" if a.shared else ""
        print(f"RESULT {a.world} proc: {dt * 1e3:.3f} ms/iter, "
              f"{gt / dt / 1e9:.2f} G genotype-counts/s, transport "
              f"{transport}{shared}", flush=True)
        print("JSON " + json.dumps(res), flush=True)
    if a.world > 1:
        import torch.distributed as dist
        dist.destroy_process_group()
    return 0


def visible_cards() -> list:
    """The parent's visible CUDA cards, as ``CUDA_VISIBLE_DEVICES`` ids."""
    import torch
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    n = torch.cuda.device_count()
    return vis.split(",")[:n] if vis else [str(i) for i in range(n)]


def run(n_proc: int, device: str = "cuda", slots: int = 1,
        rows: int = 16384, words: int = 160, groups: int = 2,
        iters: int = 30) -> dict:
    """Spawn ``n_proc`` ranks of ``slots`` slots (see the module docstring
    for ``device``); returns rank 0's result, its RESULT line as ``line``.
    A rank that fails, or outlives RANK_TIMEOUT_S, raises."""
    import torch
    dev = torch.device(device)
    base = {k: v for k, v in os.environ.items()
            if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                         "LOCAL_RANK", "BGT_TPU_MESH_DEVICES")}
    envs, shared = [], ""
    if dev.type == "cuda" and dev.index is None:
        ids = visible_cards()
        if len(ids) < n_proc * slots:
            raise ValueError(f"{n_proc} ranks of {slots} cards need "
                             f"{n_proc * slots} cards; {len(ids)} visible")
        envs = [{"CUDA_VISIBLE_DEVICES": ",".join(ids[k * slots:
                                                      (k + 1) * slots])}
                for k in range(n_proc)]
    else:
        envs = [{"BGT_TPU_MESH_DEVICES": str(slots)}] * n_proc
        if n_proc * slots > 1:
            shared = f"{n_proc} ranks x {slots} slots share {device}"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    procs = []
    try:
        for k, env in enumerate(envs):
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "bgt_tpu_torch.tools.bench_multiprocess",
                 "--rank", str(k), "--world", str(n_proc), "--port", port,
                 "--device", device, "--rows", str(rows), "--words",
                 str(words), "--groups", str(groups), "--iters", str(iters),
                 "--shared", shared],
                cwd=REPO, env={**base, **env}, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        outs = []
        for k, p in enumerate(procs):
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                raise RuntimeError(f"rank {k} exited {p.returncode}:\n"
                                   f"{out[-3000:]}")
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    lines = outs[0].splitlines()
    res = json.loads(next(ln for ln in lines if ln.startswith("JSON "))[5:])
    res["line"] = next(ln for ln in lines if ln.startswith("RESULT "))
    res["shared_card"] = bool(shared)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=2,
                    help="processes (default 2)")
    ap.add_argument("--device", default="cuda",
                    help="cuda: a card per slot, NCCL between ranks; cuda:K: "
                         "every slot on card K, gloo; cpu: CPU slots, gloo")
    ap.add_argument("--slots", type=int, default=1, help="slots a rank")
    ap.add_argument("--rows", type=int, default=16384)
    ap.add_argument("--words", type=int, default=160,
                    help="words of the whole mesh (padded to its size)")
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, help=argparse.SUPPRESS)
    ap.add_argument("--port", help=argparse.SUPPRESS)
    ap.add_argument("--shared", default="", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.rank is not None:
        return rank_main(a)
    import torch
    if torch.device(a.device).type == "cuda" and not torch.cuda.is_available():
        print("bench_multiprocess: no CUDA device (use --device cpu)",
              file=sys.stderr)
        return 2
    res = run(a.n, a.device, a.slots, a.rows, a.words, a.groups, a.iters)
    print(res["line"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
