"""Count-kernel scaling on the port's mesh: cards, slots and processes.

    python -m bgt_tpu_torch.tools.bench_scaling [--device cuda]

The counterpart of ``tools/bench_scaling.py``: the sample-column sharded
count (kernel A on each slot's column slice of every row, then the sum over
the sample axis: ``mesh.sharded_count_range_fn``, the hot reduction of
every query) timed

- at tiny rows (dispatch overhead), on 1, 2, 4 and 8 slots;
- at 10^6 rows x 2,048 words, 16.4 GB of planes (strong scaling), on 1,
  2, 4 and 8 slots;
- on the 2x2 ``rs`` mesh (rows x columns) at the same shape;
- at 10^6 rows x 512 words a slot (weak scaling), on 1, 2, 4 and 8 slots;
- over row spans from 8,192 to 10^6 at 2,048 words on 1 and 2 slots: the
  crossover where 2 beat 1, beside ``fastpath._shard_min_rows``;
- on one process of P slots against P processes of one slot each
  (``bench_multiprocess``), P = 2 and 4 (2 on the CPU), 10^6 rows x 2,048
  words.

The sizes keep kernel A at a millisecond or more a card, so that launch
overhead cannot hide the scaling.  Where the slots are: ``--device cuda``
(the default) puts slot i on card i, and a step that needs more cards than
are visible is logged and recorded as "not run: k cards"; a device with an
index (``cuda:0``, ``BGT_TPU_MESH_DEVICES``'s layout) puts every slot on
that card, and ``cpu`` on the CPU, where the steps run at the small sizes
of ``CPU_SIZES`` (for the tests).  Slots that share a device are flagged
``shared_card: true`` and carry no efficiency (the original's
``oversubscribed``).  The planes are made on each slot's device from a
random block of 4,096 rows (seed 0) tiled over the rows, and every timed
count is held to a host popcount of that block.  A time is the median of
``reps`` calls, each synchronised on every card, after one warm-up.  Any
failure exits nonzero.  Prints ONE JSON line: ``{"scaling": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from bgt_tpu_torch.ops import counts
from bgt_tpu_torch.parallel import mesh as meshlib
from bgt_tpu_torch.query import fastpath
from bgt_tpu_torch.tools import bench_multiprocess, measure

SLOT_COUNTS = (1, 2, 4, 8)
GROUPS = 2
# the card's sizes, and the CPU's (the same steps, small enough for a test)
SIZES = dict(overhead_rows=256, overhead_words=256, strong_rows=1_000_000,
             strong_words=2048, weak_rows=1_000_000, weak_words=512,
             cross_words=2048,
             cross_rows=(8192, 16384, 32768, 65536, 131072, 262144, 524288,
                         1_000_000),
             proc_counts=(2, 4), proc_rows=1_000_000, proc_words=2048,
             proc_iters=10, reps=5)
CPU_SIZES = dict(overhead_rows=64, overhead_words=16, strong_rows=3000,
                 strong_words=64, weak_rows=3000, weak_words=16,
                 cross_words=64, cross_rows=(512, 5000), proc_counts=(2,),
                 proc_rows=3000, proc_words=64, proc_iters=2, reps=2)


def log(msg: str) -> None:
    print(f"[scaling] {msg}", file=sys.stderr, flush=True)


def slots_for(n: int, device: torch.device) -> list | str:
    """``n`` slots on ``device`` (bare ``cuda``: cards 0..n-1), or why not."""
    if device.type == "cuda" and device.index is None:
        have = torch.cuda.device_count()
        if n > have:
            return f"not run: {n} cards ({have} visible)"
        return [torch.device("cuda", i) for i in range(n)]
    return [device] * n


def shared(slots: list) -> bool:
    return len(set(slots)) < len(slots)


def _sync(slots) -> None:
    for d in set(slots):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def time_mesh(slots: list, rows: int, words: int, reps: int,
              mesh2_rows: int = 0) -> dict:
    """The sharded count over ``slots`` (1-axis, or ``mesh2_rows`` x n/r)
    on planes made on the slots' devices: median seconds of ``reps``
    synchronised calls, kernel A's launches a call, and the counts held to
    the host popcount."""
    blk, masks = bench_multiprocess.synth(rows, words, GROUPS)
    if mesh2_rows:
        mesh = meshlib.make_mesh2(mesh2_rows, slots)
        r = mesh.shape[meshlib.ROW_AXIS]
    else:
        mesh = meshlib.make_mesh(slots)
        r = 1
    s = mesh.shape[meshlib.SAMPLE_AXIS]
    if words % s or rows % r:
        raise ValueError(f"{rows} x {words} does not split over {mesh.shape}")
    per_w, per_r = words // s, rows // r
    b = blk.shape[0]
    p0, p1, dm = [], [], []
    for i, dev in enumerate(mesh.slots):
        ri, si = mesh.coords(i)
        cols = slice(si * per_w, (si + 1) * per_w)
        idx = (torch.arange(ri * per_r, (ri + 1) * per_r, device=dev) % b)
        for plane, out in ((blk, p0), (blk[::-1], p1)):
            part = torch.from_numpy(np.ascontiguousarray(plane[:, cols])
                                    .view(np.int32)).to(dev)
            out.append(part[idx].contiguous())
        dm.append(counts.planes_to_torch(masks[:, cols], dev))
    if mesh2_rows:
        fn2 = meshlib.sharded_count2_fn(mesh)

        def call():  # the row blocks' counts, each on its first slot
            return fn2(p0, p1, dm)
    else:
        fn = meshlib.sharded_count_range_fn(mesh)

        def call():
            return [fn(p0, p1, dm, 0, rows)]

    out = call()  # warm-up
    _sync(slots)
    bench_multiprocess.check_tiled(
        torch.cat([t.cpu() for t in out]).numpy(), blk, masks)
    launches0 = counts.LAUNCHES["count_codes"]
    times = []
    for _ in range(reps):
        _sync(slots)
        t0 = time.perf_counter()
        call()
        _sync(slots)
        times.append(time.perf_counter() - t0)
    launches = (counts.LAUNCHES["count_codes"] - launches0) / reps
    if slots[0].type == "cuda" and launches != len(slots):
        raise AssertionError(f"kernel A launched {launches} times a call on "
                             f"{len(slots)} slots")
    del p0, p1, dm, out
    if slots[0].type == "cuda":
        torch.cuda.empty_cache()
    return {"s_per_iter": statistics.median(times),
            "launches_per_call": launches, "counts_exact": True}


def step(n: int, device: torch.device, rows: int, words: int, reps: int,
         mesh2_rows: int = 0) -> dict:
    slots = slots_for(n, device)
    if isinstance(slots, str):
        log(f"{n} slots, {rows} x {words}: {slots}")
        return {"not_run": slots}
    e = time_mesh(slots, rows, words, reps, mesh2_rows)
    e["shared_card"] = shared(slots)
    log(f"{n} slots on {sorted({str(d) for d in slots})}"
        + (f" ({mesh2_rows}x{n // mesh2_rows})" if mesh2_rows else "")
        + f", {rows} x {words}: {e['s_per_iter'] * 1e3:.4f} ms")
    return e


def efficiency(e: dict, base: dict | None, ratio: float) -> None:
    """``e``'s efficiency against ``base`` (``ratio`` = base time over e's
    ideal), only where both ran on cards of their own."""
    if "not_run" in e or base is None or "not_run" in base:
        return
    if e["shared_card"] or base["shared_card"]:
        return
    e["efficiency"] = base["s_per_iter"] / (e["s_per_iter"] * ratio)


def run(device="cuda", sizes: dict | None = None) -> dict:
    """Every step on ``device``; returns the ``scaling`` object."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: use --device cpu")
    sz = sizes or (CPU_SIZES if device.type == "cpu" else SIZES)
    kind, power = measure.describe(device)
    reps = sz["reps"]
    result: dict = {
        "method": ("sample-column sharded count (kernel A per slot, then the "
                   "sum over the sample axis: peer copies between cards, the "
                   "host between processes' gloo); median of reps calls "
                   "synchronised on every card, after a warm-up; slots that "
                   "share a device carry no efficiency"),
        "device": {"torch": str(device), "kind": kind, "power_limit": power,
                   "cards_visible": (torch.cuda.device_count()
                                     if device.type == "cuda" else 0)},
        "groups": GROUPS, "sizes": {k: v for k, v in sz.items()},
    }
    result["dispatch_overhead_s"] = {
        str(n): step(n, device, sz["overhead_rows"], sz["overhead_words"] * n,
                     reps) for n in SLOT_COUNTS}

    strong = {}
    for n in SLOT_COUNTS:
        e = step(n, device, sz["strong_rows"], sz["strong_words"], reps)
        if "s_per_iter" in e:
            e["gb_per_s"] = (sz["strong_rows"] * sz["strong_words"] * 8
                             / e["s_per_iter"] / 1e9)
        if n > 1:
            efficiency(e, strong["1"], n)
        strong[str(n)] = e
    result["strong_rows"] = sz["strong_rows"]
    result["strong_devices"] = strong
    e = step(4, device, sz["strong_rows"], sz["strong_words"], reps,
             mesh2_rows=2)
    efficiency(e, strong["1"], 4)
    if "efficiency" in e:
        e["efficiency_vs_1dev"] = e.pop("efficiency")
    result["mesh2_2x2"] = e

    weak = {}
    for n in SLOT_COUNTS:
        e = step(n, device, sz["weak_rows"], sz["weak_words"] * n, reps)
        if "s_per_iter" in e:
            e["gcounts_per_s"] = (sz["weak_rows"] * sz["weak_words"] * n * 32
                                  / e["s_per_iter"] / 1e9)
        if n > 1:
            efficiency(e, weak["1"], 1)
        weak[str(n)] = e
    result["weak_devices"] = weak

    cross, crossover = {}, None
    for rows in sz["cross_rows"]:
        a = step(1, device, rows, sz["cross_words"], reps)
        b = step(2, device, rows, sz["cross_words"], reps)
        if "not_run" in b:
            cross[str(rows)] = {"t1": a["s_per_iter"], "t2": b}
            continue
        cross[str(rows)] = {"t1": a["s_per_iter"], "t2": b["s_per_iter"],
                            "shared_card": b["shared_card"]}
        if crossover is None and b["s_per_iter"] < a["s_per_iter"] \
                and not b["shared_card"]:
            crossover = rows
    result["crossover"] = {
        "rows_vs_1dev": cross,
        "crossover_rows": crossover,
        "production_gate": ("fastpath._shard_min_rows "
                            "(BGT_TPU_SHARD_MIN_ROWS, default "
                            f"{fastpath._shard_min_rows()})"),
    }

    procs = {}
    for p in sz["proc_counts"]:
        if isinstance(slots_for(p, device), str):
            procs[str(p)] = {"not_run": slots_for(p, device)}
            log(f"processes {p}: {procs[str(p)]['not_run']}")
            continue
        kw = dict(device=str(device), rows=sz["proc_rows"],
                  words=sz["proc_words"], groups=GROUPS,
                  iters=sz["proc_iters"])
        one = bench_multiprocess.run(1, slots=p, **kw)
        many = bench_multiprocess.run(p, slots=1, **kw)
        e = {"one_process_s": one["s_per_iter"],
             "s_per_iter": many["s_per_iter"],
             "transport": many["transport"],
             "shared_card": many["shared_card"], "line": many["line"]}
        if not e["shared_card"]:
            e["efficiency"] = one["s_per_iter"] / many["s_per_iter"]
        procs[str(p)] = e
        log(f"processes {p}: {many['line']} (one process of {p} slots "
            f"{one['s_per_iter'] * 1e3:.3f} ms/iter)")
    result["processes"] = procs
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda: a card per slot; cuda:K: every slot on card "
                         "K; cpu: CPU slots at CPU_SIZES")
    args = ap.parse_args(argv)
    print(json.dumps({"scaling": run(args.device)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
