"""The sweep that finds an open-loop cell's knee, once, on the card.

    python3 benchmark/sweep.py --workload <cell> --seed <n> --seconds 30 --rates 0.5,1,1.5,2

One set-up, then one window at each rate, in the order given, each with
requests of its own (fresh groups stay fresh across windows), each checked
against the reference.  For each rate it prints the latency percentiles,
the median latency of the requests due in the window's first and last
thirds, the backlog (sent and not yet answered) averaged over each third,
and how long the last answers took after the window closed.  The knee is
the highest rate whose completions keep up with the sends: every request
of the window answered within a second of its close, and the backlog of
the last third no more than 1.5 times that of the first third plus two
requests.  Arrivals are paced, as in the cells: one request every ``1 /
rate`` seconds.  A cell's ``rate_per_s`` lies below the knee, written into
its traffic file by hand.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from benchmark import run, spec  # noqa: E402


def thirds(got, t0: float, seconds: float) -> dict:
    due = got.t_due - t0
    lat = run.latencies(got, t0, seconds)
    done = np.where(np.isfinite(got.t_done), got.t_done - t0, np.inf)
    ts = np.linspace(0, seconds, 301)[1:]
    backlog = np.array([(due <= t).sum() - (done <= t).sum() for t in ts])
    out = {}
    for k, (a, b) in enumerate(((0, seconds / 3), (2 * seconds / 3, seconds))):
        sel = (due >= a) & (due < b)
        out[f"lat_med_ms_{k}"] = float(np.median(lat[sel]) * 1e3) if sel.any() else None
        out[f"backlog_{k}"] = float(backlog[(ts > a) & (ts <= b)].mean())
    out["drain_s"] = float(np.nanmax(got.t_done) - (t0 + seconds))
    out["keeps_up"] = bool(out["drain_s"] <= 1.0
                           and out["backlog_1"] <= 1.5 * out["backlog_0"] + 2)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load(), args.workload)
    if cell.mix["loop"] != "open":
        raise SystemExit("a sweep is for an open-loop cell")
    import torch
    if not torch.cuda.is_available():
        print("[sweep] no CUDA device", file=sys.stderr)
        return 2
    ses = run.Session(cell, args.seed, "cuda", run.WORK)
    try:
        run.info("setup_s", time.perf_counter() - T_START - ses.input_s)
        for k, rate in enumerate(float(r) for r in args.rates.split(",")):
            mix = dict(cell.mix, rate_per_s=rate)
            ses.gen.mix = mix
            reqs = ses.requests(args.seconds, stream=1000 + k)
            w = ses.window(mix, reqs, args.seconds, False)
            got, t0 = w["got"], w["t0"]
            _a, _v, why, checked = ses.check(reqs, got)
            lat = run.latencies(got, t0, args.seconds) * 1e3
            row = {"rate_per_s": rate, "requests": got.n, **checked,
                   "p50_ms": float(np.percentile(lat, 50)),
                   "p95_ms": float(np.percentile(lat, 95)),
                   **thirds(got, t0, args.seconds),
                   "late_max_ms": w["summary"]["late_max_ms"], "tiers": w["tiers"]}
            print("sweep " + json.dumps(row), flush=True)
            for line in why:
                print(f"[sweep] wrong: {line}", file=sys.stderr)
    finally:
        ses.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
