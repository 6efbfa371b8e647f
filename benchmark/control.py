"""The control of the comparison that decides ``correct``.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --seconds 45 [--requests N]

The system states no precision, so the control breaks a guarantee its
configurations state: the reference with a missing call counted as called
in AN (a count pass that skips the missing-call plane), put in the
program's place.  For each seed it makes the cell's cohort and the window's
requests at the cell's own size (an open loop's ``rate x seconds``; a
closed loop's ``--requests``, as many as a run answers), and holds the
control's answers to the reference's with the run's own comparison.  It
prints each seed's numbers beside their limits, and exits 1 when any seed's
control passes.  It needs no card and imports nothing of the program.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import cohort, judge, spec, traffic  # noqa: E402
from benchmark.reference import Reference  # noqa: E402


def control(cell: spec.Cell, seed: int, seconds: float,
            n_closed: int | None = None) -> dict:
    coh = cohort.make_cohort(cell.config, seed)
    gen = traffic.Generator(cell.mix, cell.config, coh, seed)
    gen.warmup()
    reqs = gen.window(seconds, n_closed)
    max_gt = int(cell.mix.get("max_gt", cell.config["max_gt"]))
    good = Reference(coh).answers(reqs, max_gt)
    bad = Reference(coh, missing_called=True).answers(reqs, max_gt)
    verdict, why = judge.verdicts(reqs, good, judge.from_answers(reqs, bad, coh.chrom),
                                  coh.chrom)
    return {"seed": seed, "requests": len(reqs), **judge.numbers(verdict),
            "first": why[:1]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--requests", type=int, default=None)
    args = ap.parse_args(argv)
    cell = spec.Cell(spec.load(), args.workload)
    passed = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        res = control(cell, seed, args.seconds, args.requests)
        res["seconds"] = time.perf_counter() - t
        ok = all(res[k] <= v for k, v in judge.LIMITS.items())
        passed |= ok
        res["control_correct"] = ok
        print(json.dumps(res), flush=True)
    return 1 if passed else 0


if __name__ == "__main__":
    sys.exit(main())
