"""Narrow-width count experiment: kernel C against kernel A on a torch device.

The counterpart of ``docs/experiments/pallas_count.py``, whose Pallas
kernel computed ``count_codes`` with the affine step inside the kernel, for
at most 32 groups, at narrow row widths.  Its port is
``ops.counts.count_codes_narrow`` (``csrc/count_narrow.cu``: all masks in
shared memory, a warp per 16-row tile on the binary tensor cores, the
tiles brought in by bulk copies).  For each shape this checks that
kernel C equals the production ``count_codes`` (kernel A,
``csrc/count_codes.cu``) and the plain version exactly, then times C, A and
the plain version
(``count_codes_reference``), each beside the card's name and power limit.

Shapes: the reference's 16,384 rows x 160 words x 2 groups, and the 1kg
bench width, 105,730 rows x 157 words, at 1, 8 and 32 groups.  Inputs come
from ``numpy.random.default_rng(0)``, as in the reference.

    python -m bgt_tpu_torch.experiments.narrow_count [--device cuda|cpu] [--reps N]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from bgt_tpu_torch.ops import counts
from bgt_tpu_torch.tools.measure import describe, time_ms

SHAPES = [(16384, 160, 2), (105730, 157, 1), (105730, 157, 8),
          (105730, 157, 32)]


def run(device="cuda", shapes=SHAPES, reps: int = 5) -> list[dict]:
    """Check and time every shape; prints one line each and returns the
    records."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the experiment measures a card")
    kind, power = describe(device)
    where = kind if power is None else f"{kind}, {power}"
    out = []
    for rows, words, g in shapes:
        rng = np.random.default_rng(0)
        p0, p1, masks = (counts.planes_to_torch(
            rng.integers(0, 2**32, shape, dtype=np.uint32), device)
            for shape in ((rows, words), (rows, words), (g, words)))
        got = counts.count_codes_narrow(p0, p1, masks)
        plain = counts.count_codes_reference(p0, p1, masks)
        for name, want in (("count_codes", counts.count_codes(p0, p1, masks)),
                           ("the plain version", plain)):
            if not torch.equal(got, want):
                raise AssertionError(f"count_codes_narrow != {name} at "
                                     f"{(rows, words, g)}")
        rec = {"rows": rows, "words": words, "groups": g,
               "narrow_ms": time_ms(
                   lambda: counts.count_codes_narrow(p0, p1, masks), device,
                   reps),
               "count_codes_ms": time_ms(
                   lambda: counts.count_codes(p0, p1, masks), device, reps),
               "plain_ms": time_ms(
                   lambda: counts.count_codes_reference(p0, p1, masks),
                   device, reps)}
        print(f"[narrow] {where}: {rows} x {words} words x {g} "
              f"groups: count_codes_narrow {rec['narrow_ms']:.4f} ms, "
              f"count_codes {rec['count_codes_ms']:.4f} ms, plain "
              f"{rec['plain_ms']:.4f} ms", flush=True)
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)
    run(args.device, reps=args.reps)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
