"""Roofline probe for the masked-popcount count kernels on a torch device.

The counterpart of ``tools/probe_roofline.py``.  On the same random planes
(rows x 2,048 uint32 words, from ``numpy.random.default_rng(0)``) it times
read proxies, the production count, four plain formulations and the one-mask
streaming kernel, and writes one JSON object with the same keys:

- ``proxy_reduce2``, ``proxy_reduce1``: a sum over both planes / over p0,
  the device's streaming read rate.  The reference XORs the planes with the
  loop index, which XLA fuses into the reduction; eager torch would write
  that XOR out as a full copy and read it back, so here the planes are
  reduced directly (torch hoists nothing out of the loop).  Every sum is an
  int32 sum, as in the reference: torch's int64 sum of int32 words is a
  slower kernel, not a faster card;
- ``proxy_popc1``: popcount then sum over p0.  Torch has no popcount: this is
  the plain SWAR popcount, several elementwise passes, so its rate counts one
  read of p0 while the device moves more;
- ``count_1mask``, ``count_32mask``: ``ops.counts.count_codes`` (kernel A,
  ``csrc/count_codes.cu``, on a CUDA device);
- ``count_i16_1mask``, ``count_reshape_1mask``, ``count_mm_1mask``,
  ``count_mm_32mask``, ``count_stack_1mask``: the reference's variants A-D as
  plain torch (variant C's ones-vector product is ``torch.matmul``);
- ``count_raw_1mask`` in place of ``count_pallas_1mask``: kernel B,
  ``ops.counts.count_raw`` (``csrc/count_raw.cu``), on all rows (the TPU
  kernel trimmed them to a multiple of 256).

Each entry is ``{"s": seconds per iteration, "gbs": plane GB / s}``, unrounded,
timed as the reference times it: K and 2K iterations, best of 3 each,
(t_2K - t_K) / K, with the masks XORed with the loop index.  A variant that
fails fails the run.  ``device_kind`` and ``power_limit`` come from
``nvidia-smi`` on a CUDA device.

    python -m bgt_tpu_torch.tools.probe_roofline [rows] [k] [--device cuda|cpu] [--out path]

Defaults: 30,000 rows, k = 20, a CUDA device, ``roofline.json`` in the
temporary directory.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
import time

import numpy as np
import torch

from bgt_tpu_torch.ops import counts
from bgt_tpu_torch.tools.measure import describe

WORDS = 2048
RAW_REPLACES = "tools/probe_roofline.py:190"  # _kern, via count_pallas


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_seconds_per_iter(loop_fn, k: int, device: torch.device,
                            *args) -> float:
    """Time k and 2k iterations of ``loop_fn``; the difference isolates the
    per-iteration device time from launch and fixed overhead."""
    lo = functools.partial(loop_fn, k=k)
    hi = functools.partial(loop_fn, k=2 * k)
    for f in (lo, hi):  # warm-up: kernel build, allocator
        f(*args)
        _sync(device)

    def best_of(f, n=3):
        b = float("inf")
        for _ in range(n):
            _sync(device)
            t0 = time.perf_counter()
            f(*args)
            _sync(device)
            b = min(b, time.perf_counter() - t0)
        return b

    t_lo, t_hi = best_of(lo), best_of(hi)
    return max(t_hi - t_lo, 1e-9) / k


# --- the reference's plain variants A-D: (rows, groups, 3) cnt1, cnt2, nb ---

def _per_group(red, p0, p1, masks):
    both = p0 & p1
    outs = []
    for gi in range(masks.shape[0]):
        m = masks[gi][None, :]
        n10, n11, nb = red(p0, m), red(p1, m), red(both, m)
        outs.append(torch.stack([n10 - nb, n11 - nb, nb], dim=-1))
    return torch.stack(outs, dim=1)


def count_i16(p0, p1, masks):
    """Variant A: popcounts as int16, summed in 16-word blocks, then int32."""
    rows, words = p0.shape
    if words != WORDS:
        raise ValueError(f"count_i16 reshapes rows to (128, 16): needs "
                         f"{WORDS} words, got {words}")

    def red(x, m):
        r = counts._popcount32(x & m).to(torch.int16).reshape(rows, 128, 16)
        return r.sum(dim=-1, dtype=torch.int16).sum(dim=-1, dtype=torch.int32)
    return _per_group(red, p0, p1, masks)


def count_reshape(p0, p1, masks):
    """Variant B: one reshape, then two int32 sums."""
    rows = p0.shape[0]

    def red(x, m):
        r = counts._popcount32(x & m).reshape(rows, 16, -1)
        return r.sum(dim=1, dtype=torch.int32).sum(dim=-1, dtype=torch.int32)
    return _per_group(red, p0, p1, masks)


def count_mm(p0, p1, masks):
    """Variant C: the row sums as a float32 product with a ones vector."""
    ones = torch.ones((p0.shape[1], 1), dtype=torch.float32, device=p0.device)

    def red(x, m):
        return (counts._popcount32(x & m).to(torch.float32) @ ones)[:, 0]
    return _per_group(red, p0, p1, masks).to(torch.int32)


def count_stack(p0, p1, masks):
    """Variant D: the three masked streams stacked, one popcount and sum."""
    both = p0 & p1
    outs = []
    for gi in range(masks.shape[0]):
        m = masks[gi][None, :]
        s = torch.stack([p0 & m, p1 & m, both & m], dim=1)
        red = counts._popcount32(s).sum(dim=-1, dtype=torch.int32)
        n10, n11, nb = red[:, 0], red[:, 1], red[:, 2]
        outs.append(torch.stack([n10 - nb, n11 - nb, nb], dim=-1))
    return torch.stack(outs, dim=1)


def _count_loop(count_fn):
    def loop(p0, p1, masks, k):
        acc = torch.zeros((), dtype=torch.int32, device=p0.device)
        for i in range(k):
            acc += count_fn(p0, p1, masks ^ i).sum(dtype=torch.int32)
        return acc
    return loop


def _loop_reduce2(p0, p1, k):
    acc = torch.zeros((), dtype=torch.int32, device=p0.device)
    for _ in range(k):
        acc += p0.sum(dtype=torch.int32) + p1.sum(dtype=torch.int32)
    return acc


def _loop_reduce1(p0, k):
    acc = torch.zeros((), dtype=torch.int32, device=p0.device)
    for _ in range(k):
        acc += p0.sum(dtype=torch.int32)
    return acc


def _loop_popc1(p0, k):
    acc = torch.zeros((), dtype=torch.int32, device=p0.device)
    for _ in range(k):
        acc += counts._popcount32(p0).sum(dtype=torch.int32)
    return acc


def run(rows: int = 30000, k: int = 20, device="cuda") -> dict:
    """Time every variant on ``device``; returns the JSON object."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the probe measures a card")
    kind, power = describe(device)
    res = {"backend": device.type, "device_kind": kind, "power_limit": power,
           "rows": rows, "words": WORDS, "k": k}
    rng = np.random.default_rng(0)
    h0 = rng.integers(0, 2**32, (rows, WORDS), dtype=np.uint32)
    h1 = rng.integers(0, 2**32, (rows, WORDS), dtype=np.uint32)
    hm = rng.integers(0, 2**32, (32, WORDS), dtype=np.uint32)
    p0 = counts.planes_to_torch(h0, device)
    p1 = counts.planes_to_torch(h1, device)
    m32 = counts.planes_to_torch(hm, device)
    m1 = m32[:1].contiguous()
    plane_bytes = h0.nbytes * 2
    res["plane_bytes"] = plane_bytes

    def bw(name, loop_fn, *args, nbytes=plane_bytes, **extra):
        t = device_seconds_per_iter(loop_fn, k, device, *args)
        res[name] = {"s": t, "gbs": nbytes / t / 1e9, **extra}
        print(name, res[name], flush=True)

    bw("proxy_reduce2", _loop_reduce2, p0, p1)
    bw("proxy_reduce1", _loop_reduce1, p0, nbytes=h0.nbytes)
    bw("proxy_popc1", _loop_popc1, p0, nbytes=h0.nbytes)
    prod = _count_loop(counts.count_codes)
    bw("count_1mask", prod, p0, p1, m1)
    bw("count_32mask", prod, p0, p1, m32)
    bw("count_i16_1mask", _count_loop(count_i16), p0, p1, m1)
    bw("count_reshape_1mask", _count_loop(count_reshape), p0, p1, m1)
    bw("count_mm_1mask", _count_loop(count_mm), p0, p1, m1)
    bw("count_mm_32mask", _count_loop(count_mm), p0, p1, m32)
    bw("count_stack_1mask", _count_loop(count_stack), p0, p1, m1)
    bw("count_raw_1mask", _count_loop(counts.count_raw), p0, p1, m1,
       replaces=RAW_REPLACES)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("rows", nargs="?", type=int, default=30000)
    ap.add_argument("k", nargs="?", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(),
                                                  "roofline.json"))
    args = ap.parse_args(argv)
    res = run(args.rows, args.k, args.device)
    print(json.dumps(res), flush=True)
    with open(args.out, "w") as fp:
        json.dump(res, fp, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
