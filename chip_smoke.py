#!/usr/bin/env python3
"""Drive the torch port's main path once on the CUDA cards, and check it.

    python3 chip_smoke.py [--baseline OLD.cu ...]
    python3 chip_smoke.py --cards N

Needs one NVIDIA Hopper card (compute capability 9.0) and ``nvcc``; exits
non-zero, printing no result, without them.  Phases 1-12, 14 and 15 run
on cuda:0 and behave the same on a host of several cards; phase 13 runs
where two or more Hopper cards are visible, and is logged as not run on
one.  ``--cards N`` makes phase 13 mandatory (fewer than N cards: exit
non-zero, no result), skips phases 3-12 and 15 (the preflight, the build
and the cohort stay) and runs phase 14's scaling and multi-process steps
across the N cards.  It imports nothing of JAX and
nothing of ``bgt_tpu``: the cohort is made and imported by the port's own
``testing`` and ``importer``, and every device-tier output is held against
the port's own host tier (``BGT_TPU_COUNT_TIER=host``: the same code as
``bgt_tpu``'s host tier, which the CPU tests hold byte-equal to it).  Phases,
each fatal on failure:

1. preflight: the card, its name and power limit (``nvidia-smi``);
2. build: the CUDA kernels from ``bgt_tpu_torch/csrc/`` with nvcc, sm_90a,
   one nvcc per source in parallel, with ``-Xptxas -v``;
3. kernel A (``count_codes``) against its plain PyTorch version on the card,
   exact int32 equality, at the device-suite, cohort-width, ragged (rows
   and words off the kernel's 16-row and 16/32-word blocks, groups off its
   octets), one- and two-group (its carry-save path), empty,
   more-than-40- and more-than-512-group, the probe's and offset-range
   shapes, with 0xFFFFFFFF and 0x80000000 words;
4. kernel A's device time on a full HRC-width tile (10^6 rows x 2031
   words, random planes made on the card) at 1, 2, 8, 16, 32 and 33 groups
   and at the cohort's width (100,000 x 2,048 words) at 1, 2 and 8, each
   beside its bytes bound and share and, as a diagnostic, the time of the
   CUDA-core logic a design on the CUDA cores would issue at the SM clock
   read during the run; the plain version at 1 and 33 groups on the tile.
   Each ``--baseline OLD.cu`` that exports ``bgt_count_codes`` (another
   revision of kernel A) is also built, held equal to A and timed beside
   it in turns, at every one of these shapes;
5. the main path end to end: an HRC-shaped cohort (32,488 samples x 100,000
   sites) is generated, imported, and queried through ``bgt_tpu_torch.cli
   view`` with the device count tier forced, including one query of 8
   groups; every output's md5 must equal the host tier's, and the kernel
   must have launched for every query.  The subset query's host-tier and
   cold device times are printed beside its work and the planes' bytes,
   with the tier ``auto`` picks;
6. the streamed device tier (``BGT_TPU_HBM_BUDGET=1``) on one query, same md5;
7. kernels B (``count_raw``) and C (``count_codes_narrow``) against their
   plain versions on the card, exact int32 equality, at the probe's, the
   narrow experiment's, ragged, one-word and empty shapes, with the same
   words as phase 3; for C also rows, words and groups at the edges of its
   16-row tile, 8-word k-step and octet, masks filling shared memory, and
   planes whose tiles start unaligned; C must refuse 33 groups and 32
   masks of 2,048 words.  B is timed beside its plain version and bound;
   C beside kernel A in turns at 16,384 x 160 words x 2 groups (no share:
   those planes stay in L2) and 105,730 x 157 at 1, 8 and 32 groups, each
   beside its bytes bound and share, with each ``--baseline OLD.cu`` that
   exports ``bgt_count_codes_narrow`` (another revision of C) held equal
   to C and timed in the same turns;
8. the ported roofline probe (``bgt_tpu_torch.tools.probe_roofline``, 30,000
   rows, k = 5), whose JSON is printed on one line and must time every
   variant, then the narrow-width experiment
   (``bgt_tpu_torch.experiments.narrow_count``).  They are the paths of
   kernels B and C: each kernel's launch count is read around its path;
9. the port's server on the cohort, in process: the same requests (help,
   subsets, two groups with filters, a table, all samples, a GT dump, a
   400) first on the host tier, then on the card under the default tier
   (``auto``, nothing forced), cold and warm; every status and body must be
   equal and kernel A must run for each subset or group request.  Then 8
   concurrent first requests with distinct masks under ``auto``: all equal,
   and the planes transferred to the card once;
10. ``bgt_tpu_torch.open(...).query`` under ``auto`` on the card against
   the same query on the host tier, in every array and the genotypes,
   ``entry()``'s forward on the card against the same forward on the CPU,
   and the decode and gather ops on the card against a numpy unpack;
11. the mesh on one card, on the cohort: in process with 2 slots
   (``BGT_TPU_MESH_DEVICES=2``, 1,024 words each) the subset, two- and
   eight-group and a GT-emitting query, and on a 2x2 mesh (4 slots,
   ``BGT_TPU_MESH2=2x2``) the subset and GT queries, the device tier forced
   and the crossover gate off; then ``gtcshard <prefix> 2 2`` and two gloo
   ranks on this card (``chip_smoke.py --rank``, each opening only its
   shard file; two ranks on one card keep gloo) with the subset and GT
   queries cold and warm; then ``entry.dryrun_multichip(4, "cuda:0")``.  Every md5 must equal the host tier's, and
   kernel A must launch once per slot per counted query.  For 1 slot, 2
   slots, 2x2 and 2 ranks it prints the subset query's cold and warm
   seconds, kernel A's device ms per slot and the gloo collectives' ms;
12. kernel D (``pbwt_decode``, the PBWT decode scan) against its plain
   version on the card, exact equality of the rows and the final S, at 1,
   31, 33, 1,025 and 64,976 haplotypes x 0, 1, 17 and 64 rows (one run a
   row to more runs than the block's threads; all-zero, all-one and sparse
   rows), on padded runs and on RLE bytes, in ragged batches of one launch,
   with each scan forced over 1, 2, 7 and the most blocks at 1,025 and
   64,976 haplotypes, and in a batch of more scans than SMs at 5,008; then
   the cohort's PBF decoded block by block (``decode.iter_block_codes``:
   every block equal to the resident planes' codes, every final S equal to
   the next block's checkpoint) and ``decode_pbf_on_device`` over 16,384
   rows against the host; then D's time on the whole cohort (26 scans in
   one launch) at its own split and at 1, 2 and 10 blocks a scan, and at
   256- and 512-thread blocks (the same source built with
   ``-DBGT_PBWT_THREADS``), each beside its blocks, the SMs they cover, its
   bytes bound and share, in turns, with the plain version's time; each
   ``--baseline OLD.cu`` that exports ``bgt_pbwt_decode`` (another revision
   of D, with this signature or the S-form one's, which took an S scratch
   buffer and one block a scan) is
   held equal to D on the cohort and timed in the same turns; last, the
   time of all-zero rows from random against identity permutations (the
   output scatter's cost under the S form, which the inverse form removed);
13. the mesh across N >= 2 cards: (a) one process over cuda:0..N-1 (bare
   ``cuda``, the device tier forced, the crossover gate off) on the cohort,
   the subset, two-group, eight-group and GT queries cold and warm, beside
   the subset on one card; (b) the 2 x N/2 ``rs`` mesh over them, the
   subset and GT queries; (g) the port's server on them under ``auto``, a
   subset and a GT request, bodies equal to the host tier's; (f)
   ``entry.dryrun_multichip(N)`` on cuda:0..N-1; (c) N ranks, one card each
   (``LOCAL_RANK``), on NCCL, from ``gtcshard <prefix> N N`` files, and (d)
   two ranks of N/2 cards each (``CUDA_VISIBLE_DEVICES``), the in-process
   sum then NCCL, each with the subset and GT queries cold and warm: every
   rank must report ``nccl`` and no gloo collective on the query path; (e)
   a tile that no single card holds, 6,000,000 rows x 2,048 words (two
   planes of 49.2 GB), made on the cards from seeded generators, counted
   at 1 and 8 groups in process and on N NCCL ranks: each card's kernel A
   against its plain version on 100,000 rows, the summed counts against
   the host sum of every card's counts (and each rank's md5 against it),
   each card's A beside its bytes bound, the sum beside its NVLink ring
   bound and the whole call.  Every md5 must equal the host tier's, and
   kernel A must launch once on each card of each counted query;
14. the port's measurement tools (``bgt_tpu_torch/tools/``): (a)
   ``bench.run`` on 1kg11 at its full size (2,504 samples x 100,000 sites),
   without the HRC-scale block, the card tests or the scaling: every
   query's md5 must equal its pin (``bgt_tpu``'s, ``tools/bench_pins.json``)
   and the port's host tier, the import's files their pins, and the
   subset's device step and the eight groups must launch kernel A; its
   times, tiers, launches and kernel A on the 1kg11 tile are printed with
   its JSON; (b) the soak (``tools/soak.py``) for 120 s on cuda:0 against
   the host tier, no divergence; (c) ``bench_scaling`` over the visible
   cards (on one, its one-card steps; the rest recorded as not run), every
   count exact against the host popcount; (d) ``bench_multiprocess`` with
   2 gloo ranks on cuda:0.  With ``--cards N`` only (c) over the N cards
   and (d) N NCCL ranks;
15. the bench's HRC-scale block (``bench.bench_hrc_full``) on hrc_full's
   configuration, its full width (32,488 samples) and its generator
   (``testing.synth_gt_bcf_sparse_to_file``), its depth cut to 32,768
   sites (16 of its 489 chunks): the cohort made, imported and tiled, the
   region, and the subset (every 8th sample over the region) under
   ``auto``, memoized, on the card with the planes resident (first with
   their transfer, then again) and streamed with the device budget below
   the tile; every md5 must equal the port's host tier, the resident steps
   must launch kernel A on resident planes and the streamed one on the
   ``stream`` tier.

The line before the last is a JSON object with each kernel's launches on its
path (kernel A's: phases 5-6, 11, 13, 14 and 15; D's: phase 12), its largest
difference from the plain version, its times and its bound (with
``--cards``: A's on phase 13's tile, and no numbers for B, C and D); the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import io
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SEED = 20261016
# kernel: (source, the TPU kernel it replaces)
KERNELS = {
    "count_codes": ("bgt_tpu_torch/csrc/count_codes.cu",
                    "bgt_tpu/ops/counts.py:111"),  # _count3_kernel
    "count_raw": ("bgt_tpu_torch/csrc/count_raw.cu",
                  "tools/probe_roofline.py:190"),  # _kern
    "count_codes_narrow": ("bgt_tpu_torch/csrc/count_narrow.cu",
                           "docs/experiments/pallas_count.py:29"),  # _count_kernel
    # decode_block: an XLA lax.scan, not a Pallas kernel
    "pbwt_decode": ("bgt_tpu_torch/csrc/pbwt_decode.cu",
                    "bgt_tpu/ops/decode.py:64"),
}
HBM_PEAK_GBS = 3350.0  # H100 SXM data sheet, at a 700 W power limit


def log(msg: str) -> None:
    print(msg, flush=True)


def random_words(torch, shape, gen, device):
    """int32 words with every bit pattern, plus all-ones and sign-bit-only
    words in the first row, made on ``device`` from ``gen``."""
    t = torch.randint(-2**31, 2**31 - 1, shape, dtype=torch.int32,
                      device=device, generator=gen)
    if shape[0]:
        t[0, 0::3] = -1           # 0xFFFFFFFF
        t[0, 1::3] = -2**31       # 0x80000000
    return t


def check_kernel(torch, counts, device) -> int:
    """Phase 3: kernel == plain version; returns the largest |difference|."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    worst = 0
    shapes = [(2048, 1024, 1), (1003, 1024, 33), (517, 2048, 8),
              (1, 2031, 1), (7, 157, 3), (100_000, 2031, 33), (0, 2031, 2),
              (64, 157, 600), (3, 2031, 1000),
              (15, 7, 9), (17, 2031, 16), (100_003, 2048, 32), (16, 8, 8),
              (1001, 2048, 2), (33, 7, 2),  # the carry-save path's
              (30000, 2048, 1), (30000, 2048, 32)]  # the probe's
    for rows, words, g in shapes:
        p0 = random_words(torch, (rows, words), gen, device)
        p1 = random_words(torch, (rows, words), gen, device)
        masks = random_words(torch, (g, words), gen, device)
        got = counts.count_codes(p0, p1, masks)
        want = counts.count_codes_reference(p0, p1, masks)
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        ok = got.shape == (rows, g, 4) and torch.equal(got, want)
        log(f"[kernel] rows={rows} words={words} groups={g} "
            f"max_abs_err={err} {'OK' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"kernel != plain at {(rows, words, g)}")
        worst = max(worst, err)
    start, length = 1001, 2047
    for words, g in ((157, 5), (2048, 2), (2031, 1)):
        p0 = random_words(torch, (4099, words), gen, device)
        p1 = random_words(torch, (4099, words), gen, device)
        masks = random_words(torch, (g, words), gen, device)
        got = counts.count_codes_range(p0, p1, masks, start, length)
        want = counts.count_codes_reference(p0[start:start + length],
                                            p1[start:start + length], masks)
        torch.cuda.synchronize()
        err = int((got - want).abs().max())
        log(f"[kernel] count_codes_range start={start} length={length} "
            f"words={words} groups={g} max_abs_err={err}")
        if not torch.equal(got, want):
            raise AssertionError("count_codes_range != plain")
        worst = max(worst, err)
    return worst


def build_baseline(src: Path, defines=()) -> tuple[str, ctypes.CDLL]:
    """``src``, another revision of kernel A, C or D, built with the kernel
    library's nvcc flags (and ``-D`` each of ``defines``) into its build
    directory and loaded.  Returns the kernel it exports ("count_codes" for
    ``bgt_count_codes``, "count_codes_narrow" for ``bgt_count_codes_narrow``,
    both with the C signature of their sources in ``csrc/``, "pbwt_decode"
    for ``bgt_pbwt_decode``; see run_decode) and the library."""
    from bgt_tpu_torch.ops import _kernels
    flags = [*_kernels.NVCC_FLAGS, *(f"-D{d}" for d in defines)]
    h = hashlib.sha256(" ".join(flags).encode() + src.read_bytes())
    so = _kernels.BUILD_DIR / f"libbaseline-{h.hexdigest()[:16]}.so"
    if not so.exists():
        _kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        res = subprocess.run([_kernels._nvcc(), *flags, "-shared",
                              "-o", str(so), str(src)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    lib = ctypes.CDLL(str(so))
    vp = ctypes.c_void_p
    if hasattr(lib, "bgt_count_codes"):
        lib.bgt_count_codes.argtypes = [vp, vp, vp, vp, vp, ctypes.c_longlong,
                                        ctypes.c_int, ctypes.c_int,
                                        ctypes.c_int, vp]
        lib.bgt_count_codes.restype = ctypes.c_int
        return "count_codes", lib
    if hasattr(lib, "bgt_count_codes_narrow"):
        lib.bgt_count_codes_narrow.argtypes = [
            vp, vp, vp, vp, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, vp]
        lib.bgt_count_codes_narrow.restype = ctypes.c_int
        return "count_codes_narrow", lib
    if hasattr(lib, "bgt_pbwt_decode"):
        # with a plan entry: this revision's signature; without: the S
        # form's, which took an (scans, 2, m) int32 S scratch buffer and ran
        # one block a scan
        plan = hasattr(lib, "bgt_pbwt_decode_plan")
        lib.bgt_pbwt_decode.argtypes = (
            [vp] * 8 + [ctypes.c_int] * 3 + [vp] if plan
            else [vp] * 9 + [ctypes.c_int] * 2 + [vp])
        lib.bgt_pbwt_decode.restype = ctypes.c_int
        if plan:
            lib.bgt_pbwt_decode_plan.argtypes = [ctypes.c_int] * 4 + [
                ctypes.POINTER(ctypes.c_int)]
            lib.bgt_pbwt_decode_plan.restype = ctypes.c_int
        return "pbwt_decode", lib
    raise RuntimeError(f"{src} exports none of bgt_count_codes, "
                       "bgt_count_codes_narrow, bgt_pbwt_decode")


def run_decode(torch, lib, batch, blocks_per_scan: int = 0):
    """Launch ``lib``'s kernel D (see build_baseline) on a CsrBatch on the
    current stream; returns its ((rows, m) uint8, (scans, m) int32)."""
    m, n, dev = batch.m, batch.S0s.shape[0], batch.S0s.device
    row0 = np.zeros(n + 1, np.int64)
    np.cumsum(batch.rows_per_scan, out=row0[1:])
    out = torch.empty((int(row0[-1]), m), dtype=torch.uint8, device=dev)
    S_final = torch.empty((n, m), dtype=torch.int32, device=dev)
    row0_d = torch.from_numpy(row0).to(dev)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = [batch.S0s.data_ptr(), batch.rle.data_ptr(), None, None,
            batch.run_off.data_ptr(), row0_d.data_ptr(), out.data_ptr()]
    if hasattr(lib, "bgt_pbwt_decode_plan"):
        err = lib.bgt_pbwt_decode(*ptrs, S_final.data_ptr(), n, m,
                                  blocks_per_scan, stream)
    else:
        S_buf = torch.empty((n, 2, m), dtype=torch.int32, device=dev)
        err = lib.bgt_pbwt_decode(*ptrs, S_buf.data_ptr(), S_final.data_ptr(),
                                  n, m, stream)
    if err != 0:
        raise RuntimeError(f"baseline decode failed: CUDA error {err}")
    return out, S_final


def decode_plan_of(lib, m: int, scans: int, blocks_per_scan: int = 0):
    """``lib``'s plan of a launch from RLE bytes (see decode.plan), or None
    for a revision without one."""
    from bgt_tpu_torch.ops import decode
    if not hasattr(lib, "bgt_pbwt_decode_plan"):
        return None
    out = (ctypes.c_int * len(decode.DecodePlan._fields))()
    err = lib.bgt_pbwt_decode_plan(scans, m, blocks_per_scan, 1, out)
    if err != 0:
        raise RuntimeError(f"baseline decode plan failed: CUDA error {err}")
    return decode.DecodePlan(*out)


def run_baseline(torch, kind, lib, p0, p1, masks):
    """Launch ``lib``'s kernel of ``kind`` (see build_baseline) on the
    current stream; returns its (rows, groups, 4) counts."""
    rows, words = p0.shape
    g = masks.shape[0]
    out = torch.empty((rows, g, 4), dtype=torch.int32, device=p0.device)
    stream = torch.cuda.current_stream().cuda_stream
    if kind == "count_codes":
        pop = torch.empty(g, dtype=torch.int32, device=p0.device)
        err = lib.bgt_count_codes(p0.data_ptr(), p1.data_ptr(),
                                  masks.data_ptr(), pop.data_ptr(),
                                  out.data_ptr(), 0, rows, words, g, stream)
    else:
        err = lib.bgt_count_codes_narrow(p0.data_ptr(), p1.data_ptr(),
                                         masks.data_ptr(), out.data_ptr(), 0,
                                         rows, words, g, stream)
    if err != 0:
        raise RuntimeError(f"baseline launch failed: CUDA error {err}")
    return out


def in_turns(fns: dict, order: list, device, reps: int) -> dict:
    """Each of ``fns`` timed twice (``measure.time_ms``, median of
    ``reps``), in turns: ``order``, then ``order`` reversed.  Returns
    name -> [ms, ms]."""
    from bgt_tpu_torch.tools.measure import time_ms
    ms = {name: [] for name in order}
    for name in order + order[::-1]:
        ms[name].append(time_ms(fns[name], device, reps))
    return ms


def turns_text(ms: dict) -> str:
    return " | turns: " + "; ".join(
        f"{name} " + ", ".join(f"{t:.4f}" for t in ts)
        for name, ts in ms.items()) + " ms"


# phase 4's shapes: (label, rows, words, groups, groups timed against plain)
TIMED = [("tile", 1_000_000, 2031, (1, 2, 8, 16, 32, 33), (1, 33)),
         ("cohort", 100_000, 2048, (1, 2, 8), ())]


def time_kernel(torch, counts, device, bases=None) -> dict:
    """Phase 4: kernel A's device ms at a full HRC-width tile (1-33 groups)
    and at the cohort's width (1, 2, 8 groups), each beside its bytes bound
    and share; the plain version at 1 and 33 groups on the tile.  A is
    timed in two turns.  Each of ``bases`` (name -> library of another
    revision of kernel A, from build_baseline) is held equal to A and timed
    beside it in those turns: the baselines, A, A, the baselines in
    reverse."""
    from bgt_tpu_torch.tools.measure import (count_bound_ms,
                                             cuda_core_logic_ms, sm_clock_mhz,
                                             time_ms)
    bases = bases or {}
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    res = {}
    worst = 0
    for label, rows, words, groups, plain_at in TIMED:
        p0 = random_words(torch, (rows, words), gen, device)
        p1 = random_words(torch, (rows, words), gen, device)
        masks = random_words(torch, (max(groups), words), gen, device)
        nbytes = 2 * rows * words * 4
        reps = 5 if rows >= 1_000_000 else 20
        log(f"[timing] {label} {rows} x {words} words, {nbytes / 1e9:.2f} GB "
            "of planes on the card")
        for g in groups:
            m = masks[:g].contiguous()
            fns = {name: (lambda lib=lib: run_baseline(torch, "count_codes",
                                                       lib, p0, p1, m))
                   for name, lib in bases.items()}
            fns["kernel"] = lambda: counts.count_codes(p0, p1, m)
            plain = g in plain_at
            if plain or bases:
                got = fns["kernel"]()
                if plain:
                    want = counts.count_codes_reference(p0, p1, m)
                    torch.cuda.synchronize()
                    worst = max(worst, int((got - want).abs().max()))
                    if not torch.equal(got, want):
                        raise AssertionError(f"kernel != plain at {label}, g={g}")
                    del want
                for name in bases:
                    if not torch.equal(got, fns[name]()):
                        raise AssertionError(f"kernel != {name} at {label}, g={g}")
                del got
            # two turns of each; the first timing at a new shape can run
            # slow (0.616 against 0.525 ms at the cohort's 1 group, H100
            # 80GB HBM3), so the lower of A's two medians is its time
            ms = in_turns(fns, [*bases, "kernel"], device, reps)
            k_ms = min(ms["kernel"])
            turns = turns_text(ms)
            mhz = sm_clock_mhz(device)
            bound = count_bound_ms(rows, words, g, 4)
            p_ms = (time_ms(lambda: counts.count_codes_reference(p0, p1, m),
                            device, 3) if plain else None)
            gbs = nbytes / (k_ms * 1e-3) / 1e9
            log(f"[timing] {label} groups={g} kernel {k_ms:.3f} ms "
                f"({gbs:.1f} GB/s) | bound {bound:.3f} ms by bytes, share "
                f"{bound / k_ms:.3f} | CUDA-core logic "
                f"{cuda_core_logic_ms(rows, words, g, mhz):.3f} ms at "
                f"{mhz:.0f} MHz" + (f" | plain {p_ms:.3f} ms" if plain else "")
                + turns)
            res[label, g] = (k_ms, p_ms, bound, "bytes")
        del p0, p1, masks
        torch.cuda.empty_cache()
    return {"by_shape": res, "max_abs_err": worst}


def make_cohort(work: Path, n_samples: int, n_sites: int) -> str:
    """An HRC-shaped cohort imported as a BGT database; returns its prefix.
    The .spl carries a population key whose names match the cohort's."""
    import numpy as np

    from bgt_tpu_torch import cli, testing
    from bgt_tpu_torch.ops.tiles import TileStore

    prefix = str(work / "db")
    stamp = work / f"done-{n_samples}x{n_sites}-{SEED}"
    if stamp.exists():
        log(f"[cohort] reusing {prefix}")
        return prefix
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    testing.synth_gt_bcf_to_file(str(work / "in.bcf"), n_samples, n_sites,
                                 seed=SEED)
    t1 = time.perf_counter()
    if cli.main(["import", prefix, str(work / "in.bcf")]) != 0:
        raise RuntimeError("bgt import failed")
    t2 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    pops = ("CEU", "YRI", "CHB", "TSI")
    with open(prefix + ".spl", "w") as fp:
        for i in range(n_samples):
            fp.write(f"S{i:05d}\tpopulation:Z:{pops[int(rng.integers(4))]}\n")
    ts = TileStore.open_or_build(prefix)
    t3 = time.perf_counter()
    log(f"[cohort] {n_samples} samples x {n_sites} sites: synth "
        f"{t1 - t0:.1f} s, import {t2 - t1:.1f} s, tile {t3 - t2:.1f} s "
        f"({ts.plane0.shape[1]} words/row, "
        f"{2 * ts.plane0.nbytes / 1e9:.2f} GB of planes)")
    os.remove(work / "in.bcf")
    stamp.touch()
    return prefix


def capture(fn) -> tuple[str, float, int, str]:
    """(md5 of what ``fn`` writes to stdout, wall seconds, records, what it
    writes to stderr)."""
    buf, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(err):
        rc = fn()
    dt = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"query exited {rc}: {err.getvalue()[-2000:]}")
    text = buf.getvalue()
    if not text:
        raise AssertionError("query wrote nothing")
    records = sum(1 for line in text.splitlines() if not line.startswith("#"))
    return hashlib.md5(text.encode()).hexdigest(), dt, records, err.getvalue()


def stages(stderr: str) -> str:
    """The ``[T::stage] x ms`` lines of a query run at verbosity 4."""
    out = []
    for line in stderr.splitlines():
        if line.startswith("[T::"):
            name, ms = line[4:].split("] ", 1)
            out.append(f"{name} {ms}")
    return ", ".join(out)


def set_env(**kv) -> None:
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


def host_tier(fn):
    """``fn`` run on the port's host tier, as ``capture`` gives it."""
    from bgt_tpu_torch.query import fastpath
    set_env(BGT_TPU_COUNT_TIER="host", BGT_TPU_HBM_BUDGET=None)
    fastpath._COUNT_MEMO.clear()
    try:
        return capture(fn)
    finally:
        fastpath._COUNT_MEMO.clear()


def main_path(torch, device, prefix: str, queries: dict) -> tuple[int, dict]:
    """Phases 5 and 6; returns the kernel launches they made and each
    query's host-tier md5."""
    from bgt_tpu_torch import cli
    from bgt_tpu_torch import log as port_log
    from bgt_tpu_torch.ops import counts
    from bgt_tpu_torch.ops.tiles import TileStore
    from bgt_tpu_torch.query import engine, fastpath

    ref = {}
    for name, args in queries.items():
        ref[name] = host_tier(lambda: cli.main(["view", *args, prefix],
                                               device=device))
        log(f"[main] {name}: host tier {ref[name][1]:.3f} s, "
            f"{ref[name][2]} records, md5 {ref[name][0]}")

    verbosity = port_log.verbosity()
    fastpath._DEVICE_CACHE.clear()  # the first query pays the tile's H2D
    counts.LAUNCHES["count_codes"] = 0  # count only the main path from here
    for name, args in queries.items():
        for run in ("cold", "warm", "staged"):
            # the staged run logs each pipeline stage's wall time
            port_log.set_verbosity(4 if run == "staged" else verbosity)
            set_env(BGT_TPU_COUNT_TIER="device", BGT_TPU_HBM_BUDGET=None)
            fastpath._COUNT_MEMO.clear()  # the device tier, not the memo
            before = counts.LAUNCHES["count_codes"]
            md5, dt, n, err = capture(lambda: cli.main(
                ["view", *args, prefix], device=device))
            rose = counts.LAUNCHES["count_codes"] - before
            log(f"[main] {name} {run}: {dt:.3f} s, {n} records, md5 {md5}, "
                f"kernel launches +{rose}"
                + (f"; stages: {stages(err)}" if run == "staged" else ""))
            if md5 != ref[name][0]:
                raise AssertionError(f"{name}: device md5 != host-tier md5")
            if rose < 1:
                raise AssertionError(f"{name}: the count kernel did not run")
    port_log.set_verbosity(verbosity)

    # the rule of auto: host only for work below one transfer of the planes
    ts = TileStore.open_or_build(prefix)
    nbytes = 2 * ts.plane0.nbytes
    work = ts.n_rows * 1 * ts.n_words * 4 * 3  # the subset query: 1 mask
    bm = engine.BgtmReader([engine.open_bgt_cached(prefix)])
    bm.prepare()
    set_env(BGT_TPU_COUNT_TIER=None)
    fastpath._DEVICE_CACHE.clear()
    tier = fastpath.DbCtx(bm.bgt[0], None, device)._count_tier(
        np.arange(ts.n_rows), np.zeros((1, ts.n_words), np.uint32), True)
    bm.close()
    name = next(iter(queries))
    log(f"[main] {name}: host tier {ref[name][1]:.3f} s against the device "
        f"tier cold (tile H2D included) above; work {work / 1e9:.3f} GB of "
        f"masked popcount against {nbytes / 1e9:.3f} GB of planes (one "
        f"transfer): auto picks {tier}")
    if tier != "device":
        raise AssertionError("auto keeps the cohort's subset query on the host")

    # the resident tile's host-to-device transfer, timed on its own
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dt_tiles = fastpath.DeviceTiles(ts, device)
    torch.cuda.synchronize()
    h2d = time.perf_counter() - t0
    log(f"[main] tile H2D {h2d:.3f} s for {nbytes / 1e9:.2f} GB "
        f"({nbytes / h2d / 1e9:.1f} GB/s, pinned staging)")
    del dt_tiles

    # phase 6: the streamed tier
    set_env(BGT_TPU_COUNT_TIER="device", BGT_TPU_HBM_BUDGET="1")
    fastpath._COUNT_MEMO.clear()
    fastpath._DEVICE_CACHE.clear()
    before = counts.LAUNCHES["count_codes"]
    md5, dt, _n, _err = capture(lambda: cli.main(
        ["view", *queries[name], prefix], device=device))
    rose = counts.LAUNCHES["count_codes"] - before
    streamed = all(v is None for v in fastpath._DEVICE_CACHE.values())
    log(f"[stream] {name} with BGT_TPU_HBM_BUDGET=1: {dt:.3f} s, md5 {md5}, "
        f"kernel launches +{rose}, planes resident: {not streamed}")
    set_env(BGT_TPU_COUNT_TIER=None, BGT_TPU_HBM_BUDGET=None)
    fastpath._DEVICE_CACHE.clear()
    if md5 != ref[name][0] or rose < 1 or not streamed:
        raise AssertionError("streamed tier failed")
    return counts.LAUNCHES["count_codes"], {q: r[0] for q, r in ref.items()}


PROBE_VARIANTS = ("proxy_reduce2", "proxy_reduce1", "proxy_popc1",
                  "count_1mask", "count_32mask", "count_i16_1mask",
                  "count_reshape_1mask", "count_mm_1mask", "count_mm_32mask",
                  "count_stack_1mask", "count_raw_1mask")


# phase 7's exactness shapes of kernel C (rows, words, groups): the narrow
# experiment's, rows against its 16-row tile, words against its 8-word
# k-step, groups against its octets, the masks filling shared memory (the
# path without the ring), one word, no rows
NARROW_CHECKED = [(16384, 160, 2), (105730, 157, 1), (105730, 157, 8),
                  (105730, 157, 32), (7, 157, 3), (1, 1, 1), (0, 157, 2),
                  (1, 157, 8), (15, 157, 8), (16, 157, 8), (17, 157, 8),
                  (33, 157, 8), (1000, 7, 9), (1000, 8, 9), (1000, 9, 9),
                  (1000, 17, 9), (1000, 160, 9), (2000, 157, 7),
                  (2000, 157, 9), (2000, 157, 31), (2000, 157, 32),
                  (1000, 1816, 32)]
# phase 7's timed shapes of C, beside A: (rows, words, groups)
NARROW_TIMED = [(16384, 160, (2,)), (105730, 157, (1, 8, 32))]
L2_BYTES = 50 * 2**20  # H100 SXM data sheet


def planes_at(torch, rows, words, offsets, gen, device):
    """Two (rows, words) int32 planes as views into one buffer, starting
    ``offsets`` words past a 16-byte boundary, so that kernel C's tiles
    start unaligned (its head rows) or never align (its path without the
    ring)."""
    flat = torch.zeros(2 * (rows * words + 4), dtype=torch.int32,
                       device=device)
    out = []
    for i, off in enumerate(offsets):
        lo = i * (rows * words + 4) + off
        p = flat[lo: lo + rows * words].view(rows, words)
        p.copy_(random_words(torch, (rows, words), gen, device))
        out.append(p)
    return out


def check_raw_narrow(torch, counts, device, bases=None) -> dict:
    """Phase 7: kernels B and C == their plain versions, then their times
    at the shapes of their paths: C beside kernel A in turns, with each of
    ``bases`` (name -> library of another revision of kernel C, from
    build_baseline) held equal to C and timed in the same turns.  Returns
    each one's largest |difference| and (kernel ms, plain ms, bound ms,
    bound by)."""
    from bgt_tpu_torch.tools.measure import (count_bound_ms,
                                             cuda_core_logic_ms, sm_clock_mhz,
                                             time_ms)
    bases = bases or {}
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 2)
    worst = {"count_raw": 0, "count_codes_narrow": 0}

    def same(name, got, want, what):
        torch.cuda.synchronize()
        err = int((got - want).abs().max()) if got.numel() else 0
        ok = got.shape == want.shape and torch.equal(got, want)
        log(f"[kernel] {name} {what} max_abs_err={err} "
            f"{'OK' if ok else 'MISMATCH'}")
        if not ok:
            raise AssertionError(f"{name} != plain at {what}")
        worst[name] = max(worst[name], err)

    def words3(rows, words, g):
        return (random_words(torch, (rows, words), gen, device),
                random_words(torch, (rows, words), gen, device),
                random_words(torch, (g, words), gen, device))

    for rows, words in ((30000, 2048), (256, 2048), (517, 157), (1, 1),
                        (0, 2048)):
        p0, p1, m = words3(rows, words, 1)
        same("count_raw", counts.count_raw(p0, p1, m),
             counts.count_raw_reference(p0, p1, m),
             f"rows={rows} words={words}")
    p0, p1, m = words3(4099, 157, 1)
    start, length = 1001, 2047
    same("count_raw", counts.count_raw_range(p0, p1, m, start, length),
         counts.count_raw_reference(p0[start:start + length],
                                    p1[start:start + length], m),
         f"count_raw_range start={start} length={length}")
    for rows, words, g in NARROW_CHECKED:
        p0, p1, m = words3(rows, words, g)
        same("count_codes_narrow", counts.count_codes_narrow(p0, p1, m),
             counts.count_codes_reference(p0, p1, m),
             f"rows={rows} words={words} groups={g}")
    for offsets in ((1, 1), (0, 2)):  # head rows; no aligned tile start
        p0, p1 = planes_at(torch, 1000, 157, offsets, gen, device)
        m = random_words(torch, (32, 157), gen, device)
        same("count_codes_narrow", counts.count_codes_narrow(p0, p1, m),
             counts.count_codes_reference(p0, p1, m),
             f"rows=1000 words=157 groups=32, planes {offsets} words past "
             "16 bytes")
    for g, words in ((33, 157), (32, 2048)):
        p = torch.zeros((4, words), dtype=torch.int32, device=device)
        try:
            counts.count_codes_narrow(
                p, p, torch.zeros((g, words), dtype=torch.int32, device=device))
        except ValueError as e:
            log(f"[kernel] count_codes_narrow refuses {g} x {words}: {e}")
        else:
            raise AssertionError(f"count_codes_narrow took {g} x {words}")

    rows, words = 30000, 2048
    p0, p1, m = words3(rows, words, 1)
    k_ms = time_ms(lambda: counts.count_raw(p0, p1, m), device, 20)
    p_ms = time_ms(lambda: counts.count_raw_reference(p0, p1, m), device, 5)
    b_ms = count_bound_ms(rows, words, 1, 3)
    times = {"count_raw": (k_ms, p_ms, b_ms, "bytes")}
    log(f"[timing] count_raw at 30000 x 2048 words, 1 mask: kernel "
        f"{k_ms:.4f} ms, plain {p_ms:.4f} ms, bound {b_ms:.4f} ms by bytes, "
        f"share {b_ms / k_ms:.3f} | CUDA-core logic "
        f"{cuda_core_logic_ms(rows, words, 1, sm_clock_mhz(device)):.4f} ms")
    del p0, p1, m

    # C beside A (and the baselines) in turns: the baselines, C, A, then A,
    # C, the baselines; each one's time is the lower of its two
    for rows, words, groups in NARROW_TIMED:
        q0, q1, qm = words3(rows, words, max(groups))
        nbytes = 2 * rows * words * 4
        for g in groups:
            m = qm[:g].contiguous()
            fns = {name: (lambda lib=lib: run_baseline(
                torch, "count_codes_narrow", lib, q0, q1, m))
                for name, lib in bases.items()}
            fns["C"] = lambda: counts.count_codes_narrow(q0, q1, m)
            fns["A"] = lambda: counts.count_codes(q0, q1, m)
            got = fns["C"]()
            for name in ("A", *bases):
                if not torch.equal(got, fns[name]()):
                    raise AssertionError(f"count_codes_narrow != {name} at "
                                         f"{(rows, words, g)}")
            del got
            ms = in_turns(fns, [*bases, "C", "A"], device, 20)
            c_ms, a_ms = min(ms["C"]), min(ms["A"])
            b_ms = count_bound_ms(rows, words, g, 4)
            if nbytes < L2_BYTES:
                share = (f"no share: the planes ({nbytes / 1e6:.0f} MB) stay "
                         f"in the {L2_BYTES / 2**20:.0f} MB L2 across "
                         "repetitions")
            else:
                share = (f"share {b_ms / c_ms:.3f}, A's {b_ms / a_ms:.3f}")
            p_ms = None
            if (rows, g) == (105730, 32):
                p_ms = time_ms(lambda: counts.count_codes_reference(q0, q1, m),
                               device, 5)
                times["count_codes_narrow"] = (c_ms, p_ms, b_ms, "bytes")
            log(f"[timing] count_codes_narrow at {rows} x {words} words, {g} "
                f"groups: C {c_ms:.4f} ms, A {a_ms:.4f} ms"
                + (f", plain {p_ms:.4f} ms" if p_ms is not None else "")
                + f" | bound {b_ms:.4f} ms by bytes, {share}" + turns_text(ms))
        del q0, q1, qm
    return {"max_abs_err": worst, "times": times}


def kernel_paths(torch, counts, device) -> dict:
    """Phase 8: the roofline probe (kernel B's path) and the narrow-width
    experiment (kernel C's path); returns each kernel's launches there."""
    from bgt_tpu_torch.experiments import narrow_count
    from bgt_tpu_torch.tools import probe_roofline

    counts.LAUNCHES["count_raw"] = 0
    res = probe_roofline.run(30000, 5, device)
    raw = counts.LAUNCHES["count_raw"]
    print(json.dumps(res), flush=True)
    for name in PROBE_VARIANTS:
        v = res.get(name)
        if not isinstance(v, dict) or "error" in v or not {"s", "gbs"} <= set(v):
            raise AssertionError(f"probe variant {name}: {v}")
    counts.LAUNCHES["count_codes_narrow"] = 0
    narrow_count.run(device)
    narrow = counts.LAUNCHES["count_codes_narrow"]
    log(f"[paths] launches: count_raw {raw} in the probe, count_codes_narrow "
        f"{narrow} in the narrow-width experiment")
    for name, n in (("count_raw", raw), ("count_codes_narrow", narrow)):
        if n < 1:
            raise AssertionError(f"{name} did not run on its path")
    return {"count_raw": raw, "count_codes_narrow": narrow}


def _q(*pairs) -> str:
    from urllib.parse import urlencode
    return "?" + urlencode(pairs) if pairs else ""


# name: (query string, whether kernel A runs for it); the server's -G
# default and its genotype quota (10^7) apply
SERVER_QUERIES = {
    "help": (_q(), False),
    "subset": (_q(("s", 'population=="CEU"')), True),
    "two-group f=AC1>AC2": (_q(("s", 'population=="CEU"'),
                               ("s", 'population=="YRI"'),
                               ("f", "AC1>AC2")), True),
    "two-group f=AC1/AN1>=0.1.and.AC2==0": (
        _q(("s", 'population=="CEU"'), ("s", 'population=="YRI"'),
           ("f", "AC1/AN1>=0.1.and.AC2==0")), True),
    "table t= r= subset": (_q(("t", "CHROM,POS,AC,AN"),
                              ("r", "11:1000000-5000000"),
                              ("s", 'population=="YRI"')), True),
    "C= all samples (rowstats)": (_q(("C", "")), False),
    "g= GT dump r= subset": (_q(("g", ""), ("r", "11:1000000-1300000"),
                                ("s", ",S00003,S00010,S00777,S32487")), True),
    "400 bad region": (_q(("r", "nonexistent:1-2")), False),
}
# eight distinct one-group masks for the concurrent requests
CONCURRENT_QUERIES = [_q(("s", f'population{op}"{pop}"'))
                      for op in ("==", "!=")
                      for pop in ("CEU", "YRI", "CHB", "TSI")]


def fetch(port: int, query: str) -> tuple[int, bytes, float]:
    """(status, body, wall seconds) of one GET."""
    import urllib.error
    import urllib.request
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/{query}",
                                    timeout=300) as resp:
            status, body = resp.status, resp.read()
    except urllib.error.HTTPError as e:
        status, body = e.code, e.read()
    return status, body, time.perf_counter() - t0


@contextlib.contextmanager
def serving(srv):
    """Run ``srv`` in a thread; shut it down and close its socket after."""
    import threading
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        yield srv.server_address[1]
    finally:
        srv.shutdown()
        srv.server_close()
        t.join(timeout=30)


def server_path(torch, device, prefix: str) -> int:
    """Phase 9: the port's server on the host tier, then on the card under
    the default tier (``auto``), in process, the same requests to each;
    returns kernel A's launches on the server path."""
    import threading

    from bgt_tpu_torch.ops import counts
    from bgt_tpu_torch.query import fastpath
    from bgt_tpu_torch.query.engine import BgtFile
    from bgt_tpu_torch.server import server

    cfg = server.ServerConfig()
    cfg.port = 0
    cfg.files = [BgtFile(prefix)]
    cfg.prefixes = [os.path.basename(prefix)]
    ref = {}
    set_env(BGT_TPU_COUNT_TIER="host")
    with serving(server.make_server(cfg, device)) as port:
        for name, (query, _k) in SERVER_QUERIES.items():
            fastpath._COUNT_MEMO.clear()
            ref[query] = fetch(port, query)
            status, body, dt = ref[query]
            log(f"[server] {name}: host tier {status}, {dt:.3f} s, "
                f"{len(body)} bytes, md5 {hashlib.md5(body).hexdigest()}")
        for query in CONCURRENT_QUERIES:
            fastpath._COUNT_MEMO.clear()
            ref[query] = fetch(port, query)
    if ref[SERVER_QUERIES["400 bad region"][0]][0] != 400:
        raise AssertionError("the host-tier server did not answer 400")
    if any(ref[q][0] != 200 for q in CONCURRENT_QUERIES):
        raise AssertionError("a host-tier reference request failed")

    set_env(BGT_TPU_COUNT_TIER=None)  # auto: nothing forced
    fastpath._DEVICE_CACHE.clear()  # the first request pays the tile's H2D
    counts.LAUNCHES["count_codes"] = 0  # count only the server path
    with serving(server.make_server(cfg, device)) as port:
        for run in ("cold", "warm"):
            for name, (query, kernel) in SERVER_QUERIES.items():
                fastpath._COUNT_MEMO.clear()  # the kernel, not the memo
                before = counts.LAUNCHES["count_codes"]
                status, body, dt = fetch(port, query)
                rose = counts.LAUNCHES["count_codes"] - before
                md5 = hashlib.md5(body).hexdigest()
                log(f"[server] {name} {run}: {status}, {dt:.3f} s, "
                    f"{len(body)} bytes, md5 {md5}, kernel launches +{rose}")
                if (status, body) != ref[query][:2]:
                    raise AssertionError(f"server {name}: card != host tier")
                if kernel and rose < 1:
                    raise AssertionError(f"server {name}: kernel A did not run")
        launches = counts.LAUNCHES["count_codes"]

        # concurrent first requests: one transfer of the planes
        built = []

        class CountedTiles(fastpath.DeviceTiles):
            def __init__(self, ts, dev):
                built.append(1)
                super().__init__(ts, dev)

        real_tiles = fastpath.DeviceTiles
        fastpath.DeviceTiles = CountedTiles
        fastpath._DEVICE_CACHE.clear()
        fastpath._COUNT_MEMO.clear()
        before = counts.LAUNCHES["count_codes"]
        got = {}
        go = threading.Barrier(len(CONCURRENT_QUERIES))

        def worker(query):
            go.wait(timeout=60)
            got[query] = fetch(port, query)

        try:
            threads = [threading.Thread(target=worker, args=(q,))
                       for q in CONCURRENT_QUERIES]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            wall = time.perf_counter() - t0
        finally:
            fastpath.DeviceTiles = real_tiles
        rose = counts.LAUNCHES["count_codes"] - before
        each = ", ".join(f"{got[q][2]:.3f}" for q in CONCURRENT_QUERIES
                         if q in got)
        log(f"[server] {len(threads)} concurrent first requests: wall "
            f"{wall:.3f} s (each {each} s), tile transfers {len(built)}, "
            f"kernel launches +{rose}")
        if any(t.is_alive() for t in threads):
            raise AssertionError("a concurrent request did not finish")
        for q in CONCURRENT_QUERIES:
            if got[q][:2] != ref[q][:2]:
                raise AssertionError(f"concurrent {q}: card != host tier")
        if len(built) != 1 or rose < len(CONCURRENT_QUERIES):
            raise AssertionError("concurrent requests: expected one tile "
                                 f"transfer, got {len(built)}; launches +{rose}")
    set_env(BGT_TPU_COUNT_TIER=None)
    return launches


def api_entry_decode(torch, device, prefix: str, gen) -> dict:
    """Phase 10: the Python API and the entry step against their plain
    references, and the decode ops against a numpy unpack; returns kernel
    A's launches on the API and entry paths."""
    import bgt_tpu_torch
    from bgt_tpu_torch import entry
    from bgt_tpu_torch.ops import counts
    from bgt_tpu_torch.query import fastpath

    kw = dict(region="11:1000000-1300000", site_filter="AC1>AC2",
              samples=['population=="CEU"', 'population=="YRI"'])
    set_env(BGT_TPU_COUNT_TIER="host")
    fastpath._COUNT_MEMO.clear()
    t0 = time.perf_counter()
    want = bgt_tpu_torch.open(prefix, device).query(**kw)
    want_gt = want.genotypes()
    t_host = time.perf_counter() - t0
    set_env(BGT_TPU_COUNT_TIER=None)  # auto: the planes are resident
    fastpath._COUNT_MEMO.clear()
    counts.LAUNCHES["count_codes"] = 0  # count only the API path
    t0 = time.perf_counter()
    got = bgt_tpu_torch.open(prefix, device).query(**kw)
    got_gt = got.genotypes()
    t_port = time.perf_counter() - t0
    api_launches = counts.LAUNCHES["count_codes"]
    set_env(BGT_TPU_COUNT_TIER=None)
    fields = ("chrom", "pos", "rlen", "ref", "alt", "has_m", "an", "ac",
              "ac_m", "group_an", "group_ac", "samples")
    for name in fields:
        a, b = getattr(got, name), getattr(want, name)
        same = (np.array_equal(a, b) and a.dtype == b.dtype
                if isinstance(b, np.ndarray) else a == b)
        if not same:
            raise AssertionError(f"api: {name} differs from the host tier's")
    if not np.array_equal(got_gt, want_gt) or want.n_sites == 0:
        raise AssertionError("api: genotypes differ, or no site")
    log(f"[api] query {kw}: {got.n_sites} sites, genotypes "
        f"{got_gt.shape}, equal in every array; card under auto "
        f"{t_port:.3f} s, host tier {t_host:.3f} s, kernel launches "
        f"{api_launches}")
    if api_launches < 1:
        raise AssertionError("api: kernel A did not run")

    counts.LAUNCHES["count_codes"] = 0  # count only the entry step
    fwd, args = entry.entry(device)
    got_counts, got_keep = fwd(*args)
    torch.cuda.synchronize()
    entry_launches = counts.LAUNCHES["count_codes"]
    want_counts, want_keep = fwd(*(a.cpu() for a in args))  # plain version
    ok = (torch.equal(got_counts.cpu(), want_counts)
          and torch.equal(got_keep.cpu(), want_keep))
    log(f"[entry] counts {tuple(got_counts.shape)}, keep "
        f"{int(got_keep.sum())} of {got_keep.numel()}, equal to the CPU "
        f"plain version: {ok}, kernel launches {entry_launches}")
    if not ok or entry_launches < 1:
        raise AssertionError("entry: card != plain, or kernel A did not run")

    def unpack(a, b):
        a = a.cpu().numpy().view(np.uint32)
        b = b.cpu().numpy().view(np.uint32)
        b0 = np.unpackbits(a.view(np.uint8), axis=1, bitorder="little")
        b1 = np.unpackbits(b.view(np.uint8), axis=1, bitorder="little")
        return (b1 << 1) | b0

    for rows, words, start, length in ((512, 2031, 0, 512),
                                       (1000, 157, 333, 500),
                                       (77, 61, 32, 40)):
        p0 = random_words(torch, (rows, words), gen, device)
        p1 = random_words(torch, (rows, words), gen, device)
        want_codes = unpack(p0, p1)
        codes = counts.decode_codes(p0, p1)
        cols = torch.randint(0, words * 32, (2 * 300,), device=device,
                             generator=gen)
        cols[0] = words * 32 - 1
        sub = want_codes[start:start + length][:, cols.cpu().numpy()]
        gathered = counts.gather_codes_range(p0, p1, cols, start, length,
                                             cols.numel())
        pairs = counts.gt_pair_idx_range(p0, p1, cols, start, length)
        ok = (np.array_equal(codes.cpu().numpy(), want_codes)
              and np.array_equal(gathered.cpu().numpy(), sub)
              and np.array_equal(pairs.cpu().numpy(),
                                 (sub[:, 0::2] << 2) | sub[:, 1::2]))
        log(f"[decode] rows={rows} words={words} range=[{start}, "
            f"{start + length}) cols={cols.numel()}: decode_codes, "
            f"gather_codes_range, gt_pair_idx_range equal to numpy: {ok}")
        if not ok:
            raise AssertionError("decode ops != numpy unpack")
    return {"api": api_launches, "entry": entry_launches}


QUERIES = {
    "subset -G -C": ["-G", "-C", "-s", 'population=="CEU"'],
    "two-group -f": ["-G", "-s", 'population=="CEU"',
                     "-s", 'population=="YRI"',
                     "-f", "AC1/AN1>=0.1&&AC2==0"],
    # the groups of this synthetic cohort share allele frequencies, so the
    # filter above passes no site; this one passes some (12,855 of 100,000)
    "two-group -f AC1>AC2": ["-G", "-C", "-s", 'population=="CEU"',
                             "-s", 'population=="YRI"', "-f", "AC1>AC2"],
    "table -r subset": ["-t", "CHROM,POS,AC,AN", "-r", "11:1000000-5000000",
                        "-s", 'population=="YRI"'],
    # kernel A at 8 groups on the main path: each population and its rest
    "eight-group -G -C": ["-G", "-C", *(a for op in ("==", "!=")
                                        for pop in ("CEU", "YRI", "CHB", "TSI")
                                        for a in ("-s", f'population{op}"{pop}"'))],
}
# phase 11's GT-emitting query: four samples' genotypes over 300 kbp
MESH_GT = ["-C", "-s", ",S00003,S00010,S00777,S32487",
           "-r", "11:1000000-1300000"]
# phase 11 in one process: (name, slots, environment, queries)
MESH_CONFIGS = [
    ("1 slot", 1, {}, ("subset -G -C",)),
    ("2 slots", 2, {"BGT_TPU_MESH_DEVICES": "2"},
     ("subset -G -C", "two-group -f AC1>AC2", "eight-group -G -C", "GT")),
    ("2x2", 4, {"BGT_TPU_MESH_DEVICES": "4", "BGT_TPU_MESH2": "2x2"},
     ("subset -G -C", "GT")),
]
MESH_ENV = ("BGT_TPU_COUNT_TIER", "BGT_TPU_SHARD_MIN_ROWS",
            "BGT_TPU_MESH_DEVICES", "BGT_TPU_MESH2", "BGT_TPU_TILE_SHARD")
# what names a rank's place and cards; never inherited by a spawned rank
RANK_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")
RANK_TIMEOUT_S = 300


def view_args(name: str) -> list:
    return MESH_GT if name == "GT" else QUERIES[name]


def counted_view(device, prefix: str, name: str) -> dict:
    """One ``view`` query with the count memo cleared: its md5, wall
    seconds and kernel A's launches, in all and by card (the counts are set
    to 0 just before)."""
    from bgt_tpu_torch import cli
    from bgt_tpu_torch.ops import counts
    from bgt_tpu_torch.query import fastpath
    fastpath._COUNT_MEMO.clear()
    counts.LAUNCHES["count_codes"] = 0
    counts.CARD_LAUNCHES.clear()
    md5, dt, n, _err = capture(lambda: cli.main(
        ["view", *view_args(name), prefix], device=device))
    return {"md5": md5, "s": dt, "records": n,
            "launches": counts.LAUNCHES["count_codes"],
            "cards": card_launches()}


def card_launches() -> dict:
    """Kernel A's launches since the counts were last cleared, by card
    index."""
    from bgt_tpu_torch.ops import counts
    return {str(card): n for (kernel, card), n in
            sorted(counts.CARD_LAUNCHES.items(), key=str)
            if kernel == "count_codes"}


def slot_kernel_ms(torch, p0, p1) -> tuple[float, float]:
    """Kernel A's device ms on one slot's planes at one group, on their
    card, and its bytes bound.  These launches are not the path's."""
    from bgt_tpu_torch.ops import counts
    from bgt_tpu_torch.tools.measure import count_bound_ms, time_ms
    m = torch.full((1, p0.shape[1]), -1, dtype=torch.int32, device=p0.device)
    ms = time_ms(lambda: counts.count_codes(p0, p1, m), p0.device, 20)
    return ms, count_bound_ms(p0.shape[0], p0.shape[1], 1, 4)


def collectives_text(stats: dict) -> str:
    """``mesh.COLLECTIVES``, the operations that ran."""
    out = [f"{t} {op} {v['calls']} calls, {v['ms']:.3f} ms "
           f"({v['ms'] / v['calls']:.3f} each), {v['bytes'] / 1e6:.3f} MB"
           for t, ops in stats.items() for op, v in ops.items() if v["calls"]]
    return "; ".join(out) or "no collective"


def rank_main(args) -> int:
    """One rank of phase 11 or 13: joins its group from torchrun's
    environment and writes what it saw to ``args.out`` as JSON.  The
    ``views`` job (through the CLI) opens only its shard file
    (BGT_TPU_TILE_SHARD) and runs the subset and GT queries cold and warm;
    the ``tile`` job counts its column slice of phase 13's tile."""
    import torch
    from bgt_tpu_torch.parallel import distributed
    from bgt_tpu_torch.parallel import mesh as meshlib
    from bgt_tpu_torch.query import fastpath

    device = torch.device(args.device)
    res = {"rank": int(os.environ["RANK"]), "queries": {}}
    if args.rank_job == "tile":
        distributed.initialize(timeout_s=RANK_TIMEOUT_S, device=device)
        res["tile"] = tile_counts(torch, distributed.global_mesh(
            device=device))
    else:
        for name in ("subset -G -C", "GT"):
            for run in ("cold", "warm"):
                res["queries"][f"{name} {run}"] = counted_view(
                    device, args.prefix, name)
        ctx = fastpath.get_shard_context(device)
        stores = list(fastpath._TILE_CACHE.values())
        if ctx is None or not ctx.multi_process or not stores \
                or not all(ts.is_shard for ts in stores):
            raise AssertionError("the rank did not run on the mesh from its "
                                 "shard")
        ex = next(iter(ctx._planes.values()))
        res["rows"], res["words"] = ex.p0[0].shape
        res["slots"] = [str(d) for d in ctx.mesh.slots]
        res["mesh"] = ctx.mesh.size
        res["place_s"] = ex.place_s
        res["collectives"] = json.loads(json.dumps(meshlib.COLLECTIVES))
        res["kernel_ms"], res["bound_ms"] = slot_kernel_ms(torch, ex.p0[0],
                                                           ex.p1[0])
    res["backend"] = distributed.collective_backend()
    res["imported"] = sorted({m.split(".")[0] for m in sys.modules}
                             & {"jax", "bgt_tpu"})
    Path(args.out).write_text(json.dumps(res))
    torch.distributed.destroy_process_group()
    return 0


def spawn_ranks(work: Path, envs: list, device: str, job: str = "views",
                prefix: str = "") -> list:
    """One ``chip_smoke.py --rank`` process per entry of ``envs`` (each
    rank's own environment beside the group's), all started together;
    returns their results in rank order.  A rank that fails or outlives
    RANK_TIMEOUT_S fails the phase, with the end of its output (NCCL's
    warnings included)."""
    import socket
    work.mkdir(parents=True, exist_ok=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    base = {k: v for k, v in os.environ.items()
            if k not in MESH_ENV + RANK_ENV}
    n = len(envs)
    procs = []
    try:
        for k, env in enumerate(envs):
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--rank",
                 "--rank-job", job, "--prefix", prefix,
                 "--out", str(work / f"rank{k}.json"), "--device", device],
                env={**base, "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": port,
                     "RANK": str(k), "WORLD_SIZE": str(n),
                     "NCCL_DEBUG": "WARN", **env},
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for k, p in enumerate(procs):
            out, _ = p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
            if p.returncode != 0:
                raise RuntimeError(f"rank {k} exited {p.returncode}:\n"
                                   f"{out[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [json.loads((work / f"rank{k}.json").read_text())
            for k in range(n)]


def shard_ranks(prefix: str, work: Path, envs: list, slots: int,
                device: str) -> list:
    """The shard files of a mesh of len(envs) processes and ``slots``
    slots in all (``gtcshard``), then one ``views`` rank per process, each
    opening only its shard file; the files are removed after."""
    from bgt_tpu_torch import cli
    n = len(envs)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        if cli.main(["gtcshard", prefix, str(n), str(slots)]) != 0:
            raise RuntimeError("gtcshard failed")
    log(f"[mesh] gtcshard {prefix} {n} {slots}: "
        f"{time.perf_counter() - t0:.1f} s")
    try:
        return spawn_ranks(work, [{**env, "BGT_TPU_TILE_SHARD": f"{k}:{n}"}
                                  for k, env in enumerate(envs)],
                           device, prefix=prefix)
    finally:
        for k in range(n):
            Path(f"{prefix}.gtc.shard-{k}-of-{n}").unlink(missing_ok=True)


def check_ranks(label: str, ranks: list, ref: dict, per_rank: int,
                backend: str, card: str) -> int:
    """Each rank's queries against the host tier's md5, kernel A's
    launches (``per_rank`` a counted query, one on each of its cards), its
    transport, and no gloo collective where it is NCCL; logs each query and
    a summary line a rank.  Returns the ranks' launches."""
    launches = 0
    for res in ranks:
        r = res["rank"]
        for key, got in res["queries"].items():
            name = key.rsplit(" ", 1)[0]
            log(f"[mesh] {label}: rank {r} {key}: {got['s']:.3f} s, "
                f"{got['records']} records, md5 {got['md5']}, kernel "
                f"launches +{got['launches']} by card {got['cards']}")
            if got["md5"] != ref[name]:
                raise AssertionError(f"{label} rank {r} {key}: md5 != host "
                                     "tier")
            if got["launches"] != per_rank or \
                    sorted(got["cards"].values()) != [1] * per_rank:
                raise AssertionError(f"{label} rank {r} {key}: kernel A "
                                     f"launched {got['cards']}")
            launches += got["launches"]
        if res["imported"]:
            raise AssertionError(f"rank {r} imported {res['imported']}")
        if res["backend"] != backend:
            raise AssertionError(f"{label} rank {r}: transport "
                                 f"{res['backend']}, not {backend}")
        gloo = sum(v["calls"] for v in res["collectives"]["gloo"].values())
        if backend == "nccl" and gloo:
            raise AssertionError(f"{label} rank {r}: {gloo} gloo "
                                 "collectives on the query path")
        q = res["queries"]
        log(f"[mesh] {label}: rank {r} on {res['slots']} of a mesh of "
            f"{res['mesh']}, transport {res['backend']}: subset cold "
            f"{q['subset -G -C cold']['s']:.3f} s (group join, shard load "
            f"and placement included; placement {res['place_s']:.3f} s), "
            f"warm {q['subset -G -C warm']['s']:.3f} s; kernel A "
            f"{res['kernel_ms']:.4f} ms per slot on {res['rows']} x "
            f"{res['words']} words at 1 group (bound {res['bound_ms']:.4f} "
            f"ms); {collectives_text(res['collectives'])} | {card}")
    return launches


def mesh_path(torch, device, prefix: str, ref: dict) -> int:
    """Phase 11, the mesh on one card: (a) in process, 1 slot, 2 slots and
    a 2x2 mesh, the device tier forced and the crossover gate off; (b) two
    gloo ranks on this card, each opening only its shard file; (c)
    ``dryrun_multichip(4)``.  Every md5 must equal the host tier's and
    kernel A must run on every slot of every counted query.  Returns kernel
    A's launches on the mesh path (in process and in both ranks)."""
    from bgt_tpu_torch import cli, entry
    from bgt_tpu_torch.parallel import mesh as meshlib
    from bgt_tpu_torch.query import fastpath
    from bgt_tpu_torch.tools.measure import describe

    card = ", ".join(str(x) for x in describe(device))
    ref = {**ref, "GT": host_tier(lambda: cli.main(
        ["view", *MESH_GT, prefix], device=device))[0]}
    launches = 0

    def release():
        fastpath.reset_shard_context()
        fastpath._DEVICE_CACHE.clear()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    for label, slots, env, names in MESH_CONFIGS:
        release()
        set_env(**{k: None for k in MESH_ENV})
        set_env(BGT_TPU_COUNT_TIER="device", BGT_TPU_SHARD_MIN_ROWS="0", **env)
        runs = []
        for name in names:
            for run in (("cold", "warm") if name == "subset -G -C"
                        else ("",)):
                got = counted_view(device, prefix, name)
                runs.append((name, run, got))
                log(f"[mesh] {label}: {' '.join((name, run)).strip()}: "
                    f"{got['s']:.3f} s, "
                    f"{got['records']} records, md5 {got['md5']}, kernel "
                    f"launches +{got['launches']}")
                if got["md5"] != ref[name]:
                    raise AssertionError(f"mesh {label} {name}: md5 != host tier")
                if got["launches"] != slots:
                    raise AssertionError(f"mesh {label} {name}: kernel A "
                                         f"launched {got['launches']} times "
                                         f"for {slots} slots")
                launches += got["launches"]
        ctx = fastpath.get_shard_context(device)
        kinds = [e.kind for e in ctx._planes.values()] if ctx else []
        if kinds != {1: [], 2: ["s"], 4: ["rs"]}[slots]:
            raise AssertionError(f"mesh {label}: executors {kinds}")
        if ctx is None:
            dt = next(iter(fastpath._DEVICE_CACHE.values()))
            p0, p1 = dt.p0, dt.p1
        else:
            ex = next(iter(ctx._planes.values()))
            p0, p1 = ex.p0[0], ex.p1[0]
        ms, bound = slot_kernel_ms(torch, p0, p1)
        cold, warm = (r[2]["s"] for r in runs[:2])
        log(f"[mesh] {label}: subset cold {cold:.3f} s, warm {warm:.3f} s; "
            f"kernel A {ms:.4f} ms per slot on {p0.shape[0]} x {p0.shape[1]} "
            f"words at 1 group (bound {bound:.4f} ms, share "
            f"{bound / ms:.3f}); no gloo collective (one process) | {card}")
    release()
    set_env(**{k: None for k in MESH_ENV})

    ranks = shard_ranks(prefix, REPO / "build" / "chip_smoke" / "ranks",
                        [{}, {}], 2, str(device))
    launches += check_ranks("2 ranks", ranks, ref, 1, "gloo", card)

    t0 = time.perf_counter()
    out = entry.dryrun_multichip(4, device)
    log(f"[mesh] dryrun_multichip(4, {device}): counts "
        f"{out['counts'].shape}, keep {int(out['keep'].sum())} of "
        f"{out['keep'].size}, 2-axis pairs {out['pairs2'].shape}, production "
        f"2x2 view equal to the host tier, in {time.perf_counter() - t0:.2f} s")
    if any(v["calls"] for t in ("gloo", "nccl")
           for v in meshlib.COLLECTIVES[t].values()):
        raise AssertionError("an in-process mesh made a cross-rank "
                             "collective")
    return launches


# phase 13: the queries on the cards in one process, and the tile that no
# single card holds (HRC's 64,976 haplotypes pad to 2,031 words; 2,048
# split evenly over 2, 4 or 8 cards), counted at 1 and 8 groups
CARD_QUERIES = ("subset -G -C", "two-group -f AC1>AC2", "eight-group -G -C",
                "GT")
TILE_ROWS = 6_000_000
TILE_WORDS = 2_048
TILE_GROUPS = (1, 8)
TILE_CHECK_ROWS = 100_000
TILE_REPS = 3
NVLINK_GBS = 450.0  # H100 SXM data sheet: 900 GB/s NVLink, 450 each way


def sync(torch, devices) -> None:
    for dev in devices:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)


def tile_counts(torch, mesh, plain: bool = False) -> dict:
    """Phase 13 (e) on this process's slots of ``mesh``: each slot's column
    slice of the TILE_ROWS x TILE_WORDS tile, made on its card from a
    generator seeded by its mesh position (never on the host), and at each
    of TILE_GROUPS groups: each slot's kernel A against its plain version
    on TILE_CHECK_ROWS rows, exact; each slot's A in ms; then the sharded
    count (``sharded_count_fn``) TILE_REPS times after a warm-up, its
    median ms (summed counts ready on the first slot) and launches, the
    sum's ms per call from ``mesh.COLLECTIVES``, and the md5 of the summed
    counts.  In one process (``mesh.world`` 1) the summed counts are also
    held to the host sum of every slot's own counts.  With ``plain``, the
    plain version's ms on the first slot's whole slice at 1 group."""
    from bgt_tpu_torch.ops import counts
    from bgt_tpu_torch.parallel import mesh as meshlib
    from bgt_tpu_torch.tools.measure import time_ms

    rows, w = TILE_ROWS, TILE_WORDS // mesh.size
    p0, p1 = [], []
    t0 = time.perf_counter()
    for i, dev in enumerate(mesh.slots):
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 1000 + mesh.first + i)
        for plane in (p0, p1):
            plane.append(torch.randint(-2**31, 2**31 - 1, (rows, w),
                                       dtype=torch.int32, device=dev,
                                       generator=gen))
    sync(torch, mesh.slots)
    out = {"make_s": time.perf_counter() - t0, "rows": rows, "words": w,
           "groups": {}}
    fn = meshlib.sharded_count_fn(mesh)
    for g in TILE_GROUPS:
        masks = np.random.default_rng(SEED + g).integers(
            0, 2**32, (g, TILE_WORDS), dtype=np.uint32)
        msk = [counts.planes_to_torch(
            masks[:, (mesh.first + i) * w: (mesh.first + i + 1) * w], dev)
            for i, dev in enumerate(mesh.slots)]
        err = 0
        check = min(rows, TILE_CHECK_ROWS)
        for a, b, m in zip(p0, p1, msk):
            got = counts.count_codes_range(a, b, m, 0, check)
            want = counts.count_codes_reference(a[:check], b[:check], m)
            err = max(err, int((got - want).abs().max()))
        slot_ms = [time_ms(lambda a=a, b=b, m=m: counts.count_codes(a, b, m),
                           a.device, 5) for a, b, m in zip(p0, p1, msk)]
        res = {"max_abs_err": err, "check_rows": check, "slot_ms": slot_ms}
        if mesh.world == 1:
            local = [counts.count_codes(a, b, m).cpu().numpy()
                     for a, b, m in zip(p0, p1, msk)]
            host = np.sum([x.astype(np.int64) for x in local], axis=0)
            del local
        fn(p0, p1, msk)  # warm-up: the peer and NCCL paths' first call
        meshlib.reset_collectives()
        counts.LAUNCHES["count_codes"] = 0
        counts.CARD_LAUNCHES.clear()
        times = []
        for _ in range(TILE_REPS):
            sync(torch, mesh.slots)
            t0 = time.perf_counter()
            summed = fn(p0, p1, msk)
            sync(torch, [summed.device])
            times.append((time.perf_counter() - t0) * 1e3)
        res["launches"] = counts.LAUNCHES["count_codes"]
        res["cards"] = card_launches()
        res["call_ms"] = sorted(times)[TILE_REPS // 2]
        res["collectives"] = json.loads(json.dumps(meshlib.COLLECTIVES))
        got = summed.cpu().numpy()
        res["bytes"] = got.nbytes
        res["md5"] = hashlib.md5(got.tobytes()).hexdigest()
        if mesh.world == 1:
            res["host_sum_equal"] = bool(np.array_equal(got, host))
            del host
        del got, summed, msk
        out["groups"][str(g)] = res
    if plain:
        m1 = counts.planes_to_torch(
            np.full((1, w), 0xFFFFFFFF, dtype=np.uint32), p0[0].device)
        out["plain_ms"] = time_ms(
            lambda: counts.count_codes_reference(p0[0], p1[0], m1),
            p0[0].device, 1)
    del p0, p1
    torch.cuda.empty_cache()
    return out


def ring_bound_ms(nbytes: int, n: int) -> float:
    """The least time of an all-reduce of ``nbytes`` over ``n`` cards: a
    ring moves 2 (n - 1) / n of the bytes through each card's link, at
    NVLINK_GBS each way."""
    return 2 * (n - 1) / n * nbytes / (NVLINK_GBS * 1e9) * 1e3


def tile_text(label: str, t: dict, n: int, transport: str) -> list:
    """Phase 13 (e)'s lines for one run of ``tile_counts``."""
    from bgt_tpu_torch.tools.measure import count_bound_ms
    lines = []
    for g, r in t["groups"].items():
        bound = count_bound_ms(t["rows"], t["words"], int(g), 4)
        stat = r["collectives"][transport]["all_reduce"]
        sum_ms = stat["ms"] / stat["calls"] if stat["calls"] else float("nan")
        lines.append(
            f"[cards] tile {label}, {g} group(s): kernel A per card "
            f"{', '.join(f'{ms:.3f}' for ms in r['slot_ms'])} ms on "
            f"{t['rows']} x {t['words']} words (bound {bound:.3f} ms, share "
            f"{bound / max(r['slot_ms']):.3f} of the slowest); {transport} "
            f"sum {sum_ms:.3f} ms a call of {r['bytes'] / 1e6:.1f} MB (ring "
            f"bound {ring_bound_ms(r['bytes'], n):.3f} ms); whole call "
            f"{r['call_ms']:.3f} ms (median of {TILE_REPS}); A launches "
            f"{r['launches']} by card {r['cards']}; A vs plain on "
            f"{r['check_rows']} rows max_abs_err {r['max_abs_err']}; md5 "
            f"{r['md5']}")
    return lines


def release_mesh(torch) -> None:
    """Drop every placed plane and mesh context, and the cards' caches."""
    from bgt_tpu_torch.query import fastpath
    fastpath.reset_shard_context()
    fastpath._DEVICE_CACHE.clear()
    torch.cuda.empty_cache()
    set_env(**{k: None for k in MESH_ENV})


def cards_views(torch, cards, prefix: str, ref: dict, card: str) -> int:
    """Phase 13 (a), (b): the cohort's queries in one process over the
    cards (bare ``cuda``) and on the 2 x n/2 ``rs`` mesh over them, beside
    one card, the device tier forced and the crossover gate off; returns
    kernel A's launches."""
    from bgt_tpu_torch.parallel import mesh as meshlib
    from bgt_tpu_torch.query import fastpath
    n = len(cards)
    bare = torch.device("cuda")
    every = {str(i): 1 for i in range(n)}
    configs = [("1 card", cards[0], {}, ("subset -G -C",), {"0": 1}, []),
               (f"{n} cards", bare, {}, CARD_QUERIES, every, ["s"])]
    if n % 2 == 0:
        configs.append((f"2x{n // 2} cards", bare,
                        {"BGT_TPU_MESH2": f"2x{n // 2}"},
                        ("subset -G -C", "GT"), every, ["rs"]))
    launches = 0
    for label, dev, env, names, want_cards, want_kinds in configs:
        release_mesh(torch)
        set_env(BGT_TPU_COUNT_TIER="device", BGT_TPU_SHARD_MIN_ROWS="0", **env)
        meshlib.reset_collectives()
        runs = {}
        for name in names:
            for run in ("cold", "warm"):
                got = counted_view(dev, prefix, name)
                runs[name, run] = got
                log(f"[cards] {label}: {name} {run}: {got['s']:.3f} s, "
                    f"{got['records']} records, md5 {got['md5']}, kernel "
                    f"launches +{got['launches']} by card {got['cards']}")
                if got["md5"] != ref[name]:
                    raise AssertionError(f"{label} {name}: md5 != host tier")
                if got["cards"] != want_cards:
                    raise AssertionError(f"{label} {name}: kernel A by card "
                                         f"{got['cards']}, not {want_cards}")
                launches += got["launches"]
        ctx = fastpath.get_shard_context(dev)
        kinds = [e.kind for e in ctx._planes.values()] if ctx else []
        if kinds != want_kinds:
            raise AssertionError(f"{label}: executors {kinds}")
        if ctx is None:
            dt = next(iter(fastpath._DEVICE_CACHE.values()))
            planes, place = [(dt.p0, dt.p1)], "single device"
        else:
            ex = next(iter(ctx._planes.values()))
            if [str(d) for d in ctx.mesh.slots] != [str(d) for d in cards]:
                raise AssertionError(f"{label}: slots {ctx.mesh.slots}")
            planes = list(zip(ex.p0, ex.p1))
            place = f"placement {ex.place_s:.3f} s"
        per_slot = [slot_kernel_ms(torch, a, b) for a, b in planes]
        log(f"[cards] {label}: subset cold "
            f"{runs['subset -G -C', 'cold']['s']:.3f} s ({place}), warm "
            f"{runs['subset -G -C', 'warm']['s']:.3f} s; kernel A per slot "
            f"on {planes[0][0].shape[0]} x {planes[0][0].shape[1]} words at "
            "1 group " + ", ".join(f"{ms:.4f}" for ms, _ in per_slot)
            + f" ms (bound {per_slot[0][1]:.4f} ms); "
            f"{collectives_text(meshlib.COLLECTIVES)} | {card}")
    return launches


def cards_server(torch, cards, prefix: str) -> int:
    """Phase 13 (g): the port's server in process over the cards (bare
    ``cuda``) under ``auto``, a subset and a GT request cold and warm,
    against the host tier's bodies; returns kernel A's launches."""
    from bgt_tpu_torch.ops import counts
    from bgt_tpu_torch.query import fastpath
    from bgt_tpu_torch.query.engine import BgtFile
    from bgt_tpu_torch.server import server
    n = len(cards)
    bare = torch.device("cuda")
    cfg = server.ServerConfig()
    cfg.port = 0
    cfg.files = [BgtFile(prefix)]
    cfg.prefixes = [os.path.basename(prefix)]
    queries = {k: SERVER_QUERIES[k][0] for k in ("subset",
                                                  "g= GT dump r= subset")}
    want = {}
    set_env(BGT_TPU_COUNT_TIER="host")
    with serving(server.make_server(cfg, bare)) as port:
        for name, q in queries.items():
            fastpath._COUNT_MEMO.clear()
            want[name] = fetch(port, q)[:2]
    set_env(BGT_TPU_COUNT_TIER=None)
    launches = 0
    with serving(server.make_server(cfg, bare)) as port:
        for run in ("cold", "warm"):
            for name, q in queries.items():
                fastpath._COUNT_MEMO.clear()
                counts.LAUNCHES["count_codes"] = 0
                counts.CARD_LAUNCHES.clear()
                status, body, dt = fetch(port, q)
                by_card = card_launches()
                log(f"[cards] server on {n} cards under auto: {name} {run}: "
                    f"{status}, {dt:.3f} s, {len(body)} bytes, md5 "
                    f"{hashlib.md5(body).hexdigest()}, kernel launches by "
                    f"card {by_card}")
                if (status, body) != want[name]:
                    raise AssertionError(f"server {name}: cards != host tier")
                if name == "subset" and by_card != {str(i): 1
                                                    for i in range(n)}:
                    raise AssertionError(f"server {name}: kernel A by card "
                                         f"{by_card}")
                launches += counts.LAUNCHES["count_codes"]
    return launches


def cards_dryrun(torch, cards) -> int:
    """Phase 13 (f): ``entry.dryrun_multichip(n)`` on cuda:0..n-1, with no
    cross-rank collective in this process.  Its launches are checks, not
    the path's: returns 0."""
    from bgt_tpu_torch import entry
    from bgt_tpu_torch.parallel import mesh as meshlib
    n = len(cards)
    t0 = time.perf_counter()
    out = entry.dryrun_multichip(n)
    log(f"[cards] dryrun_multichip({n}) on {', '.join(map(str, cards))}: "
        f"counts {out['counts'].shape}, keep {int(out['keep'].sum())} of "
        f"{out['keep'].size}"
        + (f", 2-axis pairs {out['pairs2'].shape}, production 2x{n // 2} "
           "view equal to the host tier" if "pairs2" in out else "")
        + f", in {time.perf_counter() - t0:.2f} s")
    if any(v["calls"] for t in ("gloo", "nccl")
           for v in meshlib.COLLECTIVES[t].values()):
        raise AssertionError("an in-process mesh made a cross-rank "
                             "collective")
    return 0


def cards_ranks(cards, prefix: str, ref: dict, card: str, work: Path) -> int:
    """Phase 13 (c), (d): n NCCL ranks of one card each (LOCAL_RANK), then
    two of n/2 cards each (CUDA_VISIBLE_DEVICES halves: the in-process sum,
    then NCCL), from shard files; returns kernel A's launches."""
    n = len(cards)
    ranks = shard_ranks(prefix, work, [{"LOCAL_RANK": str(k)}
                                       for k in range(n)], n, "cuda")
    for k, res in enumerate(ranks):
        if res["slots"] != [f"cuda:{k}"]:
            raise AssertionError(f"rank {k} on {res['slots']}")
    launches = check_ranks(f"{n} ranks", ranks, ref, 1, "nccl", card)
    if n % 2:
        return launches
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = vis.split(",") if vis else [str(i) for i in range(n)]
    h = n // 2
    ranks = shard_ranks(prefix, work,
                        [{"CUDA_VISIBLE_DEVICES": ",".join(ids[:h])},
                         {"CUDA_VISIBLE_DEVICES": ",".join(ids[h:n])}],
                        n, "cuda")
    launches += check_ranks(f"2 ranks x {h} cards", ranks, ref, h, "nccl",
                            card)
    for res in ranks:
        if h > 1 and not res["collectives"]["peer"]["all_reduce"]["calls"]:
            raise AssertionError("2 ranks: no in-process sum over cards")
    return launches


def cards_tile(torch, cards, work: Path, out: dict) -> int:
    """Phase 13 (e): the tile in process over the cards, then on n NCCL
    ranks of one card each; every rank's summed counts must have the
    in-process md5.  Fills ``out`` with the in-process ``tile_counts``;
    returns kernel A's launches (the sharded calls')."""
    from bgt_tpu_torch.parallel import mesh as meshlib
    n = len(cards)
    t_in = tile_counts(torch, meshlib.make_mesh(cards), plain=True)
    out.update(t_in)
    total = TILE_ROWS * TILE_WORDS * 4 * 2
    log(f"[cards] tile {TILE_ROWS} x {TILE_WORDS} words, two planes of "
        f"{total / 2e9:.1f} GB ({total / n / 1e9:.1f} GB a card), made on "
        f"the cards in {t_in['make_s']:.2f} s; plain version on one card's "
        f"slice at 1 group {t_in['plain_ms']:.1f} ms")
    for line in tile_text(f"in process on {n} cards", t_in, n, "peer"):
        log(line)
    launches = 0
    for g, r in t_in["groups"].items():
        if (not r["host_sum_equal"] or r["max_abs_err"]
                or r["cards"] != {str(i): TILE_REPS for i in range(n)}):
            raise AssertionError(f"tile at {g} groups: {r}")
        launches += r["launches"]
    ranks = spawn_ranks(work, [{"LOCAL_RANK": str(k)} for k in range(n)],
                        "cuda", job="tile")
    for res in ranks:
        if res["backend"] != "nccl" or res["imported"]:
            raise AssertionError(f"tile rank {res['rank']}: {res['backend']}, "
                                 f"imported {res['imported']}")
        for line in tile_text(f"rank {res['rank']} of {n} NCCL ranks",
                              res["tile"], n, "nccl"):
            log(line)
        for g, r in res["tile"]["groups"].items():
            if (r["md5"] != t_in["groups"][g]["md5"] or r["max_abs_err"]
                    or r["launches"] != TILE_REPS
                    or r["collectives"]["gloo"]["all_reduce"]["calls"]):
                raise AssertionError(f"tile rank {res['rank']} at {g} "
                                     f"groups: {r}")
            launches += r["launches"]
    return launches


def cards_path(torch, n: int, prefix: str, ref: dict) -> dict:
    """Phase 13, the mesh across ``n`` cards: (a), (b) ``cards_views``; (g)
    ``cards_server``; (f) ``cards_dryrun``; (c), (d) ``cards_ranks``; (e)
    ``cards_tile``.  Each part runs even where one before it failed, and
    the phase fails after them if any did.  Returns kernel A's launches on
    the path, its largest difference from the plain version on the tile,
    and its times there."""
    import traceback

    from bgt_tpu_torch import cli
    from bgt_tpu_torch.tools.measure import count_bound_ms, describe

    cards = [torch.device("cuda", i) for i in range(n)]
    card = "; ".join(f"{d}: " + ", ".join(str(x) for x in describe(d))
                     for d in cards)
    log(f"[cards] phase 13 on {n} cards: {card}")
    ref = dict(ref)
    for name in CARD_QUERIES:
        if name not in ref:
            ref[name] = host_tier(lambda: cli.main(
                ["view", *view_args(name), prefix], device=cards[0]))[0]
    work = REPO / "build" / "chip_smoke" / "ranks"
    tile: dict = {}
    launches, failed = 0, []
    for label, fn in (
            ("(a), (b) one process", lambda: cards_views(torch, cards, prefix,
                                                          ref, card)),
            ("(g) server", lambda: cards_server(torch, cards, prefix)),
            ("(f) dryrun_multichip", lambda: cards_dryrun(torch, cards)),
            ("(c), (d) NCCL ranks", lambda: cards_ranks(cards, prefix, ref,
                                                         card, work)),
            ("(e) tile", lambda: cards_tile(torch, cards, work, tile))):
        try:
            launches += fn()
        except Exception:  # noqa: BLE001 - reported, and the phase fails
            failed.append(label)
            log(f"[cards] {label} FAILED:\n{traceback.format_exc()}")
        finally:
            release_mesh(torch)
    if failed:
        raise AssertionError(f"phase 13: {', '.join(failed)} failed")
    one = tile["groups"]["1"]
    log(f"[cards] phase 13: kernel A launches on the path {launches}")
    return {"launches": launches,
            "max_abs_err": max(r["max_abs_err"]
                               for r in tile["groups"].values()),
            "times": (one["slot_ms"][0], tile["plain_ms"],
                      count_bound_ms(TILE_ROWS, tile["words"], 1, 4),
                      "bytes")}


# phase 12's exactness shapes of kernel D: haplotypes (one run a row; a
# word of 32 and a ragged last word; rows of more runs than a block's
# threads at HRC width) and rows per block
DECODE_M = (1, 31, 33, 1025, 64_976)
DECODE_ROWS = (0, 1, 17, 64)
# forced blocks per scan ("max": slices of 16 haplotypes) at two widths:
# 1,025 is no multiple of 16 nor of its slices; 64,976 is HRC's
DECODE_SPLITS = (1, 2, 7, "max")
DECODE_SPLIT_M = (1025, 64_976)
DECODE_WIDE_BATCH_M = 5008  # 1000 Genomes: a batch of more scans than SMs
DECODE_HOST_ROWS = 16_384  # decode_pbf_on_device's check against the host
# the cohort's timed splits beside D's own, and D's block sizes
DECODE_TIMED_SPLITS = (1, 2, 10)
DECODE_THREADS = (256, 512, 1024)


def scatter_cost(torch, device, m: int, rows: int, scans: int) -> str:
    """What the output scatter of kernel D's S form cost, measured with the
    kernel of this revision: ``scans`` scans of ``rows`` all-zero rows at
    ``m`` haplotypes (one run a row, so every row runs the same
    instructions and S' = S), once from random permutations (the S form
    scattered each row's output bytes) and once from the identity.  In the
    inverse form both write the same coalesced rows and differ only in where
    each haplotype's y lookup lands.  Returns the two times and their ratio
    as a line of text."""
    from bgt_tpu_torch.formats.pbf import rle_encode
    from bgt_tpu_torch.ops import decode
    from bgt_tpu_torch.tools.measure import time_ms
    row = rle_encode(np.zeros(m, np.uint8))
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 12)
    ident = torch.arange(m, dtype=torch.int32, device=device).repeat(scans, 1)
    perm = torch.stack([torch.randperm(m, generator=gen, device=device)
                        for _ in range(scans)]).to(torch.int32)
    ms = {}
    for name, S0s in (("identity", ident), ("random", perm)):
        batch = decode.CsrBatch(
            S0s, torch.from_numpy(np.tile(np.frombuffer(row, np.uint8),
                                          rows * scans)).to(device),
            torch.arange(rows * scans + 1, dtype=torch.int64,
                         device=device) * len(row), [rows] * scans, m)
        out, S = decode.decode_csr(batch)
        torch.cuda.synchronize()
        if int(out.max()) != 0 or not torch.equal(S, S0s):
            raise AssertionError("all-zero rows did not decode to zeros")
        del out, S
        ms[name] = time_ms(lambda: decode.decode_csr(batch), device, 3)
    ratio = ms["random"] / ms["identity"]
    return (f"{scans} scans x {rows} all-zero rows at m={m}: identity S "
            f"{ms['identity']:.3f} ms ({ms['identity'] / rows * 1e3:.2f} us a "
            f"row), random S {ms['random']:.3f} ms "
            f"({ms['random'] / rows * 1e3:.2f} us a row), random / identity "
            f"{ratio:.3f}: " + ("no output scatter left (within 10%)"
                                if abs(ratio - 1) <= 0.1 else
                                "random S costs more than 10% over identity"))


def decode_variants(src: Path, threads: tuple) -> dict:
    """Kernel D's source built at each of ``threads`` (block sizes), one
    nvcc each, all at once: name -> library."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(threads) or 1) as pool:
        libs = pool.map(lambda t: build_baseline(
            src, [f"BGT_PBWT_THREADS={t}"])[1], threads)
        return {f"D {t} threads": lib for t, lib in zip(threads, libs)}


def decode_path(torch, device, prefix: str, bases=None) -> dict:
    """Phase 12: kernel D (the PBWT decode scan) against its plain version
    on the card at the edge shapes and splits, then the cohort's PBF decoded
    block by block through ``decode.iter_block_codes`` (every block equal to
    the resident planes' codes, every final S equal to the next checkpoint)
    and ``decode_pbf_on_device`` against the host, then D's and the plain
    version's times on the whole cohort in one batch, D at several splits
    and block sizes and each of ``bases`` (name -> library of another
    revision of D, from build_baseline) in turns.  Returns D's launches on
    that path, its largest difference from the plain version and its
    times."""
    from bgt_tpu_torch import testing
    from bgt_tpu_torch.ops import _kernels, counts, decode
    from bgt_tpu_torch.ops.tiles import TileStore
    from bgt_tpu_torch.tools.measure import decode_bound_ms, describe, time_ms

    card = ", ".join(str(x) for x in describe(device))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    work = REPO / "build" / "chip_smoke" / "decode"
    work.mkdir(parents=True, exist_ok=True)

    def same(what, got, want):
        """(rows, S) pairs equal; a mismatch raises, so the largest
        difference of what passes is 0."""
        torch.cuda.synchronize()
        if got[0].shape != want[0].shape or not torch.equal(got[0], want[0]) \
                or not torch.equal(got[1], want[1]):
            raise AssertionError(f"kernel D != plain at {what}")

    def edge_block(rows, m, seed):
        path = str(work / f"edge-{rows}x{m}.pbf")
        testing.write_pbf(path, testing.pbwt_codes(max(rows, 1), m, seed), 8)
        blk = next(decode.read_blocks(path))
        return blk.S, [r[:rows] for r in blk.rle]

    t0 = time.perf_counter()
    for m in DECODE_M:
        for rows in DECODE_ROWS:
            S, rle = edge_block(rows, m, SEED + m + rows)
            runs = []
            for gi in range(2):
                S0 = torch.from_numpy(S[gi]).to(device)
                lens, bits = decode.pack_block(rle[gi], m, device)
                want = decode.decode_block_reference(S0, lens, bits, m)
                same(f"rows={rows} m={m} plane {gi} padded",
                     decode.decode_block(S0, lens, bits, m), want)
                got, got_S = decode.decode_csr(
                    decode.pack_csr(S[gi: gi + 1], [rle[gi]], m, device))
                same(f"rows={rows} m={m} plane {gi} RLE bytes",
                     (got, got_S[0]), want)
                runs.append(lens.shape[1])
            log(f"[decode] rows={rows} m={m}: max_runs {runs[0]} / {runs[1]} "
                "(planes 0 / 1); D on padded runs and on RLE bytes equal "
                "to the plain version, rows and final S: OK")
    for m, sizes in ((1025, (17, 0, 64, 1)), (64_976, (64, 17))):
        S0s, rle, rows = [], [], []
        for i, n in enumerate(sizes):
            S, r = edge_block(n, m, SEED + 7 * i)
            S0s += [S[0], S[1]]
            rle += r
            rows += [n, n]
        # every scan's rows padded to the batch's longest row
        lens, bits = decode.pack_block([x for r in rle for x in r], m, device)
        S0 = torch.from_numpy(np.stack(S0s)).to(device)
        got, got_S = decode.decode_blocks(S0, lens, bits, rows, m)
        csr, csr_S = decode.decode_csr(decode.pack_csr(np.stack(S0s), rle, m,
                                                       device))
        lo = 0
        for k, n in enumerate(rows):
            want = decode.decode_block_reference(S0[k], lens[lo: lo + n],
                                                 bits[lo: lo + n], m)
            same(f"batch m={m} scan {k}", (got[lo: lo + n], got_S[k]), want)
            same(f"batch m={m} scan {k} RLE bytes",
                 (csr[lo: lo + n], csr_S[k]), want)
            lo += n
        log(f"[decode] one launch of {len(rows)} scans of {rows} rows at "
            f"m={m} (padded to {lens.shape[1]} runs, and as RLE bytes): each "
            "equal to its plain decode: OK")
    for m in DECODE_SPLIT_M:
        S, rle = edge_block(64, m, SEED + 3 * m)
        S0 = torch.from_numpy(S).to(device)
        lens, bits = decode.pack_block(rle[0] + rle[1], m, device)
        want = [decode.decode_block_reference(S0[k], lens[64 * k: 64 * k + 64],
                                              bits[64 * k: 64 * k + 64], m)
                for k in range(2)]
        split_plans = []
        for split in DECODE_SPLITS:
            bps = -(-m // 16) if split == "max" else split
            plan = decode.plan(m, 2, bps, device=device)
            got, got_S = decode.decode_blocks(S0, lens, bits, [64, 64], m,
                                              blocks_per_scan=bps)
            csr, csr_S = decode.decode_csr(decode.pack_csr(S, rle, m, device),
                                           blocks_per_scan=bps)
            for k in range(2):
                sl = slice(64 * k, 64 * k + 64)
                same(f"m={m} plane {k} over {bps} blocks",
                     (got[sl], got_S[k]), want[k])
                same(f"m={m} plane {k} over {bps} blocks, RLE bytes",
                     (csr[sl], csr_S[k]), want[k])
            split_plans.append(f"{plan.blocks_per_scan} x {plan.slice}")
        log(f"[decode] m={m}, 64 rows, both planes in one launch, each scan "
            f"forced over {', '.join(split_plans)} (blocks x haplotypes), "
            "padded and RLE bytes: equal to the plain version: OK")
    m = DECODE_WIDE_BATCH_M
    S, rle = edge_block(17, m, SEED + m)
    rows = [[17, 0, 5, 1][k % 4] for k in range(sms + 5)]
    batch = decode.pack_csr(np.stack([S[k % 2] for k in range(len(rows))]),
                            [rle[k % 2][:n] for k, n in enumerate(rows)], m,
                            device)
    plan = decode.plan(m, len(rows), device=device)
    same(f"{len(rows)} scans at m={m}", decode.decode_csr(batch),
         decode.decode_csr_reference(batch))
    log(f"[decode] {len(rows)} scans (more than the {sms} SMs) at m={m} in "
        f"one launch, {plan.blocks_per_scan} block a scan: equal to the "
        "plain version: OK")
    del batch
    path = str(work / "blocks-100x1025.pbf")
    codes = testing.pbwt_codes(100, 1025, SEED)
    testing.write_pbf(path, codes, 5)
    for max_rows in (None, 70):
        got = decode.decode_pbf_on_device(path, max_rows, device)
        if not (np.array_equal(got, codes[:max_rows]) and np.array_equal(
                got, decode.decode_pbf_on_device(path, max_rows, "cpu"))):
            raise AssertionError(f"decode_pbf_on_device max_rows={max_rows}")
    log(f"[decode] decode_pbf_on_device on 100 x 1025 (4 blocks; whole, and "
        f"cut at 70 rows mid-block) equal to the codes and to the CPU: OK; "
        f"edge checks {time.perf_counter() - t0:.1f} s")

    # the cohort's PBF: the host walk and the RLE-byte batch of every scan
    pbf = prefix + ".pbf"
    t0 = time.perf_counter()
    blocks = list(decode.read_blocks(pbf))
    t1 = time.perf_counter()
    m = blocks[0].S.shape[1]
    rle = [r for b in blocks for r in b.rle]
    batch = decode.pack_csr(np.concatenate([b.S for b in blocks]), rle, m,
                            device)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    n_scans, n_rows = len(rle), batch.n_rows
    runs = [np.array([len(x) for x in r], np.int64) for r in rle]
    max_runs = int(max(r.max() for r in runs))
    csr_bytes = batch.rle.numel() + 8 * batch.run_off.numel()
    pad_block = sum(8 * r.size * int(r.max()) for r in runs)
    log(f"[decode] cohort {pbf}: {len(blocks)} blocks x 2 planes = {n_scans} "
        f"scans against {sms} SMs, {n_rows} rows at m={m}; runs: max "
        f"{max_runs} a row, mean {sum(int(r.sum()) for r in runs) / n_rows:.1f}"
        f"; RLE bytes + offsets {csr_bytes / 1e6:.1f} MB, padded lens/bits "
        f"{pad_block / 1e9:.2f} GB at each block's max_runs, "
        f"{8 * n_rows * max_runs / 1e9:.2f} GB at the batch's; host walk "
        f"{t1 - t0:.2f} s, pack and copy {t2 - t1:.2f} s")

    # the path: every block through iter_block_codes, held to the resident
    # planes and the next checkpoint; decode_pbf_on_device against the host
    ts = TileStore.open_or_build(prefix)
    p0 = counts.planes_to_torch(ts.plane0, device)
    p1 = counts.planes_to_torch(ts.plane1, device)
    decode.LAUNCHES["pbwt_decode"] = 0
    t0 = time.perf_counter()
    prev, seen, checked = None, 0, 0
    for blk in decode.iter_block_codes(pbf, device=device):
        n = blk.codes.shape[0]
        for lo in range(0, n, 2048):
            hi = min(n, lo + 2048)
            want = counts.decode_codes(p0[blk.row0 + lo: blk.row0 + hi],
                                       p1[blk.row0 + lo: blk.row0 + hi])[:, :m]
            if not torch.equal(blk.codes[lo:hi], want):
                raise AssertionError(f"decoded rows {blk.row0 + lo}.. != the "
                                     "resident planes' codes")
        if prev is not None:
            if not np.array_equal(prev.S_final.cpu().numpy(), blk.S0):
                raise AssertionError(f"final S of the block before row "
                                     f"{blk.row0} != its checkpoint")
            checked += 1
        prev, seen = blk, seen + n
    torch.cuda.synchronize()
    t_iter = time.perf_counter() - t0
    del prev, blk
    if seen != ts.n_rows:
        raise AssertionError(f"decoded {seen} rows of {ts.n_rows}")
    t0 = time.perf_counter()
    got = decode.decode_pbf_on_device(pbf, DECODE_HOST_ROWS, device)
    t_host = time.perf_counter() - t0
    launches = decode.LAUNCHES["pbwt_decode"]
    b0 = np.unpackbits(np.asarray(ts.plane0[:DECODE_HOST_ROWS]).view(np.uint8),
                       axis=1, bitorder="little")[:, :m]
    b1 = np.unpackbits(np.asarray(ts.plane1[:DECODE_HOST_ROWS]).view(np.uint8),
                       axis=1, bitorder="little")[:, :m]
    if not np.array_equal(got, (b1 << 1) | b0):
        raise AssertionError("decode_pbf_on_device != the host's codes")
    del got, b0, b1, p0, p1
    log(f"[decode] iter_block_codes: {seen} rows, every block equal to the "
        f"resident planes' codes, {checked} final S equal to the next "
        f"checkpoint, {t_iter:.2f} s (walk, pack, decode, checks); "
        f"decode_pbf_on_device(max_rows={DECODE_HOST_ROWS}) equal to the "
        f"host's codes, {t_host:.2f} s; kernel D launches {launches}")
    if launches < 1:
        raise AssertionError("kernel D did not run on its path")

    # the plain version on the whole cohort, and D against it
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = decode.decode_csr_reference(batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    same("the whole cohort", decode.decode_csr(batch), want)
    del want
    S, rle = edge_block(64, 64_976, SEED + 64_976 + 64)
    lens, bits = decode.pack_block(rle[0], 64_976, device)
    S0 = torch.from_numpy(S[0]).to(device)
    row_ms = time_ms(lambda: decode.decode_block_reference(S0, lens, bits,
                                                           64_976), device, 3) / 64
    del S0, lens, bits

    # D's kernel alone on the whole cohort, all scans in one launch: at its
    # own split and fixed ones, at each block size, and each baseline, held
    # equal to D and timed in turns (lower of two medians of 3)
    lib = _kernels.library()
    own = decode.plan(m, n_scans, device=device)
    fns = {"D": lambda: run_decode(torch, lib, batch)}
    plans = {"D": own}
    for c in DECODE_TIMED_SPLITS:
        if c != own.blocks_per_scan:
            fns[f"D C={c}"] = lambda c=c: run_decode(torch, lib, batch, c)
            plans[f"D C={c}"] = decode.plan(m, n_scans, c, device=device)
    variants = decode_variants(REPO / KERNELS["pbwt_decode"][0],
                               tuple(t for t in DECODE_THREADS
                                     if t != own.threads))
    for name, other in {**variants, **(bases or {})}.items():
        fns[name] = lambda other=other: run_decode(torch, other, batch)
        plans[name] = decode_plan_of(other, m, n_scans)
    ref = fns["D"]()
    for name, fn in fns.items():
        if name != "D":
            same(f"the whole cohort, {name} against D", fn(), ref)
    del ref
    ms = in_turns(fns, list(fns), device, 3)
    bound = decode_bound_ms(n_scans, n_rows, m, csr_bytes)
    rows_per_scan = max(batch.rows_per_scan)
    for name, ts in ms.items():
        t, p = min(ts), plans[name]
        split = ("one block a scan (the S form)" if p is None else
                 f"{p.blocks_per_scan} blocks a scan of {p.threads} threads, "
                 f"slice {p.slice}, {p.smem} B shared, {p.blocks_per_sm} a SM:"
                 f" {n_scans * p.blocks_per_scan} blocks on "
                 f"{min(sms, n_scans * p.blocks_per_scan)} of {sms} SMs")
        log(f"[timing] pbwt_decode {name}: the cohort ({n_scans} scans, "
            f"{n_rows} rows at m={m}) in one launch, {t:.3f} ms "
            f"({t / rows_per_scan * 1e3:.2f} us a row of the longest scan, "
            f"{n_rows * m / t / 1e6:.1f} GB/s of output) | {split} | bound "
            f"{bound:.3f} ms by bytes, share {bound / t:.4f} | turns "
            + ", ".join(f"{x:.3f}" for x in ts) + f" ms | {card}")
    d_ms = min(ms["D"])
    log(f"[timing] pbwt_decode plain version: {plain_ms:.1f} ms for the "
        f"cohort (host clock, one run), {row_ms:.3f} ms a row at m=64976 | "
        f"{card}")
    del batch
    torch.cuda.empty_cache()
    log(f"[timing] pbwt_decode, {scatter_cost(torch, device, m, 8192, n_scans)}"
        f" | {card}")
    return {"launches": launches, "max_abs_err": 0,
            "times": (d_ms, plain_ms, bound, "bytes")}


# phase 14: the port's measurement tools on the card; the bench's hrc
# configuration and its HRC-scale block run in the bench's own call
TOOLS_BENCH = ("1kg11",)
SOAK_SECONDS = 120


def tools_path(torch, n: int, across: bool) -> int:
    """Phase 14, the port's measurement tools (``bgt_tpu_torch/tools/``) on
    the card: (a) ``bench.run`` on 1kg11 at its full size (no HRC-scale
    block, no card tests, no scaling), every query gated on the pins and
    the host tier, the subset's device step and the eight groups launching
    kernel A; (b) the soak for SOAK_SECONDS on cuda:0 against the host
    tier; (c) ``bench_scaling`` over the visible cards (on one card its
    one-card steps, the others recorded as not run); (d)
    ``bench_multiprocess`` with 2 gloo ranks on cuda:0.  With ``across``
    (``--cards n``) only (c) and (d) n NCCL ranks, one card each.  Returns kernel A's launches on the path:
    the bench's counted queries, each read around its query, and the
    soak's and the scaling's in this process, each counted from 0."""
    from bgt_tpu_torch.ops import counts
    from bgt_tpu_torch.tools import (bench, bench_multiprocess,
                                     bench_scaling, soak)
    from bgt_tpu_torch.tools.measure import describe

    set_env(**dict.fromkeys(MESH_ENV + ("BGT_TPU_HBM_BUDGET",), None))
    launches = 0
    if not across:
        device = torch.device("cuda", 0)
        card = ", ".join(str(x) for x in describe(device))
        cfgs = {k: bench.CONFIGS[k] for k in TOOLS_BENCH}
        t0 = time.perf_counter()
        res = bench.run(cfgs, device, json.loads(bench.PINS_PATH.read_text()),
                        full=False, device_tests=False, scaling=False)
        ex = res["extra"]
        for name in cfgs:
            e = ex[name]
            for step in ("subset_device", "groups8"):
                if e["launches"][step] < 1:
                    raise AssertionError(f"bench {name} {step}: kernel A "
                                         "did not run")
            log(f"[tools] bench {name} ({e['shape']}, {e['n_rows']} rows), "
                f"every md5 equal to its pin and the host tier: -G -C warm "
                f"{e['gc_warm_s']:.4f} s ({e['tiers']['gc_warm_0']}), cold "
                f"{e['gc_cold_s']:.3f} s (CUDA context "
                f"{e['cold']['cuda_context']}); subset cold "
                f"{e['subset_cold_s']:.3f} s (A +"
                f"{e['subset_cold']['launches']}), first "
                f"{e['subset_first_s']:.4f} s ({e['tiers']['subset_first']}, "
                f"A +{e['launches']['subset_first']}), memoized "
                f"{e['subset_repeat_s']:.4f} s, device "
                f"{e['subset_device_s']:.4f} s (A "
                f"+{e['launches']['subset_device']}); eight groups "
                f"{e['groups8_s']:.4f} s (A +{e['launches']['groups8']}); "
                f"-S/-H {e['alcnt_ours_s']:.3f} s; annotation "
                f"{e.get('anno_ours_s', float('nan')):.3f} s; -b "
                f"{e['bcf_ours_s']:.3f} s; -C {e['dump_ours_s']:.3f} s | "
                f"{card}")
        dk = ex["device_kernel"]
        log(f"[tools] bench device block on {dk['tile']} ({dk['rows']} x "
            f"{dk['words']}): A {dk['s_per_call_1mask_device'] * 1e3:.4f} / "
            f"{dk['s_per_call_32mask_device'] * 1e3:.4f} ms at 1 / 32 masks, "
            f"bound {dk['bound_ms_1mask']:.4f} / {dk['bound_ms_32mask']:.4f}"
            f" ms, share {dk['share_1mask']:.3f} / {dk['share_32mask']:.3f}; "
            f"proxy {dk['hbm_proxy_gbs']:.1f} GB/s | {card}")
        path = sum(sum(ex[k]["launches"].values())
                   for k in (*cfgs, "multidb"))
        log(f"[tools] bench: {time.perf_counter() - t0:.1f} s, kernel A "
            f"launches on its queries {path}")
        log(f"[tools] bench json: {json.dumps(res)}")
        launches += path

        counts.LAUNCHES["count_codes"] = 0
        if soak.run(SOAK_SECONDS, SEED, device) != 0:
            raise AssertionError("the soak diverged from the host tier")
        log(f"[tools] soak: kernel A launches "
            f"{counts.LAUNCHES['count_codes']}")
        if counts.LAUNCHES["count_codes"] < 1:
            raise AssertionError("the soak launched no kernel A")
        launches += counts.LAUNCHES["count_codes"]

    counts.LAUNCHES["count_codes"] = 0
    t0 = time.perf_counter()
    sc = bench_scaling.run("cuda")
    log(f"[tools] bench_scaling --device cuda: "
        f"{time.perf_counter() - t0:.1f} s, kernel A launches "
        f"{counts.LAUNCHES['count_codes']}")
    launches += counts.LAUNCHES["count_codes"]
    for block in ("dispatch_overhead_s", "strong_devices", "weak_devices"):
        for k, e in sc[block].items():
            if "not_run" not in e and not e["counts_exact"]:
                raise AssertionError(f"scaling {block} {k}: counts differ")
        log(f"[tools] scaling {block}: " + "; ".join(
            f"{k}: " + (e["not_run"] if "not_run" in e else
                        f"{e['s_per_iter'] * 1e3:.4f} ms"
                        + (f", efficiency {e['efficiency']:.3f}"
                           if "efficiency" in e else "")
                        + (" (shared card)" if e["shared_card"] else ""))
            for k, e in sc[block].items()))
    log(f"[tools] scaling crossover: {json.dumps(sc['crossover'])}")
    log(f"[tools] scaling 2x2: {json.dumps(sc['mesh2_2x2'])}")
    for k, e in sc["processes"].items():
        log(f"[tools] scaling processes {k}: " + (
            e["not_run"] if "not_run" in e else
            f"{e['line']}; one process of {k} slots "
            f"{e['one_process_s'] * 1e3:.3f} ms/iter"))
    log(f"[tools] scaling json: {json.dumps(sc)}")

    mp = bench_multiprocess.run(n if across else 2,
                                "cuda" if across else "cuda:0")
    log(f"[tools] bench_multiprocess: {mp['line']}")
    want = "nccl" if across else "gloo"
    if mp["transport"] != want or not mp["counts_exact"]:
        raise AssertionError(f"bench_multiprocess: transport "
                             f"{mp['transport']}, not {want}")
    return launches


# phase 15: hrc_full's depth cut to 16 of the generator's 2,048-site chunks
HRC_BLOCK_SITES = 32_768


def hrc_block(torch) -> int:
    """Phase 15, the bench's HRC-scale block at full width on cuda:0:
    ``bench.bench_hrc_full`` on hrc_full's configuration with
    HRC_BLOCK_SITES sites, its database under ``build/chip_smoke/``.  The
    block gates every step on the port's host tier, a device step with no
    kernel A, a streamed step off the ``stream`` tier, and resident steps
    whose planes are not on the card.  Returns kernel A's launches in the
    block, counted from 0."""
    from bgt_tpu_torch.ops import counts
    from bgt_tpu_torch.tools import bench
    from bgt_tpu_torch.tools.measure import describe

    set_env(**dict.fromkeys(MESH_ENV + ("BGT_TPU_HBM_BUDGET",), None))
    device = torch.device("cuda", 0)
    cfg = dict(bench.HRC_FULL_CFGS["full"], n_sites=HRC_BLOCK_SITES)
    extra: dict = {}
    counts.LAUNCHES["count_codes"] = 0
    t0 = time.perf_counter()
    bench.bench_hrc_full(extra, device, REPO / "build" / "chip_smoke", None,
                         cfgs={"full": cfg})
    launches = counts.LAUNCHES["count_codes"]
    sub = extra["hrc_full"]["full"]
    if launches != sum(sub["launches"].values()):
        raise AssertionError(f"phase 15: {launches} launches of kernel A, "
                             f"its steps counted {sub['launches']}")
    card = ", ".join(describe(device))
    made = (f"made in {sub['gen_s']:.1f} s ({sub['gen_s_per_chunk']:.3f} s "
            f"a chunk; {json.dumps(sub['gen_stages_s'])}), "
            if "gen_s" in sub else "input BCF made earlier, ")
    log(f"[hrc] {sub['shape']} ({sub['gen']}): {made}imported in "
        f"{sub['import_ours_s']:.1f} s ({sub['n_rows']} rows), tile "
        f"{sub['gtc_build_s']:.1f} s ({sub['gtc_bytes'] / 1e9:.3f} GB)")
    log(f"[hrc] region -G -C: first {sub['q_region_first_s']:.4f} s, warm "
        f"{sub['q_region_warm_s']:.4f} s ({sub['q_region_sites']} lines)")
    for label in ("subset_first", "subset_warm", "subset_device_first",
                  "subset_device", "subset_streamed"):
        log(f"[hrc] {label}: {sub[f'q_{label}_s']:.4f} s, tiers "
            f"{sub['tiers'][label]}, A +{sub['launches'][label]}, planes "
            f"resident {sub[f'resident_{label}']}")
    log(f"[hrc] streamed {sub['subset_streamed_rows']} rows, "
        f"{sub['subset_streamed_bytes'] / 1e9:.3f} GB, "
        f"{sub['subset_streamed_gbs']:.2f} GB/s; peak RSS "
        f"{sub['max_rss_gb']:.1f} GB; every md5 equal to the host tier's; "
        f"{time.perf_counter() - t0:.1f} s, kernel A launches {launches} | "
        f"{card}")
    log(f"[hrc] json: {json.dumps(sub)}")
    return launches


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, metavar="OLD.cu", action="append",
                    default=[],
                    help="a source of another revision of kernel A (the C "
                         "entry point bgt_count_codes), timed beside A in "
                         "phase 4, of kernel C (bgt_count_codes_narrow), "
                         "timed beside C in phase 7, or of kernel D "
                         "(bgt_pbwt_decode, with this revision's signature "
                         "or the S form's), timed beside D in phase 12; may "
                         "be given more than once")
    ap.add_argument("--cards", type=int, default=0, metavar="N",
                    help="make phase 13 (the mesh across cards) mandatory: "
                         "exit non-zero, printing no result, with fewer than "
                         "N visible cards; phases 3-12 are skipped")
    ap.add_argument("--rank", action="store_true",
                    help="run as one rank of phase 11 or 13 (its environment "
                         "names the group: MASTER_ADDR, MASTER_PORT, RANK, "
                         "WORLD_SIZE, and LOCAL_RANK or CUDA_VISIBLE_DEVICES "
                         "its cards), writing --out")
    ap.add_argument("--rank-job", choices=("views", "tile"), default="views",
                    help=argparse.SUPPRESS)
    ap.add_argument("--prefix", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda:0", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank:
        sys.path.insert(0, str(REPO))
        return rank_main(args)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    n_cards = torch.cuda.device_count()
    caps = [torch.cuda.get_device_capability(i) for i in range(n_cards)]
    if caps[0] != (9, 0):
        print(f"chip_smoke: needs compute capability (9, 0), found {caps[0]}",
              file=sys.stderr)
        return 2
    if args.cards and (args.cards < 2 or n_cards < args.cards
                       or any(c != (9, 0) for c in caps)):
        print(f"chip_smoke: --cards {args.cards} needs at least 2 and as "
              f"many Hopper cards; {n_cards} visible, capabilities {caps}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from bgt_tpu_torch.ops import _kernels, counts
    from bgt_tpu_torch.tools import measure

    device = torch.device("cuda", 0)
    cap = caps[0]
    log(f"[preflight] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, capability {cap}, {n_cards} "
        f"card(s) visible")
    log(", ".join(measure.describe(device)))

    t0 = time.perf_counter()
    _kernels.library()
    info = _kernels.build_info
    log(f"[build] {info['path']}: "
        + ("cached" if info["cached"] else
           f"nvcc {' '.join(_kernels.NVCC_FLAGS)} -c, one per source in "
           f"parallel, then -shared, in {info['seconds']:.2f} s")
        + f" (load {time.perf_counter() - t0:.2f} s)")
    for line in info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    launches = dict.fromkeys(KERNELS, 0)
    # with --cards, kernels B, C and D are not run
    times = dict.fromkeys(KERNELS, (None, None, None, None))
    errs = dict.fromkeys(KERNELS, None)
    ref = {}
    if args.cards:
        log(f"[cards] --cards {args.cards}: phases 3-12 skipped")
        prefix = make_cohort(REPO / "build" / "chip_smoke", 32_488, 100_000)
    else:
        bases = {"count_codes": {}, "count_codes_narrow": {},
                 "pbwt_decode": {}}
        for src in args.baseline:
            kind, lib = build_baseline(src)
            bases[kind][src.stem] = lib
            log(f"[build] baseline {src}: {kind}")
        err3 = check_kernel(torch, counts, device)
        timing = time_kernel(torch, counts, device, bases["count_codes"])

        prefix = make_cohort(REPO / "build" / "chip_smoke", 32_488, 100_000)
        view_launches, ref = main_path(torch, device, prefix, QUERIES)
        launches["count_codes"] = view_launches
        log(f"[main] main-path kernel launches: {view_launches}")

        rn = check_raw_narrow(torch, counts, device,
                              bases["count_codes_narrow"])
        launches.update(kernel_paths(torch, counts, device))

        server_launches = server_path(torch, device, prefix)
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED + 3)
        more = api_entry_decode(torch, device, prefix, gen)
        mesh_launches = mesh_path(torch, device, prefix, ref)
        launches["count_codes"] += mesh_launches
        log(f"[paths] count_codes launches: view {view_launches}, "
            f"server {server_launches}, api {more['api']}, entry "
            f"{more['entry']}, mesh {mesh_launches}")
        dec = decode_path(torch, device, prefix, bases["pbwt_decode"])
        launches["pbwt_decode"] = dec["launches"]
        # A at 1 group on the tile, B and C at their phase-7 shapes, D on
        # the whole cohort
        times = {"count_codes": timing["by_shape"]["tile", 1], **rn["times"],
                 "pbwt_decode": dec["times"]}
        errs = {"count_codes": max(err3, timing["max_abs_err"]),
                **rn["max_abs_err"], "pbwt_decode": dec["max_abs_err"]}

    if n_cards >= 2 and all(c == (9, 0) for c in caps):
        cards = cards_path(torch, n_cards, prefix, ref)
        launches["count_codes"] += cards["launches"]
        if args.cards:
            times["count_codes"] = cards["times"]
            errs["count_codes"] = cards["max_abs_err"]
    else:
        log(f"[cards] phase 13 (the mesh across cards) needs two or more "
            f"Hopper cards; {n_cards} visible: not run")
    launches["count_codes"] += tools_path(torch, args.cards, bool(args.cards))
    if not args.cards:
        launches["count_codes"] += hrc_block(torch)
    for pkg in ("jax", "bgt_tpu"):
        if any(m == pkg or m.startswith(pkg + ".") for m in sys.modules):
            raise AssertionError(f"{pkg} was imported")
        log(f"[main] {pkg} imported: no")

    # no single PyTorch call computes a masked popcount (torch has no
    # popcount op) or a PBWT decode, so there is no library time
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches[name], "max_abs_err": errs[name],
        "ms": times[name][0], "plain_ms": times[name][1],
        "bound_ms": times[name][2], "bound_by": times[name][3],
        "library_ms": None}
        for name, (source, replaces) in KERNELS.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
