"""PBWT decode on a torch device: the scan over the rows of a checkpoint block.

The counterpart of ``bgt_tpu/ops/decode.py``.  A PBF row is the RLE of the
row's bits permuted by S, the positional-BWT order before it; the next S is
the stable partition of S by those bits (the reference's pbc_dec_core,
pbwt.c:69-170).  Per row:

    starts = exclusive_cumsum(run_lens)
    y = cumsum(scatter(starts, bit_transitions))      # rank-space bits
    a = scatter(S, y)                                  # original order
    S' = stable_partition(S, y)                        # via cumsums

Checkpoint blocks (every 2^shift rows) and bit planes are independent
scans; within one the recurrence is sequential.  On a CUDA tensor the scans
run in ``csrc/pbwt_decode.cu`` (kernel D), in the inverse form: it carries
each haplotype's rank P = S^-1, so a row is a gather ``a[h] = y[P[h]]`` and
each haplotype's next rank is computed from its own, and the haplotypes of
a scan split into slices, one block each, that never talk (``plan`` says
how many: enough to fill the card).  One launch decodes every scan of a
batch.  On a CPU tensor the scans run in the plain PyTorch version beside
it (``decode_block_reference``, ``decode_csr_reference``), the S-form
recurrence of ``bgt_tpu``: a Python loop over rows, each step in torch ops
on all the scans that still have a row.

Runs reach the kernel in one of two forms: the padded int32 (rows, max_runs)
lens/bits arrays of ``pack_block`` (zero-length runs are padding), which
``decode_block`` and ``decode_blocks`` take, as ``bgt_tpu`` does; or the RLE
bytes themselves, concatenated with int64 row offsets (``CsrBatch``), which
the file walk of ``decode_pbf_on_device`` uses.  A PBF row's first rows run
to tens of thousands of runs at HRC width, so padding a block to its longest
row would multiply its run bytes many times over; the bytes are one per run.

Production queries never decode PBF rows on a device: they count on the
packed 2-bit tiles (``ops/tiles.py``), which the native host codec builds
once.  This decoder is for a full decode of rows when only the RLE data is
on the device, and it is the oracle of kernel D.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from dataclasses import dataclass
from typing import Iterator, NamedTuple

import numpy as np
import torch

from ..formats.pbf import PbfReader

# Launches of kernel D, counted by its wrapper where it launches it.
LAUNCHES = {"pbwt_decode": 0}
_LAUNCH_LOCK = threading.Lock()

# a block of the kernel holds in shared memory the row's y, the count of
# ones before each of its 32-bit words and the row's transition bits (12
# bytes per 32 haplotypes) beside its slice of ranks (at least 16 of 32
# bits): all within the H100's opt-in 227 KB less 1 KB kept for its static
# scratch
MAX_M = (227 * 1024 - 1024 - 16 * 4) // 12 * 32


# ---------------------------------------------------------------------------
# Runs
# ---------------------------------------------------------------------------

def _offsets(counts) -> np.ndarray:
    """(len(counts) + 1,) int64 exclusive-then-total prefix sums."""
    out = np.zeros(len(counts) + 1, np.int64)
    np.cumsum(np.asarray(counts, np.int64), out=out[1:])
    return out


def _rle_to_run_arrays(rle: bytes, max_runs: int):
    """Host-side: RLE bytes -> fixed-width (lens, bits) int32 arrays."""
    v = np.frombuffer(rle, dtype=np.uint8).astype(np.int32)
    t = v >> 1
    lens = (t & 0xF) << (4 * (t >> 4))
    bits = v & 1
    out_l = np.zeros(max_runs, np.int32)
    out_b = np.zeros(max_runs, np.int32)
    out_l[: lens.size] = lens
    out_b[: bits.size] = bits
    return out_l, out_b


def pack_block(rle_rows: list[bytes], m: int, device=None):
    """Pad a checkpoint block's RLE rows into dense (rows, max_runs) int32
    lens/bits tensors on ``device`` (default ``cuda``)."""
    max_runs = max(1, max((len(r) for r in rle_rows), default=1))
    lens = np.zeros((len(rle_rows), max_runs), np.int32)
    bits = np.zeros((len(rle_rows), max_runs), np.int32)
    for i, r in enumerate(rle_rows):
        lens[i], bits[i] = _rle_to_run_arrays(r, max_runs)
    device = torch.device("cuda" if device is None else device)
    return torch.from_numpy(lens).to(device), torch.from_numpy(bits).to(device)


@dataclass
class CsrBatch:
    """Scans whose runs are RLE bytes: scan k decodes rows
    [row0[k], row0[k+1]) from S0s[k]; row r's runs are the bytes
    rle[run_off[r]:run_off[r+1]].

    S0s: (scans, m) int32; rle: (n,) uint8; run_off: (rows + 1,) int64,
    all on one device; rows_per_scan: the rows of each scan, on the host."""
    S0s: torch.Tensor
    rle: torch.Tensor
    run_off: torch.Tensor
    rows_per_scan: list[int]
    m: int

    @property
    def n_rows(self) -> int:
        return sum(self.rows_per_scan)

    @property
    def max_runs(self) -> int:
        """The most runs of any row (host-side, from the offsets)."""
        if self.n_rows == 0:
            return 0
        return int((self.run_off[1:] - self.run_off[:-1]).max())


def pack_csr(S0s: np.ndarray, rle_rows: list[list[bytes]], m: int,
             device=None) -> CsrBatch:
    """A CsrBatch on ``device`` (default ``cuda``) from each scan's S0 (a
    (scans, m) array) and its RLE rows (one list of bytes per scan)."""
    flat = [r for rows in rle_rows for r in rows]
    off = _offsets([len(r) for r in flat])
    device = torch.device("cuda" if device is None else device)
    rle = torch.from_numpy(np.frombuffer(b"".join(flat), np.uint8).copy())
    return CsrBatch(
        torch.from_numpy(np.ascontiguousarray(S0s, np.int32)).to(device),
        rle.to(device), torch.from_numpy(off).to(device),
        [len(rows) for rows in rle_rows], m)


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------

def _step(S: torch.Tensor, lens: torch.Tensor, bits: torch.Tensor, m: int,
          ar: torch.Tensor):
    """One row of each of K scans, as ``bgt_tpu``'s scan step: S (K, m)
    int64, lens/bits (K, R) int64 -> (a (K, m) uint8, S' (K, m) int64).
    Updates at an index outside the target are dropped, as XLA drops them."""
    k = S.shape[0]
    starts = torch.cumsum(lens, 1) - lens
    prev = torch.cat([torch.zeros_like(bits[:, :1]), bits[:, :-1]], 1)
    keep = (starts >= 0) & (starts <= m)
    z = torch.zeros((k, m + 1), dtype=torch.int64, device=S.device)
    z.scatter_add_(1, torch.where(keep, starts, m),
                   torch.where(keep & (lens > 0), bits - prev, 0))
    y = torch.cumsum(z, 1)[:, :m]
    s_ok = (S >= 0) & (S < m)
    a = torch.zeros((k, m + 1), dtype=torch.uint8, device=S.device)
    a.scatter_(1, torch.where(s_ok, S, m), y.to(torch.uint8))
    n0 = m - y.sum(1, keepdim=True)
    ones_excl = torch.cumsum(y, 1) - y
    dest = torch.where(y == 0, ar - ones_excl, n0 + ones_excl)
    d_ok = (dest >= 0) & (dest < m)
    nxt = torch.zeros((k, m + 1), dtype=torch.int64, device=S.device)
    nxt.scatter_(1, torch.where(d_ok, dest, m), S)
    return a[:, :m], nxt[:, :m]


def _scan_reference(S0s: torch.Tensor, rows_per_scan: list[int], m: int,
                    runs_at):
    """The plain version of every scan: a loop over row steps, each step one
    ``_step`` over the scans that still have a row.  ``runs_at(rows)`` gives
    the (len(rows), R) int64 lens and bits of the global rows ``rows`` (an
    int64 tensor).  Returns ((sum rows, m) uint8, (scans, m) int32)."""
    dev = S0s.device
    n = len(rows_per_scan)
    row0 = _offsets(rows_per_scan)
    out = torch.zeros((int(row0[-1]), m), dtype=torch.uint8, device=dev)
    S = S0s.to(torch.int64)
    ar = torch.arange(m, dtype=torch.int64, device=dev)
    counts = np.asarray(rows_per_scan, np.int64)
    act = None
    for t in range(int(counts.max(initial=0))):
        live = np.flatnonzero(counts > t)
        if act is None or live.size != act.size:
            act = live
            act_d = torch.from_numpy(act).to(dev)
            row0_d = torch.from_numpy(row0[act]).to(dev)
        rows = row0_d + t
        lens, bits = runs_at(rows)
        if act.size == n:
            a, S = _step(S, lens, bits, m, ar)
        else:
            a, nxt = _step(S.index_select(0, act_d), lens, bits, m, ar)
            S.index_copy_(0, act_d, nxt)
        out.index_copy_(0, rows, a)
    return out, S.to(torch.int32)


def _padded_runs(lens: torch.Tensor, bits: torch.Tensor):
    def runs_at(rows):
        return (lens.index_select(0, rows).to(torch.int64),
                bits.index_select(0, rows).to(torch.int64))
    return runs_at


def _csr_runs(batch: CsrBatch):
    r = max(1, batch.max_runs)
    j = torch.arange(r, dtype=torch.int64, device=batch.rle.device)
    last = max(0, batch.rle.numel() - 1)
    rle = batch.rle if batch.rle.numel() else batch.rle.new_zeros(1)

    def runs_at(rows):
        lo = batch.run_off.index_select(0, rows)
        n = batch.run_off.index_select(0, rows + 1) - lo
        pos = (lo[:, None] + j).clamp_(max=last)
        v = rle[pos].to(torch.int64)
        t = v >> 1
        valid = j < n[:, None]
        lens = torch.where(valid, (t & 0xF) << (4 * (t >> 4)), 0)
        return lens, torch.where(valid, v & 1, 0)
    return runs_at


def decode_block_reference(S0: torch.Tensor, lens: torch.Tensor,
                           bits: torch.Tensor, m: int):
    """The plain PyTorch decode of one checkpoint block, on any device.

    S0: (m,) int32 permutation before the first row.
    lens/bits: (rows, max_runs) int32 run arrays (zero-length runs are
    padding).  Returns (rows, m) uint8 bits in original column order, plus
    the final S (int32)."""
    rows, S = _scan_reference(S0.reshape(1, -1), [lens.shape[0]], m,
                              _padded_runs(lens, bits))
    return rows, S[0]


def decode_csr_reference(batch: CsrBatch):
    """The plain PyTorch decode of every scan of ``batch``: ((rows, m)
    uint8, (scans, m) int32 final S)."""
    return _scan_reference(batch.S0s, batch.rows_per_scan, batch.m,
                           _csr_runs(batch))


# ---------------------------------------------------------------------------
# Kernel D
# ---------------------------------------------------------------------------

def _check_int32(**tensors: torch.Tensor) -> None:
    dev = next(iter(tensors.values())).device
    for name, t in tensors.items():
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, not {dev}")


def _check_kernel_inputs(S0s: torch.Tensor, m: int, **tensors) -> None:
    """What kernel D needs beyond the shapes: contiguous tensors, m within
    its shared memory, and S0s permutations, so that every output byte is
    written."""
    for name, t in {"S0s": S0s, **tensors}.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if m > MAX_M:
        raise ValueError(f"m = {m} exceeds the kernel's {MAX_M} haplotypes")
    ar = torch.arange(m, dtype=torch.int32, device=S0s.device)
    if S0s.numel() and not bool((torch.sort(S0s, 1).values == ar).all()):
        raise ValueError("S0 is not a permutation of 0..m-1")


class DecodePlan(NamedTuple):
    """Kernel D's launch for a batch: each scan split over
    ``blocks_per_scan`` blocks of ``threads`` threads, a block owning
    ``slice`` haplotypes (the last block of a scan the rest)."""
    blocks_per_scan: int
    slice: int
    threads: int
    smem: int                  # dynamic shared memory of a block, bytes
    min_blocks_per_scan: int   # the least whose slice fits in shared memory
    max_blocks_per_scan: int   # slices of 16 haplotypes
    blocks_per_sm: int         # what the occupancy API allows at ``smem``


_PLAN_FIELDS = len(DecodePlan._fields)
_CUDA_INVALID_VALUE = 1


def plan(m: int, scans: int, blocks_per_scan: int = 0, rle: bool = True,
         device=None) -> DecodePlan:
    """The launch kernel D makes for ``scans`` scans at ``m`` haplotypes
    from RLE bytes (``rle``) or padded runs, on CUDA ``device`` (default
    the current one).  ``blocks_per_scan`` 0 lets the kernel choose: the
    most blocks the card's SMs hold at once, or the least that fit when the
    scans alone fill it.  Raises ValueError for a split outside
    [min_blocks_per_scan, max_blocks_per_scan] or an m past ``MAX_M``."""
    from . import _kernels
    if m < 1 or scans < 1:
        raise ValueError(f"no launch for m = {m}, scans = {scans}")
    if m > MAX_M:
        raise ValueError(f"m = {m} exceeds the kernel's {MAX_M} haplotypes")
    out = (ctypes.c_int * _PLAN_FIELDS)()
    device = torch.device("cuda" if device is None else device)
    with torch.cuda.device(device):
        err = _kernels.library().bgt_pbwt_decode_plan(
            scans, m, _blocks_per_scan(blocks_per_scan), int(rle), out)
    if err == _CUDA_INVALID_VALUE and blocks_per_scan:
        raise ValueError(f"blocks_per_scan = {blocks_per_scan} at m = {m}: "
                         f"the kernel takes {out[4]} to {out[5]}")
    if err != 0:
        raise RuntimeError(f"pbwt_decode plan failed: CUDA error {err}")
    return DecodePlan(*out)


def _blocks_per_scan(value) -> int:
    if isinstance(value, bool) or not isinstance(value, int) or value < 0:
        raise ValueError(f"blocks_per_scan must be an int >= 0, got {value!r}")
    return value


def _launch(S0s, rle, lens, bits, run_off, rows_per_scan, m, blocks_per_scan):
    """Kernel D on the current stream (no sync): ((rows, m) uint8,
    (scans, m) int32)."""
    from . import _kernels
    dev = S0s.device
    n = S0s.shape[0]
    row0 = _offsets(rows_per_scan)
    out = torch.empty((int(row0[-1]), m), dtype=torch.uint8, device=dev)
    S_final = torch.empty((n, m), dtype=torch.int32, device=dev)
    if n == 0 or m == 0:
        return out, S_final
    split = plan(m, n, blocks_per_scan, rle is not None, dev).blocks_per_scan
    row0_d = torch.from_numpy(row0).to(dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = _kernels.library().bgt_pbwt_decode(
            S0s.data_ptr(), ptr(rle), ptr(lens), ptr(bits), run_off.data_ptr(),
            row0_d.data_ptr(), out.data_ptr(), S_final.data_ptr(), n, m, split,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pbwt_decode kernel launch failed: CUDA error {err}")
    # the ctypes call releases the GIL, so callers in threads reach this
    # read-modify-write concurrently
    with _LAUNCH_LOCK:
        LAUNCHES["pbwt_decode"] += 1
    return out, S_final


def _rows_per_scan(rows_per_scan, n_scans: int, n_rows: int) -> list[int]:
    rows = [int(r) for r in rows_per_scan]
    if len(rows) != n_scans or any(r < 0 for r in rows) or sum(rows) != n_rows:
        raise ValueError(f"rows_per_scan {rows} does not split {n_rows} rows "
                         f"into {n_scans} scans")
    return rows


def decode_blocks(S0s: torch.Tensor, lens: torch.Tensor, bits: torch.Tensor,
                  rows_per_scan, m: int, *, blocks_per_scan: int = 0):
    """Decode many independent scans (checkpoint blocks of any planes) at
    once.

    S0s: (scans, m) int32, each scan's S before its first row.
    lens/bits: (rows, max_runs) int32 run arrays of every scan's rows in
    turn; scan k owns the next rows_per_scan[k] of them.
    Returns ((rows, m) uint8 in the same row order, (scans, m) int32 final
    S of each scan; S0 for a scan of no rows).  A CUDA tensor goes to kernel
    D, all scans in one launch, each over ``blocks_per_scan`` blocks (0:
    ``plan``'s choice); a CPU tensor to the plain version, which does not
    split."""
    _check_int32(S0s=S0s, lens=lens, bits=bits)
    _blocks_per_scan(blocks_per_scan)
    if lens.shape != bits.shape or S0s.shape[1] != m:
        raise ValueError(f"shape mismatch: S0s {tuple(S0s.shape)}, lens "
                         f"{tuple(lens.shape)}, bits {tuple(bits.shape)}, m={m}")
    rows = _rows_per_scan(rows_per_scan, S0s.shape[0], lens.shape[0])
    if S0s.device.type == "cuda":
        _check_kernel_inputs(S0s, m, lens=lens, bits=bits)
        run_off = torch.arange(lens.shape[0] + 1, dtype=torch.int64,
                               device=S0s.device) * lens.shape[1]
        return _launch(S0s, None, lens, bits, run_off, rows, m,
                       blocks_per_scan)
    if S0s.device.type == "cpu":
        return _scan_reference(S0s, rows, m, _padded_runs(lens, bits))
    raise ValueError(f"no decode kernel for device {S0s.device}")


def decode_block(S0: torch.Tensor, lens: torch.Tensor, bits: torch.Tensor,
                 m: int):
    """Decode one checkpoint block.

    S0: (m,) int32 permutation before the first row.
    lens/bits: (rows, max_runs) run arrays (zero-length runs are padding).
    Returns (rows, m) uint8 bits in original column order, plus the final S
    (int32).  A CUDA tensor goes to kernel D, a CPU tensor to the plain
    version."""
    if S0.dim() != 1:
        raise ValueError(f"S0 must be 1-D, got shape {tuple(S0.shape)}")
    out, S = decode_blocks(S0.reshape(1, -1), lens, bits, [lens.shape[0]], m)
    return out, S[0]


def decode_csr(batch: CsrBatch, *, blocks_per_scan: int = 0):
    """Decode every scan of ``batch``: ((rows, m) uint8, (scans, m) int32
    final S).  On a CUDA device kernel D reads the RLE bytes itself, all
    scans in one launch, each over ``blocks_per_scan`` blocks (0: ``plan``'s
    choice); on the CPU the plain version runs."""
    S0s, m = batch.S0s, batch.m
    _check_int32(S0s=S0s)
    _blocks_per_scan(blocks_per_scan)
    if S0s.shape[1] != m or batch.rle.dtype != torch.uint8 \
            or batch.run_off.dtype != torch.int64 \
            or batch.run_off.shape != (batch.n_rows + 1,) \
            or batch.rle.device != S0s.device \
            or batch.run_off.device != S0s.device:
        raise ValueError("malformed CsrBatch")
    _rows_per_scan(batch.rows_per_scan, S0s.shape[0], batch.n_rows)
    if S0s.device.type == "cuda":
        _check_kernel_inputs(S0s, m, rle=batch.rle, run_off=batch.run_off)
        return _launch(S0s, batch.rle, None, None, batch.run_off,
                       batch.rows_per_scan, m, blocks_per_scan)
    if S0s.device.type == "cpu":
        return decode_csr_reference(batch)
    raise ValueError(f"no decode kernel for device {S0s.device}")


# ---------------------------------------------------------------------------
# PBF files
# ---------------------------------------------------------------------------

class PbfBlock(NamedTuple):
    row0: int                 # the file row of the block's first row
    S: np.ndarray             # (g, m) int32 checkpoint: each plane's S
    rle: list[list[bytes]]    # each plane's RLE rows

    @property
    def n_rows(self) -> int:
        return len(self.rle[0])


def read_blocks(path: str, max_rows: int | None = None) -> Iterator[PbfBlock]:
    """Walk a PBF's records: each checkpoint block that holds rows, with
    its S record and RLE rows, up to ``max_rows`` rows in all."""
    pb = PbfReader(path)
    try:
        m, g = pb.m, pb.g
        pb.fp.seek(16)
        cur = None
        n = 0
        while max_rows is None or n < max_rows:
            t = pb.fp.read(1)
            if t == b"S":
                if cur is not None and cur.n_rows:
                    yield cur
                S = np.stack([np.frombuffer(pb.fp.read(4 * m), dtype="<i4")
                              for _ in range(g)]).astype(np.int32)
                cur = PbfBlock(n, S, [[] for _ in range(g)])
                t = pb.fp.read(1)
            if t != b"B":
                break
            for gi in range(g):
                (length,) = struct.unpack("<i", pb.fp.read(4))
                cur.rle[gi].append(pb.fp.read(length))
            n += 1
        if cur is not None and cur.n_rows:
            yield cur
    finally:
        pb.close()


class DecodedBlock(NamedTuple):
    row0: int                 # the file row of codes[0]
    S0: np.ndarray            # (2, m) int32: the block's checkpoint S record
    codes: torch.Tensor       # (rows, m) uint8 (p1 << 1) | p0, on the device
    S_final: torch.Tensor     # (2, m) int32: each plane's S after the block


def _batch_bytes(device: torch.device, block_bytes: int) -> int:
    """Output bytes per launch: a quarter of the card's free memory (all
    that the allocator holds unused included), at least one block."""
    if device.type != "cuda":
        return block_bytes
    free, _total = torch.cuda.mem_get_info(device)
    free += torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
    return max(block_bytes, free // 4)


def iter_block_codes(path: str, max_rows: int | None = None,
                     device=None) -> Iterator[DecodedBlock]:
    """Decode a 2-plane PBF block by block on ``device`` (default ``cuda``):
    consecutive blocks are batched up to the memory a launch may fill, each
    batch (every block's two planes) decoded by one ``decode_csr`` call, and
    each block's codes yielded as a device tensor."""
    device = torch.device("cuda" if device is None else device)
    with PbfReader(path) as pb:
        m, g = pb.m, pb.g
    if g != 2:
        raise ValueError(f"{path}: expected a 2-plane PBF, found {g} planes")
    pending: list[PbfBlock] = []
    size, budget = 0, None
    for blk in read_blocks(path, max_rows):
        nbytes = g * blk.n_rows * m
        if budget is None:
            budget = _batch_bytes(device, nbytes)
        if pending and size + nbytes > budget:
            yield from _decode_batch(pending, m, device)
            pending, size = [], 0
        pending.append(blk)
        size += nbytes
    if pending:
        yield from _decode_batch(pending, m, device)


def _decode_batch(blocks: list[PbfBlock], m: int,
                  device: torch.device) -> Iterator[DecodedBlock]:
    """Both planes of every block in one decode_csr call."""
    batch = pack_csr(np.concatenate([b.S for b in blocks]),
                     [rows for b in blocks for rows in b.rle], m, device)
    out, S_final = decode_csr(batch)
    lo = 0
    for i, b in enumerate(blocks):
        p0 = out[lo: lo + b.n_rows]
        p1 = out[lo + b.n_rows: lo + 2 * b.n_rows]
        lo += 2 * b.n_rows
        yield DecodedBlock(b.row0, b.S, (p1 << 1) | p0,
                           S_final[2 * i: 2 * i + 2])


def decode_pbf_on_device(path: str, max_rows: int | None = None,
                         device=None) -> np.ndarray:
    """Decode a whole 2-plane PBF through the device scan (demo/oracle path):
    (rows, m) uint8 codes ``(p1 << 1) | p0`` of its first ``max_rows`` rows
    (all by default), decoded on ``device`` (default ``cuda``)."""
    parts = [b.codes.cpu().numpy() for b in iter_block_codes(path, max_rows,
                                                             device)]
    if parts:
        return np.concatenate(parts, axis=0)
    with PbfReader(path) as pb:
        return np.zeros((0, pb.m), np.uint8)
