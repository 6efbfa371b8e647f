"""Masked-popcount genotype counts on a torch device.

The counterpart of ``bgt_tpu/ops/counts.py`` (count_codes, count_codes_range,
site_stats, counts_to_numpy).  For packed planes p0, p1 and column masks m_g:

    n10 = popcount(p0 & m_g)   n11 = popcount(p1 & m_g)
    nb  = popcount(p0 & p1 & m_g)
    cnt1 = n10 - nb; cnt2 = n11 - nb; cnt3 = nb; cnt0 = |m_g| - cnt1 - cnt2 - cnt3

Planes and masks are uint32 words on disk; here they are int32 tensors
holding the same bits, because torch has no popcount and does not shift
uint32 on the CPU.  On a CUDA tensor each op runs its hand-written kernel
from ``csrc/``; on a CPU tensor the plain PyTorch version beside it:

- ``count_codes``/``count_codes_range``: ``csrc/count_codes.cu``, any
  group count (the production kernel);
- ``count_raw``/``count_raw_range``: the raw n10, n11, nb of one mask,
  ``csrc/count_raw.cu`` (the roofline probe's streaming kernel);
- ``count_codes_narrow``: the counts of ``count_codes`` for at most 32
  groups whose masks fit in one block's shared memory,
  ``csrc/count_narrow.cu`` (for narrow rows: the masks staged once per
  block, a warp per 16-row tile on the binary tensor cores, its tiles
  brought in by bulk copies).

The decode and gather ops (``decode_codes``, ``gather_codes``,
``gather_codes_range``, ``gt_pair_idx_range``) are plain torch ops on every
device, as their JAX counterparts are XLA ops with no Pallas kernel.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ..log import span

# Launches of each CUDA kernel, counted by its wrapper where it launches it,
# and the same launches by (kernel, card index)
LAUNCHES = {"count_codes": 0, "count_raw": 0, "count_codes_narrow": 0}
CARD_LAUNCHES: dict = {}
_LAUNCH_LOCK = threading.Lock()

# count_codes_narrow's contract, the same on every device: the groups of the
# TPU experiment it replaces (docs/experiments/pallas_count.py), and all
# masks in one block's shared memory, up to the H100's opt-in limit of
# 227 KB (32 groups up to 1,816 words).  The kernel itself asks the runtime
# for the masks' bytes, and a card with less would fail the launch.
NARROW_MAX_GROUPS = 32
NARROW_MAX_MASK_BYTES = 227 * 1024

# rows per plain-version chunk: bounds its temporaries to ~_CHUNK_WORDS words
_CHUNK_WORDS = 1 << 22


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of int32 words.  ``>>`` is arithmetic on int32, but each
    mask below clears the sign bits it smears in, so the result equals a
    logical-shift popcount of the uint32 bits (0..32 per word)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F  # per-byte counts; sign bit now clear
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def _raw_sums(a: torch.Tensor, b: torch.Tensor, m: torch.Tensor):
    """Per-row n10, n11, nb of (rows, words) planes under one (words,) mask."""
    am = a & m
    bm = b & m
    return (_popcount32(am).sum(dim=1, dtype=torch.int32),
            _popcount32(bm).sum(dim=1, dtype=torch.int32),
            _popcount32(am & bm).sum(dim=1, dtype=torch.int32))


def _row_step(words: int) -> int:
    return max(1, _CHUNK_WORDS // max(words, 1))


def count_codes_reference(p0: torch.Tensor, p1: torch.Tensor,
                          masks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch counts: (rows, words) int32 planes and (groups, words)
    int32 masks -> (rows, groups, 4) int32 counts of codes 0..3.  Chunked
    over rows so its temporaries stay bounded at any row count."""
    rows, words = p0.shape
    g = masks.shape[0]
    out = torch.empty((rows, g, 4), dtype=torch.int32, device=p0.device)
    tot = _popcount32(masks).sum(dim=1, dtype=torch.int32)
    step = _row_step(words)
    for lo in range(0, rows, step):
        a = p0[lo: lo + step]
        b = p1[lo: lo + step]
        for gi in range(g):
            n10, n11, nb = _raw_sums(a, b, masks[gi])
            cnt1 = n10 - nb
            cnt2 = n11 - nb
            blk = out[lo: lo + step, gi]
            blk[:, 0] = tot[gi] - cnt1 - cnt2 - nb
            blk[:, 1] = cnt1
            blk[:, 2] = cnt2
            blk[:, 3] = nb
    return out


def count_raw_reference(p0: torch.Tensor, p1: torch.Tensor,
                        mask1: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch raw sums of one mask: (rows, words) int32 planes and a
    (1, words) int32 mask -> (rows, 3) int32 n10, n11, nb (no affine step).
    Chunked over rows like count_codes_reference."""
    rows, words = p0.shape
    out = torch.empty((rows, 3), dtype=torch.int32, device=p0.device)
    step = _row_step(words)
    for lo in range(0, rows, step):
        sums = _raw_sums(p0[lo: lo + step], p1[lo: lo + step], mask1[0])
        for k, col in enumerate(sums):
            out[lo: lo + step, k] = col
    return out


def _check(p0: torch.Tensor, p1: torch.Tensor, masks: torch.Tensor) -> None:
    for name, t in (("p0", p0), ("p1", p1), ("masks", masks)):
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if t.device != p0.device:
            raise ValueError(f"{name} is on {t.device}, p0 on {p0.device}")
    if p1.shape != p0.shape or masks.shape[1] != p0.shape[1]:
        raise ValueError(f"shape mismatch: p0 {tuple(p0.shape)}, "
                         f"p1 {tuple(p1.shape)}, masks {tuple(masks.shape)}")


def _check_range(p0: torch.Tensor, start: int, length: int) -> tuple[int, int]:
    start, length = int(start), int(length)
    if start < 0 or length < 0 or start + length > p0.shape[0]:
        raise ValueError(f"rows [{start}, {start + length}) outside "
                         f"[0, {p0.shape[0]})")
    return start, length


def _check_cuda(**tensors: torch.Tensor) -> None:
    """What every kernel needs beyond _check: contiguous tensors, and row and
    word counts that its int arguments hold."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    rows, words = tensors["p0"].shape
    if words >= 1 << 26 or rows >= 1 << 31:
        raise ValueError(f"planes of shape {(rows, words)} are too large")


def _launch(kernel: str, device: torch.device, *args) -> None:
    """Call ``bgt_<kernel>`` of the kernel library with ``args`` and the
    current stream of ``device`` (no sync); raise on a CUDA error and count
    the launch."""
    from . import _kernels
    fn = getattr(_kernels.library(), "bgt_" + kernel)
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
    _count_launch(kernel, device.index)


def _count_launch(kernel: str, card: int | None = None) -> None:
    # the ctypes call above releases the GIL, so request threads of the
    # server reach this read-modify-write concurrently
    with _LAUNCH_LOCK:
        LAUNCHES[kernel] += 1
        key = (kernel, card)
        CARD_LAUNCHES[key] = CARD_LAUNCHES.get(key, 0) + 1


def _count_codes_cuda(p0: torch.Tensor, p1: torch.Tensor, masks: torch.Tensor,
                      start: int, length: int) -> torch.Tensor:
    """Launch the hand-written kernel on the current stream (no sync)."""
    _check_cuda(p0=p0, p1=p1, masks=masks)
    g = masks.shape[0]
    out = torch.empty((length, g, 4), dtype=torch.int32, device=p0.device)
    if length == 0 or g == 0:
        return out
    mask_pop = torch.empty(g, dtype=torch.int32, device=p0.device)
    _launch("count_codes", p0.device, p0.data_ptr(), p1.data_ptr(),
            masks.data_ptr(), mask_pop.data_ptr(), out.data_ptr(), start,
            length, p0.shape[1], g)
    return out


def count_codes_range(p0: torch.Tensor, p1: torch.Tensor, masks: torch.Tensor,
                      start: int, length: int) -> torch.Tensor:
    """Counts over the device-resident row slice [start, start+length):
    (length, groups, 4) int32.  A CUDA tensor goes to the kernel, which takes
    ``start`` as an argument; a CPU tensor to the plain version, on a
    contiguous row view (no copy)."""
    _check(p0, p1, masks)
    start, length = _check_range(p0, start, length)
    if p0.device.type == "cuda":
        return _count_codes_cuda(p0, p1, masks, start, length)
    if p0.device.type == "cpu":
        return count_codes_reference(p0.narrow(0, start, length),
                                     p1.narrow(0, start, length), masks)
    raise ValueError(f"no count kernel for device {p0.device}")


def count_codes(p0: torch.Tensor, p1: torch.Tensor,
                masks: torch.Tensor) -> torch.Tensor:
    """Per-row, per-group genotype-code counts.

    p0, p1: (rows, words) int32 planes; masks: (groups, words) int32.
    returns (rows, groups, 4) int32: counts of codes 0..3.
    """
    return count_codes_range(p0, p1, masks, 0, p0.shape[0])


def count_raw_range(p0: torch.Tensor, p1: torch.Tensor, mask1: torch.Tensor,
                    start: int, length: int) -> torch.Tensor:
    """Raw sums n10, n11, nb of one (1, words) mask over the row slice
    [start, start+length): (length, 3) int32.  A CUDA tensor goes to the
    kernel, a CPU tensor to the plain version."""
    _check(p0, p1, mask1)
    if mask1.shape[0] != 1:
        raise ValueError(f"count_raw takes one mask, got {mask1.shape[0]}")
    start, length = _check_range(p0, start, length)
    if p0.device.type == "cuda":
        _check_cuda(p0=p0, p1=p1, mask1=mask1)
        out = torch.empty((length, 3), dtype=torch.int32, device=p0.device)
        if length:
            _launch("count_raw", p0.device, p0.data_ptr(), p1.data_ptr(),
                    mask1.data_ptr(), out.data_ptr(), start, length,
                    p0.shape[1])
        return out
    if p0.device.type == "cpu":
        return count_raw_reference(p0.narrow(0, start, length),
                                   p1.narrow(0, start, length), mask1)
    raise ValueError(f"no count kernel for device {p0.device}")


def count_raw(p0: torch.Tensor, p1: torch.Tensor,
              mask1: torch.Tensor) -> torch.Tensor:
    """Per-row raw sums of one mask: (rows, words) int32 planes and a
    (1, words) int32 mask -> (rows, 3) int32 n10, n11, nb."""
    return count_raw_range(p0, p1, mask1, 0, p0.shape[0])


def count_codes_narrow(p0: torch.Tensor, p1: torch.Tensor,
                       masks: torch.Tensor) -> torch.Tensor:
    """The counts of :func:`count_codes`, (rows, groups, 4) int32, from the
    kernel that stages all masks in shared memory once per block and counts
    each 16-row tile with one warp, every group in one pass over the rows.
    It takes at most NARROW_MAX_GROUPS groups whose masks fit in
    NARROW_MAX_MASK_BYTES and raises ValueError outside those limits, on
    every device.  Its plain version is count_codes_reference."""
    _check(p0, p1, masks)
    g, words = masks.shape
    if g > NARROW_MAX_GROUPS:
        raise ValueError(f"count_codes_narrow takes at most "
                         f"{NARROW_MAX_GROUPS} groups, got {g}")
    if g * words * 4 > NARROW_MAX_MASK_BYTES:
        raise ValueError(f"{g} masks of {words} words exceed the "
                         f"{NARROW_MAX_MASK_BYTES} bytes of shared memory")
    if p0.device.type == "cuda":
        _check_cuda(p0=p0, p1=p1, masks=masks)
        rows = p0.shape[0]
        out = torch.empty((rows, g, 4), dtype=torch.int32, device=p0.device)
        if rows and g:
            _launch("count_codes_narrow", p0.device, p0.data_ptr(),
                    p1.data_ptr(), masks.data_ptr(), out.data_ptr(), 0, rows,
                    words, g)
        return out
    if p0.device.type == "cpu":
        return count_codes_reference(p0, p1, masks)
    raise ValueError(f"no count kernel for device {p0.device}")


def site_stats(counts: torch.Tensor) -> dict:
    """AN/AC vectors from (rows, groups, 4) counts (bgtm_cal_info)."""
    tot = counts.sum(dim=1, dtype=counts.dtype)  # (rows, 4)
    out = {
        "AN": tot[:, 0] + tot[:, 1] + tot[:, 3],
        "AC": tot[:, 1],
        "AC_M": tot[:, 3],
    }
    if counts.shape[1] > 1:
        out["GAN"] = counts[:, :, 0] + counts[:, :, 1] + counts[:, :, 3]
        out["GAC"] = counts[:, :, 1]
        out["GAC_M"] = counts[:, :, 3]
    return out


def decode_codes(p0: torch.Tensor, p1: torch.Tensor) -> torch.Tensor:
    """(rows, words) int32 planes -> (rows, words*32) uint8 genotype codes
    ``bit(p1) << 1 | bit(p0)``, column c from bit c % 32 of word c // 32.
    ``>>`` is arithmetic on int32, but ``(x >> s) & 1`` is still bit s."""
    _check(p0, p1, p0[:0])
    shifts = torch.arange(32, dtype=torch.int32, device=p0.device)
    b0 = (p0.unsqueeze(2) >> shifts) & 1
    b1 = (p1.unsqueeze(2) >> shifts) & 1
    return ((b1 << 1) | b0).reshape(p0.shape[0], p0.shape[1] * 32).to(
        torch.uint8)


def gather_codes(p0: torch.Tensor, p1: torch.Tensor, cols: torch.Tensor,
                 n_out: int) -> torch.Tensor:
    """The codes of :func:`decode_codes` at the ``n_out`` columns ``cols``:
    (rows, n_out) uint8.  Only the words that hold those columns are read."""
    _check(p0, p1, p0[:0])
    cols = cols.to(device=p0.device, dtype=torch.int64)
    if cols.shape != (n_out,):
        raise ValueError(f"cols has shape {tuple(cols.shape)}, "
                         f"expected ({n_out},)")
    if n_out and (int(cols.min()) < 0
                  or int(cols.max()) >= p0.shape[1] * 32):
        raise ValueError(f"cols outside [0, {p0.shape[1] * 32})")
    word = cols >> 5
    shift = (cols & 31).to(torch.int32)
    b0 = (p0.index_select(1, word) >> shift) & 1
    b1 = (p1.index_select(1, word) >> shift) & 1
    return ((b1 << 1) | b0).to(torch.uint8)


def gather_codes_range(p0: torch.Tensor, p1: torch.Tensor, cols: torch.Tensor,
                       start: int, length: int, n_out: int) -> torch.Tensor:
    """:func:`gather_codes` over the row slice [start, start+length):
    (length, n_out) uint8."""
    start, length = _check_range(p0, start, length)
    return gather_codes(p0.narrow(0, start, length),
                        p1.narrow(0, start, length), cols, n_out)


def gt_pair_idx_range(p0: torch.Tensor, p1: torch.Tensor, cols: torch.Tensor,
                      start: int, length: int) -> torch.Tensor:
    """Diploid GT cell indices over the row slice [start, start+length):
    ``cols`` holds each sample's two haplotype columns in turn, and the
    result is (length, len(cols) // 2) uint8 ``code(hap0) << 2 | code(hap1)``,
    the index into the 16-entry text-cell table."""
    sub = gather_codes_range(p0, p1, cols, start, length, int(cols.shape[0]))
    return (sub[:, 0::2] << 2) | sub[:, 1::2]


def counts_to_numpy(counts: torch.Tensor) -> np.ndarray:
    """The counts on the host: on a CUDA tensor, the wait for the pass and
    its copy back (a ``count.readback`` span)."""
    with span("count.readback", bytes=counts.numel() * counts.element_size()):
        return counts.cpu().numpy()


_STAGE_BYTES = 64 << 20


def planes_to_torch(plane: np.ndarray, device: torch.device) -> torch.Tensor:
    """A (rows, words) uint32 array (planes or masks; memory-mapped or not)
    as an int32 tensor on ``device`` holding the same bits.

    The source is never handed to ``torch.from_numpy`` (a read-only memmap
    would warn): CPU targets get a copy; CUDA targets are filled through two
    pinned staging buffers, so the host copy of one chunk overlaps the DMA of
    the previous one."""
    src = np.asarray(plane).view(np.int32)
    if src.ndim != 2:
        raise ValueError(f"expected a 2-D array, got shape {src.shape}")
    device = torch.device(device)
    if device.type != "cuda":
        return torch.from_numpy(np.array(src, copy=True)).to(device)
    rows, words = src.shape
    dst = torch.empty((rows, words), dtype=torch.int32, device=device)
    step = max(1, _STAGE_BYTES // max(words * 4, 1))
    if rows == 0:
        return dst
    bufs = [torch.empty((min(step, rows), words), dtype=torch.int32,
                        pin_memory=True) for _ in range(2)]
    done = [None, None]
    with torch.cuda.device(device):
        for i, lo in enumerate(range(0, rows, step)):
            n = min(step, rows - lo)
            k = i % 2
            if done[k] is not None:
                done[k].synchronize()  # its previous DMA has drained
            bufs[k][:n].numpy()[:] = src[lo: lo + n]
            dst[lo: lo + n].copy_(bufs[k][:n], non_blocking=True)
            done[k] = torch.cuda.Event()
            done[k].record()
        torch.cuda.current_stream().synchronize()
    return dst
