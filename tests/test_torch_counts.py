"""bgt_tpu_torch.ops.counts against bgt_tpu's count ops.

The same numpy-seeded planes and masks go through the port's plain PyTorch
counts (CPU tensors), ``bgt_tpu.ops.counts`` (its jnp formulation on
JAX-CPU; the Pallas kernel is TPU-gated, as in the JAX package's own tests)
and the host popcount tier (the port's ``fastpath.host_counts`` on its own
``TileStore``, held equal to ``bgt_tpu``'s).  Counts are integers: the
tolerance is 0.
"""

import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bgt_tpu.ops import counts as jax_counts
from bgt_tpu.ops.tiles import TileStore as JaxTileStore
from bgt_tpu.query.fastpath import host_counts as jax_host_counts
from bgt_tpu_torch.ops import counts
from bgt_tpu_torch.ops.tiles import TileStore
from bgt_tpu_torch.query.fastpath import host_counts

CPU = torch.device("cpu")


def _words(rng, shape):
    """uint32 words, with all-ones and sign-bit-only words mixed in."""
    w = rng.integers(0, 2**32, shape, dtype=np.uint32)
    flat = w.reshape(-1)
    flat[0::5] = 0xFFFFFFFF
    flat[1::7] = 0x80000000
    return w


def _inputs(rows, words, groups, seed):
    rng = np.random.default_rng(seed)
    return (_words(rng, (rows, words)), _words(rng, (rows, words)),
            _words(rng, (groups, words)))


def _port(p0, p1, masks):
    return counts.counts_to_numpy(counts.count_codes(
        counts.planes_to_torch(p0, CPU), counts.planes_to_torch(p1, CPU),
        counts.planes_to_torch(masks, CPU)))


# (rows, words, groups): ragged row counts, 0 and 1 rows, 1/8/33 groups,
# widths 1, 157 (1kg), 1024 and 2031 (HRC)
SHAPES = [(0, 157, 1), (1, 2031, 1), (1, 1, 8), (37, 157, 8), (300, 1, 33),
          (129, 1024, 33), (13, 2031, 33), (517, 1024, 1)]


@pytest.mark.parametrize("rows,words,groups", SHAPES,
                         ids=[f"{r}x{w}x{g}" for r, w, g in SHAPES])
def test_count_codes_matches_jax_and_host(rows, words, groups):
    p0, p1, masks = _inputs(rows, words, groups, seed=rows * 7 + words + groups)
    got = _port(p0, p1, masks)
    assert got.dtype == np.int32 and got.shape == (rows, groups, 4)
    want_jax = np.asarray(jax_counts.count_codes(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(masks)))
    np.testing.assert_array_equal(got, want_jax)
    ts = TileStore(rows, words * 32, p0, p1)
    want_host = host_counts(ts, np.arange(rows, dtype=np.int64), masks)
    np.testing.assert_array_equal(want_host, jax_host_counts(
        JaxTileStore(rows, words * 32, p0, p1),
        np.arange(rows, dtype=np.int64), masks))
    np.testing.assert_array_equal(got, want_host)


def test_count_codes_high_bit_words():
    """Words whose sign bit is set: the int32 arithmetic shift must not leak
    into the popcount."""
    p0 = np.array([[0xFFFFFFFF, 0x80000000, 0x80000001, 0xAAAAAAAA]],
                  dtype=np.uint32)
    p1 = np.array([[0x80000000, 0xFFFFFFFF, 0x00000001, 0x55555555]],
                  dtype=np.uint32)
    masks = np.array([[0xFFFFFFFF] * 4, [0x80000000] * 4], dtype=np.uint32)
    got = _port(p0, p1, masks)
    want = np.asarray(jax_counts.count_codes(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(masks)))
    np.testing.assert_array_equal(got, want)
    # mask 1 selects bit 31 of each word: codes (p1 << 1 | p0) 3, 3, 1, 1
    np.testing.assert_array_equal(got[0, 1], [0, 2, 0, 2])


def test_popcount32_every_bit():
    x = np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0xF0F0F0F0,
                  0x12345678], dtype=np.uint32)
    got = counts._popcount32(torch.from_numpy(x.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, np.bitwise_count(x).astype(np.int32))


@pytest.mark.parametrize("start,length", [(0, 200), (17, 100), (101, 99),
                                          (199, 1), (50, 0)])
def test_count_codes_range_offsets(start, length):
    p0, p1, masks = _inputs(200, 157, 5, seed=3)
    got = counts.count_codes_range(
        counts.planes_to_torch(p0, CPU), counts.planes_to_torch(p1, CPU),
        counts.planes_to_torch(masks, CPU), start, length)
    want = np.asarray(jax_counts.count_codes_range(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(masks), start, length))
    assert got.shape == (length, 5, 4)
    np.testing.assert_array_equal(counts.counts_to_numpy(got), want)


def test_count_codes_range_rejects_out_of_bounds():
    t = torch.zeros((10, 4), dtype=torch.int32)
    m = torch.zeros((1, 4), dtype=torch.int32)
    for start, length in ((8, 3), (-1, 2), (0, -1)):
        with pytest.raises(ValueError):
            counts.count_codes_range(t, t, m, start, length)


def test_count_codes_rejects_bad_inputs():
    t = torch.zeros((10, 4), dtype=torch.int32)
    m = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(TypeError):
        counts.count_codes(t.to(torch.int64), t, m)
    with pytest.raises(ValueError):
        counts.count_codes(t, t[:, :3], m)
    with pytest.raises(ValueError):
        counts.count_codes(t, t, torch.zeros((1, 5), dtype=torch.int32))
    meta = torch.empty((10, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no count kernel"):
        counts.count_codes(meta, meta, m.to("meta"))


@pytest.mark.parametrize("groups", [1, 3])
def test_site_stats_matches_jax(groups):
    p0, p1, masks = _inputs(64, 157, groups, seed=groups)
    c = counts.count_codes(counts.planes_to_torch(p0, CPU),
                           counts.planes_to_torch(p1, CPU),
                           counts.planes_to_torch(masks, CPU))
    got = counts.site_stats(c)
    want = jax_counts.site_stats(jnp.asarray(counts.counts_to_numpy(c)))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(counts.counts_to_numpy(got[key]),
                                      np.asarray(want[key]), err_msg=key)


def test_planes_to_torch_round_trip(tmp_path):
    rng = np.random.default_rng(5)
    plane = _words(rng, (33, 157))
    t = counts.planes_to_torch(plane, CPU)
    assert t.dtype == torch.int32 and t.shape == plane.shape
    np.testing.assert_array_equal(t.numpy().view(np.uint32), plane)
    # a read-only memmap (how tile stores hold their planes): copied, and
    # torch does not warn about a non-writable array
    path = tmp_path / "plane.bin"
    plane.tofile(path)
    mm = np.memmap(path, dtype=np.uint32, mode="r", shape=plane.shape)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        t2 = counts.planes_to_torch(mm, CPU)
    np.testing.assert_array_equal(t2.numpy().view(np.uint32), plane)
    t2[0, 0] = 0  # the tensor owns its memory
    assert mm[0, 0] == plane[0, 0]
    masks = counts.planes_to_torch(plane[:2, :], CPU)
    np.testing.assert_array_equal(masks.numpy().view(np.uint32), plane[:2])
    with pytest.raises(ValueError):
        counts.planes_to_torch(plane[0], CPU)



def _planes(rows, words, seed):
    p0, p1, _m = _inputs(rows, words, 1, seed)
    return p0, p1, counts.planes_to_torch(p0, CPU), counts.planes_to_torch(p1, CPU)


# (rows, words): one word, the 1kg width, a ragged width, the HRC width
DECODE_SHAPES = [(3, 1), (17, 157), (9, 61), (2, 2031), (0, 5)]


@pytest.mark.parametrize("rows,words", DECODE_SHAPES,
                         ids=[f"{r}x{w}" for r, w in DECODE_SHAPES])
def test_decode_codes_matches_jax(rows, words):
    p0, p1, t0, t1 = _planes(rows, words, seed=rows * 11 + words)
    got = counts.decode_codes(t0, t1)
    assert got.dtype == torch.uint8 and got.shape == (rows, words * 32)
    if rows:  # the JAX op cannot reshape zero rows
        want = np.asarray(jax_counts.decode_codes(jnp.asarray(p0),
                                                  jnp.asarray(p1)))
        np.testing.assert_array_equal(got.numpy(), want)
    # and a numpy unpack of the same bits
    b0 = np.unpackbits(p0.view(np.uint8), axis=1, bitorder="little")
    b1 = np.unpackbits(p1.view(np.uint8), axis=1, bitorder="little")
    np.testing.assert_array_equal(got.numpy(), (b1 << 1) | b0)


def test_decode_codes_high_bits():
    p0 = np.array([[0xFFFFFFFF, 0x80000000]], dtype=np.uint32)
    p1 = np.array([[0x80000000, 0x80000000]], dtype=np.uint32)
    got = counts.decode_codes(counts.planes_to_torch(p0, CPU),
                              counts.planes_to_torch(p1, CPU)).numpy()[0]
    assert list(got[:31]) == [1] * 31 and got[31] == 3
    assert list(got[32:63]) == [0] * 31 and got[63] == 3


# (rows, words, start, length, n_cols): offsets, ragged widths, empty ranges
GATHER_CASES = [(40, 157, 0, 40, 50), (40, 157, 13, 20, 7), (33, 61, 32, 1, 64),
                (12, 2031, 5, 6, 300), (8, 3, 8, 0, 4), (8, 3, 2, 5, 0)]


@pytest.mark.parametrize("rows,words,start,length,n", GATHER_CASES,
                         ids=[f"{r}x{w}@{s}+{l}:{n}"
                              for r, w, s, l, n in GATHER_CASES])
def test_gather_ops_match_jax(rows, words, start, length, n):
    p0, p1, t0, t1 = _planes(rows, words, seed=rows + words + n)
    rng = np.random.default_rng(n)
    cols = rng.integers(0, words * 32, n).astype(np.int32)
    if n:
        cols[0] = words * 32 - 1  # the last column of the last word
    j0, j1, jc = jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(cols)
    tc = torch.from_numpy(cols)
    whole = counts.gather_codes(t0, t1, tc, n)
    assert whole.dtype == torch.uint8 and whole.shape == (rows, n)
    np.testing.assert_array_equal(
        whole.numpy(), np.asarray(jax_counts.gather_codes(j0, j1, jc, n)))
    got = counts.gather_codes_range(t0, t1, tc, start, length, n)
    assert got.shape == (length, n)
    np.testing.assert_array_equal(got.numpy(), whole.numpy()[start:start + length])
    even = n - n % 2
    pairs = counts.gt_pair_idx_range(t0, t1, tc[:even], start, length)
    assert pairs.dtype == torch.uint8 and pairs.shape == (length, even // 2)
    if length:  # the JAX ops cannot reshape zero rows
        np.testing.assert_array_equal(got.numpy(), np.asarray(
            jax_counts.gather_codes_range(j0, j1, jc, start, length, n)))
        np.testing.assert_array_equal(pairs.numpy(), np.asarray(
            jax_counts.gt_pair_idx_range(j0, j1, jc[:even], start, length)))


def test_gather_ops_reject_bad_inputs():
    _p0, _p1, t0, t1 = _planes(4, 2, seed=0)
    for cols in ([64], [-1]):
        with pytest.raises(ValueError, match="outside"):
            counts.gather_codes(t0, t1, torch.tensor(cols), 1)
    with pytest.raises(ValueError, match="shape"):
        counts.gather_codes(t0, t1, torch.tensor([1, 2]), 3)
    with pytest.raises(ValueError):
        counts.gather_codes_range(t0, t1, torch.tensor([1]), 3, 2, 1)
    with pytest.raises(TypeError):
        counts.decode_codes(t0.to(torch.int64), t1)


def test_launch_counter_is_locked():
    """Concurrent launches from many threads lose no count."""
    import sys
    import threading
    before = counts.LAUNCHES["count_raw"]
    n_threads, per = 16, 2000

    def work():
        for _ in range(per):
            counts._count_launch("count_raw")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert counts.LAUNCHES["count_raw"] - before == n_threads * per
    counts.LAUNCHES["count_raw"] = before


@pytest.mark.parametrize("rows,words,groups,out_ints,ms", [
    (1_000_000, 2031, 1, 4, 4.855), (1_000_000, 2031, 33, 4, 5.008),
    (30000, 2048, 1, 3, 0.1468), (105730, 157, 32, 4, 0.0558)])
def test_count_bound_ms(rows, words, groups, out_ints, ms):
    """The bound chip_smoke prints: the bytes (planes and masks read once,
    counts written once, at 3.35 TB/s) alone, at every group count; the
    CUDA-core logic time (3 ANDs per word per group at 132 SMs x 64 per
    clock) is a separate diagnostic."""
    from bgt_tpu_torch.tools.measure import count_bound_ms, cuda_core_logic_ms
    bound = count_bound_ms(rows, words, groups, out_ints)
    nbytes = (2 * rows + groups) * words * 4 + rows * groups * out_ints * 4
    assert bound == pytest.approx(nbytes / 3.35e12 * 1e3, rel=1e-12)
    assert bound == pytest.approx(ms, abs=5e-4)
    assert cuda_core_logic_ms(rows, words, groups, 1980.0) == pytest.approx(
        3 * rows * words * groups / (132 * 64 * 1.98e9) * 1e3, rel=1e-12)


def test_chip_smoke_needs_cuda(tmp_path):
    """chip_smoke exits non-zero without a card, with or without a
    baseline kernel to time beside A."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.main([]) == 2
    assert chip_smoke.main(["--baseline", str(tmp_path / "a.cu")]) == 2
