"""bgt_tpu_torch.ops.decode (the PBWT scan) against bgt_tpu.ops.decode.

The same PBF files, written from numpy-seeded codes, go through the port's
plain PyTorch decode (CPU tensors) and ``bgt_tpu``'s ``lax.scan`` on
JAX-CPU.  Rows are uint8 and permutations int32: every comparison is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bgt_tpu.ops import decode as jax_decode
from bgt_tpu_torch import testing
from bgt_tpu_torch.formats.pbf import PbfReader
from bgt_tpu_torch.ops import decode
from bgt_tpu_torch.query import importer

CPU = torch.device("cpu")


def _pbf(tmp_path, n_rows, m, shift, seed):
    path = str(tmp_path / f"d{n_rows}x{m}.pbf")
    codes = testing.pbwt_codes(n_rows, m, seed)
    testing.write_pbf(path, codes, shift)
    return path, codes


def _reader_codes(path, n_rows=None):
    """The port's host codec, row by row: (rows, m) codes."""
    out = []
    with PbfReader(path) as pb:
        while n_rows is None or len(out) < n_rows:
            row = pb.read_row()
            if row is None:
                break
            out.append((row[1] << 1) | row[0])
        m = pb.m
    return np.array(out, np.uint8).reshape(-1, m)


# (rows, m, shift): one or several blocks; m below, at and past one 32-bit
# word, and not a multiple of 32; rows = 1; blocks of 17 and 16 rows
BLOCKS = [(1, 1, 4), (17, 31, 5), (20, 32, 4), (40, 33, 4), (1, 90, 4),
          (70, 90, 4), (33, 1025, 5)]


@pytest.mark.parametrize("rows,m,shift", BLOCKS,
                         ids=[f"{r}x{m}s{s}" for r, m, s in BLOCKS])
def test_decode_block_matches_jax(tmp_path, rows, m, shift):
    """Each block of each plane: the port's decode_block (CPU: the plain
    version) equals bgt_tpu's in its rows and its final S."""
    path, codes = _pbf(tmp_path, rows, m, shift, seed=rows * m)
    n = 0
    for blk in decode.read_blocks(path):
        for gi in range(2):
            lens, bits = decode.pack_block(blk.rle[gi], m, device=CPU)
            got, S = decode.decode_block(torch.from_numpy(blk.S[gi]), lens,
                                         bits, m)
            jl, jb = jax_decode.pack_block(blk.rle[gi], m)
            want, jS = jax_decode.decode_block(jnp.asarray(blk.S[gi]), jl, jb, m)
            assert got.dtype == torch.uint8 and S.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            np.testing.assert_array_equal(S.numpy(), np.asarray(jS))
            np.testing.assert_array_equal(
                got.numpy(), (codes[blk.row0: blk.row0 + blk.n_rows] >> gi) & 1)
        n += blk.n_rows
    assert n == rows


@pytest.mark.parametrize("m", [1, 33, 90])
def test_pack_block_matches_jax(tmp_path, m):
    path, _codes = _pbf(tmp_path, 40, m, 4, seed=m)
    for blk in decode.read_blocks(path):
        for gi in range(2):
            lens, bits = decode.pack_block(blk.rle[gi], m, device=CPU)
            jl, jb = jax_decode.pack_block(blk.rle[gi], m)
            assert lens.dtype == bits.dtype == torch.int32
            np.testing.assert_array_equal(lens.numpy(), np.asarray(jl))
            np.testing.assert_array_equal(bits.numpy(), np.asarray(jb))
    lens, bits = decode.pack_block([], m, device=CPU)
    assert lens.shape == bits.shape == (0, 1)


def test_pack_block_defaults_to_cuda(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.Tensor, "to",
                        lambda self, device: seen.append(device) or self)
    decode.pack_block([b"\x03"], 1)
    assert seen == [torch.device("cuda")] * 2


def test_degenerate_and_long_runs_keep_s(tmp_path):
    """All-zero and all-one rows leave S as it was; runs of 16 and more
    (several RLE bytes each) and padding runs decode as bgt_tpu's."""
    m = 90
    codes = np.zeros((6, m), np.uint8)
    codes[1] = 3
    codes[2, :40] = 1
    codes[3, ::7] = 2
    codes[4] = 1
    testing.write_pbf(str(tmp_path / "x.pbf"), codes, 4)
    blk = next(decode.read_blocks(str(tmp_path / "x.pbf")))
    assert max(len(r) for r in blk.rle[0]) > 1  # multi-byte runs
    for gi in range(2):
        lens, bits = decode.pack_block(blk.rle[gi], m, device=CPU)
        assert (lens == 0).any()  # padding runs
        S0 = torch.from_numpy(blk.S[gi])
        for r in (0, 1, 4):  # constant rows of both planes
            _rows, S = decode.decode_block(S0, lens[r: r + 1], bits[r: r + 1], m)
            assert torch.equal(S, S0)
        got, S = decode.decode_block(S0, lens, bits, m)
        jl, jb = jax_decode.pack_block(blk.rle[gi], m)
        want, jS = jax_decode.decode_block(jnp.asarray(blk.S[gi]), jl, jb, m)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(S.numpy(), np.asarray(jS))
        np.testing.assert_array_equal(got.numpy(), (codes >> gi) & 1)


@pytest.mark.parametrize("max_rows", [None, 0, 1, 16, 23, 70, 100])
def test_decode_pbf_matches_jax(tmp_path, max_rows):
    """The PBF of bgt_tpu's own decode test (70 x 90, a checkpoint every
    16 rows, degenerate rows 10 and 11), whole and cut mid-block."""
    rng = np.random.default_rng(77)
    codes = rng.choice(4, size=(70, 90), p=[0.55, 0.3, 0.05, 0.1]).astype(np.uint8)
    codes[10] = 0
    codes[11] = 1
    path = str(tmp_path / "t.pbf")
    testing.write_pbf(path, codes, 4)
    got = decode.decode_pbf_on_device(path, max_rows, device="cpu")
    want = jax_decode.decode_pbf_on_device(path, max_rows)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, codes[:max_rows])
    np.testing.assert_array_equal(got, _reader_codes(path, max_rows))


@pytest.fixture(scope="module")
def imported_pbf(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torchdecodedb")
    (tmp / "in.vcf").write_text(testing.random_vcf(n_samples=60, n_sites=300,
                                                   seed=7))
    importer.import_vcf(str(tmp / "db"), [str(tmp / "in.vcf")], is_vcf=True)
    return str(tmp / "db.pbf")


@pytest.mark.parametrize("max_rows", [None, 150, 1])
def test_decode_imported_database(imported_pbf, max_rows):
    """An imported database's PBF (one 8,192-row block, cut mid-block)."""
    got = decode.decode_pbf_on_device(imported_pbf, max_rows, device="cpu")
    want = jax_decode.decode_pbf_on_device(imported_pbf, max_rows)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _reader_codes(imported_pbf, max_rows))
    with PbfReader(imported_pbf) as pb:
        assert got.shape == (min(max_rows or pb.n, pb.n), pb.m)


def test_iter_block_codes_final_s_is_next_checkpoint(tmp_path):
    path, codes = _pbf(tmp_path, 75, 45, 4, seed=3)
    blocks = list(decode.iter_block_codes(path, device="cpu"))
    assert [b.row0 for b in blocks] == [0, 16, 32, 48, 64]
    for b, nxt in zip(blocks, blocks[1:]):
        np.testing.assert_array_equal(b.S_final.numpy(), nxt.S0)
    for b in blocks:
        np.testing.assert_array_equal(b.codes.numpy(),
                                      codes[b.row0: b.row0 + b.codes.shape[0]])


def _scans(tmp_path, m, rows, seed):
    """Padded runs of one scan per entry of ``rows`` (plane 0 of a block of
    that many rows), padded to one max_runs: (S0s, lens, bits, per-scan
    padded arrays)."""
    S0s, per = [], []
    for i, n in enumerate(rows):
        path, _codes = _pbf(tmp_path, max(n, 1), m, 8, seed=seed + i)
        blk = next(decode.read_blocks(path))
        lens, bits = decode.pack_block(blk.rle[0][:n], m, device=CPU)
        S0s.append(blk.S[0])
        per.append((lens, bits))
    width = max(lens.shape[1] for lens, _ in per)
    pad = [[torch.nn.functional.pad(t, (0, width - t.shape[1])) for t in p]
           for p in per]
    return (torch.from_numpy(np.stack(S0s)), torch.cat([p[0] for p in pad]),
            torch.cat([p[1] for p in pad]), per)


@pytest.mark.parametrize("rows", [[3, 0, 17, 1], [64], [0, 0]])
def test_decode_blocks_equals_per_block_calls(tmp_path, rows):
    m = 77
    S0s, lens, bits, per = _scans(tmp_path, m, rows, seed=11)
    got, S = decode.decode_blocks(S0s, lens, bits, rows, m)
    assert got.shape == (sum(rows), m) and S.shape == (len(rows), m)
    lo = 0
    for k, (ln, bt) in enumerate(per):
        want, wS = decode.decode_block(S0s[k], ln, bt, m)
        assert torch.equal(got[lo: lo + rows[k]], want)
        assert torch.equal(S[k], wS)
        lo += rows[k]
    assert torch.equal(S[[k for k, n in enumerate(rows) if n == 0]],
                       S0s[[k for k, n in enumerate(rows) if n == 0]])


def test_csr_runs_equal_padded_runs(tmp_path):
    """The RLE-byte form of a batch decodes as its padded form."""
    path, _codes = _pbf(tmp_path, 50, 70, 4, seed=9)
    blocks = list(decode.read_blocks(path))
    batch = decode.pack_csr(np.concatenate([b.S for b in blocks]),
                            [r for b in blocks for r in b.rle], 70, device=CPU)
    got, S = decode.decode_csr(batch)
    assert batch.rows_per_scan == [16, 16, 16, 16, 16, 16, 2, 2]
    lo = 0
    for k, rle_rows in enumerate(r for b in blocks for r in b.rle):
        lens, bits = decode.pack_block(rle_rows, 70, device=CPU)
        want, wS = decode.decode_block(batch.S0s[k], lens, bits, 70)
        assert torch.equal(got[lo: lo + len(rle_rows)], want)
        assert torch.equal(S[k], wS)
        lo += len(rle_rows)


# ---------------------------------------------------------------------------
# Kernel D's algorithm, emulated in numpy on the CPU
# ---------------------------------------------------------------------------

def _row_y(lens, bits, m):
    """One row's y as every block of kernel D builds it: (y as 32-bit words,
    the ones before each word, the row's zeros).  A run with a nonzero
    length, a start in [0, m) and a bit unlike the previous run's flips its
    start bit; y is the prefix XOR of the flips, inside a word by shifts,
    across words by the exclusive XOR of the words' parities."""
    W = (m + 31) // 32
    starts = np.cumsum(lens) - lens
    prev = np.concatenate([[0], bits[:-1]])
    flips = (lens > 0) & (bits != prev) & (starts >= 0) & (starts < m)
    t = np.zeros(W, np.uint32)
    np.bitwise_xor.at(t, starts[flips] >> 5,
                      (1 << (starts[flips] & 31)).astype(np.uint32))
    x = t.copy()
    for sh in (1, 2, 4, 8, 16):
        x ^= x << np.uint32(sh)
    par = np.bitwise_count(t) & 1
    x ^= np.where((np.bitwise_xor.accumulate(par) ^ par) == 1,
                  np.uint32(0xFFFFFFFF), np.uint32(0))
    if m % 32:
        x[-1] &= np.uint32((1 << (m % 32)) - 1)
    ones = np.bitwise_count(x).astype(np.int64)
    return x.astype(np.int64), np.cumsum(ones) - ones, m - int(ones.sum())


def _kernel_d_emulation(S0, runs, m, blocks_per_scan):
    """Kernel D's inverse-form, sliced algorithm in numpy: the haplotypes
    cut into slices of L (``blocks_per_scan`` rounded to a multiple of 16,
    C = ceil(m / L) slices), each carrying its own ranks P = S0^-1 alone
    through every row (``runs``: each row's (lens, bits) int64 arrays) from
    that row's y, then writing its part of the final S from P.  Returns
    ((rows, m) uint8, final S int32, C)."""
    L = -(-m // blocks_per_scan)
    L = -(-L // 16) * 16
    C = -(-m // L)
    ys = [_row_y(lens, bits, m) for lens, bits in runs]
    out = np.zeros((len(runs), m), np.uint8)
    S_final = np.full(m, -1, np.int64)
    for c in range(C):
        lo, hi = c * L, min(m, (c + 1) * L)
        mine = (S0 >= lo) & (S0 < hi)
        P = np.zeros(hi - lo, np.int64)
        P[S0[mine] - lo] = np.flatnonzero(mine)
        for r, (words, ones_before, n0) in enumerate(ys):
            word, b = words[P >> 5], P & 31
            y = (word >> b) & 1
            o = ones_before[P >> 5] + np.bitwise_count(word & ((1 << b) - 1))
            out[r, lo:hi] = y
            P = np.where(y == 1, n0 + o, P - o)
        S_final[P] = np.arange(lo, hi)
    return out, S_final.astype(np.int32), C


def _rle_runs(rle_rows):
    """Each row's runs as the kernel decodes the RLE bytes (no padding)."""
    out = []
    for row in rle_rows:
        v = np.frombuffer(row, np.uint8).astype(np.int64)
        t = v >> 1
        out.append(((t & 15) << (4 * (t >> 4)), v & 1))
    return out


EMU_M = [1, 15, 33, 777, 1025]
EMU_SPLITS = [1, 3, 7, "max"]  # "max": ceil(m / 16), slices of 16


@pytest.fixture(scope="module")
def emu_block(tmp_path_factory):
    """m -> (block 0's S record, each plane's RLE rows, each plane's plain
    and bgt_tpu decode); random rows of every code, then the degenerate and
    long-run rows of test_degenerate_and_long_runs_keep_s at width m."""
    tmp = tmp_path_factory.mktemp("emu")
    cache = {}

    def get(m):
        if m not in cache:
            extra = np.zeros((5, m), np.uint8)
            extra[1] = 3
            extra[2, : max(1, 4 * m // 9)] = 1
            extra[3, ::7] = 2
            extra[4] = 1
            codes = np.concatenate([testing.pbwt_codes(21, m, seed=m), extra])
            path = str(tmp / f"e{m}.pbf")
            testing.write_pbf(path, codes, 8)
            blk = next(decode.read_blocks(path))
            wants = []
            for gi in range(2):
                lens, bits = decode.pack_block(blk.rle[gi], m, device=CPU)
                got, S = decode.decode_block_reference(
                    torch.from_numpy(blk.S[gi]), lens, bits, m)
                jl, jb = jax_decode.pack_block(blk.rle[gi], m)
                jw, jS = jax_decode.decode_block(jnp.asarray(blk.S[gi]), jl, jb, m)
                np.testing.assert_array_equal(got.numpy(), np.asarray(jw))
                np.testing.assert_array_equal(S.numpy(), np.asarray(jS))
                np.testing.assert_array_equal(got.numpy(), (codes >> gi) & 1)
                wants.append((lens.numpy().astype(np.int64),
                               bits.numpy().astype(np.int64),
                               got.numpy(), S.numpy()))
            cache[m] = blk, wants
        return cache[m]
    return get


@pytest.mark.parametrize("source", ["padded", "bytes"])
@pytest.mark.parametrize("split", EMU_SPLITS)
@pytest.mark.parametrize("m", EMU_M)
def test_kernel_d_algorithm_matches_plain(emu_block, m, split, source):
    """The inverse form, cut into slices, gives byte for byte the rows and
    the final S of the plain version (the S-form recurrence) and of
    bgt_tpu's decode_block on JAX-CPU, on padded runs and on RLE bytes."""
    blk, wants = emu_block(m)
    blocks_per_scan = -(-m // 16) if split == "max" else split
    for gi, (lens, bits, want, want_S) in enumerate(wants):
        runs = (list(zip(lens, bits)) if source == "padded"
                else _rle_runs(blk.rle[gi]))
        got, S, C = _kernel_d_emulation(blk.S[gi].astype(np.int64), runs, m,
                                        blocks_per_scan)
        assert C <= blocks_per_scan and (C - 1) * 16 < m
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(S, want_S)


def test_decode_rejects_bad_inputs():
    S0 = torch.arange(8, dtype=torch.int32)
    lens = torch.full((2, 1), 8, dtype=torch.int32)
    bits = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        decode.decode_block(S0, lens.long(), bits, 8)
    with pytest.raises(ValueError, match="shape"):
        decode.decode_block(S0, lens, bits[:, :0], 8)
    with pytest.raises(ValueError, match="rows_per_scan"):
        decode.decode_blocks(S0[None], lens, bits, [1], 8)
    for bad in (-1, 1.5, True):
        with pytest.raises(ValueError, match="blocks_per_scan"):
            decode.decode_blocks(S0[None], lens, bits, [2], 8,
                                 blocks_per_scan=bad)


def test_decode_rejects_one_plane_pbf(tmp_path):
    from bgt_tpu_torch.formats.pbf import PbfWriter
    with PbfWriter(str(tmp_path / "g1.pbf"), 4, 1, 2) as w:
        w.write_row([np.array([0, 1, 1, 0], np.uint8)])
    with pytest.raises(ValueError, match="2-plane"):
        decode.decode_pbf_on_device(str(tmp_path / "g1.pbf"), device="cpu")
