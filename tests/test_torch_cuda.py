"""bgt_tpu_torch's CUDA paths on a card: every test here needs one and skips
without it.  The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

Inputs come from numpy seeds; the kernel is held to its plain PyTorch
version and to ``bgt_tpu``'s host popcount with exact int32 equality.
"""

import numpy as np
import pytest
import torch

from bgt_tpu.ops.tiles import TileStore as JaxTileStore
from bgt_tpu.query.fastpath import host_counts as jax_host_counts
from bgt_tpu_torch.ops import counts
from bgt_tpu_torch.ops.tiles import TileStore
from bgt_tpu_torch.query import fastpath

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(rows, words, groups, seed):
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 2**32, shape, dtype=np.uint32)
           for shape in ((rows, words), (rows, words), (groups, words))]
    for w in out:
        w.reshape(-1)[0::5] = 0xFFFFFFFF
        w.reshape(-1)[1::7] = 0x80000000
    return out


SHAPES = [(0, 157, 1), (1, 2031, 1), (1, 1, 8), (37, 157, 8), (300, 1, 33),
          (129, 1024, 33), (13, 2031, 33), (2048, 1024, 1), (1003, 1024, 33),
          (517, 2048, 8)]


@pytest.mark.parametrize("rows,words,groups", SHAPES,
                         ids=[f"{r}x{w}x{g}" for r, w, g in SHAPES])
def test_kernel_matches_plain_and_host(cuda, rows, words, groups):
    p0, p1, masks = _inputs(rows, words, groups, seed=rows + words)
    d = [counts.planes_to_torch(a, cuda) for a in (p0, p1, masks)]
    before = counts.LAUNCHES["count_codes"]
    got = counts.counts_to_numpy(counts.count_codes(*d))
    assert counts.LAUNCHES["count_codes"] == before + (1 if rows else 0)
    assert got.shape == (rows, groups, 4)
    plain = counts.counts_to_numpy(counts.count_codes_reference(*d))
    np.testing.assert_array_equal(got, plain)
    ts = JaxTileStore(rows, words * 32, p0, p1)
    np.testing.assert_array_equal(
        got, jax_host_counts(ts, np.arange(rows, dtype=np.int64), masks))
    start = rows // 3
    got_r = counts.counts_to_numpy(
        counts.count_codes_range(d[0], d[1], d[2], start, rows - start))
    np.testing.assert_array_equal(got_r, got[start:])


def test_kernel_rejects_non_contiguous(cuda):
    p = torch.zeros((8, 64), dtype=torch.int32, device=cuda)
    m = torch.zeros((1, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        counts.count_codes(p[:, ::2], p[:, ::2], m)


def test_planes_to_torch_staged_chunks(cuda, monkeypatch):
    monkeypatch.setattr(counts, "_STAGE_BYTES", 3 * 157 * 4)  # 3 rows/chunk
    plane = _inputs(50, 157, 1, seed=2)[0]
    t = counts.planes_to_torch(plane, cuda)
    assert t.device.type == "cuda" and t.dtype == torch.int32
    np.testing.assert_array_equal(t.cpu().numpy().view(np.uint32), plane)


@pytest.mark.parametrize("chunk", [7, 512, 100_000])
def test_stream_counts_matches_host(cuda, chunk):
    p0, p1, masks = _inputs(3000, 157, 4, seed=chunk)
    ts = TileStore(3000, 157 * 32, p0, p1)
    rows = np.sort(np.random.default_rng(chunk).choice(3000, 1100,
                                                       replace=False))
    before = counts.LAUNCHES["count_codes"]
    got = fastpath.stream_counts(ts, rows, masks, cuda, chunk_rows=chunk)
    assert counts.LAUNCHES["count_codes"] - before == -(-rows.size // chunk)
    np.testing.assert_array_equal(
        got, jax_host_counts(JaxTileStore(3000, 157 * 32, p0, p1), rows, masks))


A_GROUPS = [1, 2, 7, 8, 9, 16, 32, 33, 600]
A_WORDS = [1, 7, 8, 157, 2031, 2048]


@pytest.mark.parametrize("words", A_WORDS)
@pytest.mark.parametrize("groups", A_GROUPS)
def test_kernel_a_groups_and_words(cuda, groups, words):
    """Kernel A (tensor-core AND-popcount) at every octet boundary and
    pass of groups and at word counts below, at and past its 16- and
    32-word blocks, on a ragged 17-row tile and an offset range."""
    d = [counts.planes_to_torch(a, cuda)
         for a in _inputs(17, words, groups, seed=groups * 7 + words)]
    plain = counts.count_codes_reference(*d)
    assert torch.equal(counts.count_codes(*d), plain)
    got = counts.count_codes_range(d[0], d[1], d[2], 1, 15)
    torch.cuda.synchronize()
    assert torch.equal(got, plain[1:16])


@pytest.mark.parametrize("groups", [1, 8, 33])
@pytest.mark.parametrize("rows", [1, 15, 16, 17, 100_003])
def test_kernel_a_rows(cuda, rows, groups):
    """Row counts below, at and past one 16-row tile, and many tiles with a
    ragged last one, at the HRC width."""
    d = [counts.planes_to_torch(a, cuda)
         for a in _inputs(rows, 2031, groups, seed=rows + groups)]
    got = counts.count_codes(*d)
    torch.cuda.synchronize()
    assert torch.equal(got, counts.count_codes_reference(*d))


@pytest.mark.parametrize("rows,words,groups", [(64, 157, 600), (3, 2031, 1000)],
                         ids=["64x157x600", "3x2031x1000"])
def test_kernel_beyond_512_groups(cuda, rows, words, groups):
    """Kernel A counts groups in passes of 40 per launch: any count works."""
    d = [counts.planes_to_torch(a, cuda)
         for a in _inputs(rows, words, groups, seed=groups)]
    got = counts.count_codes(*d)
    torch.cuda.synchronize()
    assert got.shape == (rows, groups, 4)
    assert torch.equal(got, counts.count_codes_reference(*d))


def _on_card(cuda, arrays):
    return [counts.planes_to_torch(a, cuda) for a in arrays]


# (rows, words): the probe's width, a ragged tile, the 1kg width, one word,
# no rows, a width with no 128-bit loads, a row wider than shared memory
RAW_SHAPES = [(30000, 2048), (256, 2048), (517, 157), (1, 1), (0, 2048),
              (300, 2031), (3, 60000)]


@pytest.mark.parametrize("rows,words", RAW_SHAPES,
                         ids=[f"{r}x{w}" for r, w in RAW_SHAPES])
def test_count_raw_kernel_matches_plain(cuda, rows, words):
    p0, p1, mask = _on_card(cuda, _inputs(rows, words, 1, seed=rows + words))
    before = counts.LAUNCHES["count_raw"]
    got = counts.count_raw(p0, p1, mask)
    assert counts.LAUNCHES["count_raw"] == before + (1 if rows else 0)
    torch.cuda.synchronize()
    assert got.shape == (rows, 3)
    assert torch.equal(got, counts.count_raw_reference(p0, p1, mask))
    start = rows // 3
    got_r = counts.count_raw_range(p0, p1, mask, start, rows - start)
    assert torch.equal(got_r, got[start:])


def test_count_raw_kernel_unaligned_planes(cuda):
    """Planes 4 bytes off a 16-byte boundary take the 32-bit loads."""
    rows, words = 129, 2048
    a, b, mask = _inputs(rows, words, 1, seed=7)
    flat = torch.zeros(2 * rows * words + 1, dtype=torch.int32, device=cuda)
    p0 = flat[1: 1 + rows * words].view(rows, words)
    p1 = flat[1 + rows * words:].view(rows, words)
    p0.copy_(counts.planes_to_torch(a, cuda))
    p1.copy_(counts.planes_to_torch(b, cuda))
    m = counts.planes_to_torch(mask, cuda)
    assert p0.data_ptr() % 16 == 4
    got = counts.count_raw(p0, p1, m)
    assert torch.equal(got, counts.count_raw_reference(p0, p1, m))


# (rows, words, groups): the experiment's shapes (the 1kg width at 1, 8 and
# 32 groups), ragged, one word, 2 and 3 words, the shared-memory limit (the
# path without the ring), a wide row, no rows, no groups; then rows against
# kernel C's 16-row tile, words against its 8-word k-step, groups against
# its octets
NARROW_SHAPES = [(16384, 160, 2), (105730, 157, 1), (105730, 157, 8),
                 (105730, 157, 32), (7, 157, 3), (1, 1, 1),
                 (33, 2, 9), (70, 3, 17), (64, 1816, 32), (1000, 2048, 8),
                 (0, 157, 2), (5, 157, 0),
                 (1, 157, 8), (15, 157, 9), (16, 157, 8), (17, 157, 32),
                 (33, 157, 7),
                 (1000, 7, 9), (1000, 8, 8), (1000, 9, 31), (1000, 17, 32),
                 (1000, 160, 9),
                 (2000, 157, 7), (2000, 157, 8), (2000, 157, 9),
                 (2000, 157, 31), (2000, 157, 32), (1000, 1816, 32)]


def _first_row_edges(arrays):
    """All-ones and sign-bit-only words across the first row of each array,
    as chip_smoke.py's inputs have them."""
    for a in arrays:
        if a.shape[0]:
            a[0, 0::3] = 0xFFFFFFFF
            a[0, 1::3] = 0x80000000
    return arrays


@pytest.mark.parametrize("rows,words,groups", NARROW_SHAPES,
                         ids=[f"{r}x{w}x{g}" for r, w, g in NARROW_SHAPES])
def test_count_narrow_kernel_matches_plain(cuda, rows, words, groups):
    d = _on_card(cuda, _first_row_edges(
        _inputs(rows, words, groups, seed=rows * 3 + groups)))
    before = counts.LAUNCHES["count_codes_narrow"]
    got = counts.count_codes_narrow(*d)
    assert counts.LAUNCHES["count_codes_narrow"] == before + (
        1 if rows and groups else 0)
    torch.cuda.synchronize()
    assert got.shape == (rows, groups, 4)
    assert torch.equal(got, counts.count_codes_reference(*d))
    assert torch.equal(got, counts.count_codes(*d))


@pytest.mark.parametrize("offsets", [(1, 1), (2, 2), (3, 3), (0, 2), (1, 0)],
                         ids=lambda o: f"p0+{o[0]},p1+{o[1]}")
def test_count_narrow_kernel_unaligned_planes(cuda, offsets):
    """Planes that start a few words past a 16-byte boundary: where a later
    row starts both planes' 16-row tiles on one, kernel C counts the rows
    before it from global memory and the rest through its ring; where none
    does (p0 and p1 off by different amounts), every tile from global
    memory."""
    rows, words = 1000, 157
    a, b, masks = _first_row_edges(_inputs(rows, words, 32, seed=11))
    flat = torch.zeros(2 * (rows * words + 4), dtype=torch.int32, device=cuda)
    planes = []
    for i, (arr, off) in enumerate(zip((a, b), offsets)):
        lo = i * (rows * words + 4) + off
        p = flat[lo: lo + rows * words].view(rows, words)
        p.copy_(counts.planes_to_torch(arr, cuda))
        planes.append(p)
    assert planes[0].data_ptr() % 16 == 4 * offsets[0]
    m = counts.planes_to_torch(masks, cuda)
    got = counts.count_codes_narrow(planes[0], planes[1], m)
    torch.cuda.synchronize()
    assert torch.equal(got, counts.count_codes_reference(planes[0], planes[1], m))


@pytest.mark.parametrize("groups,words", [(33, 157), (32, 2048)])
def test_count_narrow_kernel_rejects_outside_limits(cuda, groups, words):
    p = torch.zeros((4, words), dtype=torch.int32, device=cuda)
    m = torch.zeros((groups, words), dtype=torch.int32, device=cuda)
    before = counts.LAUNCHES["count_codes_narrow"]
    with pytest.raises(ValueError):
        counts.count_codes_narrow(p, p, m)
    assert counts.LAUNCHES["count_codes_narrow"] == before


def _unpack(p0, p1):
    """numpy codes bit(p1) << 1 | bit(p0), column c from bit c % 32 of word
    c // 32."""
    b0 = np.unpackbits(p0.view(np.uint8), axis=1, bitorder="little")
    b1 = np.unpackbits(p1.view(np.uint8), axis=1, bitorder="little")
    return (b1 << 1) | b0


# (rows, words, start, length): the HRC width, a ragged width, offset ranges
DECODE_CASES = [(64, 2031, 0, 64), (300, 157, 17, 200), (33, 61, 32, 1),
                (5, 1, 0, 5)]


@pytest.mark.parametrize("rows,words,start,length", DECODE_CASES,
                         ids=[f"{r}x{w}@{s}+{n}" for r, w, s, n in DECODE_CASES])
def test_decode_ops_on_card_match_numpy(cuda, rows, words, start, length):
    p0, p1, _m = _inputs(rows, words, 1, seed=rows + words)
    t0, t1 = _on_card(cuda, (p0, p1))
    want = _unpack(p0, p1)
    got = counts.decode_codes(t0, t1)
    assert got.device.type == "cuda" and got.dtype == torch.uint8
    np.testing.assert_array_equal(got.cpu().numpy(), want)
    rng = np.random.default_rng(words)
    cols = rng.integers(0, words * 32, 2 * 97).astype(np.int64)
    cols[0] = words * 32 - 1
    tc = torch.from_numpy(cols).to(cuda)
    sub = want[start:start + length][:, cols]
    got = counts.gather_codes_range(t0, t1, tc, start, length, cols.size)
    np.testing.assert_array_equal(got.cpu().numpy(), sub)
    pairs = counts.gt_pair_idx_range(t0, t1, tc, start, length)
    np.testing.assert_array_equal(pairs.cpu().numpy(),
                                  (sub[:, 0::2] << 2) | sub[:, 1::2])


def test_server_request_on_card_matches_host(cuda, tmp_path, monkeypatch):
    """One subset request to the port's server on the card equals
    bgt_tpu's server on its host tier, and kernel A ran for it.  Each server
    gets its own package's ServerConfig and BgtFile."""
    import threading
    import urllib.request

    from bgt_tpu.query import fastpath as jax_fastpath
    from bgt_tpu.query.engine import BgtFile as JaxBgtFile
    from bgt_tpu.server import server as jax_server
    from bgt_tpu_torch import testing
    from bgt_tpu_torch.query import importer
    from bgt_tpu_torch.query.engine import BgtFile
    from bgt_tpu_torch.server import server

    (tmp_path / "in.vcf").write_text(
        testing.random_vcf(n_samples=40, n_sites=300, seed=3))
    importer.import_vcf(str(tmp_path / "db"), [str(tmp_path / "in.vcf")],
                        is_vcf=True)
    (tmp_path / "db.spl").write_text(testing.random_spl(40, seed=3))
    jax_cfg = jax_server.ServerConfig()
    jax_cfg.port = 0
    jax_cfg.files = [JaxBgtFile(str(tmp_path / "db"))]
    jax_cfg.prefixes = ["db"]
    cfg = server.ServerConfig()
    cfg.port = 0
    cfg.files = [BgtFile(str(tmp_path / "db"))]
    cfg.prefixes = ["db"]
    servers = [jax_server.make_server(jax_cfg), server.make_server(cfg, cuda)]
    for s in servers:
        threading.Thread(target=s.serve_forever, daemon=True).start()
    query = '?s=population=="YRI"&s=,S0001,S0002&f=AC1>AC2&C='
    try:
        bodies = []
        for s, tier in zip(servers, ("host", "device")):
            monkeypatch.setenv("BGT_TPU_COUNT_TIER", tier)
            jax_fastpath._COUNT_MEMO.clear()
            fastpath._COUNT_MEMO.clear()
            before = counts.LAUNCHES["count_codes"]
            url = f"http://127.0.0.1:{s.server_address[1]}/{query}"
            with urllib.request.urlopen(url, timeout=120) as resp:
                bodies.append((resp.status, resp.read()))
            launched = counts.LAUNCHES["count_codes"] - before
        assert launched >= 1
        assert bodies[0][0] == 200 and bodies[1] == bodies[0]
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()


# The shard bodies of parallel/mesh.py on 2, 4 and 8 slots of one card.  Per
# slot: 157 words pad to 158/160 (79, 40, 20 words: A's scalar and 128-bit
# loads), 2,031 to 2,032 (1,016 and 508: 128-bit; 254 at 8: scalar), 2,048
# to 1,024/512/256 (128-bit); 1 and 2 groups take A's carry-save path.
MESH_SLOTS = [2, 4, 8]
MESH_WORDS = [157, 2031, 2048]
MESH_GROUPS = [1, 2, 8, 33]


@pytest.mark.parametrize("groups", MESH_GROUPS)
@pytest.mark.parametrize("words", MESH_WORDS)
@pytest.mark.parametrize("slots", MESH_SLOTS)
def test_mesh_bodies_on_card(cuda, slots, words, groups):
    """Every shard body against the plain single-device version on the same
    card: counts exact int32, codes and pairs exact uint8; kernel A runs once
    per slot."""
    from bgt_tpu_torch.parallel import mesh
    rows = 301
    p0, p1, masks = _inputs(rows, words, groups, seed=slots * 7919 + words + groups)
    d = [counts.planes_to_torch(a, cuda) for a in (p0, p1, masks)]
    plain = counts.count_codes_reference(*d)
    codes = counts.decode_codes(d[0], d[1])
    rows_idx = np.array([0, 5, rows - 1, 17, 17, 150])
    want_pairs = (codes[rows_idx][:, 0::2] << 2) | codes[rows_idx][:, 1::2]

    m = mesh.make_mesh([cuda] * slots)
    s0, s1, sm = mesh.shard_planes(m, p0, p1, masks)
    assert all(t.is_contiguous() and t.device.type == "cuda"
               for t in s0 + s1 + sm)
    before = counts.LAUNCHES["count_codes"]
    got = mesh.sharded_count_fn(m)(s0, s1, sm)
    assert counts.LAUNCHES["count_codes"] - before == slots
    assert torch.equal(got, plain)
    got = mesh.sharded_count_range_fn(m)(s0, s1, sm, 17, 250)
    assert torch.equal(got, plain[17:267])
    pairs = mesh.sharded_pairs_rows_fn(m)(s0, s1, rows_idx)
    assert torch.equal(pairs[:, : words * 16], want_pairs)
    gathered = mesh.sharded_gather_codes_fn(m)(s0, s1)
    assert torch.equal(gathered[:, : words * 32], codes)

    m2 = mesh.make_mesh2(2, [cuda] * slots)
    q0, q1, qm = mesh.shard_planes2(m2, p0, p1, masks)
    blocks = mesh.sharded_count2_fn(m2)(q0, q1, qm)
    assert torch.equal(torch.cat(blocks)[:rows], plain)
    pairs2 = mesh.sharded_pairs_rows2_fn(m2)(q0, q1, rows_idx)
    assert torch.equal(pairs2[:, : words * 16], want_pairs)
    torch.cuda.synchronize()


_CARD_RANK = r"""
import io, json, os, sys
rank, port, db, repo = sys.argv[1:5]
sys.path.insert(0, repo)
import torch
from bgt_tpu_torch.parallel import distributed
distributed.initialize("127.0.0.1:" + port, 2, int(rank), timeout_s=120)
from bgt_tpu_torch.ops import counts
from bgt_tpu_torch.query import fastpath
from bgt_tpu_torch.query.view import main_view
os.environ["BGT_TPU_COUNT_TIER"] = "device"
buf = io.StringIO()
assert main_view(["-G", "-C", "-s", 'population=="CEU"', db], out=buf,
                 device="cuda:0") == 0
ctx = fastpath.get_shard_context(torch.device("cuda:0"))
assert ctx is not None and ctx.multi_process and ctx.n_dev == 2
print(json.dumps({"out": buf.getvalue(), "launches": counts.LAUNCHES["count_codes"]}))
torch.distributed.destroy_process_group()
"""


def test_two_ranks_on_one_card(cuda, tmp_path, monkeypatch):
    """Two gloo ranks on cuda:0, one slot each, each placing its column
    slice of the full tiles: both write the port's host-tier bytes, and
    kernel A ran once in each."""
    import io
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from bgt_tpu_torch import testing
    from bgt_tpu_torch.ops import _kernels
    from bgt_tpu_torch.query import importer
    from bgt_tpu_torch.query.view import main_view

    (tmp_path / "in.vcf").write_text(
        testing.random_vcf(n_samples=300, n_sites=200, seed=9))
    db = str(tmp_path / "db")
    importer.import_vcf(db, [str(tmp_path / "in.vcf")], is_vcf=True)
    (tmp_path / "db.spl").write_text(testing.random_spl(300, seed=9))
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "host")
    fastpath._COUNT_MEMO.clear()
    buf = io.StringIO()
    assert main_view(["-G", "-C", "-s", 'population=="CEU"', db], out=buf,
                     device=cuda) == 0
    _kernels.library()  # built once, before the ranks load it
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BGT_TPU_", "MASTER_"))}
    repo = str(Path(__file__).resolve().parent.parent)
    procs = [subprocess.Popen([sys.executable, "-c", _CARD_RANK, str(r), port,
                               db, repo], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, env=env)
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err.decode()[-3000:]
            outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for res in outs:
        assert res["out"] == buf.getvalue() and res["out"].count("\n") > 100
        assert res["launches"] == 1


def _cards(n):
    """cuda:0 .. cuda:n-1, or a skip where fewer cards are visible."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA devices")
    return [torch.device("cuda", i) for i in range(n)]


@pytest.mark.parametrize("groups", [1, 2, 8, 33])
@pytest.mark.parametrize("words", MESH_WORDS)
@pytest.mark.parametrize("n_cards", [2, 4])
def test_mesh_bodies_across_cards(n_cards, words, groups):
    """Every shard body with its slots on distinct cards against one card:
    counts exact int32, codes and pairs exact uint8, every result on the
    first card; kernel A runs once on each card; the sums and gathers are
    peer copies (``COLLECTIVES["peer"]``), never a host copy."""
    from bgt_tpu_torch.parallel import mesh
    cards = _cards(n_cards)
    rows = 301
    p0, p1, masks = _inputs(rows, words, groups, seed=n_cards * 104729 + words
                            + groups)
    d = [counts.planes_to_torch(a, cards[0]) for a in (p0, p1, masks)]
    one = counts.count_codes(*d)
    codes = counts.decode_codes(d[0], d[1])
    rows_idx = np.array([0, 5, rows - 1, 17, 17, 150])
    want_pairs = (codes[rows_idx][:, 0::2] << 2) | codes[rows_idx][:, 1::2]

    m = mesh.make_mesh(cards)
    s0, s1, sm = mesh.shard_planes(m, p0, p1, masks)
    assert [t.device for t in s0] == cards
    mesh.reset_collectives()
    counts.CARD_LAUNCHES.clear()
    got = mesh.sharded_count_fn(m)(s0, s1, sm)
    assert {k: v for k, v in counts.CARD_LAUNCHES.items()
            if k[0] == "count_codes"} == {("count_codes", i): 1
                                          for i in range(n_cards)}
    assert got.device == cards[0] and torch.equal(got, one)
    got = mesh.sharded_count_range_fn(m)(s0, s1, sm, 17, 250)
    assert torch.equal(got, one[17:267])
    pairs = mesh.sharded_pairs_rows_fn(m)(s0, s1, rows_idx)
    assert torch.equal(pairs[:, : words * 16], want_pairs)
    gathered = mesh.sharded_gather_codes_fn(m)(s0, s1)
    assert torch.equal(gathered[:, : words * 32], codes)
    peer = mesh.COLLECTIVES["peer"]
    assert peer["all_reduce"]["calls"] == 2 and peer["all_gather"]["calls"] == 2

    m2 = mesh.make_mesh2(2, cards)
    q0, q1, qm = mesh.shard_planes2(m2, p0, p1, masks)
    blocks = mesh.sharded_count2_fn(m2)(q0, q1, qm)
    assert torch.equal(torch.cat([b.to(cards[0]) for b in blocks])[:rows], one)
    pairs2 = mesh.sharded_pairs_rows2_fn(m2)(q0, q1, rows_idx)
    assert pairs2.device == cards[0]
    assert torch.equal(pairs2[:, : words * 16], want_pairs)
    for dev in cards:
        torch.cuda.synchronize(dev)


_NCCL_RANK = r"""
import io, json, os, sys
rank, n, port, db, repo = sys.argv[1:6]
sys.path.insert(0, repo)
import torch
from bgt_tpu_torch.parallel import distributed, mesh
distributed.initialize("127.0.0.1:" + port, int(n), int(rank), timeout_s=120,
                       device="cuda")
from bgt_tpu_torch.ops import counts
from bgt_tpu_torch.query import fastpath
from bgt_tpu_torch.query.view import main_view
os.environ["BGT_TPU_COUNT_TIER"] = "device"
out = {}
for name, args in (("subset", ["-G", "-C", "-s", 'population=="CEU"']),
                   ("gt", ["-C", "-s", ",S0001,S0003,S0004"])):
    fastpath._COUNT_MEMO.clear()
    buf = io.StringIO()
    assert main_view(args + [db], out=buf, device="cuda") == 0
    out[name] = buf.getvalue()
ctx = fastpath.get_shard_context(torch.device("cuda"))
assert ctx is not None and ctx.multi_process
print(json.dumps({"out": out, "backend": distributed.collective_backend(),
                  "slots": [str(d) for d in ctx.mesh.slots],
                  "cards": {str(k[1]): v for k, v in counts.CARD_LAUNCHES.items()},
                  "collectives": mesh.COLLECTIVES}))
torch.distributed.destroy_process_group()
"""


@pytest.mark.parametrize("layout", ["4x1", "2x2"])
def test_nccl_ranks_across_cards(tmp_path, monkeypatch, layout):
    """Four ranks of one card each (LOCAL_RANK), or two of two cards each
    (CUDA_VISIBLE_DEVICES), each opening only its shard file: every rank
    chose NCCL, made no gloo collective, ran kernel A once on each of its
    cards per counted query, and wrote the port's host-tier bytes for the
    subset and GT queries."""
    import io
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    from bgt_tpu_torch import testing
    from bgt_tpu_torch.ops import _kernels
    from bgt_tpu_torch.query import importer
    from bgt_tpu_torch.query.view import main_view

    _cards(4)
    n_ranks, per = (4, 1) if layout == "4x1" else (2, 2)
    (tmp_path / "in.vcf").write_text(
        testing.random_vcf(n_samples=300, n_sites=200, seed=11))
    db = str(tmp_path / "db")
    importer.import_vcf(db, [str(tmp_path / "in.vcf")], is_vcf=True)
    (tmp_path / "db.spl").write_text(testing.random_spl(300, seed=11))
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "host")
    want = {}
    for name, args in (("subset", ["-G", "-C", "-s", 'population=="CEU"']),
                       ("gt", ["-C", "-s", ",S0001,S0003,S0004"])):
        fastpath._COUNT_MEMO.clear()
        buf = io.StringIO()
        assert main_view(args + [db], out=buf, device="cuda:0") == 0
        want[name] = buf.getvalue()
    TileStore.emit_shards(db, n_ranks, 4)
    _kernels.library()  # built once, before the ranks load it
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = str(s.getsockname()[1])
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BGT_TPU_", "MASTER_")) and k != "LOCAL_RANK"}
    vis = os.environ.get("CUDA_VISIBLE_DEVICES")
    ids = vis.split(",") if vis else [str(i) for i in range(4)]
    repo = str(Path(__file__).resolve().parent.parent)
    procs = []
    for r in range(n_ranks):
        mine = ({"LOCAL_RANK": str(r)} if per == 1 else
                {"CUDA_VISIBLE_DEVICES": ",".join(ids[r * per:(r + 1) * per])})
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _NCCL_RANK, str(r), str(n_ranks), port, db,
             repo], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env={**env, **mine, "BGT_TPU_TILE_SHARD": f"{r}:{n_ranks}",
                 "NCCL_DEBUG": "WARN"}))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            assert p.returncode == 0, err.decode()[-3000:]
            outs.append(json.loads(out.decode().strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, res in enumerate(outs):
        assert res["out"] == want and want["subset"].count("\n") > 100
        assert res["backend"] == "nccl"
        assert res["slots"] == ([f"cuda:{r}"] if per == 1
                                else [f"cuda:{i}" for i in range(per)])
        # the subset and the GT query's subset counts: once a card each
        assert res["cards"] == {s[5:]: 2 for s in res["slots"]}
        assert not any(v["calls"] for v in res["collectives"]["gloo"].values())
        assert res["collectives"]["nccl"]["all_reduce"]["calls"] >= 2
        assert res["collectives"]["nccl"]["all_gather"]["calls"] >= 1
        if per > 1:
            assert res["collectives"]["peer"]["all_reduce"]["calls"] >= 2


# kernel D's edge shapes: haplotypes (1 run a row; words of 32 and a ragged
# last word; rows of more runs than the block's 1,024 threads at HRC width)
# and rows per block (none, one, ragged)
D_M = [1, 31, 33, 1025, 64_976]
D_ROWS = [0, 1, 17, 64]


def _d_block(tmp_path, rows, m, seed):
    """Block 0 of a PBF of ``rows`` rows from numpy-seeded codes (one
    checkpoint): its S record (2, m) and each plane's RLE rows."""
    from bgt_tpu_torch import testing
    from bgt_tpu_torch.ops import decode
    path = str(tmp_path / f"d{rows}x{m}.pbf")
    testing.write_pbf(path, testing.pbwt_codes(max(rows, 1), m, seed), 8)
    blk = next(decode.read_blocks(path))
    return blk.S, [r[:rows] for r in blk.rle]


@pytest.mark.parametrize("rows", D_ROWS)
@pytest.mark.parametrize("m", D_M)
def test_pbwt_decode_matches_plain(cuda, tmp_path, m, rows):
    """Kernel D on the padded runs and on the RLE bytes, against the plain
    version on the card: equal rows and final S, one launch each."""
    from bgt_tpu_torch.ops import decode
    S, rle = _d_block(tmp_path, rows, m, seed=m + rows)
    for gi in range(2):
        S0 = torch.from_numpy(S[gi]).to(cuda)
        lens, bits = decode.pack_block(rle[gi], m, device=cuda)
        before = decode.LAUNCHES["pbwt_decode"]
        got, got_S = decode.decode_block(S0, lens, bits, m)
        assert decode.LAUNCHES["pbwt_decode"] == before + 1
        want, want_S = decode.decode_block_reference(S0, lens, bits, m)
        torch.cuda.synchronize()
        assert got.shape == (rows, m) and torch.equal(got, want)
        assert torch.equal(got_S, want_S)
        batch = decode.pack_csr(S[gi:gi + 1], [rle[gi]], m, cuda)
        got, got_S = decode.decode_csr(batch)
        torch.cuda.synchronize()
        assert torch.equal(got, want) and torch.equal(got_S[0], want_S)


def test_pbwt_decode_ragged_batch_one_launch(cuda, tmp_path):
    """Scans of 0, 1, 17 and 64 rows and both planes in one launch, each
    equal to its own plain decode."""
    from bgt_tpu_torch.ops import decode
    m = 1025
    S0s, rows, rle = [], [], []
    for i, n in enumerate([17, 0, 64, 1]):
        S, r = _d_block(tmp_path, n, m, seed=i)
        for gi in range(2):
            S0s.append(S[gi])
            rows.append(n)
            rle.append(r[gi])
    # every scan's rows padded to the batch's longest row
    lens, bits = decode.pack_block([x for r in rle for x in r], m, device=cuda)
    S0 = torch.from_numpy(np.stack(S0s)).to(cuda)
    before = decode.LAUNCHES["pbwt_decode"]
    got, got_S = decode.decode_blocks(S0, lens, bits, rows, m)
    csr, csr_S = decode.decode_csr(decode.pack_csr(np.stack(S0s), rle, m, cuda))
    assert decode.LAUNCHES["pbwt_decode"] == before + 2
    lo = 0
    for k, n in enumerate(rows):
        want, want_S = decode.decode_block_reference(
            S0[k], lens[lo: lo + n], bits[lo: lo + n], m)
        assert torch.equal(got[lo: lo + n], want)
        assert torch.equal(csr[lo: lo + n], want)
        assert torch.equal(got_S[k], want_S) and torch.equal(csr_S[k], want_S)
        lo += n


# kernel D with each scan split over a forced number of blocks (0: its own
# plan; "max": ceil(m / 16), slices of 16): 1,025 is no multiple of 16 nor
# of its slices, 64,976 (HRC) fits whole in one block's 16-bit ranks,
# 65,536 is the last width of 16-bit ranks and past it they are 32-bit
D_SPLITS = [(m, c) for m in (1025, 64_976) for c in (1, 2, 7, "max")] + [
    (65_536, 0), (65_536, 1), (65_537, 0), (70_001, 3)]


@pytest.mark.parametrize("m,split", D_SPLITS,
                         ids=[f"{m}-{c}" for m, c in D_SPLITS])
def test_pbwt_decode_forced_splits(cuda, tmp_path, m, split):
    """Both planes of a 64-row block as two scans of one launch, each over
    ``split`` blocks, on padded runs and on RLE bytes: equal rows and final
    S to the plain version."""
    from bgt_tpu_torch.ops import decode
    S, rle = _d_block(tmp_path, 64, m, seed=m + 3)
    bps = -(-m // 16) if split == "max" else split
    p = decode.plan(m, 2, bps, device=cuda)
    assert p.max_blocks_per_scan == -(-m // 16)
    assert p.slice % 16 == 0 and (p.blocks_per_scan - 1) * p.slice < m
    assert m <= p.blocks_per_scan * p.slice
    assert p.blocks_per_scan == bps or (bps == 0 and p.blocks_per_scan >= 1)
    S0 = torch.from_numpy(S).to(cuda)
    lens, bits = decode.pack_block(rle[0] + rle[1], m, device=cuda)
    before = decode.LAUNCHES["pbwt_decode"]
    got, got_S = decode.decode_blocks(S0, lens, bits, [64, 64], m,
                                      blocks_per_scan=bps)
    csr, csr_S = decode.decode_csr(decode.pack_csr(S, rle, m, cuda),
                                   blocks_per_scan=bps)
    assert decode.LAUNCHES["pbwt_decode"] == before + 2
    for k in range(2):
        want, want_S = decode.decode_block_reference(
            S0[k], lens[64 * k: 64 * k + 64], bits[64 * k: 64 * k + 64], m)
        torch.cuda.synchronize()
        assert torch.equal(got[64 * k: 64 * k + 64], want)
        assert torch.equal(csr[64 * k: 64 * k + 64], want)
        assert torch.equal(got_S[k], want_S) and torch.equal(csr_S[k], want_S)


def test_pbwt_decode_more_scans_than_sms(cuda, tmp_path):
    """A batch of more scans than the card has SMs at the 1000 Genomes
    width (5,008 haplotypes) takes one block per scan and decodes every
    scan as the plain version does."""
    from bgt_tpu_torch.ops import decode
    m = 5008
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    S, rle = _d_block(tmp_path, 17, m, seed=11)
    rows = [[17, 0, 5, 1][k % 4] for k in range(sms + 5)]
    batch = decode.pack_csr(np.stack([S[k % 2] for k in range(len(rows))]),
                            [rle[k % 2][:n] for k, n in enumerate(rows)], m,
                            cuda)
    assert decode.plan(m, len(rows), device=cuda).blocks_per_scan == 1
    got, got_S = decode.decode_csr(batch)
    want, want_S = decode.decode_csr_reference(batch)
    torch.cuda.synchronize()
    assert torch.equal(got, want) and torch.equal(got_S, want_S)


def test_pbwt_decode_plan(cuda):
    """The default plan fills the card's SMs once at the occupancy it
    reports; forced splits outside what fits are refused."""
    from bgt_tpu_torch.ops import decode
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for m, scans in ((64_976, 26), (64_976, 1), (1025, 3), (70_001, 40)):
        p = decode.plan(m, scans, device=cuda)
        assert p.blocks_per_sm >= 1 and p.threads in (256, 512, 1024)
        assert p.blocks_per_scan == 1 or scans * p.blocks_per_scan <= sms * p.blocks_per_sm
        assert p.min_blocks_per_scan <= p.blocks_per_scan <= p.max_blocks_per_scan
    assert decode.plan(64_976, 26, device=cuda).min_blocks_per_scan == 1
    with pytest.raises(ValueError, match="blocks_per_scan"):
        decode.plan(1025, 1, 66, device=cuda)  # slices of 16 make 65
    wide = decode.plan(decode.MAX_M, 1, device=cuda)
    assert wide.min_blocks_per_scan > 1
    with pytest.raises(ValueError, match="blocks_per_scan"):
        decode.plan(decode.MAX_M, 1, 1, device=cuda)
    with pytest.raises(ValueError, match="exceeds"):
        decode.plan(decode.MAX_M + 1, 1, device=cuda)


def test_decode_pbf_on_device_card_equals_cpu(cuda, tmp_path):
    from bgt_tpu_torch import testing
    from bgt_tpu_torch.ops import decode
    path = str(tmp_path / "f.pbf")
    codes = testing.pbwt_codes(100, 1025, seed=5)
    testing.write_pbf(path, codes, 5)
    for max_rows in (None, 70, 1):
        got = decode.decode_pbf_on_device(path, max_rows)  # default: cuda
        np.testing.assert_array_equal(got, codes[:max_rows])
        np.testing.assert_array_equal(
            got, decode.decode_pbf_on_device(path, max_rows, device="cpu"))


def test_pbwt_decode_rejects_bad_inputs(cuda):
    from bgt_tpu_torch.ops import decode
    S0 = torch.arange(64, dtype=torch.int32, device=cuda)
    lens = torch.full((3, 2), 32, dtype=torch.int32, device=cuda)
    bits = torch.zeros((3, 2), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        decode.decode_block(S0, lens.t().contiguous().t(), bits, 64)
    with pytest.raises(TypeError, match="int32"):
        decode.decode_block(S0, lens.to(torch.int64), bits, 64)
    with pytest.raises(ValueError, match="permutation"):
        decode.decode_block(torch.zeros_like(S0), lens, bits, 64)
    with pytest.raises(ValueError, match="exceeds"):
        m = decode.MAX_M + 1
        decode.decode_block(torch.arange(m, dtype=torch.int32, device=cuda),
                            lens, bits, m)


def test_pbwt_decode_raises_without_its_library(cuda, monkeypatch):
    """A CUDA tensor goes to kernel D or raises: no fallback to the plain
    version when the kernel library cannot load."""
    from bgt_tpu_torch.ops import _kernels, decode

    def broken():
        raise OSError("no kernel library")

    monkeypatch.setattr(_kernels, "library", broken)
    S0 = torch.arange(64, dtype=torch.int32, device=cuda)
    lens = torch.full((3, 2), 32, dtype=torch.int32, device=cuda)
    before = decode.LAUNCHES["pbwt_decode"]
    with pytest.raises(OSError, match="no kernel library"):
        decode.decode_block(S0, lens, torch.zeros_like(lens), 64)
    assert decode.LAUNCHES["pbwt_decode"] == before


# --- the bench on the card (bgt_tpu_torch/tools/bench.py) ---------------------

# the bench's tiles: 1kg11 (105,730 rows x 157 words) and hrc (31,716 x
# 2,031), at the device block's 1 and 32 masks
BENCH_TILES = [(105_730, 157, 1), (105_730, 157, 32), (31_716, 2031, 1),
               (31_716, 2031, 32)]


@pytest.mark.parametrize("rows,words,groups", BENCH_TILES,
                         ids=[f"{r}x{w}x{g}" for r, w, g in BENCH_TILES])
def test_bench_tile_kernel_matches_plain(cuda, rows, words, groups):
    d = [counts.planes_to_torch(a, cuda)
         for a in _inputs(rows, words, groups, seed=rows + groups)]
    before = counts.LAUNCHES["count_codes"]
    got = counts.count_codes(*d)
    assert counts.LAUNCHES["count_codes"] == before + 1
    assert torch.equal(got, counts.count_codes_reference(*d))


def test_bench_run_on_card_gated_on_host_tier(cuda, tmp_path, monkeypatch):
    """bench.run at small configurations on the card under ``auto``, its
    pins taken from the port's host tier: every md5 equal, the subset's
    device step and the eight groups launching kernel A, -G -C answered by
    rowstats, and the device block's A exact on the widest tile."""
    from bgt_tpu_torch.query import importer
    from bgt_tpu_torch.tools import bench

    cfgs = {"1kg11": dict(n_samples=40, n_sites=300, seed=1337,
                          anno_rows=2000),
            "hrc": dict(n_samples=400, n_sites=200, seed=2026)}
    monkeypatch.delenv("BGT_TPU_COUNT_TIER", raising=False)
    pins = {}
    for i, (name, cfg) in enumerate(cfgs.items()):
        d = tmp_path / name
        bench.ensure_db(tmp_path, name, cfg, i == 0)
        bench.ensure_inputs(d, cfg, i == 0)
        key = bench.cfg_key(name, cfg)
        pins[key] = {"import": {e: bench.file_md5(d / f"ourdb{e}")
                                for e in bench.IMPORT_EXTS},
                     "views": {q: bench.host_md5(d, args, cuda)
                               for q, args in bench.queries(i == 0).items()}}
        if i == 0:  # the BCF-input import and the merge, as the bench runs
            with open(d / "in_gt.bcf", "wb") as fp:
                bench.view(d, ["-b", "-C"], cuda, sink=bench._FileSink(fp))
            importer.import_vcf(str(d / "ourdb_b"), [str(d / "in_gt.bcf")])
            pins[key]["import_bcf"] = {
                ".pbf": bench.file_md5(d / "ourdb_b.pbf")}
            md = tmp_path / "multidb"
            md.mkdir()
            bench.split_halves(d / "in.vcf", md, cfg["n_samples"])
            for half in ("a", "b"):
                importer.import_vcf(str(md / f"our_{half}"),
                                    [str(md / f"{half}.vcf")], is_vcf=True)
            pins["multidb:" + key] = {"views": {
                q: bench.host_md5(md, args, cuda, ("our_a", "our_b"))
                for q, args in bench.MULTIDB_QUERIES.items()}}
    res = bench.run(cfgs, cuda, pins, bench_dir=tmp_path, full=False,
                    device_tests=False, scaling=False)
    ex = res["extra"]
    for name in cfgs:
        assert ex[name]["launches"]["subset_device"] >= 1
        assert ex[name]["launches"]["groups8"] >= 1
        assert set(ex[name]["tiers"]["gc_warm_0"]) == {"rowstats"}
    dk = ex["device_kernel"]
    assert dk["tile"] == "hrc" and dk["max_abs_err_32mask"] == 0
    assert 0 < dk["share_1mask"] and res["device"]["power_limit"]
