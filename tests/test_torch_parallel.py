"""bgt_tpu_torch's sample-column mesh against bgt_tpu's, exactly.

The port's mesh runs on slots of the CPU device (``BGT_TPU_MESH_DEVICES``
or an explicit slot list), its cross-process collectives on gloo; bgt_tpu's
runs on the 8 virtual JAX-CPU devices of ``tests/conftest.py``.  The rules
that need cards (which slots ``cuda`` names, the NCCL transport, the dry
run's distinct cards) run against faked card counts, UUIDs and collectives.  The same
numpy-seeded inputs go through both, and counts (int32), pairs and codes
(uint8) and ``view`` output bytes must be equal.  On the CPU every slot's
local count is kernel A's plain version.
"""

import io
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bgt_tpu.core import kexpr as jax_kexpr
from bgt_tpu.ops import counts as jax_counts
from bgt_tpu.parallel import mesh as jax_mesh
from bgt_tpu.query import fastpath as jax_fastpath
from bgt_tpu.query import view as jax_view
from bgt_tpu_torch import entry, testing
from bgt_tpu_torch.core import kexpr, xp_torch
from bgt_tpu_torch.ops import counts
from bgt_tpu_torch.ops.tiles import TileStore
from bgt_tpu_torch.parallel import distributed, mesh
from bgt_tpu_torch.query import fastpath, importer, view

REPO = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
SLOTS8 = [CPU] * 8


def _np(t):
    return t.cpu().numpy()


def ref_counts(codes, group_cols):
    """Scalar oracle: counts of codes 0..3 per row per group."""
    out = np.zeros((codes.shape[0], len(group_cols), 4), dtype=np.int64)
    for gi, cols in enumerate(group_cols):
        sub = codes[:, cols]
        for c in range(4):
            out[:, gi, c] = (sub == c).sum(axis=1)
    return out


@pytest.fixture(scope="module")
def data():
    """bgt_tpu's tests/test_ops.py `data`: 64 rows x 333 haplotypes."""
    rng = np.random.default_rng(0)
    codes = rng.choice(4, size=(64, 333),
                       p=[0.7, 0.2, 0.05, 0.05]).astype(np.uint8)
    ts = TileStore.from_codes(codes)
    groups = [np.random.default_rng(3).choice(ts.m, size=70, replace=False),
              np.arange(ts.m)]
    masks = np.stack([ts.pack_mask(g) for g in groups])
    return codes, ts, groups, masks


@pytest.fixture(scope="module")
def jax_mesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 CPU devices"
    return jax_mesh.make_mesh()


@pytest.fixture
def count_calls(monkeypatch):
    """The lengths of the port's count passes (one per slot on a mesh)."""
    calls = []
    real = counts.count_codes_range

    def spy(*args):
        calls.append(args[4])
        return real(*args)

    monkeypatch.setattr(counts, "count_codes_range", spy)
    return calls


def test_sharded_counts_match(data, jax_mesh8):
    codes, ts, groups, masks = data
    m8 = mesh.make_mesh(SLOTS8)
    got = mesh.sharded_count_fn(m8)(*mesh.shard_planes(m8, ts.plane0,
                                                       ts.plane1, masks))
    assert got.dtype == torch.int32
    jm = jax_mesh.shard_planes(jax_mesh8, ts.plane0, ts.plane1, masks)
    want = np.asarray(jax_mesh.sharded_count_fn(jax_mesh8)(*jm))
    np.testing.assert_array_equal(_np(got), want)
    np.testing.assert_array_equal(_np(got), ref_counts(codes, groups))


def test_sharded_gather_codes(data, jax_mesh8):
    codes, ts, _groups, masks = data
    m8 = mesh.make_mesh(SLOTS8)
    p0, p1, _ = mesh.shard_planes(m8, ts.plane0, ts.plane1, masks)
    got = _np(mesh.sharded_gather_codes_fn(m8)(p0, p1))
    jp0, jp1, _ = jax_mesh.shard_planes(jax_mesh8, ts.plane0, ts.plane1, masks)
    want = np.asarray(jax_mesh.sharded_gather_codes_fn(jax_mesh8)(jp0, jp1))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, : ts.m], codes)


@pytest.mark.parametrize("start,length", [(0, 64), (5, 17), (63, 1), (10, 0)])
def test_sharded_count_range(data, jax_mesh8, count_calls, start, length):
    _codes, ts, _groups, masks = data
    m8 = mesh.make_mesh(SLOTS8)
    placed = mesh.shard_planes(m8, ts.plane0, ts.plane1, masks)
    got = _np(mesh.sharded_count_range_fn(m8)(*placed, start, length))
    assert count_calls == [length] * 8  # one exact-span pass per slot
    jm = jax_mesh.shard_planes(jax_mesh8, ts.plane0, ts.plane1, masks)
    want = np.asarray(jax_mesh.sharded_count_range_fn(jax_mesh8)(
        *jm, start, length))
    np.testing.assert_array_equal(got, want)


ROW_SETS = [[0], [3, 3, 63, 0, 17], list(range(64))]


@pytest.mark.parametrize("rows", ROW_SETS, ids=["one", "repeats", "all"])
def test_sharded_pairs_rows(data, jax_mesh8, rows):
    _codes, ts, _groups, masks = data
    m8 = mesh.make_mesh(SLOTS8)
    p0, p1, _ = mesh.shard_planes(m8, ts.plane0, ts.plane1, masks)
    got = _np(mesh.sharded_pairs_rows_fn(m8)(p0, p1, np.array(rows)))
    jp0, jp1, _ = jax_mesh.shard_planes(jax_mesh8, ts.plane0, ts.plane1, masks)
    want = np.asarray(jax_mesh.sharded_pairs_rows_fn(jax_mesh8)(
        jp0, jp1, jnp.asarray(np.array(rows, np.int32))))
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def _unaligned():
    """bgt_tpu's test_mesh2_counts_parity inputs: 37 x 24, 3 masks."""
    rng = np.random.default_rng(19)
    p0 = rng.integers(0, 2**32, (37, 24), dtype=np.uint32)
    p1 = rng.integers(0, 2**32, (37, 24), dtype=np.uint32)
    masks = rng.integers(0, 2**32, (3, 24), dtype=np.uint32)
    return p0, p1, masks


@pytest.mark.parametrize("r_axis", [2, 4])
def test_mesh2_counts_parity(r_axis):
    p0, p1, masks = _unaligned()
    m2 = mesh.make_mesh2(r_axis, SLOTS8)
    blocks = mesh.sharded_count2_fn(m2)(*mesh.shard_planes2(m2, p0, p1, masks))
    assert len(blocks) == r_axis
    got = torch.cat([b.cpu() for b in blocks]).numpy()
    jm2 = jax_mesh.make_mesh2(r_axis)
    want = np.asarray(jax_mesh.sharded_count2_fn(jm2)(
        *jax_mesh.shard_planes2(jm2, p0, p1, masks)))
    np.testing.assert_array_equal(got, want)
    single = np.asarray(jax_counts.count_codes(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(masks)))
    np.testing.assert_array_equal(got[:37], single)


@pytest.mark.parametrize("r_axis", [2, 4])
def test_mesh2_pairs_parity(r_axis):
    p0, p1, masks = _unaligned()
    rows = np.array([0, 9, 10, 36, 5, 36], dtype=np.int32)
    m2 = mesh.make_mesh2(r_axis, SLOTS8)
    q0, q1, _ = mesh.shard_planes2(m2, p0, p1, masks)
    got = _np(mesh.sharded_pairs_rows2_fn(m2)(q0, q1, rows))
    jm2 = jax_mesh.make_mesh2(r_axis)
    j0, j1, _ = jax_mesh.shard_planes2(jm2, p0, p1, masks)
    want = np.asarray(jax_mesh.sharded_pairs_rows2_fn(jm2)(
        j0, j1, jnp.asarray(rows)))
    np.testing.assert_array_equal(got, want)


def test_mesh2_refuses_bad_split():
    with pytest.raises(ValueError, match="split"):
        mesh.make_mesh2(3, SLOTS8)


def test_distributed_helpers_single_process(monkeypatch):
    """distributed.py in one process, 8 slots: bgt_tpu's
    test_distributed_helpers_single_process."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("BGT_TPU_MESH_DEVICES", "8")
    distributed.initialize()  # no-op: one process
    assert not torch.distributed.is_initialized()
    m = distributed.global_mesh(device="cpu")
    assert m.size == 8 and m.world == 1 and m.slots == SLOTS8
    rng = np.random.default_rng(0)
    codes = rng.choice(4, size=(32, 250)).astype(np.uint8)
    ts = TileStore.from_codes(codes)
    lo, hi = distributed.local_column_range(ts.n_words, m)
    assert lo == 0 and hi >= ts.n_words
    pad = hi - ts.n_words
    p0 = np.pad(ts.plane0, ((0, 0), (0, pad)))
    p1 = np.pad(ts.plane1, ((0, 0), (0, pad)))
    g0, g1 = distributed.place_local_planes(m, p0, p1)
    assert len(g0) == 8 and all(t.is_contiguous() for t in g0 + g1)
    masks = np.pad(np.stack([ts.pack_mask(np.arange(ts.m))]),
                   ((0, 0), (0, pad)))
    msk = distributed.place_local(m, masks)
    got = _np(mesh.sharded_count_range_fn(m)(g0, g1, msk, 0, 32))
    np.testing.assert_array_equal(got, ref_counts(codes, [np.arange(ts.m)]))


@pytest.mark.parametrize("env,slots", [(None, 1), ("3", 3)])
def test_local_slots(monkeypatch, env, slots):
    if env is None:
        monkeypatch.delenv("BGT_TPU_MESH_DEVICES", raising=False)
    else:
        monkeypatch.setenv("BGT_TPU_MESH_DEVICES", env)
    assert mesh.local_slots("cpu") == [CPU] * slots


def _fake_cards(monkeypatch, n_cards, group_world=None):
    """``n_cards`` visible CUDA devices, and a process group of
    ``group_world`` ranks (None: no group), for the slot rules alone."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n_cards)
    monkeypatch.setattr(torch.distributed, "is_initialized",
                        lambda: group_world is not None)
    monkeypatch.setattr(torch.distributed, "get_world_size",
                        lambda group=None: group_world or 1)


CUDA = [torch.device("cuda", i) for i in range(4)]
# (device, BGT_TPU_MESH_DEVICES, LOCAL_RANK, process group size) -> slots
SLOT_CASES = [
    ("cuda:1", None, None, None, CUDA[1:2]),
    ("cuda:3", None, "0", 2, CUDA[3:4]),
    ("cuda", None, None, None, CUDA),
    (None, None, None, None, CUDA),
    ("cuda", None, "2", 4, CUDA[2:3]),
    ("cuda", None, "0", 4, CUDA[0:1]),
    ("cuda", None, None, 4, CUDA),            # a group, no torchrun
    ("cuda", None, "2", None, CUDA),          # LOCAL_RANK but no group
    ("cuda", "2", "1", 4, [torch.device("cuda")] * 2),
    ("cuda:1", "3", None, None, CUDA[1:2] * 3),
    ("cpu", None, "1", 2, [CPU]),
]


@pytest.mark.parametrize("device,env,local,group,want", SLOT_CASES,
                         ids=[f"{c[0]}-mesh{c[1]}-local{c[2]}-group{c[3]}"
                              for c in SLOT_CASES])
def test_local_slots_cards(monkeypatch, device, env, local, group, want):
    """``cuda:k`` is that card, bare ``cuda`` every visible card or, in a
    process group under torchrun, ``cuda:$LOCAL_RANK``;
    BGT_TPU_MESH_DEVICES=N is N slots on the device as given (4 cards
    faked)."""
    _fake_cards(monkeypatch, 4, group)
    for k, v in (("BGT_TPU_MESH_DEVICES", env), ("LOCAL_RANK", local)):
        if v is None:
            monkeypatch.delenv(k, raising=False)
        else:
            monkeypatch.setenv(k, v)
    assert mesh.local_slots(device) == want


def test_local_slots_refuses_missing_card(monkeypatch):
    _fake_cards(monkeypatch, 2, 4)
    monkeypatch.delenv("BGT_TPU_MESH_DEVICES", raising=False)
    monkeypatch.setenv("LOCAL_RANK", "3")
    with pytest.raises(ValueError, match="LOCAL_RANK=3"):
        mesh.local_slots("cuda")


# the ranks' cards by UUID (None: a rank off CUDA) -> the mesh's transport
TRANSPORT_CASES = [
    ([["a"], ["b"], ["c"], ["d"]], "nccl"),   # one card a rank
    ([["a", "b"], ["c", "d"]], "nccl"),       # two ranks of two cards
    ([["a", "a"], ["b", "b"]], "nccl"),       # slots of a rank share a card
    ([["a"], ["a"]], "gloo"),                 # two ranks on one card
    ([["a", "b"], ["b", "c"]], "gloo"),       # one card in two ranks
    ([["a"], ["b"], ["a"]], "gloo"),
    ([["a"], None], "gloo"),                  # a CPU rank
    ([None, None], "gloo"),
]


@pytest.mark.parametrize("layouts,want", TRANSPORT_CASES,
                         ids=[str(c[0]) for c in TRANSPORT_CASES])
def test_transport_for_layout(layouts, want):
    assert distributed.transport_for(layouts) == want


@pytest.fixture
def fake_group(monkeypatch):
    """A process group of two ranks, this one rank 0, faked around
    ``distributed``'s transport choice: the other rank's card UUIDs are
    ``other["cards"]``, this rank's ``["card-0"]``; ``made`` records each
    new_group call and ``reduced`` each all_reduce."""
    state = {"cards": ["card-1"], "made": [], "reduced": []}
    monkeypatch.setattr(distributed, "_STATE",
                        {"backend": None, "group": None, "cards": None})
    monkeypatch.setattr(distributed.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(distributed.dist, "get_world_size",
                        lambda group=None: 2)
    monkeypatch.setattr(distributed.dist, "get_rank", lambda group=None: 0)
    monkeypatch.setattr(distributed, "_card_uuids", lambda slots: ["card-0"])

    def gather(out, mine):
        out[:] = [mine, state["cards"]]

    def new_group(**kw):
        state["made"].append(kw)
        if state.get("refuse"):
            raise RuntimeError("NCCL refused")
        return "nccl-group"

    def all_reduce(t, group=None):
        state["reduced"].append((t.device, group))
        t.mul_(2)

    monkeypatch.setattr(distributed.dist, "all_gather_object", gather)
    monkeypatch.setattr(distributed.dist, "new_group", new_group)
    monkeypatch.setattr(distributed.dist, "all_reduce", all_reduce)
    return state


@pytest.mark.parametrize("other,want", [(["card-1"], "nccl"),
                                        (["card-0"], "gloo"),
                                        (None, "gloo")],
                         ids=["distinct", "shared", "cpu-rank"])
def test_initialize_chooses_transport(fake_group, other, want):
    """The choice is made once at join from the gathered cards: an NCCL
    group (and one probe sum on it) only where no card is shared and every
    rank is on CUDA; ``collective_backend`` reports it."""
    fake_group["cards"] = other
    distributed.initialize(device="cpu")
    assert distributed.collective_backend() == want
    assert len(fake_group["made"]) == (want == "nccl")
    if want == "nccl":
        assert fake_group["made"][0]["backend"] == "nccl"
        assert fake_group["reduced"] == [(CPU, "nccl-group")]
    distributed.initialize(device="cpu")  # chosen already: nothing more
    assert len(fake_group["made"]) == (want == "nccl")


def test_initialize_never_falls_back_to_gloo(fake_group):
    fake_group["refuse"] = True
    with pytest.raises(RuntimeError, match="NCCL refused"):
        distributed.initialize(device="cpu")
    assert distributed._STATE["backend"] is None


def test_global_mesh_takes_the_transport(fake_group, monkeypatch):
    """``global_mesh`` hands the mesh the transport and group chosen at
    join, and refuses slots other than the cards NCCL was set up for."""
    monkeypatch.delenv("BGT_TPU_MESH_DEVICES", raising=False)
    distributed.initialize(device="cpu")

    def gather(out, mine):
        for t in out:
            t.copy_(mine)

    monkeypatch.setattr(distributed.dist, "all_gather", gather)
    m = distributed.global_mesh(device="cpu")
    assert (m.transport, m.group, m.world, m.size) == ("nccl", "nccl-group",
                                                       2, 2)
    monkeypatch.setenv("BGT_TPU_MESH_DEVICES", "2")
    with pytest.raises(ValueError, match="NCCL was set up"):
        distributed.global_mesh(device="cpu")


@pytest.fixture
def nccl_calls(monkeypatch):
    """torch.distributed's NCCL collectives faked as a world of 2: what
    each received (its devices), rank 1 holding this rank's values + 100."""
    seen = []

    def all_reduce(t, group=None):
        seen.append(("all_reduce", t.device, group))
        if t.device.type != "meta":
            t.mul_(2).add_(100)

    def all_gather_into_tensor(out, t, group=None):
        seen.append(("all_gather", t.device, out.device, group))
        if t.device.type != "meta":
            out[0].copy_(t)
            out[1].copy_(t + 100)

    monkeypatch.setattr(torch.distributed, "all_reduce", all_reduce)
    monkeypatch.setattr(torch.distributed, "all_gather_into_tensor",
                        all_gather_into_tensor)
    mesh.reset_collectives()
    yield seen
    mesh.reset_collectives()


def test_nccl_layout_makes_no_host_copy(nccl_calls):
    """On the NCCL layout ``psum``/``all_gather_cols`` hand the first
    slot's tensor itself to the collective: slots on the meta device,
    which cannot be copied to the host, go through, and the results stay
    there."""
    meta = torch.device("meta")
    m = mesh.Mesh(("s",), (4,), [meta, meta], rank=0, world=2,
                  transport="nccl", group="g")
    local = [torch.empty((5, 3, 4), dtype=torch.int32, device=meta)] * 2
    assert mesh.psum(m, local).device == meta
    cols = [torch.empty((5, 7), dtype=torch.uint8, device=meta)] * 2
    out = mesh.all_gather_cols(m, cols)
    assert out.device == meta and out.shape == (5, 28)
    assert nccl_calls == [("all_reduce", meta, "g"),
                          ("all_gather", meta, meta, "g")]
    nccl = mesh.COLLECTIVES["nccl"]
    assert nccl["all_reduce"]["calls"] == nccl["all_gather"]["calls"] == 1
    assert nccl["all_reduce"]["bytes"] == 5 * 3 * 4 * 4
    assert nccl["all_gather"]["bytes"] == 2 * 5 * 14
    assert not any(v["calls"] for t in ("gloo", "peer")
                   for v in mesh.COLLECTIVES[t].values())


def test_nccl_layout_values(nccl_calls):
    """The NCCL branches' arithmetic on CPU tensors: the sum is this rank's
    in-process sum through the all_reduce; the gathered columns are rank 0's
    then rank 1's."""
    m = mesh.Mesh(("s",), (4,), [CPU, CPU], rank=0, world=2,
                  transport="nccl")
    rng = np.random.default_rng(4)
    local = [torch.as_tensor(rng.integers(0, 50, (6, 2, 4), dtype=np.int32))
             for _ in range(2)]
    got = mesh.psum(m, local)
    np.testing.assert_array_equal(_np(got), 2 * (_np(local[0])
                                                 + _np(local[1])) + 100)
    cols = [torch.as_tensor(rng.integers(0, 16, (6, c), dtype=np.uint8))
            for c in (3, 5)]
    got = _np(mesh.all_gather_cols(m, cols))
    mine = np.concatenate([_np(c) for c in cols], axis=1)
    np.testing.assert_array_equal(got, np.concatenate([mine, mine + 100],
                                                      axis=1))


# --- the query path on an in-process mesh ----------------------------------

def _db(tmp_path, n_samples, n_sites, seed, spl=False):
    (tmp_path / "in.vcf").write_text(
        testing.random_vcf(n_samples=n_samples, n_sites=n_sites, seed=seed))
    importer.import_vcf(str(tmp_path / "db"), [str(tmp_path / "in.vcf")],
                        is_vcf=True)
    if spl:
        (tmp_path / "db.spl").write_text(testing.random_spl(n_samples,
                                                             seed=seed))
    return str(tmp_path / "db")


def _view(main_view, args, db, **kw):
    jax_fastpath._COUNT_MEMO.clear()
    fastpath._COUNT_MEMO.clear()
    buf, err = io.StringIO(), io.StringIO()
    assert main_view(args + [db], out=buf, err=err, **kw) == 0, err.getvalue()
    return buf.getvalue()


def _port_mesh_view(args, db):
    """The port's view on the CPU device, with the context it built."""
    fastpath.reset_shard_context()
    try:
        out = _view(view.main_view, args, db, device=CPU)
        ctx = fastpath.get_shard_context(CPU)
        kinds = [e.kind for e in ctx._planes.values()] if ctx else []
    finally:
        fastpath.reset_shard_context()
    return out, kinds


@pytest.mark.parametrize("slots", [None, "8"], ids=["unsharded", "8-slots"])
def test_view_sharded_vs_unsharded(tmp_path, monkeypatch, count_calls, slots):
    """``view -C`` on an 8-slot mesh and on one device: both equal
    bgt_tpu's bytes (bgt_tpu's test_view_sharded_vs_unsharded)."""
    db = _db(tmp_path, 16, 150, 55)
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "host")
    want = _view(jax_view.main_view, ["-C"], db)
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    monkeypatch.setenv("BGT_TPU_SHARD_MIN_ROWS", "0")
    monkeypatch.setenv("BGT_TPU_MESH2", "1x8")
    if slots:
        monkeypatch.setenv("BGT_TPU_MESH_DEVICES", slots)
    got, kinds = _port_mesh_view(["-C"], db)
    assert got == want and want.count("\n") > 100
    # -C over all samples: rowstats answers, no count pass on any slot
    assert not count_calls
    got, kinds = _port_mesh_view(["-G", "-C", "-s", ",S0001,S0003"], db)
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "host")
    assert got == _view(jax_view.main_view, ["-G", "-C", "-s", ",S0001,S0003"],
                        db)
    assert kinds == (["s"] if slots else [])
    assert len(count_calls) == (8 if slots else 1)


def test_shard_crossover_gate(tmp_path, monkeypatch, count_calls):
    """Below BGT_TPU_SHARD_MIN_ROWS an in-process mesh query routes to one
    device (nothing placed on the mesh), with identical bytes; the gate at
    0 places the planes (bgt_tpu's test_shard_crossover_gate)."""
    db = _db(tmp_path, 12, 80, 77)
    args = ["-G", "-C", "-s", ",S0001,S0003"]
    monkeypatch.setenv("BGT_TPU_MESH_DEVICES", "8")
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    gated, kinds_gated = _port_mesh_view(args, db)
    assert kinds_gated == [] and len(count_calls) == 1
    monkeypatch.setenv("BGT_TPU_SHARD_MIN_ROWS", "0")
    meshed, kinds_mesh = _port_mesh_view(args, db)
    assert len(kinds_mesh) == 1 and len(count_calls) == 1 + 8
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "host")
    assert gated == meshed == _view(jax_view.main_view, args, db)


# BGT_TPU_MESH2 -> the executor kind on a 10-sample (32-word) database with
# 8 slots: the heuristic gives r = 8; a malformed value falls through to it
MESH2_CASES = [(None, "rs"), ("2x4", "rs"), ("1x8", "s"), ("8X1", "rs"),
               ("2x", "rs"), ("axb", "rs"), ("3x3", "rs"), ("2x4x1", "rs"),
               ("-2x-4", "rs"), ("", "rs")]


@pytest.mark.parametrize("mesh2,kind", MESH2_CASES,
                         ids=[str(c[0]) for c in MESH2_CASES])
def test_mesh2_production_path(tmp_path, monkeypatch, count_calls, mesh2,
                               kind):
    """A narrow database on 8 slots routes counts through the rows x columns
    executor ('rs') unless BGT_TPU_MESH2 puts every slot on the sample axis;
    the bytes equal bgt_tpu's host tier (bgt_tpu's
    test_mesh2_production_path, plus malformed values)."""
    db = _db(tmp_path, 10, 90, 31)
    args = ["-G", "-C", "-s", ",S0001,S0003"]
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "host")
    want = _view(jax_view.main_view, args, db)
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    monkeypatch.setenv("BGT_TPU_SHARD_MIN_ROWS", "0")
    monkeypatch.setenv("BGT_TPU_MESH_DEVICES", "8")
    if mesh2 is None:
        monkeypatch.delenv("BGT_TPU_MESH2", raising=False)
    else:
        monkeypatch.setenv("BGT_TPU_MESH2", mesh2)
    got, kinds = _port_mesh_view(args, db)
    assert kinds == [kind]
    assert len(count_calls) == 8  # every slot counted once
    assert got == want


def test_default_has_no_mesh(monkeypatch):
    """One slot and no process group: no context, the single-device path."""
    monkeypatch.delenv("BGT_TPU_MESH_DEVICES", raising=False)
    fastpath.reset_shard_context()
    assert fastpath.get_shard_context(CPU) is None
    monkeypatch.setenv("BGT_TPU_MESH_DEVICES", "2")
    monkeypatch.setenv("BGT_TPU_SHARD", "0")
    fastpath.reset_shard_context()
    try:
        assert fastpath.get_shard_context(CPU) is None
    finally:
        fastpath.reset_shard_context()


def test_executor_places_once_under_concurrency(tmp_path, monkeypatch):
    """Concurrent first requests place a database's planes on the mesh once
    (the build lock of ShardContext.executor)."""
    import threading
    db = _db(tmp_path, 12, 80, 5)
    TileStore.open_or_build(db)  # the .gtc exists before the requests
    monkeypatch.setenv("BGT_TPU_MESH_DEVICES", "4")
    monkeypatch.setenv("BGT_TPU_SHARD_MIN_ROWS", "0")
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    built = []
    real = fastpath.ShardContext._build

    def slow_build(self, ts):
        built.append(1)
        return real(self, ts)

    monkeypatch.setattr(fastpath.ShardContext, "_build", slow_build)
    fastpath.reset_shard_context()
    outs = {}
    go = threading.Barrier(6)

    def worker(i):
        go.wait(timeout=60)
        buf = io.StringIO()
        assert view.main_view(["-G", "-C", "-s", f",S000{i + 1}", db],
                              out=buf, device=CPU) == 0
        outs[i] = buf.getvalue()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
        fastpath.reset_shard_context()
    assert not any(t.is_alive() for t in threads)
    assert len(outs) == 6 and len(built) == 1
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "host")
    for i in range(6):
        assert outs[i] == _view(jax_view.main_view,
                                ["-G", "-C", "-s", f",S000{i + 1}"], db)


# --- two gloo processes ------------------------------------------------------

RANK = r"""
import io, json, os, sys, types
rank, port, dbdir, mode, repo = sys.argv[1:6]
rank = int(rank)
sys.path.insert(0, repo)
os.environ["BGT_TPU_MESH_DEVICES"] = "4"
if mode == "shards":
    os.environ["BGT_TPU_TILE_SHARD"] = f"{rank}:2"
import torch
from bgt_tpu_torch.parallel import distributed
distributed.initialize("127.0.0.1:" + port, 2, rank, timeout_s=120)
from bgt_tpu_torch.ops import counts
from bgt_tpu_torch.query import fastpath
from bgt_tpu_torch.query.view import main_view
calls = []
real = counts.count_codes_range
counts.count_codes_range = lambda *a: calls.append(a[4]) or real(*a)
os.chdir(dbdir)
SUBSET = ["-G", "-C", "-s", ",S0001,S0003,S0004"]

class BinOut:  # .buffer duck-type for the -b binary stream
    def __init__(self): self.buffer = io.BytesIO()
    def write(self, s): self.buffer.write(s.encode("latin-1"))
    def flush(self): pass

def run(name, args):
    fastpath._COUNT_MEMO.clear()
    out = BinOut() if "-b" in args else io.StringIO()
    assert main_view(args + ["db"], out=out, device="cpu") == 0
    data = out.buffer.getvalue() if "-b" in args else out.getvalue().encode()
    with open(f"{name}_{rank}.out", "wb") as fp:
        fp.write(data)

seen = {}
if mode == "full":
    os.environ["BGT_TPU_COUNT_TIER"] = "device"
    run("subset", SUBSET)
    seen["subset"] = len(calls)
elif mode == "auto":
    os.environ.pop("BGT_TPU_COUNT_TIER", None)
    if rank == 0:  # only rank 0 holds resident planes: the tier must not see it
        fastpath.get_device_tiles(types.SimpleNamespace(prefix="db"),
                                  torch.device("cpu"))
    run("subset", SUBSET)  # host on both ranks (the CPU device's cut)
    seen["subset"] = len(calls)
    os.environ["BGT_TPU_HOST_WORK_MAX"] = "0"
    run("subset_device", SUBSET)  # the mesh on both ranks
    seen["subset_device"] = len(calls) - seen["subset"]
else:
    for name, args in (("subset", SUBSET), ("gt", ["-C"]),
                       ("gtsub", ["-C", "-s", ",S0001,S0003,S0004"]),
                       ("bcf", ["-b", "-C"])):
        before = len(calls)
        run(name, args)
        seen[name] = len(calls) - before
    stores = list(fastpath._TILE_CACHE.values())
    assert stores and all(ts.is_shard for ts in stores), "full tile opened"
    assert stores[0].word_offset == rank * stores[0].n_words // 2
ctx = fastpath.get_shard_context(torch.device("cpu"))
assert ctx is not None and ctx.multi_process and ctx.n_dev == 8
assert "jax" not in sys.modules
print(json.dumps(seen), flush=True)
torch.distributed.destroy_process_group()
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_ranks(tmp_path, mode):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA", "JAX", "BGT_TPU_", "MASTER_"))
           and k not in ("RANK", "WORLD_SIZE")}
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(rank), port,
                               str(tmp_path), mode, str(REPO)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=env)
             for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=240)
            outs.append((p.returncode, out.decode(), err.decode()))
    except subprocess.TimeoutExpired:
        pytest.fail("distributed processes timed out")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rc, _out, err in outs:
        assert rc == 0, err[-3000:]
    return [json.loads(out.strip().splitlines()[-1]) for _rc, out, _e in outs]


class _BinOut:
    def __init__(self):
        self.buffer = io.BytesIO()

    def write(self, s):
        self.buffer.write(s.encode("latin-1"))

    def flush(self):
        pass


@pytest.mark.parametrize("mode", ["full", "auto", "shards"])
def test_two_process_mesh_byte_parity(tmp_path, monkeypatch, mode):
    """Two gloo ranks x 4 slots on the CPU: each places only its column
    slice of the full tiles ("full"; "auto" under the default tier with only
    rank 0's planes resident), or opens only its column-slice shard file,
    the full .gtc deleted ("shards", for -G -C -s, -C, -C -s and -b -C).
    Every output equals bgt_tpu's single-process bytes (bgt_tpu's
    tests/test_multiprocess.py)."""
    db = _db(tmp_path, 300, 150, 33, spl=True)
    monkeypatch.delenv("BGT_TPU_COUNT_TIER", raising=False)
    subset = ["-G", "-C", "-s", ",S0001,S0003,S0004"]
    want = {"subset": _view(jax_view.main_view, subset, db).encode()}
    if mode == "auto":
        want["subset_device"] = want["subset"]
    if mode == "shards":
        want["gt"] = _view(jax_view.main_view, ["-C"], db).encode()
        want["gtsub"] = _view(jax_view.main_view, ["-C", "-s",
                                                   ",S0001,S0003,S0004"],
                              db).encode()
        bo = _BinOut()
        assert jax_view.main_view(["-b", "-C", db], out=bo) == 0
        want["bcf"] = bo.buffer.getvalue()
        TileStore.emit_shards(db, 2, 8)
        os.unlink(db + ".gtc")  # the ranks cannot fall back to the full tile
    assert want["subset"].count(b"\n") > 100
    seen = _two_ranks(tmp_path, mode)
    for name, data in want.items():
        for rank in (0, 1):
            assert (tmp_path / f"{name}_{rank}.out").read_bytes() == data, \
                (name, rank)
    for s in seen:
        if mode == "auto":
            assert s == {"subset": 0, "subset_device": 4}
        elif mode == "full":
            assert s == {"subset": 4}  # the memo's full pass, 4 slots
        else:
            # the exact span per slot; GT-only queries count nothing
            assert s == {"subset": 4, "gt": 0, "gtsub": 4, "bcf": 0}


def test_column_shard_single_process_raises(tmp_path, monkeypatch):
    """A shard tile in one process with several slots still raises: no
    process holds the other columns."""
    db = _db(tmp_path, 40, 60, 8)
    TileStore.emit_shards(db, 2, 2)
    monkeypatch.setenv("BGT_TPU_TILE_SHARD", "0:2")
    monkeypatch.setenv("BGT_TPU_MESH_DEVICES", "2")
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", "device")
    fastpath._TILE_CACHE.clear()
    fastpath.reset_shard_context()
    try:
        with pytest.raises(ValueError, match="mesh"):
            _view(view.main_view, ["-G", "-C", "-s", ",S0001"], db, device=CPU)
    finally:
        fastpath._TILE_CACHE.clear()
        fastpath.reset_shard_context()


# --- dryrun_multichip and the torch array namespace --------------------------

@pytest.mark.parametrize("n", [4, 8])
def test_dryrun_multichip_matches_bgt_tpu(n):
    got = entry.dryrun_multichip(n, "cpu")
    ts, masks = entry._example_data(n_rows=64, m=32 * 8 * n)
    jm = jax_mesh.make_mesh(jax.devices()[:n])
    jp = jax_mesh.shard_planes(jm, ts.plane0, ts.plane1, masks)
    want = np.asarray(jax_mesh.sharded_count_fn(jm)(*jp))
    np.testing.assert_array_equal(got["counts"], want)
    stats = jax_counts.site_stats(jnp.asarray(want))
    flt, _err = jax_kexpr.parse("AC/AN>=0.1&&AC2==0")
    _t, keep = flt.compile_vector(jnp)({  # int32: JAX-CPU has no int64
        "AC": stats["AC"], "AN": stats["AN"], "AC2": jnp.asarray(want[:, 1, 1])})
    np.testing.assert_array_equal(got["keep"], np.asarray(keep))
    np.testing.assert_array_equal(
        got["codes"], np.asarray(jax_mesh.sharded_gather_codes_fn(jm)(*jp[:2])))
    jm2 = jax_mesh.make_mesh2(2, jax.devices()[:n])
    j0, j1, _ = jax_mesh.shard_planes2(jm2, ts.plane0, ts.plane1, masks)
    rows = np.array([0, 5, 17, ts.n_rows - 1], dtype=np.int32)
    np.testing.assert_array_equal(got["pairs2"], np.asarray(
        jax_mesh.sharded_pairs_rows2_fn(jm2)(j0, j1, jnp.asarray(rows))))
    np.testing.assert_array_equal(got["counts2"], want)


@pytest.mark.parametrize("n,have", [(4, 1), (16, 8)])
def test_dryrun_multichip_needs_n_cards(monkeypatch, n, have):
    """With no device the dry run spans n distinct cards, and fewer raise
    bgt_tpu's message (its dry run on the 8 JAX-CPU devices, for 16)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: have)
    with pytest.raises(AssertionError,
                       match=f"need {n} devices, have {have}"):
        entry.dryrun_multichip(n)
    if have == len(jax.devices()):
        sys.path.insert(0, str(REPO))
        import __graft_entry__
        with pytest.raises(AssertionError,
                           match=f"need {n} devices, have {have}"):
            __graft_entry__.dryrun_multichip(n)


# tests/test_kexpr.py's vector cases, and the operators they leave out
XP_EXPRS = ["AC>0", "AC/AN>=0.1&&AC2==0", "AC1/AN1>=0.1&&AC2==0", "AC+AN*2-3",
            "(AC>10)||(AN<50)", "AC%7==3", "AC//10>2", "sqrt(AC)",
            "log(AN)+exp(AC/AN)", "pow(AC,2)-AN", "log10(AN)>1.5",
            "sin(AC)*cos(AN)+tan(AC/AN)", "-AC+!AC2", "~AC^AN", "AC**2",
            "abs(AC-50)", "AC<<2|AN>>1", "1/AN", "AC&AN", "AC1!=AC2", "AN<=AC"]


@pytest.mark.parametrize("expr", XP_EXPRS)
def test_xp_torch_matches_numpy(expr):
    """``compile_vector(xp_torch)`` on torch tensors against
    ``compile_vector(np)``: the same types and dtypes, integer results
    equal, float results within 4 ulp (torch's vectorised sqrt and friends
    may round the last bit differently from numpy's)."""
    rng = np.random.default_rng(0)
    n = 1000
    env = {"AC": rng.integers(0, 100, n), "AN": rng.integers(1, 200, n),
           "AC1": rng.integers(0, 50, n), "AN1": rng.integers(1, 100, n),
           "AC2": rng.integers(0, 3, n)}
    ke, err = kexpr.parse(expr)
    assert err == 0
    ke.set_default_func()
    t_np, v_np = ke.compile_vector(np)(env)
    t_xp, v_xp = ke.compile_vector(xp_torch)(
        {k: torch.as_tensor(v) for k, v in env.items()})
    v_xp = v_xp.as_subclass(torch.Tensor).numpy()
    assert t_xp == t_np and v_xp.dtype == np.asarray(v_np).dtype
    if v_xp.dtype.kind == "f":
        np.testing.assert_allclose(v_xp, v_np, rtol=4 * np.finfo(float).eps)
    else:
        np.testing.assert_array_equal(v_xp, v_np)
