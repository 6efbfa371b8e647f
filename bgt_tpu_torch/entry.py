"""The flagship forward step on a torch device, and its dry run on a mesh.

The counterparts of ``entry()`` and ``dryrun_multichip()`` in the
repository's ``__graft_entry__.py``: the masked-popcount genotype count over
packed 2-bit planes, the per-site AN/AC statistics, and a site filter, on
the same numpy-seeded planes and masks; the dry run shards them over a mesh
of slots: distinct cards, or several slots on one device.  On a CUDA device
every count runs kernel A.
"""

from __future__ import annotations

import contextlib
import io
import os
import tempfile

import numpy as np
import torch

from .ops import counts as counts_ops
from .ops.tiles import TileStore


def _example_data(n_rows: int = 256, m: int = 1024, n_groups: int = 2,
                  seed: int = 0) -> tuple[TileStore, np.ndarray]:
    """The planes and masks of ``__graft_entry__._example_data``: the same
    numpy draws in the same order."""
    rng = np.random.default_rng(seed)
    codes = rng.choice(4, size=(n_rows, m),
                       p=[0.7, 0.2, 0.05, 0.05]).astype(np.uint8)
    ts = TileStore.from_codes(codes)
    masks = np.stack([
        ts.pack_mask(rng.choice(m, size=m // 2, replace=False)),
        ts.pack_mask(np.arange(m)),
    ][:n_groups])
    return ts, masks


def forward(p0: torch.Tensor, p1: torch.Tensor, masks: torch.Tensor):
    """(counts (rows, groups, 4) int32, keep (rows,) bool)."""
    counts = counts_ops.count_codes(p0, p1, masks)
    stats = counts_ops.site_stats(counts)
    # the site filter AC/AN>=0.05 && AC>0, in integers
    keep = (stats["AC"] * 20 >= stats["AN"]) & (stats["AC"] > 0)
    return counts, keep


def entry(device: torch.device | str | None = None):
    """(forward, args): ``args`` are the example's planes and masks as int32
    tensors on ``device`` (default ``cuda``), holding the same bits."""
    device = torch.device("cuda" if device is None else device)
    ts, masks = _example_data()
    args = tuple(counts_ops.planes_to_torch(a, device)
                 for a in (ts.plane0, ts.plane1, masks))
    return forward, args


@contextlib.contextmanager
def _env(**kv):
    old = {k: os.environ.get(k) for k in kv}
    os.environ.update(kv)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _dryrun_slots(n_devices: int, device) -> list[torch.device]:
    """``n_devices`` distinct cards ``cuda:0 .. cuda:n-1`` (``bgt_tpu``'s
    ``jax.devices()[:n]``), or ``n_devices`` slots on an explicit
    ``device``."""
    if device is not None:
        return [torch.device(device)] * n_devices
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    _check(have >= n_devices, f"need {n_devices} devices, have {have}")
    return [torch.device("cuda", i) for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device: torch.device | str | None = None
                     ) -> dict:
    """Run the full sharded query step over an in-process mesh of
    ``n_devices`` slots, and check it.  With no ``device`` the slots are
    ``n_devices`` distinct cards (``cuda:0 .. cuda:n-1``), as ``bgt_tpu``'s
    dry run spans ``n`` chips, and fewer visible cards raise
    AssertionError("need n devices, have k"); with ``device`` they are
    ``n_devices`` slots on it.

    The sample-column axis is sharded: each slot's local counts (kernel A on
    a card), their sum, ``site_stats`` and the filter ``AC/AN>=0.1&&AC2==0``
    on the first slot (``kexpr.compile_vector`` over ``core/xp_torch``), and
    each slot's local ``decode_codes``; counts and codes are held to the
    single-device ``count_codes``/``decode_codes`` on the first slot.  With
    ``n_devices`` >= 4 and even, also the 2-axis mesh's counts and pairs,
    then the production 2-axis ``view`` through ``ShardContext``
    byte-compared with the host tier, on the same slots.  Returns the numpy
    counts, keep vector, codes and (2-axis) pairs; raises AssertionError on
    any mismatch."""
    from .core import kexpr, xp_torch
    from .parallel import mesh as meshlib

    slots = _dryrun_slots(n_devices, device)
    first = slots[0]
    mesh = meshlib.make_mesh(slots)
    ts, masks = _example_data(n_rows=64, m=32 * 8 * n_devices)
    p0, p1, msk = meshlib.shard_planes(mesh, ts.plane0, ts.plane1, masks)

    flt, err = kexpr.parse("AC/AN>=0.1&&AC2==0")
    _check(err == 0, "filter parse error")
    flt_fn = flt.compile_vector(xp_torch)

    local = [counts_ops.count_codes(a, b, m) for a, b, m in zip(p0, p1, msk)]
    counts = meshlib.psum(mesh, local)
    stats = counts_ops.site_stats(counts)
    _t, keep = flt_fn({"AC": stats["AC"].to(torch.int64),
                       "AN": stats["AN"].to(torch.int64),
                       "AC2": counts[:, 1, 1].to(torch.int64)})
    codes = meshlib.all_gather_cols(
        mesh, [counts_ops.decode_codes(a, b) for a, b in zip(p0, p1)])

    d0, d1, dm = (counts_ops.planes_to_torch(a, first)
                  for a in (ts.plane0, ts.plane1, masks))
    _check(torch.equal(counts, counts_ops.count_codes(d0, d1, dm)),
           "sharded counts mismatch")
    _check(torch.equal(codes, counts_ops.decode_codes(d0, d1)),
           "sharded codes mismatch")
    out = {"counts": counts.cpu().numpy(),
           "keep": keep.as_subclass(torch.Tensor).cpu().numpy(),
           "codes": codes.cpu().numpy()}

    # 2-axis (site-batch x sample-column) mesh: rows shard along 'r',
    # columns along 's'; the sum rides 's' only and stays row-sharded
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2 = meshlib.make_mesh2(2, slots)
        q0, q1, qm = meshlib.shard_planes2(mesh2, ts.plane0, ts.plane1, masks)
        blocks = meshlib.sharded_count2_fn(mesh2)(q0, q1, qm)
        counts2 = torch.cat([b.cpu() for b in blocks])[: ts.n_rows]
        _check(torch.equal(counts2, counts.cpu()),
               "2-axis mesh counts mismatch")
        rows_sel = np.array([0, 5, 17, ts.n_rows - 1], dtype=np.int32)
        pairs2 = meshlib.sharded_pairs_rows2_fn(mesh2)(q0, q1, rows_sel).cpu()
        want = out["codes"][rows_sel]
        want = (want[:, 0::2] << 2) | want[:, 1::2]
        _check(np.array_equal(pairs2.numpy()[:, : want.shape[1]], want),
               "2-axis mesh pairs mismatch")
        out["counts2"] = counts2.numpy()
        out["pairs2"] = pairs2.numpy()
        _production_mesh2(slots, first if device is not None
                          else torch.device("cuda"))
    return out


def _production_mesh2(slots: list, device: torch.device) -> None:
    """A real database through the query path's ``ShardContext`` on a
    rows x columns mesh of ``slots``, counting from the entry point's
    ``device``, byte-compared with the single-device host tier."""
    from . import testing
    from .query import fastpath, importer
    from .query.view import main_view

    def run_query(tmp, mesh_slots, **env):
        with _env(**env):
            fastpath.reset_shard_context()
            fastpath._COUNT_MEMO.clear()
            if mesh_slots:
                fastpath.get_shard_context(device, mesh_slots)
            buf, err = io.StringIO(), io.StringIO()
            rc = main_view(["-G", "-C", "-s", ",S0001,S0003",
                            os.path.join(tmp, "db")], out=buf, err=err,
                           device=device)
            _check(rc == 0, f"view failed: {err.getvalue()[-2000:]}")
            sc = fastpath.get_shard_context(device)
            kinds = [e.kind for e in sc._planes.values()] if sc else []
            fastpath.reset_shard_context()
            return buf.getvalue(), kinds

    n = len(slots)
    with tempfile.TemporaryDirectory(prefix="bgt_dryrun_") as tmp:
        with open(os.path.join(tmp, "in.vcf"), "w") as fp:
            fp.write(testing.random_vcf(n_samples=10, n_sites=96, seed=5))
        importer.import_vcf(os.path.join(tmp, "db"),
                            [os.path.join(tmp, "in.vcf")], is_vcf=True)
        want, _ = run_query(tmp, None, BGT_TPU_SHARD="0",
                            BGT_TPU_COUNT_TIER="host")
        got, kinds = run_query(tmp, slots, BGT_TPU_SHARD="1",
                               BGT_TPU_COUNT_TIER="device",
                               BGT_TPU_SHARD_MIN_ROWS="0",
                               BGT_TPU_MESH2=f"{n // 2}x2")
    _check(kinds == ["rs"], f"production 2-axis executor did not engage: "
                            f"{kinds}")
    _check(got == want, "production 2-axis mesh query bytes differ")
