"""The flagship forward step on a torch device.

The counterpart of ``entry()`` in the repository's ``__graft_entry__.py``:
the masked-popcount genotype count over packed 2-bit planes, the per-site
AN/AC statistics, and the site filter ``AC/AN >= 0.05 && AC > 0``, on the
same numpy-seeded planes and masks.  On a CUDA device the count runs
kernel A.
"""

from __future__ import annotations

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
