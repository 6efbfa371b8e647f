"""bgt_tpu_torch.entry against the repository's ``__graft_entry__.entry``.

The JAX step runs under ``jax.jit`` on the CPU (its count takes the jnp
formulation there, as in the JAX package's own tests); the port's step runs
the plain PyTorch count on the CPU.  The inputs must hold the same bits and
the counts and the filter must be equal (exact).
"""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from bgt_tpu_torch import entry as port_entry
from bgt_tpu_torch.ops import counts


def test_example_data_is_the_same():
    ts, masks = port_entry._example_data()
    want_ts, want_masks = graft._example_data()
    np.testing.assert_array_equal(ts.plane0, want_ts.plane0)
    np.testing.assert_array_equal(ts.plane1, want_ts.plane1)
    np.testing.assert_array_equal(masks, want_masks)


def test_entry_matches_jax_entry():
    fwd, args = port_entry.entry("cpu")
    jfwd, jargs = graft.entry()
    assert all(a.dtype == torch.int32 and a.device.type == "cpu" for a in args)
    for a, b in zip(args, jargs):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))
    got_counts, got_keep = fwd(*args)
    want_counts, want_keep = jax.jit(jfwd)(*jargs)
    assert got_counts.shape == (256, 2, 4) and got_counts.dtype == torch.int32
    assert got_keep.dtype == torch.bool
    np.testing.assert_array_equal(counts.counts_to_numpy(got_counts),
                                  np.asarray(want_counts))
    np.testing.assert_array_equal(got_keep.numpy(), np.asarray(want_keep))
    assert int(got_keep.sum()) > 0


def test_entry_defaults_to_cuda():
    if torch.cuda.is_available():
        _fwd, args = port_entry.entry()
        assert all(a.device.type == "cuda" for a in args)
        return
    # torch built without CUDA refuses to make the tensors
    with pytest.raises((RuntimeError, AssertionError), match="CUDA"):
        port_entry.entry()
