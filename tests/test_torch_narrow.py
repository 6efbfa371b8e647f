"""bgt_tpu_torch's count_codes_narrow against the JAX narrow-width experiment.

The experiment, ``docs/experiments/pallas_count.py``, is loaded from its
file and its Pallas kernel runs in interpret mode on JAX-CPU:
``jax.experimental.pallas.pallas_call`` is patched to pass
``interpret=True``, and the experiment imports ``pallas`` inside its
function, so it takes the patched call; its file is not changed.  On a CPU
tensor ``count_codes_narrow`` is its plain version, ``count_codes_reference``.
Inputs come from numpy seeds; counts are integers, so the tolerance is 0.
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas

from bgt_tpu.ops import counts as jax_counts
from bgt_tpu_torch.experiments import narrow_count
from bgt_tpu_torch.ops import counts

CPU = torch.device("cpu")
EXPERIMENT = (Path(__file__).resolve().parent.parent / "docs" / "experiments"
              / "pallas_count.py")


@pytest.fixture
def experiment(monkeypatch):
    """The experiment module, with its pallas_call in interpret mode."""
    monkeypatch.setattr(pallas, "pallas_call",
                        functools.partial(pallas.pallas_call, interpret=True))
    spec = importlib.util.spec_from_file_location("pallas_count_experiment",
                                                  EXPERIMENT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(rows, words, groups, seed):
    """uint32 words, with all-ones and sign-bit-only words mixed in."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 2**32, shape, dtype=np.uint32)
           for shape in ((rows, words), (rows, words), (groups, words))]
    for w in out:
        w.reshape(-1)[0::5] = 0xFFFFFFFF
        w.reshape(-1)[1::7] = 0x80000000
    return out


def _narrow(p0, p1, masks):
    return counts.counts_to_numpy(counts.count_codes_narrow(
        *(counts.planes_to_torch(a, CPU) for a in (p0, p1, masks))))


# (rows, words, groups, row_tile): ragged row tiles, 1 to 32 groups, the
# experiment's 160-word width and the 1kg bench width of 157; then rows,
# words and groups at the edges of the CUDA kernel's 16-row tile, 8-word
# k-step and 8-group octet
INTERPRET_SHAPES = [(300, 157, 3, 64), (64, 157, 32, 64), (1, 160, 1, 512),
                    (17, 9, 9, 16), (33, 8, 8, 32), (15, 17, 31, 8),
                    (16, 7, 7, 16), (1, 1, 32, 8)]


@pytest.mark.parametrize("rows,words,groups,row_tile", INTERPRET_SHAPES,
                         ids=[f"{r}x{w}x{g}" for r, w, g, _ in INTERPRET_SHAPES])
def test_narrow_matches_jax_experiment(experiment, rows, words, groups,
                                       row_tile):
    p0, p1, masks = _inputs(rows, words, groups, seed=rows + words + groups)
    got = _narrow(p0, p1, masks)
    assert got.dtype == np.int32 and got.shape == (rows, groups, 4)
    want = np.asarray(experiment.count_codes_pallas(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(masks),
        row_tile=row_tile))
    np.testing.assert_array_equal(got, want)


# at the shared-memory limit (32 groups x 1,816 words; 1 group x 58,112
# words), one word, and no rows
EDGE_SHAPES = [(5, 1816, 32), (3, 58112, 1), (9, 1, 5), (0, 157, 2)]


@pytest.mark.parametrize("rows,words,groups", EDGE_SHAPES,
                         ids=[f"{r}x{w}x{g}" for r, w, g in EDGE_SHAPES])
def test_narrow_limits_match_count_codes(rows, words, groups):
    p0, p1, masks = _inputs(rows, words, groups, seed=words)
    got = _narrow(p0, p1, masks)
    assert got.shape == (rows, groups, 4)
    want = np.asarray(jax_counts.count_codes(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(masks)))
    np.testing.assert_array_equal(got, want)


def test_narrow_no_groups():
    p0, p1, masks = _inputs(4, 157, 0, seed=0)
    assert _narrow(p0, p1, masks).shape == (4, 0, 4)


@pytest.mark.parametrize("groups,words", [(33, 157), (32, 2048), (32, 1817),
                                          (1, 58113)])
def test_narrow_rejects_outside_limits(groups, words):
    p = torch.zeros((4, words), dtype=torch.int32)
    m = torch.zeros((groups, words), dtype=torch.int32)
    with pytest.raises(ValueError):
        counts.count_codes_narrow(p, p, m)


def test_narrow_rejects_other_devices():
    meta = torch.empty((10, 4), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no count kernel"):
        counts.count_codes_narrow(meta, meta, meta[:2])


def test_narrow_experiment_on_cpu(capsys):
    recs = narrow_count.run("cpu", shapes=[(64, 157, 2), (0, 160, 3)], reps=1)
    assert [(r["rows"], r["words"], r["groups"]) for r in recs] == [
        (64, 157, 2), (0, 160, 3)]
    for r in recs:
        assert {"narrow_ms", "count_codes_ms", "plain_ms"} <= set(r)
    assert capsys.readouterr().out.count("[narrow] cpu: ") == 2
