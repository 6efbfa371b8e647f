"""bgt_tpu_torch's one-mask raw count and its roofline probe against bgt_tpu.

The reference probe's Pallas kernel (``tools/probe_roofline.py``,
``count_pallas``) is nested inside its ``main()`` and cannot be imported,
so the raw sums n10, n11, nb of ``count_raw`` (its plain version on a CPU
tensor) are held against ``bgt_tpu.ops.counts.count_codes`` on JAX-CPU
through the inverse of the affine step: n10 = cnt1 + cnt3,
n11 = cnt2 + cnt3, nb = cnt3.  The probe's plain variants A-D are held
against the same counts, and the probe itself runs on the CPU at a small
size.  Inputs come from numpy seeds; counts are integers, so the tolerance
is 0.
"""

import json
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bgt_tpu.ops import counts as jax_counts
from bgt_tpu_torch.ops import counts
from bgt_tpu_torch.tools import probe_roofline

CPU = torch.device("cpu")
REFERENCE = Path(__file__).resolve().parent.parent / "tools" / "probe_roofline.py"


def _inputs(rows, words, groups, seed):
    """uint32 words, with all-ones and sign-bit-only words mixed in."""
    rng = np.random.default_rng(seed)
    out = [rng.integers(0, 2**32, shape, dtype=np.uint32)
           for shape in ((rows, words), (rows, words), (groups, words))]
    for w in out:
        w.reshape(-1)[0::5] = 0xFFFFFFFF
        w.reshape(-1)[1::7] = 0x80000000
    return out


def _raw_from_counts(c):
    """(rows, 1, 4) counts -> (rows, 3) n10, n11, nb."""
    c = c[:, 0]
    return np.stack([c[:, 1] + c[:, 3], c[:, 2] + c[:, 3], c[:, 3]], axis=1)


def _torch(*arrays):
    return [counts.planes_to_torch(a, CPU) for a in arrays]


SHAPES = [(256, 2048), (300, 157), (1, 1), (0, 2048)]


@pytest.mark.parametrize("rows,words", SHAPES,
                         ids=[f"{r}x{w}" for r, w in SHAPES])
def test_count_raw_matches_jax(rows, words):
    p0, p1, mask = _inputs(rows, words, 1, seed=rows + words)
    got = counts.counts_to_numpy(counts.count_raw(*_torch(p0, p1, mask)))
    assert got.dtype == np.int32 and got.shape == (rows, 3)
    want = np.asarray(jax_counts.count_codes(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(mask)))
    np.testing.assert_array_equal(got, _raw_from_counts(want))


@pytest.mark.parametrize("start,length", [(0, 300), (17, 100), (299, 1),
                                          (150, 0)])
def test_count_raw_range_offsets(start, length):
    p0, p1, mask = _inputs(300, 157, 1, seed=4)
    got = counts.count_raw_range(*_torch(p0, p1, mask), start, length)
    assert got.shape == (length, 3)
    want = np.asarray(jax_counts.count_codes_range(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(mask), start, length))
    np.testing.assert_array_equal(counts.counts_to_numpy(got),
                                  _raw_from_counts(want))


def test_count_raw_rejects_bad_inputs():
    t = torch.zeros((10, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="one mask"):
        counts.count_raw(t, t, t[:2])
    with pytest.raises(ValueError):
        counts.count_raw_range(t, t, t[:1], 8, 3)
    with pytest.raises(TypeError):
        counts.count_raw(t, t, t[:1].to(torch.int64))
    meta = t.to("meta")
    with pytest.raises(ValueError, match="no count kernel"):
        counts.count_raw(meta, meta, meta[:1])


@pytest.mark.parametrize("variant", [probe_roofline.count_i16,
                                     probe_roofline.count_reshape,
                                     probe_roofline.count_mm,
                                     probe_roofline.count_stack],
                         ids=lambda f: f.__name__)
def test_probe_variants_match_jax(variant):
    p0, p1, masks = _inputs(64, probe_roofline.WORDS, 3, seed=9)
    got = variant(*_torch(p0, p1, masks))
    want = np.asarray(jax_counts.count_codes(
        jnp.asarray(p0), jnp.asarray(p1), jnp.asarray(masks)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(counts.counts_to_numpy(got), want[..., 1:])


def test_probe_i16_needs_2048_words():
    t = torch.zeros((4, 1024), dtype=torch.int32)
    with pytest.raises(ValueError, match="2048 words"):
        probe_roofline.count_i16(t, t, t[:1])


def test_probe_on_cpu(tmp_path, capsys):
    out = tmp_path / "roofline.json"
    assert probe_roofline.main(["256", "1", "--device", "cpu",
                                "--out", str(out)]) == 0
    res = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == res
    ref_variants = re.findall(r'\bbw\("(\w+)"', REFERENCE.read_text())
    variants = [("count_raw_1mask" if v == "count_pallas_1mask" else v)
                for v in ref_variants]
    assert set(res) == set(variants) | {
        "backend", "device_kind", "power_limit", "rows", "words", "k",
        "plane_bytes"}
    assert "first_readback_s" not in res and "count_pallas_1mask" not in res
    assert (res["backend"], res["rows"], res["words"], res["k"]) == (
        "cpu", 256, 2048, 1)
    assert res["plane_bytes"] == 2 * 256 * 2048 * 4
    for v in variants:
        assert res[v]["s"] > 0 and res[v]["gbs"] >= 0, v
    assert res["count_raw_1mask"]["replaces"] == "tools/probe_roofline.py:190"


def test_probe_needs_a_card_for_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        probe_roofline.run(8, 1, "cuda")
