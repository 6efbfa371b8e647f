"""bgt_tpu_torch.api against bgt_tpu.api, array for array.

The databases are written by the port's own importer.  The same query goes
through the port's ``Dataset`` on the CPU device with the device count tier
forced, and through ``bgt_tpu``'s on its JAX-CPU device tier and on its host
tier.  Every array of the results, and the genotype matrix, must be equal
(integers and codes: exact).
"""

import numpy as np
import pytest
import torch

import bgt_tpu
import bgt_tpu_torch
from bgt_tpu.query import fastpath as jax_fastpath
from bgt_tpu_torch import api, testing
from bgt_tpu_torch.ops import counts
from bgt_tpu_torch.query import fastpath, importer

FIELDS = ("chrom", "pos", "rlen", "ref", "alt", "has_m", "an", "ac", "ac_m",
          "group_an", "group_ac", "samples")


@pytest.fixture(scope="module")
def prefixes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torchapidb")
    out = []
    for name, n, seed in (("a", 14, 91), ("b", 9, 92)):
        (tmp / f"{name}.vcf").write_text(
            testing.random_vcf(n_samples=n, n_sites=120, seed=seed))
        importer.import_vcf(str(tmp / name), [str(tmp / f"{name}.vcf")],
                            is_vcf=True)
        (tmp / f"{name}.spl").write_text(testing.random_spl(n, seed=seed))
        out.append(str(tmp / name))
    return out


@pytest.fixture
def count_calls(monkeypatch):
    calls = []
    real = counts.count_codes_range

    def spy(*args, **kw):
        calls.append(1)
        return real(*args, **kw)

    monkeypatch.setattr(counts, "count_codes_range", spy)
    return calls


def _query(ds, monkeypatch, tier, kw):
    jax_fastpath._COUNT_MEMO.clear()
    fastpath._COUNT_MEMO.clear()
    fastpath._DEVICE_CACHE.clear()
    monkeypatch.setenv("BGT_TPU_COUNT_TIER", tier)
    res = ds.query(**kw)
    return res, res.genotypes() if kw.get("genotypes", True) else None


def _same(got, want):
    for name in FIELDS:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, np.ndarray):
            assert isinstance(a, np.ndarray) and a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert a == b, name


QUERIES = [
    dict(samples=['population=="CEU"', 'population=="YRI"'],
         region="11:100000-40000000", site_filter="AC1>=1||AN2>0"),
    dict(samples=[",S0001,S0003,S0005"], region="11:10000-90000000"),
    dict(samples=['population=="TSI"', ",S0002,S0004"], start=3, limit=17),
    dict(samples=['population=="YRI"'], site_filter="AC>0", genotypes=False),
]


@pytest.mark.parametrize("kw", QUERIES, ids=[str(i) for i in range(len(QUERIES))])
@pytest.mark.parametrize("which", ["one", "two"])
def test_query_matches_jax_api(prefixes, monkeypatch, count_calls, kw, which):
    dbs = prefixes[:1] if which == "one" else prefixes
    host, host_gt = _query(bgt_tpu.open(dbs), monkeypatch, "host", kw)
    jax_dev, jax_gt = _query(bgt_tpu.open(dbs), monkeypatch, "device", kw)
    assert not count_calls
    ours, our_gt = _query(api.open(dbs, torch.device("cpu")), monkeypatch,
                          "device", kw)
    assert count_calls, "the port's device count tier did not run"
    assert host.n_sites > 0
    _same(jax_dev, host)
    _same(ours, host)
    if host_gt is not None:
        assert our_gt.dtype == np.uint8
        np.testing.assert_array_equal(jax_gt, host_gt)
        np.testing.assert_array_equal(our_gt, host_gt)


def test_all_samples_query_uses_rowstats(prefixes, monkeypatch, count_calls):
    want, want_gt = _query(bgt_tpu.open(prefixes[0]), monkeypatch, "host", {})
    got, got_gt = _query(bgt_tpu_torch.open(prefixes[0], "cpu"), monkeypatch,
                         "device", {})
    _same(got, want)
    np.testing.assert_array_equal(got_gt, want_gt)
    assert not count_calls


def test_open_defaults_to_cuda(prefixes, monkeypatch):
    ds = bgt_tpu_torch.open(prefixes)
    want = bgt_tpu.open(prefixes)
    assert isinstance(ds, api.Dataset)
    assert ds.device == torch.device("cuda")
    assert ds.samples == want.samples
    assert ds.n_sites == want.n_sites
    assert [f.prefix for f in ds.files] == [f.prefix for f in want.files]
    if not torch.cuda.is_available():
        # the default tier is auto: without CUDA a counted query raises
        monkeypatch.delenv("BGT_TPU_COUNT_TIER", raising=False)
        fastpath._COUNT_MEMO.clear()
        with pytest.raises(RuntimeError, match="not available"):
            ds.query(samples=['population=="YRI"'])


def test_bad_inputs_raise(prefixes):
    ds = api.open(prefixes[0], "cpu")
    with pytest.raises(ValueError, match="site filter"):
        ds.query(site_filter="AC>)")
    with pytest.raises(ValueError, match="region"):
        ds.query(region="nonexistent:1-2")
