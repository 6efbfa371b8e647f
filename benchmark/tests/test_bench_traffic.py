"""The traffic generator: the same seed gives the same schedule, every
request is well formed, and every seed gets the same sizes and arrivals."""

from collections import Counter
from urllib.parse import parse_qs, urlsplit

import numpy as np
import pytest

from benchmark import cohort, traffic
from benchmark.reference import eval_filter
from helpers import tiny_cell

SEED = 3 * 2 ** 31 + 5


def make(mix, config="tiny", seed=SEED):
    cell = tiny_cell(mix, config)
    coh = cohort.make_cohort(cell.config, seed)
    return cell, coh, traffic.Generator(cell.mix, cell.config, coh, seed)


def schedule(mix, config="tiny", seed=SEED):
    _cell, _coh, gen = make(mix, config, seed)
    return [(r.path, r.due) for r in gen.warmup() + gen.window(10.0, 48)]


@pytest.mark.parametrize("mix,config", [("tiny_open", "tiny"), ("tiny_scan", "tiny"),
                                        ("tiny_pop", "tiny1kg")])
def test_same_seed_same_schedule(mix, config):
    assert schedule(mix, config) == schedule(mix, config)
    assert schedule(mix, config) != schedule(mix, config, SEED + 1)


@pytest.mark.parametrize("mix,config", [("tiny_open", "tiny"), ("tiny_scan", "tiny"),
                                        ("tiny_pop", "tiny1kg")])
def test_requests_are_well_formed(mix, config):
    cell, coh, gen = make(mix, config)
    reqs = gen.warmup() + gen.window(10.0, 48)
    labels = {k: set(v.tolist()) for k, v in coh.meta.items()}
    for r in reqs:
        q = parse_qs(urlsplit(r.path).query, keep_blank_values=True)
        assert q["r"] == [f"{coh.chrom}:{r.region[0]}-{r.region[1]}"]
        assert coh.pos[0] <= r.region[0] <= r.region[1] <= coh.pos[-1]
        assert q["s"] == [traffic.render_group(g) for g in r.groups]
        assert "&&" not in r.path and "||" not in r.path
        assert r.groups
        for g in r.groups:
            for key, op, val in g:
                assert op in (">=", "<", "==")
                if isinstance(val, str):
                    assert val in labels[key]
        if r.filter is not None:
            assert q["f"] == [traffic.render_filter(r.filter)]
            env = {"AC": np.ones(2, np.int64), "AN": np.ones(2, np.int64)}
            for k in range(len(r.groups)):
                env[f"AC{k + 1}"] = env[f"AN{k + 1}"] = env["AC"]
            eval_filter(r.filter, env)
        for k, v in cell.mix["params"].items():
            assert q[k] == [v]


def test_open_loop_arrivals_and_shares():
    cell, _coh, gen = make("tiny_open")
    reqs = gen.window(10.0)
    n = round(cell.mix["rate_per_s"] * 10.0)
    assert len(reqs) == n
    due = np.array([r.due for r in reqs])
    assert due[0] > 0.0 and (np.diff(due) > 0).all() and due[-1] == pytest.approx(10.0)
    # the same gaps and shares for every seed, in another order
    _c, _h, other = make("tiny_open", seed=SEED + 9)
    due2 = np.array([r.due for r in other.window(10.0)])
    assert np.allclose(np.sort(np.diff(due, prepend=0)), np.sort(np.diff(due2, prepend=0)))
    blocks = [min(traffic.BLOCK, n - lo) for lo in range(0, n, traffic.BLOCK)]
    shares = Counter(len(r.groups) for r in reqs)
    assert shares[2] == sum(traffic._exact_counts([0.6, 0.4], b)[1] for b in blocks)
    assert shares[1] == n - shares[2]
    assert sum(r.filter is not None for r in reqs) == sum(
        traffic._exact_counts([0.7, 0.3], b)[1] for b in blocks)
    # every block of arrivals holds the same gaps
    gaps = np.diff(due, prepend=0)
    for lo in range(0, n - traffic.BLOCK + 1, traffic.BLOCK):
        assert np.allclose(np.sort(gaps[lo: lo + traffic.BLOCK]),
                           np.sort(gaps[:traffic.BLOCK]))
    lengths = sorted(r.region[1] - r.region[0] for r in reqs)
    assert lengths == sorted(r.region[1] - r.region[0] for r in other.window(10.0))


def test_fresh_groups_never_repeat():
    _cell, _coh, gen = make("tiny_open")
    reqs = gen.warmup() + gen.window(10.0)
    keys = [tuple(tuple(g) for g in r.groups) for r in reqs]
    assert len(set(keys)) == len(keys)
    for r in reqs:
        if len(r.groups) == 2:
            assert r.groups[0][0][2] != r.groups[1][0][2]  # distinct cohorts


def test_fixed_groups_and_reversed_warmup():
    _cell, coh, gen = make("tiny_pop", "tiny1kg")
    reqs = gen.window(10.0)
    sup = sorted(set(coh.meta["super_population"].tolist()))
    pops = sorted(set(coh.meta["population"].tolist()))
    for r in reqs:
        assert [g[0][2] for g in r.groups] in (sup, pops)
    for r in gen.warmup():
        assert [g[0][2] for g in r.groups] in (sup[::-1], pops[::-1])


def test_closed_loop_blocks_and_windows():
    cell, coh, gen = make("tiny_scan")
    reqs = gen.window(10.0, 64)
    assert len(reqs) == 64 and all(r.due is None for r in reqs)
    lo, hi = cell.config["samples"]["metadata"]["age"]["int_uniform"]
    for r in reqs:
        (k1, op1, t), (k2, op2, u) = r.groups[0]
        assert (k1, op1, k2, op2) == ("age", ">=", "age", "<")
        assert 8 <= u - t <= 36 and lo <= t and u <= hi + 1
        assert r.region[1] - r.region[0] + 1 >= cell.mix["regions"]["min_bp"]


def test_paced_arrivals_are_even():
    _cell, _coh, gen = make("tiny_open")
    due = np.array([r.due for r in gen.window(10.0)])
    assert np.allclose(np.diff(due, prepend=0), 10.0 / len(due))


@pytest.mark.parametrize("mix,config", [("tiny_open", "tiny"), ("tiny_scan", "tiny"),
                                        ("tiny_pop", "tiny1kg")])
def test_warmup_one_request_a_group_set(mix, config):
    cell, coh, gen = make(mix, config)
    reqs = gen.warmup()
    assert len(reqs) == len(cell.mix["group_sets"])
    assert reqs[0].region == (int(coh.pos[0]), int(coh.pos[-1]))
    for r, gset in zip(reqs, cell.mix["group_sets"]):
        n = len(gset["groups"]) if "groups" in gset else len(set(coh.meta[gset["each_label"]].tolist()))
        assert len(r.groups) == n
