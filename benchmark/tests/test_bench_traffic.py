"""The traffic generator: the same seed gives the same schedule, every
request is well formed, and every seed gets the same work: the same
arrivals and the same multiset of requests' sizes, in another order."""

from collections import Counter
from urllib.parse import parse_qs, urlsplit

import numpy as np
import pytest

from benchmark import cohort, spec, traffic
from benchmark.reference import eval_filter
from helpers import tiny_cell

SEED = 3 * 2 ** 31 + 5
SEEDS = [SEED + 7919 * k for k in range(8)]
CELLS = ["hrc_r1.adhoc_af", "1kg_p3.population_af"]


def make(mix, config="tiny", seed=SEED):
    cell = tiny_cell(mix, config)
    coh = cohort.make_cohort(cell.config, seed)
    return cell, coh, traffic.Generator(cell.mix, cell.config, coh, seed)


def schedule(mix, config="tiny", seed=SEED):
    _cell, _coh, gen = make(mix, config, seed)
    return [(r.path, r.due) for r in gen.warmup() + gen.window(10.0, 48)]


def make_cell(name, seed=SEED):
    """A cell of ``BENCHMARK.json`` with its cohort's sites and samples
    (the generator reads no genotypes)."""
    cell = spec.Cell(spec.load(), name)
    pos, ref, alt = cohort.make_sites(cell.config, seed)
    names, meta = cohort.make_samples(cell.config, seed)
    coh = cohort.Cohort(None, pos, ref, alt, names, meta, cell.config["chrom"],
                        cell.config["chrom_len"])
    return cell, coh, traffic.Generator(cell.mix, cell.config, coh, seed)


def any_cell(name, seed=SEED):
    """(cell, cohort, generator, window seconds) of a tiny mix or of a cell."""
    if name in CELLS:
        return (*make_cell(name, seed), 51.0)
    return (*make(name, "tiny1kg" if name == "tiny_pop" else "tiny", seed), 10.0)


def gset_of(mix, coh, r) -> int:
    """The index of the group set ``r`` was drawn from."""
    for k, g in enumerate(mix["group_sets"]):
        if "each_label" in g:
            labs = sorted(set(coh.meta[g["each_label"]].tolist()))
            if [grp[0][2] for grp in r.groups] == labs:
                return k
        elif len(r.groups) == len(g["groups"]):
            return k
    raise AssertionError(r.path)


def work(mix, coh, reqs) -> list:
    """The window's multiset of (group set, region length, filter, drawn
    labels, drawn integers)."""
    return sorted((gset_of(mix, coh, r), r.region[1] - r.region[0] + 1, r.filter or "",
                   tuple(v for g in r.groups for _k, _op, v in g if isinstance(v, str)),
                   tuple(int(v) for g in r.groups for _k, _op, v in g
                         if not isinstance(v, str)))
                  for r in reqs)


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


@pytest.mark.parametrize("name", ["tiny_open", "tiny_pop"] + CELLS)
def test_open_loop_arrivals_and_shares(name):
    cell, coh, gen, seconds = any_cell(name)
    reqs = gen.window(seconds)
    n = round(cell.mix["rate_per_s"] * seconds)
    assert len(reqs) == n
    due = np.array([r.due for r in reqs])
    assert due[0] > 0.0 and (np.diff(due) > 0).all() and due[-1] == pytest.approx(seconds)
    # the same gaps and shares for every seed, in another order
    _c, _h, other, _s = any_cell(name, SEED + 9)
    due2 = np.array([r.due for r in other.window(seconds)])
    assert np.allclose(np.sort(np.diff(due, prepend=0)), np.sort(np.diff(due2, prepend=0)))
    blocks = [min(traffic.BLOCK, n - lo) for lo in range(0, n, traffic.BLOCK)]
    shares = [g["share"] for g in cell.mix["group_sets"]]
    got = Counter(gset_of(cell.mix, coh, r) for r in reqs)
    assert got[1] == sum(traffic._exact_counts(shares, b)[1] for b in blocks)
    assert got[0] == n - got[1]
    f = cell.mix["filters"]["share"]
    assert sum(r.filter is not None for r in reqs) == sum(
        traffic._exact_counts([1 - f, f], b)[1] for b in blocks)
    # every block of arrivals holds the same gaps
    gaps = np.diff(due, prepend=0)
    for lo in range(0, n - traffic.BLOCK + 1, traffic.BLOCK):
        assert np.allclose(np.sort(gaps[lo: lo + traffic.BLOCK]),
                           np.sort(gaps[:traffic.BLOCK]))
    lengths = sorted(r.region[1] - r.region[0] for r in reqs)
    assert lengths == sorted(r.region[1] - r.region[0] for r in other.window(seconds))


@pytest.mark.parametrize("name", ["tiny_open", "tiny_pop"] + CELLS)
def test_every_seed_gets_the_same_work(name):
    """The window's multiset of (group set, region length, filter, labels,
    integers) is the mix's alone; the seed changes the order and the
    intervals' starts."""
    windows, orders, starts = [], set(), set()
    for seed in SEEDS:
        cell, coh, gen, seconds = any_cell(name, seed)
        gen.warmup()
        reqs = gen.window(seconds)
        windows.append(work(cell.mix, coh, reqs))
        orders.add(tuple(r.filter or "" for r in reqs))
        starts.add(tuple(sorted(r.region[0] for r in reqs)))
    assert all(w == windows[0] for w in windows[1:])
    assert len(orders) == len(SEEDS) and len(starts) == len(SEEDS)


@pytest.mark.parametrize("name", CELLS)
def test_marginals_are_the_mix_s(name):
    """Each block's regions are the Zipf ranks at its quantile levels, with
    their lengths; over the mix's draws (windows of other streams) each
    label comes up about equally often and the integers spread uniformly
    over their range."""
    cell, coh, gen, seconds = any_cell(name)
    gen.warmup()
    reqs = gen.window(seconds)
    spec_r = cell.mix["regions"]
    starts, lengths = gen._intervals
    cdf = np.cumsum(np.arange(1, spec_r["count"] + 1, dtype=float) ** -spec_r["zipf_s"])
    for lo in range(0, len(reqs), traffic.BLOCK):
        block = reqs[lo: lo + traffic.BLOCK]
        u = (np.arange(len(block)) + 0.5) / len(block)
        ranks = np.searchsorted(cdf / cdf[-1], u)
        assert sorted((int(starts[k]), int(starts[k] + lengths[k] - 1)) for k in ranks) \
            == sorted(r.region for r in block)
    pooled = list(reqs)
    for stream in range(10, 17):
        _c, _h, other, _s = any_cell(name)
        pooled += other.window(seconds, stream=stream)
    tmpls = [p for g in cell.mix["group_sets"] for t in g.get("groups", []) for p in t]
    for p in tmpls:
        vals = Counter(v for r in pooled for g in r.groups for k, _op, v in g if k == p["key"])
        total = sum(vals.values())
        if p["draw"] == "label":
            labs = set(coh.meta[p["key"]].tolist())
            assert set(vals) == labs
            assert all(abs(c / total * len(labs) - 1) < 0.35 for c in vals.values())
        else:
            assert set(vals) == set(range(p["lo"], p["hi"] + 1))
            mean = sum(v * c for v, c in vals.items()) / total
            assert abs(mean - (p["lo"] + p["hi"]) / 2) < 1.5


@pytest.mark.parametrize("name", ["tiny_open", "hrc_r1.adhoc_af"])
def test_fresh_groups_never_repeat(name):
    _cell, _coh, gen, seconds = any_cell(name)
    reqs = gen.warmup() + gen.window(seconds)
    assert len(reqs) >= (206 if name in CELLS else 62)
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


@pytest.mark.parametrize("name", ["tiny_open"] + CELLS)
def test_paced_arrivals_are_even(name):
    cell, _coh, gen, seconds = any_cell(name)
    due = np.array([r.due for r in gen.window(seconds)])
    assert len(due) == round(cell.mix["rate_per_s"] * seconds)
    assert np.allclose(np.diff(due, prepend=0), 1.0 / cell.mix["rate_per_s"])
    if name in CELLS:
        assert cell.mix["rate_per_s"] == 4 and len(due) == 204


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
