"""The reference against a loop over sites and samples at a tiny size,
with the server's quota low enough that some answers end in ``*``."""

import numpy as np
import pytest

from benchmark import cohort, traffic
from benchmark.reference import Reference, eval_filter
from helpers import tiny_cell

OPS = {"<": lambda a, b: a < b, "<=": lambda a, b: a <= b,
       ">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
       "==": lambda a, b: a == b, "!=": lambda a, b: a != b}


def brute(coh, req, max_gt):
    """bgt-server's loop, one site and one sample at a time."""
    n = coh.n_samples
    gid = [1] * n if not req.groups else [0] * n
    for k, preds in enumerate(req.groups):
        for s in range(n):
            if all(OPS[op](coh.meta[key][s], val) for key, op, val in preds):
                gid[s] = k + 1
    out = [s for s in range(n) if gid[s]]
    g = max(len(req.groups), 1)
    pos, info, marker = [], [], False
    if not out:
        return pos, info, marker
    read = read_at_last = 0
    beg, end = req.region
    for i in range(len(coh.pos)):
        if not beg <= coh.pos[i] <= end:
            continue
        an, ac = [0] * g, [0] * g
        for s in out:
            for h in (2 * s, 2 * s + 1):
                c = coh.codes[i, h]
                if c != 2:
                    an[gid[s] - 1] += 1
                if c == 1:
                    ac[gid[s] - 1] += 1
        env = {"AN": np.float64(sum(an)), "AC": np.float64(sum(ac))}
        for k in range(g):
            env[f"AN{k + 1}"] = np.float64(an[k])
            env[f"AC{k + 1}"] = np.float64(ac[k])
        ok = True
        if req.filter:
            with np.errstate(divide="ignore", invalid="ignore"):
                ok = bool(eval(req.filter.replace("&&", " and ")
                               .replace("||", " or "), {}, env))
        read += len(out)
        if not ok:
            continue
        if read_at_last > max_gt:
            return pos, info, True
        pos.append(int(coh.pos[i]))
        info.append([sum(an), sum(ac)] + ([x for k in range(g) for x in (an[k], ac[k])]
                                          if g > 1 else []))
        read_at_last = read
    return pos, info, read > max_gt


@pytest.mark.parametrize("mix", ["tiny_open", "tiny_scan", "tiny_pop"])
def test_reference_matches_the_loop(mix):
    cell = tiny_cell(mix, "tiny1kg" if mix == "tiny_pop" else "tiny")
    cfg = dict(cell.config, n_samples=cell.config["n_samples"], p_missing=0.05)
    coh = cohort.make_cohort(cfg, 987654321987)
    gen = traffic.Generator(cell.mix, cfg, coh, 987654321987)
    reqs = gen.window(4.0, 24)[:24]
    # two more: no sample in the group, and no group (every sample)
    nobody = (("population", "==", "none") if mix == "tiny_pop"
              else ("age", ">=", 1000))
    reqs.append(traffic.Request(len(reqs), reqs[0].region, [[nobody]], None, ""))
    reqs.append(traffic.Request(len(reqs), reqs[0].region, [], "AC>=1", ""))
    max_gt = 4000
    got = Reference(coh).answers(reqs, max_gt)
    markers = set()
    for r, a in zip(reqs, got):
        pos, info, marker = brute(coh, r, max_gt)
        assert a.pos.tolist() == pos, r.path
        assert a.info.tolist() == info
        assert a.marker == marker, r.path
        assert a.alleles.shape == (len(pos), 2)
        markers.add(marker)
    assert markers == {True, False}


def test_filter_divides_as_reals():
    env = {"AC": np.array([0, 1, 1, 3]), "AN": np.array([0, 0, 100, 4]),
           "AC1": np.array([0, 1, 1, 3]), "AN1": np.array([0, 0, 100, 4]),
           "AC2": np.array([0, 0, 1, 0])}
    assert eval_filter("AC1/AN1>=0.01", env).tolist() == [False, True, True, True]
    assert eval_filter("AC1/AN1>=0.1&&AC2==0", env).tolist() == [False, True, False, True]
    assert eval_filter("AC1>0||AC2>0", env).tolist() == [False, True, True, True]
    assert eval_filter("(AC+1)*2>=4", env).tolist() == [False, True, True, True]
