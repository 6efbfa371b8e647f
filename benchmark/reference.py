"""The plain reference: what the server must answer to each request, in
NumPy, from the genotype codes, sites and sample metadata the benchmark
made.  It imports nothing of the program.

Semantics (bgt's ``view -G -C`` through bgt-server):

- a group is the samples whose metadata satisfy all its predicates; a
  sample in several of a request's groups belongs to the last; the output
  samples are those of any group;
- per group and site, AC counts the alternate calls (code 1) and AN the
  called haplotypes (codes 0, 1 and 3: a missing call, code 2, is not
  counted); AC and AN of the site are the sums over the groups, and with
  more than one group the line also carries AN1, AC1, AN2, ...;
- the sites are those with a position in the region, in order, that pass
  the ``f`` filter over AC, AN, ACk and ANk (with one group, AC1 and AN1 are
  AC and AN); ``/`` divides as reals;
- the quota (bgt-server.go:330-352): every site of the region read costs
  the output samples' count of genotypes; before a passing site is written,
  the server stops, with a last line ``*``, when the genotypes read through
  the previous written site exceed ``max_gt``; a complete answer also ends
  in ``*`` when the whole region's genotypes exceed ``max_gt``;
- with no output sample the body is the header alone.

Counts for every site and every distinct group of a run come from float32
matrix products of 0/1 indicators (exact: every partial sum is an integer
below 2**24), in blocks of sites.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

import numpy as np

_OPS = {"<": np.less, "<=": np.less_equal, ">": np.greater,
        ">=": np.greater_equal, "==": np.equal, "!=": np.not_equal}


@dataclass
class Answer:
    pos: np.ndarray        # written sites' positions
    alleles: np.ndarray    # (sites, 2) uint8: REF and ALT
    info: np.ndarray       # (sites, 2 or 2 + 2 G) int64: AN, AC[, ANk, ACk]
    marker: bool           # the body ends in "*"
    rows: int              # the region's sites
    n_out: int             # the output samples


def group_of_sample(meta: dict, groups: list, n: int) -> np.ndarray:
    """1-based group of each sample (0: none), the last matching group."""
    gid = np.zeros(n, np.int64)
    for k, preds in enumerate(groups):
        m = np.ones(n, bool)
        for key, op, val in preds:
            m &= _OPS[op](meta[key], val)
        gid[m] = k + 1
    return gid


# --- the site filter ----------------------------------------------------------

_TOKEN = re.compile(r"\s*(\d+\.\d*|\.\d+|\d+|[A-Za-z_][A-Za-z_0-9]*|&&|\|\||"
                    r">=|<=|==|!=|[-+*/()<>!])")


def _tokens(expr: str) -> list:
    out, i = [], 0
    while i < len(expr):
        m = _TOKEN.match(expr, i)
        if not m:
            raise ValueError(f"cannot read {expr[i:]!r}")
        out.append(m.group(1))
        i = m.end()
    return out


def eval_filter(expr: str, env: dict) -> np.ndarray:
    """``expr`` over arrays ``env``, C precedence: ``||`` < ``&&`` <
    ``== !=`` < ``< <= > >=`` < ``+ -`` < ``* /`` < unary."""
    toks = _tokens(expr)
    pos = [0]

    def peek():
        return toks[pos[0]] if pos[0] < len(toks) else None

    def take():
        pos[0] += 1
        return toks[pos[0] - 1]

    def binary(next_level, ops, fn):
        def level():
            a = next_level()
            while peek() in ops:
                a = fn(take(), a, next_level())
            return a
        return level

    def unary():
        t = take()
        if t == "(":
            v = lor()
            if take() != ")":
                raise ValueError("unbalanced parentheses")
            return v
        if t == "-":
            return -unary()
        if t == "!":
            return (unary() == 0).astype(np.int64)
        if t[0].isdigit() or t[0] == ".":
            return float(t) if "." in t else int(t)
        return env[t]

    def arith(op, a, b):
        if op == "/":
            with np.errstate(divide="ignore", invalid="ignore"):
                return np.true_divide(a, b)
        return {"+": np.add, "-": np.subtract, "*": np.multiply}[op](a, b)

    def cmp(op, a, b):
        return _OPS[op](a, b).astype(np.int64)

    mul = binary(unary, ("*", "/"), arith)
    add = binary(mul, ("+", "-"), arith)
    rel = binary(add, ("<", "<=", ">", ">="), cmp)
    eq = binary(rel, ("==", "!="), cmp)
    land = binary(eq, ("&&",), lambda _o, a, b: ((a != 0) & (b != 0)).astype(np.int64))
    lor = binary(land, ("||",), lambda _o, a, b: ((a != 0) | (b != 0)).astype(np.int64))
    v = lor()
    if pos[0] != len(toks):
        raise ValueError(f"trailing tokens in {expr!r}")
    return np.broadcast_to(np.asarray(v) != 0, env["AC"].shape)


# --- counts -------------------------------------------------------------------

def site_counts(codes: np.ndarray, masks: np.ndarray, block: int = 1024,
                missing_called: bool = False):
    """(AN, AC) of every site for every sample mask: two (sites, masks)
    int64 arrays.  ``missing_called`` counts missing calls as called: the
    control, which breaks the configuration's guarantee on AN."""
    hap = np.repeat(masks.T.astype(np.float32), 2, axis=0)  # (haps, masks)
    size2 = 2 * masks.sum(axis=1).astype(np.int64)
    n = codes.shape[0]
    an = np.empty((n, masks.shape[0]), np.int64)
    ac = np.empty_like(an)
    for lo in range(0, n, block):
        blk = codes[lo: lo + block]
        ac[lo: lo + block] = np.rint((blk == 1).astype(np.float32) @ hap)
        miss = np.rint((blk == 2).astype(np.float32) @ hap).astype(np.int64)
        an[lo: lo + block] = size2 - (0 if missing_called else miss)
    return an, ac


class Reference:
    def __init__(self, coh, missing_called: bool = False):
        self.coh = coh
        self.missing_called = missing_called

    def answers(self, reqs: list, max_gt: int) -> list:
        coh = self.coh
        n = coh.n_samples
        # no group: one group of every sample (bgt's default)
        gids = [group_of_sample(coh.meta, r.groups, n) if r.groups
                else np.ones(n, np.int64) for r in reqs]
        cols: dict = {}
        masks = []
        req_cols = []
        for r, gid in zip(reqs, gids):
            idx = []
            for k in range(max(len(r.groups), 1)):
                m = gid == k + 1
                key = m.tobytes()
                if key not in cols:
                    cols[key] = len(masks)
                    masks.append(m)
                idx.append(cols[key])
            req_cols.append(idx)
        if not masks:
            return []
        an_all, ac_all = site_counts(coh.codes, np.array(masks),
                                     missing_called=self.missing_called)
        return [self._answer(r, gid, idx, an_all, ac_all, max_gt)
                for r, gid, idx in zip(reqs, gids, req_cols)]

    def _answer(self, r, gid, idx, an_all, ac_all, max_gt) -> Answer:
        pos = self.coh.pos
        beg, end = r.region
        lo = int(np.searchsorted(pos, beg, "left"))
        hi = int(np.searchsorted(pos, end, "right"))
        rows = hi - lo
        n_out = int((gid > 0).sum())
        g = len(idx)
        width = 2 if g == 1 else 2 + 2 * g
        if n_out == 0:
            return Answer(np.zeros(0, np.int64), np.zeros((0, 2), np.uint8),
                          np.zeros((0, width), np.int64), False, rows, 0)
        gan = an_all[lo:hi][:, idx]
        gac = ac_all[lo:hi][:, idx]
        an, ac = gan.sum(axis=1), gac.sum(axis=1)
        env = {"AN": an, "AC": ac}
        for k in range(g):
            env[f"AN{k + 1}"] = gan[:, k] if g > 1 else an
            env[f"AC{k + 1}"] = gac[:, k] if g > 1 else ac
        sel = (np.nonzero(eval_filter(r.filter, env))[0] if r.filter
               else np.arange(rows))
        before = np.concatenate([[0], (sel[:-1] + 1) * n_out]) if sel.size else sel
        over = np.nonzero(before > max_gt)[0]
        if over.size:
            sel, marker = sel[: over[0]], True
        else:
            marker = rows * n_out > max_gt
        info = [an[sel], ac[sel]]
        if g > 1:
            for k in range(g):
                info += [gan[sel, k], gac[sel, k]]
        keep = lo + sel
        alleles = np.stack([self.coh.ref[keep], self.coh.alt[keep]], axis=1)
        return Answer(pos[keep], alleles, np.stack(info, axis=1), marker,
                      rows, n_out)
