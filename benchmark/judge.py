"""The comparison that decides ``correct``: every answer of the window
against the reference's, exactly.

A request is ``missing`` when no answer came (an error, or none by the end
of the wait past the window's close), and ``wrong`` when its answer says
another thing than the reference's: a status other than 200, a body that
is not a ``view`` body, another chromosome, other INFO keys, or other
sites, alleles, counts or ``*`` marker.  Both numbers are held to the limit
0.  A late answer is neither: its latency counts the wait.
"""

from __future__ import annotations

import json

import numpy as np

LIMITS = {"missing": 0, "wrong": 0}


def expected_keys(n_groups: int) -> list:
    g = max(n_groups, 1)
    keys = ["AN", "AC"]
    if g > 1:
        for k in range(1, g + 1):
            keys += [f"AN{k}", f"AC{k}"]
    return keys


class Answers:
    """The client's reduced answers (its ``.npz``), or, through
    ``from_answers``, another program's put in the server's place."""

    def __init__(self, path: str | None = None):
        if path is None:
            return
        with np.load(path) as z:
            self.t_due = z["t_due"]
            self.t_sent = z["t_sent"]
            self.t_done = z["t_done"]
            self.status = z["status"]
            n_sites, width = z["n_sites"], z["width"]
            pos, alleles, info = z["pos"], z["alleles"], z["info"]
            self.meta = json.loads(str(z["meta"]))
        self.n = len(self.status)
        self.pos, self.alleles, self.info = [], [], []
        s = i = 0
        for k in range(self.n):
            c, w = int(n_sites[k]), int(width[k])
            self.pos.append(pos[s: s + c])
            self.alleles.append(alleles[s: s + c])
            self.info.append(info[i: i + c * w].reshape(c, w))
            s += c
            i += c * w


def from_answers(reqs: list, answers: list, chrom: str) -> Answers:
    """``answers`` (the reference's ``Answer`` objects) as if the server had
    given them: the control puts a broken reference in the program's
    place."""
    got = Answers()
    got.n = len(answers)
    got.t_due = got.t_sent = np.zeros(got.n)
    got.t_done = np.ones(got.n)
    got.status = np.full(got.n, 200)
    got.pos = [a.pos for a in answers]
    got.alleles = [a.alleles for a in answers]
    got.info = [a.info for a in answers]
    got.meta = [{"ok": True, "marker": a.marker,
                 "keys": expected_keys(len(r.groups)) if len(a.pos) else [],
                 "chroms": [chrom] if len(a.pos) else []}
                for r, a in zip(reqs, answers)]
    return got


def verdicts(reqs: list, answers: list, got: Answers, chrom: str) -> tuple:
    """(per-request verdict: ``ok``, ``missing`` or ``wrong``, reasons of
    the first wrong ones)."""
    out, why = [], []
    for k in range(got.n):
        r, a, meta = reqs[k], answers[k], got.meta[k]
        if not np.isfinite(got.t_done[k]):
            out.append("missing")
            continue
        reason = None
        if got.status[k] != 200:
            reason = f"status {got.status[k]}: {meta.get('text')!r}"
        elif not meta["ok"]:
            reason = f"not a view body: {meta.get('text')!r}"
        elif len(got.pos[k]) != len(a.pos) or not np.array_equal(got.pos[k], a.pos):
            reason = f"sites: {len(got.pos[k])} against {len(a.pos)}"
        elif len(a.pos) and meta["chroms"] != [chrom]:
            reason = f"chromosomes {meta['chroms']}"
        elif len(a.pos) and meta["keys"] != expected_keys(len(r.groups)):
            reason = f"INFO keys {meta['keys']}"
        elif not np.array_equal(got.alleles[k], a.alleles):
            reason = "alleles"
        elif len(a.pos) and got.info[k].shape != a.info.shape:
            reason = f"INFO width {got.info[k].shape} against {a.info.shape}"
        elif len(a.pos) and not np.array_equal(got.info[k], a.info):
            d = np.abs(got.info[k] - a.info)
            reason = f"counts: largest gap {int(d.max())} at {int((d > 0).sum())} values"
        elif meta["marker"] != a.marker:
            reason = f"marker {meta['marker']} against {a.marker}"
        if reason is None:
            out.append("ok")
        else:
            out.append("wrong")
            if len(why) < 5:
                why.append(f"request {k} ({r.path}): {reason}")
    return out, why


def numbers(verdict: list) -> dict:
    return {"missing": verdict.count("missing"), "wrong": verdict.count("wrong")}
