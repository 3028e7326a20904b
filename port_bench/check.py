"""The comparison that decides ``correct``: the system's answers against
the reference's (``reference.py``), as a few numbers, each held to a
limit that the configuration file states (its ``limits``).

  arm_gap     per arm, per listed position j: the larger of |system value
              - reference's j-th value| and |system value - reference's
              value of the same row|; a row the reference holds dead, or a
              list of another length, reads 1. The lexical and d-tag arms'
              arithmetic is exact, so there a row other than the
              reference's at its position reads 1 too.
  hit_gap     per hit position j: the larger of |system score - the
              reference's j-th score| and |system score - the reference's
              rerank of the same row|; a hit outside the reference's fusion
              pool reads 1; a hit the system left out reads by how far it
              lies above the confidence floor.
  strict_err  |system strict count - reference's|, exact.
  unanswered  sampled requests the system never answered.
The vector arm's near-ties (within the system's rounding: adjacent
values, the last probed cell, a query projection component at a half)
give the reference alternatives; a number takes the one that fits best.
Every gap is capped at 1.
"""
from __future__ import annotations

import math

CAP = 1.0


def _gap(a: float, b: float | None) -> float:
    if b is None or not math.isfinite(a):
        return CAP
    return min(CAP, abs(a - b))


def arm_gap(prog: dict, ans, k: int) -> float:
    """The arm number of one request (the system lists each arm's first k
    live entries)."""
    worst = 0.0
    for arm in range(3):
        listed = prog["arms"][arm]
        best = CAP
        for alt, values in ans.arms[arm]:
            g = 0.0 if len(listed) == min(k, len(alt)) else CAP
            for j, (row, v) in enumerate(listed):
                ref = alt[j] if j < len(alt) else (None, None)
                g = max(g, _gap(v, ref[0]), _gap(v, values[j]))
                if arm > 0 and ref[1] != row:
                    g = CAP
            best = min(best, g)
        worst = max(worst, best)
    return worst


def hit_gap(prog: dict, ans) -> float:
    hits = prog["hits"]
    best = CAP
    for final, pool in zip(ans.finals, ans.pools):
        g = 0.0
        for j, (row, s) in enumerate(hits):
            ref_s = final[j][1] if j < len(final) else None
            g = max(g, _gap(s, ref_s), _gap(s, ans.hit_values[j]))
            if row not in pool:
                g = CAP
        for j in range(len(hits), len(final)):
            g = max(g, min(CAP, max(0.0, final[j][1] - ans.floor)))
        best = min(best, g)
    return best


def compare(progs: list[dict], answers: list, n_unanswered: int, k: int) -> dict[str, float]:
    """The numbers over every compared request."""
    out = {"arm_gap": 0.0, "hit_gap": 0.0, "strict_err": 0.0,
           "unanswered": float(n_unanswered)}
    for prog, ans in zip(progs, answers):
        out["arm_gap"] = max(out["arm_gap"], arm_gap(prog, ans, k))
        out["hit_gap"] = max(out["hit_gap"], hit_gap(prog, ans))
        out["strict_err"] = max(out["strict_err"], float(abs(prog["strict"] - ans.strict)))
    return out


def judge(numbers: dict[str, float], limits: dict[str, float]) -> tuple[bool, dict]:
    """(every number within its limit, {name: {"value", "limit"}})."""
    shown = {name: {"value": numbers[name], "limit": limits[name]} for name in limits}
    return all(v["value"] <= v["limit"] for v in shown.values()), shown
