"""Calibration matrix → router priors (reference: eval/derive_priors.py:26;
the port of ``mobius_rag_tpu.eval_harness.derive_priors``, writing the
format of the port's ``data/router_priors.json``).

Takes the per-(strategy × query_class) cells produced by calibrate() and
rewrites data/router_priors.json's numeric fields (accuracy,
accuracy_std, recall_capacity) while keeping shapes/speed/cost from the
existing file; bumps priors_version with the calibration id.
"""
from __future__ import annotations

import json
import statistics
from typing import Any

from mobius_rag_tpu_torch.query.router import _default_priors_path


def derive_priors(matrix: dict[str, Any], calib_id: str,
                  priors_path: str | None = None,
                  out_path: str | None = None,
                  min_n: int = 3) -> dict[str, Any]:
    """Cells with n < min_n keep their previous values (small-sample
    cells would otherwise whipsaw the router; same caution as the
    reference's 'we'll re-measure once the bandit has accumulated')."""
    path = priors_path or _default_priors_path()
    with open(path) as f:
        priors = json.load(f)

    updated = 0
    deltas: list[dict[str, Any]] = []
    skipped: list[dict[str, Any]] = []
    for sid, classes in matrix.items():
        if sid not in priors["priors"]:
            if sid != "natural":  # natural has no prior cell by design
                skipped.append({"sid": sid, "reason": "unknown strategy"})
            continue
        for qc, cell in classes.items():
            if qc not in priors["priors"][sid]:
                skipped.append({"sid": sid, "qc": qc,
                                "reason": "no prior cell"})
                continue
            if cell.get("n", 0) < min_n:
                skipped.append({"sid": sid, "qc": qc, "n": cell.get("n", 0),
                                "reason": f"n < min_n ({min_n})"})
                continue
            dst = priors["priors"][sid][qc]
            before = {"accuracy": dst.get("accuracy"),
                      "accuracy_std": dst.get("accuracy_std"),
                      "recall_capacity": dst.get("recall_capacity")}
            dst["accuracy"] = cell["accuracy"]
            dst["accuracy_std"] = max(cell["accuracy_std"], 0.02)
            dst["recall_capacity"] = cell["recall"]
            after = {"accuracy": dst["accuracy"],
                     "accuracy_std": dst["accuracy_std"],
                     "recall_capacity": dst["recall_capacity"]}
            deltas.append({"sid": sid, "qc": qc, "n": cell["n"],
                           "before": before, "after": after})
            updated += 1

    priors["priors_version"] = f"calib-{calib_id[:8]}"
    dest = out_path or path
    with open(dest, "w") as f:
        json.dump(priors, f, indent=2)
    return {"updated_cells": updated, "priors_version": priors["priors_version"],
            "path": dest, "deltas": deltas, "skipped": skipped}


def merge_matrices(matrices: "list[dict[str, Any]]") -> dict[str, Any]:
    """Pool per-(strategy × query_class) cells across several
    calibration passes (e.g. the n=6 σ-band runs over re-drawn
    corpora): n sums, accuracy/recall become n-weighted means, stds
    pool as the within+between law of total variance. This is how
    cells accumulate enough n to clear derive_priors' min_n gate —
    the round-4 single-pass derivation updated 0 cells because every
    (strategy, class) held < 3 bank queries (the reference grows n the
    same way: repeated calibration runs, eval/calibrate.py:203-272)."""
    out: dict[str, Any] = {}
    for m in matrices:
        for sid, classes in m.items():
            for qc, cell in classes.items():
                dst = out.setdefault(sid, {}).setdefault(qc, [])
                dst.append(cell)
    merged: dict[str, Any] = {}
    for sid, classes in out.items():
        for qc, cs in classes.items():
            n = sum(c.get("n", 0) for c in cs)
            if n == 0:
                continue
            w = [c.get("n", 0) / n for c in cs]

            def wmean(key):
                return round(sum(wi * c.get(key, 0.0)
                                 for wi, c in zip(w, cs)), 4)

            def pooled_std(mean_key, std_key, mu):
                var = sum(wi * (c.get(std_key, 0.0) ** 2
                                + (c.get(mean_key, 0.0) - mu) ** 2)
                          for wi, c in zip(w, cs))
                return round(var ** 0.5, 4)

            acc = wmean("accuracy")
            rec = wmean("recall")
            merged.setdefault(sid, {})[qc] = {
                "n": n,
                "accuracy": acc,
                "accuracy_std": pooled_std("accuracy", "accuracy_std", acc),
                "recall": rec,
                "recall_std": pooled_std("recall", "recall_std", rec),
                "answer_rate": wmean("answer_rate"),
                "latency_ms_median": round(statistics.median(
                    c.get("latency_ms_median", 0.0) for c in cs), 2),
            }
    return merged
