"""Calibration: run every bank query through every forced strategy +
natural routing; aggregate per (strategy × query_class); fingerprint;
persist. Reference parity: eval/calibrate.py:72-333 (6× forced fan,
accuracy/recall_capacity/speed cells, fingerprint capture).

Output matrix cells feed derive_priors to regenerate
data/router_priors.json (derive_priors.py:26 contract). The port of
``mobius_rag_tpu.eval_harness.calibrate``.
"""
from __future__ import annotations

import statistics
from typing import Any

from mobius_rag_tpu_torch.eval_harness.bank import Bank, load_bank
from mobius_rag_tpu_torch.eval_harness.db import EvalDB
from mobius_rag_tpu_torch.eval_harness.run import lexicon_revision, run_eval
from mobius_rag_tpu_torch.query.agent import CorpusSearchAgent

STRATEGIES_TO_FORCE = ("a", "b", "c", "d", "s", None)  # None = natural


def calibrate(
    agent: CorpusSearchAgent,
    bank: Bank | str,
    *,
    k: int = 10,
    db: EvalDB | None = None,
    judge_llm=None,
) -> dict[str, Any]:
    if isinstance(bank, str):
        bank = load_bank(bank)
    db = db or EvalDB()

    per_run: dict[str, Any] = {}
    cells: dict[tuple[str, str], list[dict]] = {}
    for forced in STRATEGIES_TO_FORCE:
        name = forced or "natural"
        out = run_eval(agent, bank, forced_mode=forced, k=k, db=db,
                       judge_llm=judge_llm)
        per_run[name] = {"run_id": out.run_id, **out.aggregates}
        for r in out.results:
            qc = r.get("query_class") or "vague"
            cells.setdefault((name, qc), []).append(r)

    matrix: dict[str, dict[str, Any]] = {}
    for (name, qc), rows in sorted(cells.items()):
        recalls = [r["chunk_recall"] for r in rows]
        lat = [r["latency_ms"] for r in rows]
        answered = [r for r in rows if not r["refused"] and r["strategy_chain"] != ["e"]]
        matrix.setdefault(name, {})[qc] = {
            "n": len(rows),
            "accuracy": round(
                sum(1 for r in rows if r["judge_verdict"] == "correct") / len(rows), 4),
            "accuracy_std": round(
                statistics.pstdev([1.0 if r["judge_verdict"] == "correct" else 0.0
                                   for r in rows]), 4),
            "recall": round(sum(recalls) / len(recalls), 4),
            "recall_std": round(statistics.pstdev(recalls), 4) if len(recalls) > 1 else 0.0,
            "answer_rate": round(len(answered) / len(rows), 4),
            "latency_ms_median": round(statistics.median(lat), 2),
        }

    # oracle = per-query best forced arm; headroom = oracle - natural
    # (CANONICAL_STRATEGY_BASELINE.md §3 methodology)
    by_query: dict[str, dict[str, float]] = {}
    for forced in ("a", "b", "c", "d", "s"):
        run_id = per_run.get(forced, {}).get("run_id")
        if not run_id:
            continue
        for r in db.results(run_id):
            by_query.setdefault(r["query_id"], {})[forced] = r["chunk_recall"]
    oracle = (
        sum(max(v.values()) for v in by_query.values()) / len(by_query)
        if by_query else 0.0
    )
    natural = per_run.get("natural", {}).get("mean_chunk_recall", 0.0)

    fingerprint = {
        "priors_version": agent.router.priors_version,
        "router_version": agent.router.version,
        "lexicon_revision": lexicon_revision(agent),
        "bank_sha": bank.sha,
    }
    result = {
        "fingerprint": fingerprint,
        "per_run": per_run,
        "matrix": matrix,
        "oracle_recall": round(oracle, 4),
        "natural_recall": natural,
        "routing_headroom": round(oracle - natural, 4),
    }
    result["calib_id"] = db.insert_calibration(fingerprint, result["matrix"])
    return result
