"""Forced-strategy matrix runner + oracle/headroom analyzer + latency
harness.

Reference parity: eval/run_matrix.py:189 (forced-strategy matrix with
repeats), eval/analyze_matrix.py:154 (oracle/headroom analyzer with
knobs), eval/time_cmhc.py:22 (wall + per-arm latency breakdown). The port
of ``mobius_rag_tpu.eval_harness.matrix``.
"""
from __future__ import annotations

import statistics
from typing import Any

from mobius_rag_tpu_torch.eval_harness.bank import Bank, load_bank
from mobius_rag_tpu_torch.eval_harness.db import EvalDB
from mobius_rag_tpu_torch.eval_harness.run import run_eval
from mobius_rag_tpu_torch.query.agent import CorpusSearchAgent
from mobius_rag_tpu_torch.query.engine import QueryRequest


def run_matrix(
    agent: CorpusSearchAgent,
    bank: Bank | str,
    *,
    strategies: tuple[str, ...] = ("a", "b", "c", "d"),
    repeats: int = 1,
    k: int = 10,
    db: EvalDB | None = None,
) -> dict[str, Any]:
    """strategy × repeat grid of forced runs; cells carry per-query
    recall series so the analyzer can do σ-banded comparisons
    (CANONICAL_STRATEGY_BASELINE.md methodology)."""
    if isinstance(bank, str):
        bank = load_bank(bank)
    db = db or EvalDB()
    cells: dict[str, list[dict[str, Any]]] = {s: [] for s in strategies}
    for s in strategies:
        for rep in range(repeats):
            out = run_eval(agent, bank, forced_mode=s, k=k, db=db)
            cells[s].append({
                "run_id": out.run_id, "repeat": rep,
                "per_query": {r["query_id"]: r["chunk_recall"] for r in out.results},
                "aggregates": out.aggregates,
            })
    return {"bank": bank.name, "bank_sha": bank.sha, "repeats": repeats,
            "cells": cells}


def analyze_matrix(matrix: dict[str, Any], *, natural_run: dict[str, float] | None = None
                   ) -> dict[str, Any]:
    """Oracle recall (per-query best arm), per-arm means ± σ across
    repeats, routing headroom vs a natural run, and per-query winners —
    the analyze_matrix.py knobs."""
    cells = matrix["cells"]
    # mean per-query recall per strategy across repeats
    per_strategy: dict[str, dict[str, float]] = {}
    for s, runs in cells.items():
        agg: dict[str, list[float]] = {}
        for run in runs:
            for qid, rec in run["per_query"].items():
                agg.setdefault(qid, []).append(rec)
        per_strategy[s] = {qid: sum(v) / len(v) for qid, v in agg.items()}

    qids = sorted({q for s in per_strategy.values() for q in s})
    winners = {}
    oracle_vals = []
    for qid in qids:
        best_s, best_v = None, -1.0
        for s, series in per_strategy.items():
            v = series.get(qid, 0.0)
            if v > best_v:
                best_s, best_v = s, v
        winners[qid] = {"strategy": best_s, "recall": round(best_v, 4)}
        oracle_vals.append(best_v)
    oracle = sum(oracle_vals) / len(oracle_vals) if oracle_vals else 0.0

    arm_stats = {}
    for s, runs in cells.items():
        means = [r["aggregates"]["mean_chunk_recall"] for r in runs]
        arm_stats[s] = {
            "mean_recall": round(sum(means) / len(means), 4),
            "recall_std": round(statistics.pstdev(means), 4) if len(means) > 1 else 0.0,
            "answer_rate": round(sum(r["aggregates"]["answer_rate"] for r in runs)
                                 / len(runs), 4),
            "latency_ms_median": round(statistics.median(
                r["aggregates"]["latency_ms_median"] for r in runs), 2),
        }

    out = {
        "oracle_recall": round(oracle, 4),
        "winners": winners,
        "arm_stats": arm_stats,
        "winner_distribution": {
            s: sum(1 for w in winners.values() if w["strategy"] == s)
            for s in cells
        },
    }
    if natural_run:
        nat = natural_run.get("mean_chunk_recall", 0.0)
        out["natural_recall"] = nat
        out["routing_headroom"] = round(oracle - nat, 4)
    return out


def time_queries(agent: CorpusSearchAgent, bank: Bank | str, *, k: int = 10
                 ) -> dict[str, Any]:
    """Latency harness: wall + engine-stage breakdown per query
    (time_cmhc.py parity — the reference reports bm25/rerank arm ms; the
    compiled pipeline reports prepare/device ms instead since the arms
    fuse into one program)."""
    if isinstance(bank, str):
        bank = load_bank(bank)
    rows = []
    for q in bank.queries:
        res = agent.engine.search(QueryRequest(query=q.query), k=k)[0]
        rows.append({
            "query_id": q.id,
            "prepare_ms": round(res.telemetry["timings_ms"]["prepare"], 2),
            "device_ms": round(res.telemetry["timings_ms"]["device"], 2),
            "wall_ms": round(sum(res.telemetry["timings_ms"].values()), 2),
        })
    walls = sorted(r["wall_ms"] for r in rows)
    return {
        "per_query": rows,
        "wall_ms_median": walls[len(walls) // 2] if walls else 0,
        "wall_ms_p95": walls[max(0, int(0.95 * len(walls)) - 1)] if walls else 0,
        "device_ms_median": sorted(r["device_ms"] for r in rows)[len(rows) // 2]
        if rows else 0,
    }


def run_gate_on_bank(agent: CorpusSearchAgent, bank: Bank | str) -> dict[str, Any]:
    """Contour-bank runner (scripts/run_gate_on_contour_bank.py parity):
    classify+gate every query, compare against expected_contour."""
    if isinstance(bank, str):
        bank = load_bank(bank)
    from mobius_rag_tpu_torch.query.classify import classify_query
    from mobius_rag_tpu_torch.query.gate import corpus_probe, run_gate

    rows = []
    for q in bank.queries:
        pre = classify_query(q.query, agent.engine.lexicon)
        probe = corpus_probe(pre.expansion.matched_codes, agent._tag_docs())
        profile = classify_query(q.query, agent.engine.lexicon,
                                 {"union_docs": probe.union_docs,
                                  "intersection_docs": probe.intersection_docs})
        g = run_gate(q.query, profile, probe)
        expected = q.expected.get("expected_contour")
        actual = g.contour.value.lower()  # bank uses lowercase contour names
        rows.append({"query_id": q.id, "expected": expected,
                     "actual": actual,
                     "ok": (expected is None) or expected.lower() == actual})
    scored = [r for r in rows if r["expected"]]
    return {
        "per_query": rows,
        "match_rate": round(sum(r["ok"] for r in scored) / len(scored), 4)
        if scored else None,
    }
