"""Eval runner: drive a bank through the agent, judge, persist, aggregate.

Reference parity (eval/run.py:332): per query — call the agent,
deterministic checks (routing / citation / fail-fast / contour,
:90-143), rubric judge, chunk-only fact recall; aggregates — accuracy,
citation rate, median/p95 latency (:277-325). Fingerprint captures
priors_version, lexicon revision, bank sha (calibrate.py:274-333).

The port of ``mobius_rag_tpu.eval_harness.run``.

CLI: python -m mobius_rag_tpu_torch.eval_harness.run --bank toy|cmhc_paraphrase
[--corpus toy|fixture] [--calibrate] [--device cuda|cpu] (resolves reference
banks by name too: --bank cmhc_smoke).
"""
from __future__ import annotations

import dataclasses
import hashlib
import statistics
import time
from typing import Any, Callable

from mobius_rag_tpu_torch.eval_harness.bank import Bank, BankQuery, load_bank
from mobius_rag_tpu_torch.eval_harness.db import EvalDB
from mobius_rag_tpu_torch.eval_harness.fact_checker import check_facts
from mobius_rag_tpu_torch.eval_harness.judge import judge_answer
from mobius_rag_tpu_torch.query.agent import AgentRequest, AgentResult, CorpusSearchAgent


def _doc_tokens(name: str) -> frozenset[str]:
    """Normalized token set of a document name: extension stripped,
    caseless, alnum runs. Citation matching is token-subset so
    'SH-PRO-PE-MFC-Training.pdf' matches filename
    'SH-PRO-PE-MFC-Training.md' and 'Sunshine Provider Manual' matches
    'Sunshine Provider Manual.md'."""
    import re

    base = name.rsplit(".", 1)[0] if name.lower().endswith(
        (".pdf", ".md", ".txt", ".html", ".htm")) else name
    return frozenset(re.findall(r"[a-z0-9]+", base.lower()))


def _citation_match(expected: str, actual: str) -> bool:
    e, a = _doc_tokens(expected), _doc_tokens(actual)
    return bool(e) and bool(a) and (e <= a or a <= e)


def deterministic_checks(q: BankQuery, res: AgentResult) -> dict[str, Any]:
    """Non-LLM pass/fail checks (run.py:90-143)."""
    checks: dict[str, Any] = {}
    exp = q.expected
    if exp.get("strategy"):
        checks["routing"] = {
            "expected": exp["strategy"],
            "actual": res.decision.get("strategy"),
            "chain": res.strategy_chain,
            "ok": exp["strategy"] in res.strategy_chain,
        }
    if exp.get("query_class"):
        checks["query_class"] = {
            "expected": exp["query_class"],
            "actual": res.profile.get("query_class"),
            "ok": exp["query_class"] == res.profile.get("query_class"),
        }
    if exp.get("expected_contour"):
        # a list means "any of these contours is acceptable" (the
        # quality loop's EXACT-or-VICINITY coverage expectation)
        want = exp["expected_contour"]
        accept = want if isinstance(want, (list, tuple)) else [want]
        checks["contour"] = {
            "expected": want,
            "actual": res.gate.get("contour"),
            "ok": res.gate.get("contour") in accept,
        }
    gc = exp.get("golden_citation") or {}
    if gc.get("document"):
        docs = {c.metadata.get("filename", "") for c in res.chunks} | {
            c.doc_id for c in res.chunks
        }
        checks["citation"] = {
            "expected": gc["document"],
            "ok": any(_citation_match(gc["document"], d) for d in docs if d),
        }
    checks["answered"] = {"ok": bool(res.answer) and not res.refused}
    return checks


def lexicon_revision(agent: CorpusSearchAgent) -> str:
    lex = agent.engine.lexicon
    if lex is None:
        return "none"
    blob = ",".join(sorted(e.full_code for e in lex.entries))
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def _check_rate(results: list[dict[str, Any]], name: str) -> float | None:
    """Pass-rate over queries that carry the named deterministic check.

    None (not 0.0) when no query in the bank declares an expectation —
    a bank without contour fields has no contour-match rate at all.
    """
    with_check = [r for r in results if name in r["checks"]]
    if not with_check:
        return None
    passed = sum(1 for r in with_check if r["checks"][name].get("ok"))
    return round(passed / len(with_check), 4)


@dataclasses.dataclass
class EvalRunResult:
    run_id: str
    aggregates: dict[str, Any]
    results: list[dict[str, Any]]


def run_eval(
    agent: CorpusSearchAgent,
    bank: Bank | str,
    *,
    forced_mode: str | None = None,
    k: int = 10,
    db: EvalDB | None = None,
    judge_llm=None,
    request_fn: Callable[[BankQuery], AgentRequest] | None = None,
    warmup: bool = True,
) -> EvalRunResult:
    if isinstance(bank, str):
        bank = load_bank(bank)
    db = db or EvalDB()
    # Blind-eval traps present? (adversarial_corpus doc-id convention —
    # precision/forbidden-hit aggregates are only reported when the
    # corpus actually contains traps, never a vacuous 1.0/0.0.)
    has_traps = any(d.startswith("trap_")
                    for d in agent.engine.store._doc_rows)
    if warmup and bank.queries:
        # one unmeasured pass: the first query otherwise pays the
        # kernels' first launches (module loads, a cold allocator), an
        # artifact of measurement, not serving
        agent.run(AgentRequest(query=bank.queries[0].query, k=k))
    fingerprint = {
        "priors_version": agent.router.priors_version,
        "router_version": agent.router.version,
        "lexicon_revision": lexicon_revision(agent),
        "bank_sha": bank.sha,
        "forced_mode": forced_mode,
        "fact_checker_version": "tpu-v1",
    }
    run_id = db.insert_run(bank, fingerprint)

    results = []
    for q in bank.queries:
        t0 = time.perf_counter()
        req = request_fn(q) if request_fn else AgentRequest(query=q.query, k=k)
        if forced_mode:
            req = dataclasses.replace(req, mode=forced_mode)
        res = agent.run(req)
        latency_ms = (time.perf_counter() - t0) * 1e3

        checks = deterministic_checks(q, res)
        jr = judge_answer(res.answer, q.must_facts, q.bonus_facts,
                          q.forbidden_facts, llm=judge_llm)
        fc = check_facts(q.must_facts, [c.text for c in res.chunks],
                         answer=res.answer, mode="grounding", llm=judge_llm)
        payload = {
            "query": q.query,
            "strategy_chain": res.strategy_chain,
            "confidence": res.confidence_label,
            "refused": res.refused,
            "judge_score": jr.score,
            "judge_verdict": jr.verdict,
            "judge_method": jr.method,
            # answer-level forbidden check: did the SYNTHESIZED answer
            # assert a rubric-forbidden fact? (distinct from the
            # retrieval-level trap_forbidden_hit below — retrieval may
            # surface a trap the synthesis guard then refuses to quote)
            "answer_forbidden": any(jr.verdicts.forbidden)
            if q.forbidden_facts else None,
            "chunk_recall": fc.recall,
            "grounding": fc.grounding,
            "hallucinated": fc.hallucinated,
            "checks": checks,
            "latency_ms": round(latency_ms, 2),
            "query_class": res.profile.get("query_class"),
            "contour": res.gate.get("contour"),
        }
        if has_traps:
            # retrieval-level trap scoring: near-miss chunks in the
            # top-k dilute precision; a forbidden-trap hit means the
            # context handed to synthesis asserts a forbidden fact
            docs = [c.doc_id for c in res.chunks]
            n_near = sum(1 for d in docs if d.startswith("trap_nearmiss"))
            n_forb = sum(1 for d in docs if d.startswith("trap_forbidden"))
            payload.update({
                "trap_near_miss_hits": n_near,
                "trap_forbidden_hit": bool(n_forb),
                "retrieval_precision": round(
                    1.0 - (n_near + n_forb) / len(docs), 4) if docs else None,
            })
        db.insert_result(run_id, q.id, payload)
        results.append({"query_id": q.id, **payload})

    lat = [r["latency_ms"] for r in results]
    n = len(results)
    agg = {
        "n": n,
        "accuracy": round(sum(1 for r in results if r["judge_verdict"] == "correct") / n, 4) if n else 0,
        "partial_rate": round(sum(1 for r in results if r["judge_verdict"] == "partial") / n, 4) if n else 0,
        "answer_rate": round(sum(1 for r in results if r["checks"]["answered"]["ok"]) / n, 4) if n else 0,
        "mean_chunk_recall": round(sum(r["chunk_recall"] for r in results) / n, 4) if n else 0,
        "mean_grounding": round(sum(r["grounding"] for r in results) / n, 4) if n else 0,
        "citation_rate": _check_rate(results, "citation"),
        "routing_match_rate": _check_rate(results, "routing"),
        "contour_match_rate": _check_rate(results, "contour"),
        "latency_ms_median": round(statistics.median(lat), 2) if lat else 0,
        "latency_ms_p95": round(sorted(lat)[max(0, int(0.95 * len(lat)) - 1)], 2) if lat else 0,
        "warmup_excluded_cold_compile": bool(warmup),
    }
    with_forbidden = [r for r in results if r["answer_forbidden"] is not None]
    agg["answer_forbidden_rate"] = round(
        sum(1 for r in with_forbidden if r["answer_forbidden"])
        / len(with_forbidden), 4) if with_forbidden else None
    if has_traps:
        prec = [r["retrieval_precision"] for r in results
                if r.get("retrieval_precision") is not None]
        agg.update({
            "retrieval_precision_mean": round(sum(prec) / len(prec), 4)
            if prec else None,
            "forbidden_hit_rate": round(
                sum(1 for r in results if r.get("trap_forbidden_hit")) / n, 4)
            if n else None,
            "near_miss_rate": round(
                sum(1 for r in results if r.get("trap_near_miss_hits")) / n, 4)
            if n else None,
        })
    db.finalize_run(run_id, agg)
    return EvalRunResult(run_id=run_id, aggregates=agg, results=results)


def _main() -> None:
    import argparse
    import json

    from mobius_rag_tpu_torch.index.store import ChunkStore
    from mobius_rag_tpu_torch.query.engine import SearchEngine
    from mobius_rag_tpu_torch.testing import hash_embed, sample_lexicon, toy_corpus

    ap = argparse.ArgumentParser()
    ap.add_argument("--bank", default="toy")
    ap.add_argument("--mode", default=None, help="forced strategy a|b|c|d|s")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--snapshot", default=None,
                    help="ChunkStore snapshot dir (default: built-in toy corpus)")
    ap.add_argument("--corpus", default=None, choices=["toy", "fixture"],
                    help="fixture = ingest data/corpus_cmhc through the full "
                         "pipeline (the CMHC quality-loop corpus)")
    ap.add_argument("--judge", default="overlap", choices=["overlap", "llm"],
                    help="llm = rubric judge through the env-selected "
                         "adapter (MRAG_JUDGE_PROVIDER=openai|vertex|proxy; "
                         "see eval_harness.judge.get_judge_llm)")
    ap.add_argument("--calibrate", action="store_true",
                    help="forced-arm calibration matrix instead of a single run")
    ap.add_argument("--derive-priors", default=None, metavar="OUT_JSON",
                    help="with --calibrate: regenerate router priors to this path")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()

    if args.corpus == "fixture":
        from mobius_rag_tpu_torch.eval_harness.fixture_corpus import build_fixture_stack

        agent, _, _, _, info = build_fixture_stack(device=args.device)
        import sys

        print(f"fixture corpus: {info}", file=sys.stderr)
    else:
        lex = sample_lexicon()
        if args.snapshot:
            store = ChunkStore.restore(args.snapshot, device=args.device)
        else:
            store = ChunkStore(device=args.device)
            store.add_chunks(toy_corpus(lex))
        agent = CorpusSearchAgent(SearchEngine(store, lex, embed_fn=hash_embed,
                                               device=args.device))
    judge_llm = None
    if args.judge == "llm":
        from mobius_rag_tpu_torch.eval_harness.judge import get_judge_llm

        judge_llm = get_judge_llm()
        if judge_llm is None:
            ap.error("--judge llm needs MRAG_JUDGE_PROVIDER "
                     "(openai|vertex|proxy) + its credentials")
    if args.calibrate:
        from mobius_rag_tpu_torch.eval_harness.calibrate import calibrate

        out = calibrate(agent, args.bank, k=args.k, judge_llm=judge_llm)
        if args.derive_priors:
            from mobius_rag_tpu_torch.eval_harness.derive_priors import derive_priors

            info = derive_priors(out["matrix"], out["calib_id"],
                                 out_path=args.derive_priors)
            out["derived_priors"] = info
        print(json.dumps(out, default=str))
        return
    out = run_eval(agent, args.bank, forced_mode=args.mode, k=args.k,
                   judge_llm=judge_llm)
    print(json.dumps({"run_id": out.run_id, **out.aggregates}))


if __name__ == "__main__":
    _main()
