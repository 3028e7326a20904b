"""Retrieval strategies a / b / c / d / s (the port of
``mobius_rag_tpu.query.strategies``).

Reference parity map:
- a: the hybrid search (corpus_search.py:3280) — engine.search.
- b: wide → themes → narrow (corpus_search_agent.py:552): a broad
  tag_mode=none vector pass, theme clustering of the hits, then one
  narrow strict pass per theme; union. Clustering here is greedy cosine
  over the hit embeddings (host, ≤50 vectors — tiny).
- c: LLM answers from top chunks with quoted citations; every citation
  is verified VERBATIM against the source chunk (strategy_c.py:977,
  outcome matrix in its docstring). No web locator in the air-gapped
  build — citations verify against the corpus.
- d: external-first (strategy_d.py:831): web search → fetch top URLs →
  extract passages → LLM synthesis with passage citations; results are
  marked source_type="external". Degrades to 'no results' offline.
- s: payor fact-store pre-route (corpus_search_agent.py:3808-3960) with
  the conceptual-marker guard.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Any

import numpy as np
import torch

from mobius_rag_tpu_torch.clients import FactStoreClient, LLMClient, WebSearchClient
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine, SearchHit, SearchResult

WIDE_MIN_SIM = 0.78  # strategy b vector_broad floor (agent :552)
WIDE_K = 50
MAX_THEMES = 3
THEME_SIM = 0.80  # same-theme cosine threshold


@dataclasses.dataclass
class StrategyOutcome:
    strategy: str
    hits: list[SearchHit]
    answer: str | None
    confidence_label: str
    success: bool
    detail: dict[str, Any]
    elapsed_ms: float
    search_results: list[SearchResult] = dataclasses.field(default_factory=list)


def rewrite_for_strategy(query: str, strategy: str, *, payer: str = "",
                         state: str = "", program: str = "",
                         literals: tuple[str, ...] = ()) -> str:
    """Per-strategy query rewrite (agent :884).

    Every strategy strips persona/meta lead-ins ("as a billing manager,
    ..."). Beyond that:
    - c/d (the strategies that leave the pure-retrieval context) get the
      payer context APPENDED — an LLM grounding pass or a web search for
      "timely filing deadline" without "sunshine health florida medicaid"
      answers for the wrong payer (the reference's authoritative-query
      build, strategy_d.py:286);
    - a, when the query carries literal anchors (policy/HCPCS codes),
      LEADS with them — the reference's literal extraction puts the
      code first so exact-match ranking dominates (the hashed lexical
      arm is order-invariant, but phrase coverage and the code-fastpath
      consumers read the rewritten string).
    """
    q = re.sub(r"^\s*(as a (billing|um|front.?end)\s+\w*\s*,?)", "", query, flags=re.I)
    q = q.strip() or query
    if strategy in ("c", "d"):
        qualifiers = " ".join(
            x for x in (payer.replace("_", " "), state, program) if x)
        if qualifiers and qualifiers.lower() not in q.lower():
            q = f"{q} {qualifiers}"
    elif strategy == "a" and literals:
        lead = [l for l in literals if l.lower() not in q.lower().split()[:len(literals)]]
        if lead:
            q = " ".join(lead) + " " + q
    return q


def run_strategy_a(engine: SearchEngine, req: QueryRequest, k: int,
                   literals: tuple[str, ...] = ()) -> StrategyOutcome:
    t0 = time.perf_counter()
    res = engine.search(dataclasses.replace(
        req, query=rewrite_for_strategy(req.query, "a", literals=literals)),
        k=k)[0]
    ok = bool(res.hits) and res.confidence_label in ("high", "medium")
    return StrategyOutcome(
        "a", res.hits, None, res.confidence_label, ok,
        {"expansion": res.expansion.matched_codes,
         "strict_count": res.telemetry["strict_count"]},
        (time.perf_counter() - t0) * 1e3, [res],
    )


def _greedy_themes(vectors: np.ndarray, max_themes: int = MAX_THEMES,
                   sim_threshold: float = THEME_SIM) -> list[list[int]]:
    """Greedy cosine clustering: each vector joins the first theme whose
    centroid is ≥ threshold-similar, else seeds a new theme (capped)."""
    themes: list[list[int]] = []
    centroids: list[np.ndarray] = []
    for i, v in enumerate(vectors):
        placed = False
        for t, c in enumerate(centroids):
            if float(v @ c) >= sim_threshold:
                themes[t].append(i)
                n = len(themes[t])
                centroids[t] = c * ((n - 1) / n) + v / n
                centroids[t] /= max(np.linalg.norm(centroids[t]), 1e-6)
                placed = True
                break
        if not placed and len(themes) < max_themes:
            themes.append([i])
            centroids.append(v / max(np.linalg.norm(v), 1e-6))
    return themes


def hit_vectors(store, rows: list[int]) -> np.ndarray:
    """The embeddings of the hit rows as float32 [len(rows), D], and only
    those rows on the host: gathered on the device from a device-resident
    store (int8 rows times their scales), read from the host int8 matrix
    with its scales under host residency. The JAX package reads the whole
    row matrix to the host here, takes int8 rows unscaled and finds no
    rows under host residency (ROADMAP §3, "Faults of the JAX package")."""
    idx = np.asarray(rows, np.int64)
    if store.host_vectors is not None:
        return store.host_vectors[idx].astype(np.float32) * store.host_scales[idx][:, None]
    vectors = store.index.vectors
    sel = torch.from_numpy(idx).to(vectors.device)
    vecs = vectors[sel].float()
    if vectors.dtype == torch.int8:
        vecs = vecs * store.index.vec_scales[sel][:, None]
    return vecs.cpu().numpy()


def run_strategy_b(engine: SearchEngine, req: QueryRequest, k: int,
                   wide_min_sim: float = WIDE_MIN_SIM) -> StrategyOutcome:
    t0 = time.perf_counter()
    results: list[SearchResult] = []
    # 1. wide: no tag gating, recall mode, similarity floor
    wide = engine.search(dataclasses.replace(
        req, tag_mode="none", mode="recall", min_similarity=wide_min_sim,
    ), k=WIDE_K)[0]
    results.append(wide)
    if not wide.hits:
        # floor too high for this corpus/encoder — retry unfloored
        wide = engine.search(dataclasses.replace(
            req, tag_mode="none", mode="recall", min_similarity=0.0), k=WIDE_K)[0]
        results.append(wide)
    if not wide.hits:
        return StrategyOutcome("b", [], None, "abstain", False,
                               {"themes": 0}, (time.perf_counter() - t0) * 1e3, results)

    # 2. themes over hit embeddings
    vecs = hit_vectors(engine.store, [h.row for h in wide.hits])
    themes = _greedy_themes(vecs)

    # 3. one narrow strict pass per theme, seeded by the theme centroid
    merged: dict[int, SearchHit] = {}
    for theme in themes:
        centroid = vecs[theme].mean(axis=0)
        centroid /= max(np.linalg.norm(centroid), 1e-6)
        narrow = engine.search(dataclasses.replace(
            req, embedding=centroid, tag_mode="strict", mode="corpus"), k=k)[0]
        results.append(narrow)
        for h in narrow.hits:
            if h.row not in merged or h.score > merged[h.row].score:
                merged[h.row] = h
    hits = sorted(merged.values(), key=lambda h: h.score, reverse=True)[:k]
    label = results[-1].confidence_label if hits else "abstain"
    ok = bool(hits)
    return StrategyOutcome(
        "b", hits, None, label, ok,
        {"themes": len(themes), "wide_hits": len(wide.hits)},
        (time.perf_counter() - t0) * 1e3, results,
    )


_QUOTE_RE = re.compile(r'"([^"]{12,400})"')

# Lexical-location confidence: if the quote's content tokens overlap a
# corpus chunk this strongly, the corpus demonstrably covers the claim's
# location — a non-verbatim quote there is a fabrication, not a gap.
_LOCATE_OVERLAP = 0.7


def _norm_ws(s: str) -> str:
    return re.sub(r"\s+", " ", s.strip())


def locate_citation(quote: str, retrieved_texts: list[str],
                    engine: SearchEngine, req: QueryRequest,
                    curator=None, web: WebSearchClient | None = None) -> dict:
    """The reference's citation locator chain (strategy_c.py:273-699):
    documents → discovered_sources → web, producing the full 6-outcome
    matrix:

      validated_correct      quote verbatim in a corpus chunk (or a
                             fetched external source)
      validated_hallucinated corpus demonstrably covers the claim's
                             location but the quote is not there
      located_unverified     a curated source plausibly holds it but
                             cannot be fetched/verified (offline, or
                             fetched body lacks the quote)
      unverified_robots      the locator found a source whose robots
                             policy blocks fetching
      needs_scrape           a fetchable source exists but returned no
                             extractable text (scrape work needed)
      needs_external         nothing in corpus or registry — requires an
                             external search pass
    """
    q = _norm_ws(quote)
    # 1. documents: verbatim in the retrieved context
    if any(q in _norm_ws(t) for t in retrieved_texts):
        return {"outcome": "validated_correct", "where": "retrieved"}
    # 2. documents: lexical locate across the whole corpus
    try:
        located = engine.search(QueryRequest(
            query=quote, tag_mode="none", mode="precision"), k=5)[0]
    except ValueError:
        located = None
    if located and located.hits:
        toks = set(re.findall(r"[a-z0-9]+", q.lower()))
        for h in located.hits:
            if q in _norm_ws(h.text):
                return {"outcome": "validated_correct", "where": "corpus",
                        "doc_id": h.doc_id}
        best = max(located.hits, key=lambda h: len(
            toks & set(re.findall(r"[a-z0-9]+", h.text.lower()))))
        overlap = (len(toks & set(re.findall(r"[a-z0-9]+", best.text.lower())))
                   / max(len(toks), 1))
        if overlap >= _LOCATE_OVERLAP:
            return {"outcome": "validated_hallucinated", "where": "corpus",
                    "doc_id": best.doc_id, "overlap": round(overlap, 3)}
    # 3. discovered_sources: curated registry for this payer
    sources = []
    if curator is not None:
        sources = [s for s in curator.search(payer=req.payer or "")
                   if s.status in ("curated", "ingested", "discovered")]
    if sources:
        src = sources[0]  # highest authority first (registry sort order)
        if web is not None and not getattr(web, "offline", False):
            probe = curator.probe(src.url) if hasattr(curator, "probe") else {}
            if probe.get("robots_disallowed"):
                return {"outcome": "unverified_robots", "url": src.url}
            body = web.fetch(src.url, timeout_s=8.0)
            if not body:
                return {"outcome": "needs_scrape", "url": src.url}
            if q in _norm_ws(body):
                return {"outcome": "validated_correct", "where": "external",
                        "url": src.url}
            return {"outcome": "located_unverified", "url": src.url}
        return {"outcome": "located_unverified", "url": src.url,
                "reason": "offline"}
    # 4. nothing locatable
    return {"outcome": "needs_external"}


def run_strategy_c(engine: SearchEngine, req: QueryRequest, k: int,
                   llm: LLMClient, curator=None,
                   web: WebSearchClient | None = None) -> StrategyOutcome:
    """LLM → validate (strategy_c.py:977): answer with quoted citations,
    then run every quote through the documents → discovered_sources →
    web locator chain (locate_citation's 6-outcome matrix). Success
    requires every citation validated_correct; located_unverified
    citations degrade confidence instead of failing outright (the
    reference surfaces them as caveats)."""
    t0 = time.perf_counter()
    # retrieval runs on the payer-contextualized rewrite; the LLM still
    # answers the caller's original question
    rewritten = rewrite_for_strategy(req.query, "c", payer=req.payer,
                                     state=req.state, program=req.program)
    res = engine.search(dataclasses.replace(req, query=rewritten,
                                            mode="recall"), k=max(k, 8))[0]
    context = "\n".join(
        f"[passage {i}]\n{h.text}" for i, h in enumerate(res.hits)
    )
    prompt = (
        f"Answer the question using ONLY the passages. Quote supporting "
        f"text in double quotes.\n\nQUESTION: {req.query}\n\n{context}"
    )
    answer = llm.generate(prompt, stage="strategy_c", max_tokens=800)
    texts = [h.text for h in res.hits]
    outcomes = []
    for quote in _QUOTE_RE.findall(answer or ""):
        loc = locate_citation(quote, texts, engine, req, curator, web)
        outcomes.append({"quote": quote[:120], **loc})
    by_outcome: dict[str, int] = {}
    for o in outcomes:
        by_outcome[o["outcome"]] = by_outcome.get(o["outcome"], 0) + 1
    n_ok = by_outcome.get("validated_correct", 0)
    n_bad = by_outcome.get("validated_hallucinated", 0)
    success = bool(answer) and bool(outcomes) and n_ok == len(outcomes)
    if success:
        label = "high" if n_ok >= 2 else "medium"
    elif n_bad == 0 and n_ok > 0:
        label = "low"  # partially verified, rest located-but-unverified
    else:
        label = "abstain"
    return StrategyOutcome(
        "c", res.hits[:k], answer if success else None, label, success,
        {"citations": outcomes, "outcome_counts": by_outcome},
        (time.perf_counter() - t0) * 1e3, [res],
    )


def run_strategy_d(engine: SearchEngine, req: QueryRequest, k: int,
                   llm: LLMClient, web: WebSearchClient) -> StrategyOutcome:
    """External-first: authoritative web query from payer context, fetch
    top URLs, synthesize with passage citations."""
    t0 = time.perf_counter()
    rewritten = rewrite_for_strategy(req.query, "d", payer=req.payer,
                                     state=req.state, program=req.program)
    serp = web.search(f"{rewritten} provider manual", max_results=5)
    passages = []
    for r in serp[:5]:
        body = web.fetch(r.get("url", ""), timeout_s=8.0)
        if body:
            passages.append({"url": r["url"], "text": body[:2000]})
    if not passages:
        return StrategyOutcome("d", [], None, "abstain", False,
                               {"serp": len(serp), "fetched": 0},
                               (time.perf_counter() - t0) * 1e3)
    context = "\n".join(f"[passage {i}]\n{p['text']}" for i, p in enumerate(passages))
    answer = llm.generate(
        f"Answer from the passages, citing them as [passage N].\n\n"
        f"QUESTION: {req.query}\n\n{context}",
        stage="strategy_d", max_tokens=800,
    )
    hits = [
        SearchHit(row=-1, chunk_id=f"external-{i}", doc_id=p["url"], text=p["text"],
                  score=0.5, similarity=0.0, signals={},
                  metadata={"source_type": "external", "url": p["url"]})
        for i, p in enumerate(passages)
    ]
    success = bool(answer and "[passage" in answer)
    return StrategyOutcome(
        "d", hits[:k], answer if success else None,
        "medium" if success else "abstain", success,
        {"serp": len(serp), "fetched": len(passages)},
        (time.perf_counter() - t0) * 1e3,
    )


_CONCEPTUAL_MARKERS = re.compile(r"\b(why|how does|explain|compare|difference)\b", re.I)


def run_strategy_s(req: QueryRequest, fact_store: FactStoreClient | None) -> StrategyOutcome | None:
    """Fact-store pre-route; None = no hit / guarded off (conceptual
    queries skip the fact store — its rows are point facts)."""
    if fact_store is None or _CONCEPTUAL_MARKERS.search(req.query):
        return None
    t0 = time.perf_counter()
    row = fact_store.lookup(req.query, payer=req.payer, state=req.state)
    if not row:
        return None
    hit = SearchHit(
        row=-1, chunk_id=f"fact-{row.get('id', '0')}", doc_id=row.get("source", "fact_store"),
        text=row.get("fact", ""), score=1.0, similarity=1.0, signals={},
        metadata={"source_type": "fact_store", "payer": row.get("payer", "")},
    )
    return StrategyOutcome(
        "s", [hit], row.get("fact", ""), "high", True,
        {"fact_id": row.get("id")}, (time.perf_counter() - t0) * 1e3,
    )
