"""The retrieval agent — RAG-as-agent orchestrator (the port of
``mobius_rag_tpu.query.agent``).

Rebuilds app/services/corpus_search_agent.py (5.6k LoC) as a thin host
control loop over the search engine:

  classify → fact-store pre-route (s) → fail-fast gate (e) →
  corpus probe + contour gate → route (v1/v2) → adaptive strategy loop
  with per-strategy success criteria → synthesis → confidence + hint

Control flow is host Python (strings and decisions); all O(corpus) work
stays in the device searches the strategies call. Reference anchors:
outer ≤4-attempt cascade (:3066), forced-mode override (:3082), gate e
(:398), strategy order by profile (:2240), adaptive success checks
(:2352), synthesis (:2673), confidence aggregation (:2534), improvement
hint (:2556), v2 multi-invoke union (:2986, :3031).
"""
from __future__ import annotations

import dataclasses
import os
import time
import uuid
from typing import Any

from mobius_rag_tpu_torch.clients import (FactStoreClient, LLMClient, OfflineLLMStub,
                                          OfflineWebStub, WebSearchClient)
from mobius_rag_tpu_torch.query.classify import QueryProfile, classify_query
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine, SearchHit
from mobius_rag_tpu_torch.query.gate import (Contour, GateResult, corpus_probe,
                                             doc_tag_index, run_gate)
from mobius_rag_tpu_torch.query.router import (RoutePreferences, Router,
                                               resolve_preferences)
from mobius_rag_tpu_torch.query.strategies import (StrategyOutcome, run_strategy_a,
                                                   run_strategy_b, run_strategy_c,
                                                   run_strategy_d, run_strategy_s)

MAX_ATTEMPTS = 4

# Escalation budget (agent :2321): strategies carry relative costs; the
# adaptive loop stops escalating when the per-query budget is spent even
# if attempts remain (c/d burn LLM/web calls, a/b are near-free).
STRATEGY_COST = {"a": 1.0, "b": 2.0, "c": 4.0, "d": 4.0, "s": 0.5}
ESCALATION_BUDGET = 8.0

# Query-signature fast-exit (agent :3105): a query shape that was just
# refused/abstained fast-exits without re-running the strategy cascade.
_SIGNATURE_CACHE_MAX = 512

# Selectivity-based term partitioning (agent :1131-1343): matched lexicon
# entries split into ANCHORS (rare, discriminating — they drive filters
# and candidate pools) and CONTEXT (common — expansion-only). An entry
# anchors when its corpus-derived selectivity clears this bar.
ANCHOR_SELECTIVITY = 0.82

# Candidate-pool cascade (agent :1762): minimum docs for a pool level to
# be usable; below it the pool relaxes one level.
POOL_MIN_DOCS = 1

# Internal recall self-estimate (agent :1503): below this the adaptive
# loop keeps escalating even after a nominal success, and the re-route
# boosts recall demand (router hook).
SELF_ESTIMATE_FLOOR = 0.5


def partition_terms(profile: QueryProfile, lexicon) -> dict[str, list[str]]:
    """Split the query's matched lexicon codes into anchors vs context by
    selectivity (agent :1131-1221 semantics — selectivity is corpus-
    derived via Lexicon.set_tag_doc_counts)."""
    anchors, context = [], []
    for code in profile.expansion.matched_codes:
        e = lexicon.entry_by_code(code) if lexicon else None
        if e is not None and e.selectivity >= ANCHOR_SELECTIVITY:
            anchors.append(code)
        else:
            context.append(code)
    return {"anchors": anchors, "context": context}


@dataclasses.dataclass
class AgentRequest:
    query: str
    # Forced strategy override (agent :3082): a single strategy
    # ("a"), or an override SET ("a,c" / "a+c") restricting the
    # adaptive cascade to exactly those strategies in router order;
    # None = the router picks freely.
    mode: str | None = None
    payer: str = ""
    state: str = ""
    program: str = ""
    k: int = 10
    # Caller-mode preset (router :118-160): named context resolving to
    # preference defaults; the explicit fields below override it.
    caller_mode: str | None = None
    accuracy_need: float | None = None
    recall_demand: float | None = None
    speed_budget: str | None = None
    answer_shape: str | None = None
    embedding: Any = None


@dataclasses.dataclass
class AgentResult:
    agent_id: str
    query: str
    answer: str
    chunks: list[SearchHit]
    confidence_label: str
    strategy_chain: list[str]
    decision: dict[str, Any]
    gate: dict[str, Any]
    profile: dict[str, Any]
    improvement_hint: str
    refused: bool
    telemetry: dict[str, Any]
    # Human-readable strategy-chain narrative for the operator trace UI
    # (the reference persists one per decision, agent :3402) — how the
    # query moved through classify → gate → route → strategies.
    narrative: str = ""


class CorpusSearchAgent:
    def __init__(
        self,
        engine: SearchEngine,
        *,
        router: Router | None = None,
        llm: LLMClient | None = None,
        web: WebSearchClient | None = None,
        fact_store: FactStoreClient | None = None,
        router_version: str | None = None,
        curator=None,
    ):
        self.engine = engine
        version = router_version or os.getenv("ROUTER_VERSION", "v1")
        self.router = router or Router(version=version)
        self.llm = llm or OfflineLLMStub()
        if web is None:
            # env-selected concrete transport (MRAG_WEB_PROVIDER:
            # Google CSE / DDG HTML / chained — providers_external.py);
            # unset keeps the zero-egress stub
            from mobius_rag_tpu_torch.providers_external import get_web_client

            web = get_web_client()
        self.web = web or OfflineWebStub()
        self.fact_store = fact_store
        # discovered-source registry backing strategy c's citation
        # locator chain (strategy_c.py:273-699)
        self.curator = curator
        self._tag_docs_cache: tuple[int, dict] | None = None
        self.observers: list = []  # callbacks(AgentResult) — decision persistence
        # signature → (refused_answer, contour) for fast-exit
        self._signature_cache: dict[str, tuple[str, str]] = {}
        # conflicting-number passages dropped by the last synthesis
        self._synth_conflicts: list[dict] = []

    def _vocab_overlap(self, query: str) -> float | None:
        """Fraction of the query's content words whose hash bucket is
        populated in the corpus DF table — the gate's in-domain signal
        for lexicon-free phrasing (run_gate vocab_overlap). None when
        the store has no lexical stats (empty corpus)."""
        from mobius_rag_tpu_torch.query.gate import _plausible_words  # noqa: F401
        from mobius_rag_tpu_torch.query.text import hash_bucket, tokenize

        try:
            df, n_live = self.engine.store.lexical_stats()
        except Exception:
            return None
        if not df or n_live <= 0:
            return None
        words = [w for w in tokenize(query) if len(w) >= 4]
        if not words:
            return None
        h = self.engine.cfg.lexical_buckets
        hits = sum(1 for w in words if df.get(hash_bucket(w, h), 0) > 0)
        return hits / len(words)

    # -- corpus probe cache -------------------------------------------------

    def _tag_docs(self) -> dict:
        key = len(self.engine.store.records)
        if self._tag_docs_cache is None or self._tag_docs_cache[0] != key:
            self._tag_docs_cache = (
                key, doc_tag_index(self.engine.store, self.engine.lexicon)
            )
        return self._tag_docs_cache[1]

    def _doc_meta(self) -> dict[str, tuple[str, int]]:
        """doc_id → (payer, max authority_level) over live records."""
        key = len(self.engine.store.records)
        cached = getattr(self, "_doc_meta_cache", None)
        if cached is None or cached[0] != key:
            meta: dict[str, tuple[str, int]] = {}
            for rec in self.engine.store.records:
                if rec is None:
                    continue
                prev = meta.get(rec.doc_id, ("", -1))
                meta[rec.doc_id] = (rec.payer or prev[0],
                                    max(prev[1], rec.authority_level))
            self._doc_meta_cache = (key, meta)
        return self._doc_meta_cache[1]

    # -- candidate pool (agent :1762, :1970) ---------------------------------

    def build_candidate_pool(self, partition: dict[str, list[str]],
                             payer: str) -> dict[str, Any]:
        """Cascading candidate-pool levels: tightest usable pool wins.
          L0  docs carrying ALL anchor tags, payer-matched
          L1  docs carrying ANY anchor tag, payer-matched
          L2  L1 ∪ payer-unaffiliated regulator docs (inherited-authority
              augmentation — regulator policy governs every payer)
          L3  docs carrying ANY matched tag (union, unfiltered)
        """
        tag_docs = self._tag_docs()
        meta = self._doc_meta()
        anchors = partition["anchors"]
        all_codes = anchors + partition["context"]

        def payer_ok(doc: str) -> bool:
            return not payer or meta.get(doc, ("", 0))[0] in ("", payer)

        anchor_sets = [tag_docs.get(c, set()) for c in anchors]
        l0 = set.intersection(*anchor_sets) if anchor_sets else set()
        l0 = {d for d in l0 if payer_ok(d)}
        l1 = set().union(*anchor_sets) if anchor_sets else set()
        l1 = {d for d in l1 if payer_ok(d)}
        regulators = {d for d, (p, a) in meta.items() if not p and a >= 4}
        l2 = l1 | {d for d in regulators
                   if any(d in tag_docs.get(c, ()) for c in all_codes)}
        l3 = set().union(*(tag_docs.get(c, set()) for c in all_codes)) \
            if all_codes else set()
        for level, pool in enumerate((l0, l1, l2, l3)):
            if len(pool) >= POOL_MIN_DOCS:
                return {"level": level, "docs": len(pool),
                        "doc_ids": sorted(pool)[:20],
                        "inherited": level == 2 and bool(pool - l1)}
        return {"level": 3, "docs": 0, "doc_ids": [], "inherited": False}

    # -- internal recall self-estimate (agent :1503) --------------------------

    def _recall_self_estimate(self, outcome: StrategyOutcome,
                              partition: dict[str, list[str]]) -> float:
        """How much of the query's anchor-term surface did the hits
        actually cover? Feeds routing (low estimate ⇒ keep escalating and
        boost recall demand on the re-route)."""
        if not outcome.hits:
            return 0.0
        lex = self.engine.lexicon
        anchor_keys = set()
        for code in partition["anchors"]:
            e = lex.entry_by_code(code) if lex else None
            if e is not None:
                anchor_keys.add((e.kind, e.tag_id))
        covered = set()
        for h in outcome.hits:
            rec = self.engine.store.record(h.row) if h.row >= 0 else None
            if rec is None:
                continue
            for kind, ids in (("j", rec.j_tags), ("d", rec.d_tags),
                              ("p", rec.p_tags)):
                covered |= {(kind, t) for t in ids}
        tag_cov = (len(anchor_keys & covered) / len(anchor_keys)
                   if anchor_keys else 1.0)
        conf = {"high": 1.0, "medium": 0.7, "low": 0.4,
                "abstain": 0.0}.get(outcome.confidence_label, 0.0)
        return round(0.6 * tag_cov + 0.4 * conf, 4)

    # -- strategies ----------------------------------------------------------

    def _run_strategy(self, sid: str, req: QueryRequest, k: int,
                      literals: tuple[str, ...] = ()) -> StrategyOutcome:
        if sid == "a":
            return run_strategy_a(self.engine, req, k, literals=literals)
        if sid == "b":
            return run_strategy_b(self.engine, req, k)
        if sid == "c":
            return run_strategy_c(self.engine, req, k, self.llm,
                                  curator=self.curator, web=self.web)
        if sid == "d":
            return run_strategy_d(self.engine, req, k, self.llm, self.web)
        raise ValueError(f"unknown strategy {sid!r}")

    # -- synthesis -------------------------------------------------------------

    def _filter_conflicting(
            self, hits: list[SearchHit]) -> tuple[list[SearchHit], list[dict]]:
        """Drop lower-ranked passages that mirror a higher-ranked one but
        disagree on numbers. A near-duplicate with perturbed figures is
        the classic poisoned/near-miss shape (timely filing 90 vs 180
        days); feeding both to synthesis invites the model to assert the
        wrong one. Hits arrive fusion-ranked (score + authority), so the
        kept copy is always the better-trusted one. Reference analogue:
        corpus_search_agent.py:2673's synthesis context builder trusts
        rank order the same way — this makes the trust explicit when
        passages contradict each other."""
        import re as _re

        num_re = _re.compile(r"\d+(?:\.\d+)?")
        from mobius_rag_tpu_torch.query.text import tokenize

        sigs: list[tuple[frozenset[str], frozenset[str]]] = []
        for h in hits:
            nums = frozenset(num_re.findall(h.text))
            toks = frozenset(t for t in tokenize(h.text, drop_stopwords=True)
                             if not t.isdigit())
            sigs.append((nums, toks))
        kept: list[SearchHit] = []
        kept_sigs: list[tuple[frozenset[str], frozenset[str]]] = []
        conflicts: list[dict] = []
        for h, (nums, toks) in zip(hits, sigs):
            clash = None
            for kh, (knums, ktoks) in zip(kept, kept_sigs):
                if not nums or not knums or nums == knums or not toks or not ktoks:
                    continue
                overlap = len(toks & ktoks) / min(len(toks), len(ktoks))
                if overlap >= 0.7 and (nums ^ knums):
                    clash = (kh, knums)
                    break
            if clash is not None:
                conflicts.append({
                    "dropped_doc": h.doc_id, "kept_doc": clash[0].doc_id,
                    "dropped_nums": sorted(nums - clash[1])[:6],
                })
            else:
                kept.append(h)
                kept_sigs.append((nums, toks))
        return kept, conflicts

    def _synthesize(self, query: str, hits: list[SearchHit]) -> str:
        if not hits:
            return ""
        hits, conflicts = self._filter_conflicting(hits)
        self._synth_conflicts = conflicts

        def passage(h: SearchHit) -> str:
            # neighbor-enriched context (corpus_search.py:3079): siblings
            # carry the section header / table label a sparse chunk lacks
            parts = [h.text] + [n["text"] for n in getattr(h, "neighbors", [])]
            return "\n".join(parts)

        context = "\n".join(
            f"[passage {i}]\n{passage(h)}" for i, h in enumerate(hits[:8])
        )
        return self.llm.generate(
            f"Synthesize a grounded answer from the passages; cite as "
            f"[passage N]; say UNKNOWN if they don't answer it.\n\n"
            f"QUESTION: {query}\n\n{context}",
            stage="synthesis", max_tokens=900,
        )

    @staticmethod
    def _improvement_hint(gate: GateResult, profile: QueryProfile,
                          outcomes: list[StrategyOutcome]) -> str:
        if gate.contour == Contour.UNDERSPECIFIED:
            missing = "payer" if not profile.has_j_tag else "topic facet"
            return f"specify the {missing} to narrow the search"
        if gate.contour == Contour.CORPUS_GAP:
            return "the corpus has no documents for these tags — ingest the payer's manual"
        if gate.contour == Contour.VICINITY:
            return "related documents exist but not this exact combination"
        if outcomes and all(not o.success for o in outcomes):
            return "try adding a payer name or policy/HCPCS code"
        return ""

    # -- main --------------------------------------------------------------

    @staticmethod
    def _parse_mode(mode: str | None) -> list[str]:
        """Forced-mode override parse: None → [], "a" → ["a"],
        "a,c"/"a+c" → ["a", "c"] (an override SET, agent :3082)."""
        if not mode:
            return []
        parts = [p.strip() for p in mode.replace("+", ",").split(",") if p.strip()]
        bad = [p for p in parts if p not in ("a", "b", "c", "d", "s")]
        if bad or not parts:
            raise ValueError(
                f"mode {mode!r} must be strategies from a|b|c|d|s "
                f"(single or a ','/'+'-joined set)")
        return list(dict.fromkeys(parts))

    def run(self, req: AgentRequest) -> AgentResult:
        forced = self._parse_mode(req.mode)
        t0 = time.perf_counter()
        agent_id = uuid.uuid4().hex[:12]
        self._synth_conflicts = []
        chain: list[str] = []
        outcomes: list[StrategyOutcome] = []
        story: list[str] = []  # strategy-chain narrative lines

        # classify with a corpus probe behind the matched tags
        pre = classify_query(req.query, self.engine.lexicon)
        probe = corpus_probe(pre.expansion.matched_codes, self._tag_docs())
        profile = classify_query(
            req.query, self.engine.lexicon,
            {"union_docs": probe.union_docs, "intersection_docs": probe.intersection_docs},
        )
        gate = run_gate(req.query, profile, probe,
                        vocab_overlap=self._vocab_overlap(req.query))

        # selectivity partition + cascading candidate pool (:1343, :1762)
        partition = partition_terms(profile, self.engine.lexicon)
        pool = self.build_candidate_pool(partition, req.payer)

        story.append(
            f"classified as {profile.query_class} "
            f"(canonicality {profile.canonicality:.2f}, "
            f"literals {profile.literals or 'none'}); "
            f"gate contour {gate.contour.value}")
        story.append(
            f"anchors {partition['anchors'] or 'none'}, "
            f"candidate pool L{pool['level']} ({pool['docs']} docs"
            + (", inherited-authority augmented" if pool.get("inherited") else "")
            + ")")

        base_req = QueryRequest(
            query=req.query, embedding=req.embedding, payer=req.payer,
            state=req.state, program=req.program,
        )

        def _result(answer, hits, label, decision, refused=False):
            hint = self._improvement_hint(gate, profile, outcomes)
            res = AgentResult(
                agent_id=agent_id, query=req.query, answer=answer, chunks=hits,
                confidence_label=label, strategy_chain=chain,
                decision=decision,
                gate={"contour": gate.contour.value, "reasons": gate.reasons,
                      "fail_fast": gate.fail_fast,
                      "union_docs": probe.union_docs,
                      "intersection_docs": probe.intersection_docs},
                profile={"query_class": profile.query_class,
                         "literals": profile.literals,
                         "canonicality": profile.canonicality,
                         "anchors": partition["anchors"],
                         "context_terms": partition["context"],
                         "pool": pool,
                         **profile.features},
                improvement_hint=hint, refused=refused,
                narrative=" → ".join(story),
                telemetry={
                    "elapsed_ms": (time.perf_counter() - t0) * 1e3,
                    "synthesis_conflicts": self._synth_conflicts,
                    "attempts": [
                        {"strategy": o.strategy, "success": o.success,
                         "hits": len(o.hits), "label": o.confidence_label,
                         "ms": o.elapsed_ms, "detail": o.detail}
                        for o in outcomes
                    ],
                },
            )
            for obs in self.observers:
                try:
                    obs(res)
                except Exception:  # observers are fire-and-forget
                    pass
            return res

        # query-signature fast-exit: identical normalized query shape that
        # was just refused skips the cascade entirely (agent :3105)
        signature = " ".join(sorted(set(req.query.lower().split()))) + f"|{req.payer}"
        cached = self._signature_cache.get(signature)
        if cached is not None and not forced:
            chain.append("e")
            story.append("signature fast-exit (same query shape was just refused)")
            return _result(cached[0], [], "abstain",
                           {"strategy": "e", "reason": "signature fast-exit"},
                           refused=True)

        def _refuse(answer, reason):
            chain.append("e")
            story.append(f"refused by gate e ({reason})")
            if len(self._signature_cache) >= _SIGNATURE_CACHE_MAX:
                self._signature_cache.clear()
            self._signature_cache[signature] = (answer, gate.contour.value)
            return _result(answer, [], "abstain",
                           {"strategy": "e", "reason": reason}, refused=True)

        # fail-fast gate e (strategy chain entry "e", ~0.25 s in the
        # reference; here it's pure regex)
        if gate.fail_fast:
            return _refuse(f"Request refused ({gate.fail_fast}).",
                           f"fail_fast:{gate.fail_fast}")
        if gate.contour in (Contour.OUT_OF_SCOPE, Contour.UNCLEAR):
            return _refuse(
                "This question is outside the corpus domain."
                if gate.contour == Contour.OUT_OF_SCOPE
                else "Could not parse the question — please rephrase.",
                f"gate:{gate.contour.value}")

        # strategy s pre-route (payor fact store)
        if not forced or "s" in forced:
            s_out = run_strategy_s(base_req, self.fact_store)
            if s_out is not None:
                chain.append("s")
                outcomes.append(s_out)
                story.append("fact-store pre-route (s) hit — answered directly")
                return _result(s_out.answer or "", s_out.hits, "high",
                               {"strategy": "s", "reason": "fact-store hit"})
            if forced == ["s"]:
                chain.append("s")
                story.append("forced s: no fact-store hit")
                return _result("", [], "abstain",
                               {"strategy": "s", "reason": "forced s; no fact-store hit"})
            forced = [f for f in forced if f != "s"]

        # multi-literal short-circuit (agent :2091): two+ literal anchors
        # co-occurring verbatim in one chunk is near-certain evidence —
        # skip routing entirely and return the direct lookup.
        if not forced and len(profile.literals) >= 2:
            t_sc = time.perf_counter()
            sc = self.engine.search(dataclasses.replace(
                base_req, tag_mode="none", mode="precision"), k=req.k * 2)[0]
            lits = [l.lower() for l in profile.literals]
            sc_hits = [h for h in sc.hits
                       if all(l in h.text.lower() for l in lits)][: req.k]
            if sc_hits:
                chain.append("a")
                outcomes.append(StrategyOutcome(
                    "a", sc_hits, None, "high", True,
                    {"short_circuit": "multi_literal",
                     "literals": profile.literals},
                    (time.perf_counter() - t_sc) * 1e3, [sc]))
                story.append(
                    f"multi-literal short-circuit: {profile.literals} "
                    f"co-occur verbatim in {len(sc_hits)} chunk(s)")
                answer = self._synthesize(req.query, sc_hits)
                return _result(answer, sc_hits, "high",
                               {"strategy": "a",
                                "reason": "multi-literal short-circuit"})

        # route — caller-mode preset resolution (router :118-162): the
        # named preset supplies defaults, explicit request fields win
        prefs = resolve_preferences(
            req.caller_mode, accuracy_need=req.accuracy_need,
            recall_demand=req.recall_demand, speed_budget=req.speed_budget,
            answer_shape=req.answer_shape,
        )
        # inherited-authority corpus signal for the linear router features
        # (regulator-grade docs exist → corpus_depth counts them)
        has_regulator = any(
            r is not None and r.authority_level >= 4
            for r in self.engine.store.records
        )
        features = {**profile.features, "query_class": profile.query_class,
                    "canonicality": profile.canonicality,
                    "has_inherited_docs": has_regulator,
                    # the pool refines the raw probe's union for routing
                    "pool_size": pool["docs"] or profile.pool_size,
                    "pool_level": pool["level"]}
        if len(forced) == 1:
            decision = self.router.decide_override(forced[0], features, prefs)
        elif forced:
            # forced override SET (agent :3082): the router ranks freely
            # but the cascade may only use strategies from the set
            decision = self.router.decide(features, prefs)
            order = [s for s in decision.order if s in forced] or list(forced)
            decision = dataclasses.replace(
                decision, order=order, strategy=order[0],
                multi_invoke=[order[0]],
                reason=f"forced_set={'+'.join(forced)}; " + decision.reason)
        else:
            decision = self.router.decide(features, prefs)

        decision_dict = {
            "strategy": decision.strategy, "order": decision.order,
            "scores": decision.scores, "withdrawn": decision.withdrawn,
            "multi_invoke": decision.multi_invoke,
            "priors_version": decision.priors_version, "reason": decision.reason,
        }
        score_str = ", ".join(f"{s}:{decision.scores.get(s, 0.0):.2f}"
                              for s in decision.order)
        story.append(
            ("forced to " if forced else "routed to ")
            + f"{decision.strategy}"
            + (f" [{score_str}]" if score_str else "")
            + (f" (caller mode {req.caller_mode})" if req.caller_mode else "")
            + (f", withdrawn {decision.withdrawn}" if decision.withdrawn else ""))

        # v2 multi-invoke: run the near-tied strategies, union, synthesize once
        if len(decision.multi_invoke) > 1 and not forced:
            merged: dict[str, SearchHit] = {}
            for sid in decision.multi_invoke:
                chain.append(sid)
                out = self._run_strategy(sid, base_req, req.k)
                outcomes.append(out)
                for h in out.hits:
                    key = h.chunk_id
                    if key not in merged or h.score > merged[key].score:
                        merged[key] = h
            hits = sorted(merged.values(), key=lambda h: h.score, reverse=True)[: req.k]
            label = max((o.confidence_label for o in outcomes if o.hits),
                        key=["abstain", "low", "medium", "high"].index, default="abstain")
            answer = next((o.answer for o in outcomes if o.answer), None) \
                or self._synthesize(req.query, hits)
            story.append(
                f"v2 multi-invoke {'+'.join(decision.multi_invoke)}: "
                f"union of {len(merged)} chunks, confidence {label}")
            return _result(answer, hits, label, decision_dict)

        # adaptive loop: walk the fallback order until a strategy succeeds
        # WITH an adequate recall self-estimate, or the escalation budget
        # is spent. A nominal success whose self-estimate is low keeps
        # escalating (agent :1503 → the router re-route boosts recall
        # demand through the recall_self_estimate feature).
        budget = ESCALATION_BUDGET
        best: StrategyOutcome | None = None
        best_est = -1.0
        order = list(decision.order)
        attempt = 0
        while order and attempt < MAX_ATTEMPTS:
            sid = order.pop(0)
            cost = STRATEGY_COST.get(sid, 1.0)
            if cost > budget and best is not None:
                story.append(f"escalation budget spent before {sid}")
                break  # escalation budget spent (agent :2321)
            budget -= cost
            attempt += 1
            chain.append(sid)
            out = self._run_strategy(sid, base_req, req.k,
                                     literals=tuple(profile.literals))
            est = self._recall_self_estimate(out, partition)
            out.detail["recall_self_estimate"] = est
            outcomes.append(out)
            story.append(
                f"strategy {sid}: {len(out.hits)} hits, "
                f"{out.confidence_label}, self-estimate {est:.2f} — "
                + ("accepted" if out.success and est >= SELF_ESTIMATE_FLOOR
                   else "succeeded but low estimate, escalating"
                   if out.success else "failed"))
            if est > best_est or (out.success and not (best and best.success)):
                best, best_est = out, est
            if len(forced) == 1:  # single forced mode: one attempt only
                break
            if out.success and est >= SELF_ESTIMATE_FLOOR:
                break
            if out.success and est < SELF_ESTIMATE_FLOOR and order:
                # re-route with the self-estimate fed back (router hook);
                # a forced set also bounds the re-route
                redecide = self.router.decide(
                    {**features, "recall_self_estimate": est}, prefs,
                    exclude=list(dict.fromkeys(chain)))
                order = [s for s in redecide.order if s not in chain
                         and (not forced or s in forced)]

        best = best or StrategyOutcome(decision.strategy, [], None, "abstain",
                                       False, {}, 0.0)
        answer = best.answer or self._synthesize(req.query, best.hits)
        label = self._aggregate_confidence(best, outcomes)
        if len(outcomes) >= 3 and label != best.confidence_label:
            story.append(
                f"confidence downgraded to {label} ({len(outcomes)} attempts)")
        return _result(answer, best.hits, label, decision_dict)

    @staticmethod
    def _aggregate_confidence(best: StrategyOutcome,
                              outcomes: list[StrategyOutcome]) -> str:
        """Confidence aggregation (agent :2534): the winning outcome's
        label, downgraded one notch when the cascade needed 3+ attempts —
        having to escalate that far is itself evidence of uncertainty."""
        if not best.hits:
            return "abstain"
        ladder = ["abstain", "low", "medium", "high"]
        label = best.confidence_label
        if len(outcomes) >= 3 and label != "abstain":
            label = ladder[max(0, ladder.index(label) - 1)]
        return label
