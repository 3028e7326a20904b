"""Fixture corpus loader — the real-text quality-loop substrate.

The reference's production corpus (~70k chunks of payer manuals behind
eval/queries_cmhc.yaml) is not part of its repo, so this framework ships
an AUTHORED policy-document corpus (data/corpus_cmhc/) that reconstructs
the bank's fact surface. Loading goes through the FULL ingest pipeline —
upload → chunking worker (Path-B tagging over the C++ Aho-Corasick) →
embedding worker (batched encode) → publish — exactly the path a
production document takes (reference: main.py:5126 upload →
worker/coordinator.py → embedding_worker.py → publish.py).

The port of ``mobius_rag_tpu.eval_harness.fixture_corpus``: the corpus is
a copy of the JAX package's under the port's ``data/corpus_cmhc/``, its
``manifest.yaml`` as ``manifest.json``.
"""
from __future__ import annotations

import json
import os
from typing import Any, Callable

import numpy as np

from mobius_rag_tpu_torch.config import Config, get_config
from mobius_rag_tpu_torch.index.store import ChunkStore
from mobius_rag_tpu_torch.ingest.pipeline import IngestPipeline
from mobius_rag_tpu_torch.query.lexicon import Lexicon

DEFAULT_CORPUS_DIR = os.path.join(
    os.path.dirname(__file__), "..", "data", "corpus_cmhc")


def load_fixture_corpus(pipeline: IngestPipeline,
                        corpus_dir: str | None = None) -> dict[str, Any]:
    """Upload + drain every manifest document through the pipeline.
    Returns {documents, chunks, drained}."""
    corpus_dir = corpus_dir or DEFAULT_CORPUS_DIR
    with open(os.path.join(corpus_dir, "manifest.json")) as f:
        manifest = json.load(f)
    uploaded = 0
    for doc in manifest["documents"]:
        path = os.path.join(corpus_dir, doc["file"])
        with open(path, "rb") as f:
            data = f.read()
        pipeline.upload(
            data, doc["file"], payer=doc.get("payer", ""),
            state=doc.get("state", ""), program=doc.get("program", ""),
            authority_level=int(doc.get("authority_level", 0)),
            summary=doc.get("summary", ""), instant=False,
        )
        uploaded += 1
    drained = pipeline.drain(max_jobs_per_kind=4 * uploaded)
    return {"documents": uploaded, "chunks": pipeline.store.size,
            "drained": drained}


def derive_selectivity(store: ChunkStore, lexicon: Lexicon) -> int:
    """Recompute entry selectivity from corpus doc counts per tag
    (Lexicon.set_tag_doc_counts — the agent's selectivity partition
    input, corpus_search_agent.py:1131-1221). Returns n_docs."""
    docs_per_tag: dict[str, set[str]] = {}
    doc_ids: set[str] = set()
    tag_code = {
        (e.kind, e.tag_id): e.full_code for e in lexicon.entries
    }
    for rec in store.records:
        if rec is None:
            continue
        doc_ids.add(rec.doc_id)
        for kind, ids in (("j", rec.j_tags), ("d", rec.d_tags), ("p", rec.p_tags)):
            for tid in ids:
                code = tag_code.get((kind, tid))
                if code:
                    docs_per_tag.setdefault(code, set()).add(rec.doc_id)
    lexicon.set_tag_doc_counts(
        {c: len(d) for c, d in docs_per_tag.items()}, len(doc_ids))
    return len(doc_ids)


_DISTRACTOR_PAYERS = [
    ("peach_state", "GA", "Peach State Health Plan"),
    ("superior", "TX", "Superior HealthPlan"),
    ("buckeye", "OH", "Buckeye Health Plan"),
    ("magellan", "PA", "Magellan Health"),
    ("amerihealth", "NC", "AmeriHealth Caritas"),
    ("anthem", "CA", "Anthem Blue Cross"),
    ("united_healthcare", "NY", "UnitedHealthcare Community Plan"),
    ("cigna", "IL", "Cigna Healthcare"),
    ("carelon", "MI", "Carelon Behavioral Health"),
]

_DISTRACTOR_TOPICS = [
    ("timely filing", "Initial claims must be received within {n} days of the "
     "date of service; corrected claims within {m} days of the remittance advice."),
    ("prior authorization", "Prior authorization requests for {svc} are decided "
     "within {n} calendar days; expedited requests within {m} hours."),
    ("appeals", "Provider disputes must be filed within {n} days of the "
     "explanation of payment, with the original claim number attached."),
    ("eligibility verification", "Verify member eligibility through the provider "
     "portal before each visit; enrollment can change monthly."),
    ("credentialing", "Credentialing applications are processed within {n} "
     "calendar days; re-credentialing occurs every {m} months."),
    ("telehealth", "Synchronous telehealth for {svc} is billed with the modifier "
     "and place-of-service combination in the billing guide."),
    ("pharmacy", "The preferred drug list is updated quarterly; non-formulary "
     "requests require a coverage determination from the prescriber."),
    ("behavioral health", "{svc} requires a current treatment plan and progress "
     "notes demonstrating medical necessity; units beyond the annual maximum "
     "require authorization."),
]

_DISTRACTOR_SERVICES = [
    "intensive outpatient services", "residential treatment",
    "psychological testing", "applied behavior analysis",
    "durable medical equipment", "home health visits", "imaging studies",
    "partial hospitalization", "targeted case management", "dialysis services",
    "skilled nursing care", "outpatient surgery",
]


def distractor_corpus(n_docs: int, lexicon: Lexicon | None = None,
                      cfg: Config | None = None,
                      embed_fn: Callable[[list[str]], np.ndarray] | None = None,
                      seed: int = 7):
    """Policy-shaped distractor documents over NON-bank payers/states but
    the SAME domain/process vocabulary, so the fixture corpus scales to a
    retrieval difficulty the 20 core documents alone can't provide (the
    reference measured its baselines at ~70k chunks). Deterministic per
    seed. Returns featurized ChunkRecords ready for store.add_chunks."""
    from mobius_rag_tpu_torch.index.store import ChunkRecord
    from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk

    cfg = cfg or get_config()
    if embed_fn is None:
        from mobius_rag_tpu_torch.testing import hash_embed

        embed_fn = hash_embed
    rng = np.random.default_rng(seed)
    recs = []
    texts = []
    metas = []
    for di in range(n_docs):
        payer, state, payer_name = _DISTRACTOR_PAYERS[int(rng.integers(len(_DISTRACTOR_PAYERS)))]
        doc_id = f"distractor_{payer}_{di}"
        n_paras = int(rng.integers(3, 7))
        topic_ids = rng.choice(len(_DISTRACTOR_TOPICS), size=n_paras, replace=True)
        for pi, ti in enumerate(topic_ids):
            topic, template = _DISTRACTOR_TOPICS[int(ti)]
            svc = _DISTRACTOR_SERVICES[int(rng.integers(len(_DISTRACTOR_SERVICES)))]
            body = template.format(
                n=int(rng.choice([30, 60, 90, 95, 120, 180, 365])),
                m=int(rng.choice([24, 36, 48, 72, 90, 180])),
                svc=svc,
            )
            text = f"{payer_name} {state} Medicaid — {topic}: {body}"
            texts.append(text)
            metas.append((doc_id, pi, payer, state, payer_name, topic))
    embs = embed_fn(texts)
    for (doc_id, pi, payer, state, payer_name, topic), text, emb in zip(metas, texts, embs):
        recs.append(featurize_chunk(ChunkRecord(
            chunk_id=f"{doc_id}-c{pi}", doc_id=doc_id,
            source_id=f"{doc_id}-s{pi}", text=text, embedding=emb,
            payer=payer, state=state, program="medicaid",
            authority_level=2, filename=f"{payer_name} Provider Manual {doc_id[-4:]}.pdf",
            section_path=topic.title(), page=pi + 1,
        ), lexicon, cfg))
    return recs


# payer mentions in bank query text → (payer code, state) of the
# authored corpus; traps inherit the SAME payer/state so strict filters
# admit them (a trap the filter rejects tests nothing)
_QUERY_PAYERS = [
    ("sunshine health", ("sunshine_health", "FL", "Sunshine Health")),
    ("aetna", ("aetna", "FL", "Aetna Better Health")),
    ("simply healthcare", ("simply_healthcare", "FL", "Simply Healthcare")),
    ("molina", ("molina", "FL", "Molina Healthcare")),
]

_NUM_RE = None  # lazy compiled


def _perturb_numbers(text: str, rng) -> str | None:
    """Replace every standalone number with a different plausible policy
    value; None when the text has no numbers to perturb."""
    import re
    global _NUM_RE
    if _NUM_RE is None:
        _NUM_RE = re.compile(r"\b(\d{1,4})\b")
    pool = [24, 30, 45, 48, 60, 72, 90, 120, 180, 240, 365]
    hit = {"n": 0}

    def sub(m):
        hit["n"] += 1
        orig = int(m.group(1))
        alts = [p for p in pool if p != orig] or [orig + 30]
        return str(alts[int(rng.integers(len(alts)))])

    out = _NUM_RE.sub(sub, text)
    return out if hit["n"] else None


def adversarial_corpus(bank, lexicon: Lexicon | None = None,
                       cfg: Config | None = None,
                       embed_fn: Callable[[list[str]], np.ndarray] | None = None,
                       seed: int = 13) -> list:
    """Blind-eval trap documents derived from a bank's rubric surface
    (VERDICT r2 item 5 — make the quality claim falsifiable):

    - NEAR-MISS negatives: each numeric must/bonus fact re-appears with
      every number perturbed, in a document carrying the query's OWN
      payer/state and policy phrasing (``trap_nearmiss_*``). A pipeline
      that ranks by topical similarity alone surfaces these over the
      golden chunk; a synthesis that ingests one reports a wrong number.
    - FORBIDDEN traps: each forbidden fact stated as policy text in the
      same payer context (``trap_forbidden_*``). Any of these in the
      retrieved top-k is a scored miss (run_eval's forbidden_hit_rate).

    The corpus rows are ordinary published chunks — same featurization,
    same tags — distinguishable ONLY by doc_id prefix, which the eval
    harness uses for scoring and the engine never sees."""
    from mobius_rag_tpu_torch.eval_harness.bank import load_bank
    from mobius_rag_tpu_torch.index.store import ChunkRecord
    from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk

    if isinstance(bank, str):
        bank = load_bank(bank)
    cfg = cfg or get_config()
    if embed_fn is None:
        from mobius_rag_tpu_torch.testing import hash_embed

        embed_fn = hash_embed
    rng = np.random.default_rng(seed)
    texts, metas = [], []
    for q in bank.queries:
        ql = q.query.lower()
        payer, state, payer_name = "", "FL", "Florida Medicaid"
        for needle, (p, s, name) in _QUERY_PAYERS:
            if needle in ql:
                payer, state, payer_name = p, s, name
                break
        near = []
        for fact in (q.must_facts + q.bonus_facts):
            perturbed = _perturb_numbers(fact, rng)
            if perturbed:
                near.append(perturbed)
        for pi, text in enumerate(near):
            texts.append(f"{payer_name} {state} Medicaid provider policy: "
                         f"{text}.")
            metas.append((f"trap_nearmiss_{q.id}", pi, payer, state,
                          payer_name, "near_miss"))
        for pi, fact in enumerate(q.forbidden_facts):
            texts.append(f"{payer_name} {state} Medicaid provider policy: "
                         f"{fact}.")
            metas.append((f"trap_forbidden_{q.id}", pi, payer, state,
                          payer_name, "forbidden"))
    if not texts:
        return []
    embs = embed_fn(texts)
    recs = []
    for (doc_id, pi, payer, state, payer_name, kind), text, emb in zip(
            metas, texts, embs):
        rec = ChunkRecord(
            chunk_id=f"{doc_id}-c{pi}", doc_id=doc_id,
            source_id=f"{doc_id}-s{pi}", text=text, embedding=emb,
            payer=payer, state=state, program="medicaid",
            authority_level=2,
            filename=f"{payer_name} Policy Bulletin.pdf",
            section_path="Provider Policies", page=pi + 1)
        rec.extra["trap"] = kind
        recs.append(featurize_chunk(rec, lexicon, cfg))
    return recs


def build_fixture_stack(*, embed_fn: Callable[[list[str]], np.ndarray] | None = None,
                        lexicon: Lexicon | None = None,
                        cfg: Config | None = None,
                        corpus_dir: str | None = None,
                        llm=None, telemetry=None, device="cuda"):
    """End-to-end quality-loop stack: full lexicon + fixture corpus
    ingested through the real pipeline + engine + agent, the store and
    engine on ``device``. Returns (agent, engine, store, pipeline, info)."""
    from mobius_rag_tpu_torch.query.agent import CorpusSearchAgent
    from mobius_rag_tpu_torch.query.engine import SearchEngine

    cfg = cfg or get_config()
    lexicon = lexicon or Lexicon.load(cfg.lexicon_path)
    if embed_fn is None:
        from mobius_rag_tpu_torch.testing import hash_embed

        embed_fn = hash_embed
    store = ChunkStore(cfg, device=device)
    import uuid

    from mobius_rag_tpu_torch.ingest.queue import JobQueue

    queue = JobQueue(os.path.join(
        cfg.data_dir, f"jobs-fixture-{uuid.uuid4().hex[:8]}.sqlite"))
    pipeline = IngestPipeline(store, lexicon, embed_fn, llm=llm, queue=queue)
    info = load_fixture_corpus(pipeline, corpus_dir)
    info["n_docs"] = derive_selectivity(store, lexicon)
    engine = SearchEngine(store, lexicon, cfg=cfg, embed_fn=embed_fn,
                          telemetry=telemetry, device=device)
    agent = CorpusSearchAgent(engine, llm=llm)
    return agent, engine, store, pipeline, info
