"""Deterministic test/bench fixtures.

`hash_embed` is a stand-in encoder: a bag-of-words of per-token gaussian
directions (seeded by a stable token hash), L2-normalized. Texts sharing
vocabulary get high cosine similarity, so end-to-end retrieval tests are
meaningful without a trained encoder — the same role the mocked
embedding provider plays in the reference's tests (SURVEY §4 tier 2).
"""
from __future__ import annotations

import zlib

import numpy as np

from mobius_rag_tpu_torch.config import get_config
from mobius_rag_tpu_torch.index.store import ChunkRecord
from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk
from mobius_rag_tpu_torch.query.lexicon import Lexicon
from mobius_rag_tpu_torch.query.text import tokenize


def _token_direction(tok: str, dim: int) -> np.ndarray:
    seed = zlib.crc32(tok.encode())
    return np.random.default_rng(seed).standard_normal(dim).astype(np.float32)


def hash_embed(texts: list[str], dim: int | None = None) -> np.ndarray:
    dim = dim or get_config().embed_dim
    out = np.zeros((len(texts), dim), np.float32)
    for i, t in enumerate(texts):
        toks = tokenize(t, drop_stopwords=True)
        for tok in toks:
            out[i] += _token_direction(tok, dim)
        n = np.linalg.norm(out[i])
        if n > 0:
            out[i] /= n
    return out


def sample_lexicon() -> Lexicon:
    import os

    path = os.path.join(os.path.dirname(__file__), "data", "lexicon_sample.json")
    return Lexicon.from_json(path)


# A tiny synthetic healthcare-policy corpus exercising payers, domains,
# authority levels, and distractors.
_TOY_DOCS = [
    ("sunshine_provider_manual", "sunshine_health", "FL", 4, [
        ("Timely filing: participating providers must submit initial claims "
         "within 180 days from the date of service. Non-participating "
         "providers have 365 days. Claim disputes within 90 days of the EOP.",
         "Claims / Timely Filing"),
        ("Prior authorization is required for residential substance use "
         "treatment billed under H0019. Submit the ASAM level of care "
         "determination with the request.", "Behavioral Health / Prior Auth"),
        ("Durable medical equipment over $500 requires prior authorization. "
         "DME rentals are capped at purchase price.", "Benefits / DME"),
    ]),
    ("aetna_provider_manual", "aetna", "FL", 4, [
        ("Aetna Better Health timely filing deadline is 180 days for all "
         "claims. Corrected claims must arrive within 365 days.",
         "Claims / Filing"),
        ("No PCP referral is required for in-network outpatient behavioral "
         "health therapy. Out-of-network requires prior authorization.",
         "Behavioral Health / Referrals"),
        ("Preferred drug list updates are published quarterly. Formulary "
         "exceptions need a coverage determination request.",
         "Pharmacy / Formulary"),
    ]),
    ("ahca_quarterly_report", "", "FL", 1, [
        ("Statewide Medicaid managed care enrollment grew 3% this quarter. "
         "Plans processed claims within contractual windows.",
         "Enrollment Statistics"),
        ("Telehealth utilization remains above pre-pandemic baselines across "
         "behavioral health services.", "Utilization Trends"),
    ]),
    ("molina_quick_reference", "molina", "FL", 3, [
        ("Molina Healthcare eligibility verification is available via the "
         "provider portal or by phone. Verify member eligibility before "
         "each visit.", "Eligibility"),
        ("Electronic claims: use payer ID 51062 through your clearinghouse. "
         "EDI enrollment forms are on the provider portal.", "Billing / EDI"),
    ]),
]


def toy_corpus(lexicon: Lexicon | None = None, *, pad_docs: int = 0,
               rng: np.random.Generator | None = None):
    """Build featurized ChunkRecords for the toy corpus (+ optional random
    distractor docs to scale N). Returns list[ChunkRecord]."""
    cfg = get_config()
    recs: list[ChunkRecord] = []
    for doc, payer, state, auth, chunks in _TOY_DOCS:
        texts = [t for t, _ in chunks]
        embs = hash_embed(texts)
        for i, ((text, section), emb) in enumerate(zip(chunks, embs)):
            prev_text = texts[i - 1] if i > 0 else ""
            next_text = texts[i + 1] if i + 1 < len(texts) else ""
            rec = ChunkRecord(
                chunk_id=f"{doc}-c{i}", doc_id=doc, source_id=f"{doc}-s{i}",
                text=text, embedding=emb, payer=payer, state=state,
                program="medicaid" if payer else "",
                authority_level=auth, filename=f"{doc}.pdf",
                section_path=section, page=i + 1,
                neighbor_text=(prev_text + "\n" + next_text).strip(),
            )
            recs.append(featurize_chunk(rec, lexicon, cfg))
    rng = rng or np.random.default_rng(1234)
    for di in range(pad_docs):
        words = rng.choice(
            ["network", "committee", "annual", "review", "budget", "meeting",
             "training", "audit", "survey", "report", "schedule", "update"],
            size=20,
        )
        text = " ".join(words)
        rec = ChunkRecord(
            chunk_id=f"filler{di}-c0", doc_id=f"filler{di}",
            source_id=f"filler{di}-s0", text=text,
            embedding=hash_embed([text])[0],
            filename=f"filler{di}.pdf", authority_level=0,
        )
        recs.append(featurize_chunk(rec, lexicon, cfg))
    return recs


class ScriptedLLM:
    """Test LLM returning the canned response of each stage (``default``
    for a stage without one) and recording the stages it was asked for."""

    def __init__(self, responses: dict[str, str] | None = None,
                 default: str = "UNKNOWN"):
        self.responses = responses or {}
        self.default = default
        self.calls: list[str] = []

    def generate(self, prompt: str, *, system: str = "", max_tokens: int = 1024,
                 temperature: float = 0.0, stage: str = "") -> str:
        self.calls.append(stage)
        return self.responses.get(stage, self.default)


class ScriptedWeb:
    """Test web client serving a url→body map (search returns every url
    whose body shares a query token)."""

    offline = False

    def __init__(self, pages: dict[str, str] | None = None):
        self.pages = pages or {}

    def search(self, query: str, *, max_results: int = 5):
        toks = {t for t in query.lower().split() if len(t) > 3}
        out = [{"url": u, "title": u}
               for u, body in self.pages.items()
               if any(t in body.lower() for t in toks)]
        return out[:max_results]

    def fetch(self, url: str, *, timeout_s: float = 8.0) -> str:
        return self.pages.get(url, "")
