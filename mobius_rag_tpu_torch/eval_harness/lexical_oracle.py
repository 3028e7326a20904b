"""Exact host-side BM25 oracle (the port of
``mobius_rag_tpu.eval_harness.lexical_oracle``).

The lexical-arm parity reference (SURVEY §7 phase 0: 'host-side exact
BM25'): classic BM25 over unhashed stemmed terms with the same field
weights and saturation constants the device arm uses — but exact term
identity (no feature-hash collisions) and per-corpus average document
length. Used by tests/benchmarks to bound what hashing + the fixed
reference length cost in ranking fidelity."""
from __future__ import annotations

import math
from collections import Counter

from mobius_rag_tpu_torch.index.store import ChunkStore
from mobius_rag_tpu_torch.ingest.featurize import _B, _K1, FIELD_WEIGHTS
from mobius_rag_tpu_torch.query.text import normalize_query, tokenize


class BM25Oracle:
    def __init__(self, store: ChunkStore):
        self.rows: list[int] = []
        self.doc_terms: list[dict[str, float]] = []  # field-weighted tf-sat
        self.df: Counter = Counter()
        lens = []
        docs_raw = []
        for i, rec in enumerate(store.records):
            if rec is None:
                continue
            fields = {"filename": rec.filename, "summary": rec.summary,
                      "section_path": rec.section_path, "body": rec.text}
            toks_by_field = {f: tokenize(t) for f, t in fields.items() if t}
            docs_raw.append((i, toks_by_field))
            lens.append(sum(len(t) for t in toks_by_field.values()))
            for term in {t for toks in toks_by_field.values() for t in toks}:
                self.df[term] += 1
        self.n = len(docs_raw)
        self.avgdl = (sum(lens) / len(lens)) if lens else 1.0
        for i, toks_by_field in docs_raw:
            self.rows.append(i)
            weights: dict[str, float] = {}
            for field, toks in toks_by_field.items():
                dl = len(toks)
                norm = _K1 * (1.0 - _B + _B * dl / self.avgdl)
                fw = FIELD_WEIGHTS[field]
                for term, tf in Counter(toks).items():
                    weights[term] = weights.get(term, 0.0) + \
                        fw * (tf * (_K1 + 1.0)) / (tf + norm)
            self.doc_terms.append(weights)

    def idf(self, term: str) -> float:
        dfv = self.df.get(term, 0)
        return math.log(1.0 + (self.n - dfv + 0.5) / (dfv + 0.5))

    def search(self, query: str, expansion_phrases: list[str] = (),
               k: int = 10) -> list[tuple[int, float]]:
        """→ [(store row, score)] descending; zero-score rows excluded."""
        terms: set[str] = set(tokenize(normalize_query(query), drop_stopwords=True))
        for p in expansion_phrases:
            terms.update(tokenize(p, drop_stopwords=True))
        scored = []
        for row, weights in zip(self.rows, self.doc_terms):
            s = sum(self.idf(t) * weights[t] for t in terms if t in weights)
            if s > 0:
                scored.append((row, s))
        scored.sort(key=lambda x: -x[1])
        return scored[:k]
