"""The port's multi-slice merge (parallel/slices.py) against the JAX
package's: tests/test_slices.py's cases, and the two packages' merges of
twin per-slice results. Tolerances: chunk ids and labels equal, scores
within 1e-6 (the merge moves scores, it computes none)."""
import numpy as np
import pytest
import torch

from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu.index.store import ChunkStore as JStore
from mobius_rag_tpu.parallel.slices import merge_slice_results as jmerge
from mobius_rag_tpu.query.engine import QueryRequest as JRequest, SearchEngine as JEngine
from mobius_rag_tpu_torch import testing as ttesting
from mobius_rag_tpu_torch.index.store import ChunkStore as TStore
from mobius_rag_tpu_torch.parallel.slices import merge_slice_results
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine

torch.set_num_threads(1)

TEXTS = ("timely filing deadline for sunshine health claims",
         "prior authorization durable medical equipment",
         "molina eligibility verification")


def _port_engines():
    lex = ttesting.sample_lexicon()
    recs = ttesting.toy_corpus(lex, pad_docs=60)
    mid = len(recs) // 2
    parts = []
    for rs in (recs[:mid], recs[mid:]):
        st = TStore(device="cpu")
        st.add_chunks(rs)
        parts.append(SearchEngine(st, lex, embed_fn=ttesting.hash_embed, device="cpu"))
    full = TStore(device="cpu")
    full.add_chunks(recs)
    return parts, SearchEngine(full, lex, embed_fn=ttesting.hash_embed, device="cpu")


def _jax_engines():
    lex = jtesting.sample_lexicon()
    recs = jtesting.toy_corpus(lex, pad_docs=60)
    mid = len(recs) // 2
    parts = []
    for rs in (recs[:mid], recs[mid:]):
        st = JStore()
        st.add_chunks(rs)
        parts.append(JEngine(st, lex, embed_fn=jtesting.hash_embed))
    return parts


@pytest.fixture(scope="module")
def engines():
    return _port_engines(), _jax_engines()


def _queries(cls, embed):
    return [cls(query="", tag_mode="none", embedding=embed([t])[0]) for t in TEXTS]


def test_hierarchical_merge_matches_full_engine(engines):
    """Embedding-only queries: every score is slice-independent, so the
    merge of two half-corpus engines is the whole-corpus engine."""
    (parts, full), _ = engines
    qs = _queries(QueryRequest, ttesting.hash_embed)
    merged = merge_slice_results([e.search(qs, k=5) for e in parts], k=5)
    for m, w in zip(merged, full.search(qs, k=5)):
        assert [h.chunk_id for h in m.hits] == [h.chunk_id for h in w.hits]
        np.testing.assert_allclose([h.score for h in m.hits], [h.score for h in w.hits],
                                   atol=1e-6)
        assert m.telemetry["multi_slice"]["slices"] == 2
        assert "arms" not in m.telemetry


@pytest.mark.parametrize("kind", ["embedding", "text"])
def test_merge_matches_jax(engines, kind):
    """The two packages' merges of their twin per-slice results agree."""
    (parts, _), jparts = engines
    if kind == "embedding":
        tq, jq = _queries(QueryRequest, ttesting.hash_embed), _queries(JRequest,
                                                                      jtesting.hash_embed)
    else:
        tq = [QueryRequest(query=t) for t in TEXTS]
        jq = [JRequest(query=t) for t in TEXTS]
    got = merge_slice_results([e.search(tq, k=5) for e in parts], k=5)
    want = jmerge([e.search(jq, k=5) for e in jparts], k=5)
    for g, w in zip(got, want):
        assert [h.chunk_id for h in g.hits] == [h.chunk_id for h in w.hits]
        np.testing.assert_allclose([h.score for h in g.hits], [h.score for h in w.hits],
                                   atol=1e-6)
        assert g.confidence_label == w.confidence_label
        assert g.telemetry["multi_slice"] == w.telemetry["multi_slice"]


def test_merge_dedupes_caps_and_checks(engines):
    (parts, _), _ = engines
    q = QueryRequest(query="", tag_mode="none", embedding=ttesting.hash_embed(["claims"])[0])
    a = parts[0].search([q], k=5)
    merged = merge_slice_results([a, a], k=5)  # the same slice twice: duplicates
    ids = [h.chunk_id for h in merged[0].hits]
    assert len(ids) == len(set(ids)) <= 5
    assert merge_slice_results([], k=5) == []
    with pytest.raises(ValueError, match="ragged"):
        merge_slice_results([a, a + a], k=5)
