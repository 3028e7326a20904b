"""Chunk featurization: everything the device index needs is precomputed
here, once, at publish time — so query-time scoring is pure device math.

Replaces three reference mechanisms:
- the multi-field weighted tsvector ``search_vec`` (A filename / B summary
  / C paths / D body; migration rebuild_rag_published_fts_multifield.py)
  → hashed-term BM25 weight vector (:func:`build_lexical_weights`);
- Path-B Aho-Corasick lexicon tagging (app/services/policy_path_b.py:335-410)
  → phrase/tag matching over the chunk haystacks (:func:`match_phrases`,
  through the lexicon's Aho-Corasick matcher, ingest/aho.py);
- the reranker's runtime substring haystack scans (corpus_search.py:1909)
  → phrase presence bits over the ENRICHED haystack (body + neighbor text
  + doc metadata), stored per chunk in ``phrase_bits``.
"""
from __future__ import annotations

import math
from collections import Counter

from mobius_rag_tpu_torch.config import Config, get_config
from mobius_rag_tpu_torch.index.store import ChunkRecord
from mobius_rag_tpu_torch.query.lexicon import Lexicon
from mobius_rag_tpu_torch.query.text import (hash_bucket, normalize_query,
                                             tokenize, tokenize_terms)

# Postgres ts_rank weights for labels {D, C, B, A} are {0.1, 0.2, 0.4, 1.0};
# the reference maps filename→A, summary→B, section paths→C, body→D.
FIELD_WEIGHTS = {"filename": 1.0, "summary": 0.4, "section_path": 0.2, "body": 0.1}

# BM25 shape constants. Saturation uses a fixed reference length rather
# than a corpus-wide avgdl so featurization is streaming (no second pass
# over the corpus when documents arrive incrementally).
_K1 = 1.2
_B = 0.75
_REF_LEN = 300.0


def build_lexical_weights(
    *,
    body: str,
    filename: str = "",
    summary: str = "",
    section_path: str = "",
    num_buckets: int | None = None,
) -> dict[int, float]:
    """Field-weighted, tf-saturated term weights hashed into buckets."""
    cfg = get_config()
    h = num_buckets or cfg.lexical_buckets
    out: dict[int, float] = {}
    fields = {
        "filename": filename,
        "summary": summary,
        "section_path": section_path,
        "body": body,
    }
    for field, text in fields.items():
        if not text:
            continue
        toks = tokenize(text)
        if not toks:
            continue
        dl = len(toks)
        norm = _K1 * (1.0 - _B + _B * dl / _REF_LEN)
        fw = FIELD_WEIGHTS[field]
        for term, tf in Counter(toks).items():
            b = hash_bucket(term, h)
            out[b] = out.get(b, 0.0) + fw * (tf * (_K1 + 1.0)) / (tf + norm)
    return out


def match_phrases(haystack: str, lexicon: Lexicon) -> dict[str, list[int]]:
    """Match every lexicon phrase against a haystack (case-insensitive,
    word-boundary) via the native Aho-Corasick automaton. Returns
    {"phrase_ids": [...], "j": [...], "d": [...], "p": [...]} — tag ids
    are the union of tags whose entries matched."""
    phrase_ids = lexicon.matcher.match_set(haystack)
    _, owners = lexicon.phrase_table()
    tags: dict[str, set[int]] = {"j": set(), "d": set(), "p": set()}
    for pid in phrase_ids:
        for kind, tag_id in owners.get(pid, ()):
            tags[kind].add(tag_id)
    return {
        "phrase_ids": sorted(phrase_ids),
        "j": sorted(tags["j"]),
        "d": sorted(tags["d"]),
        "p": sorted(tags["p"]),
    }


def enriched_haystack(rec: ChunkRecord) -> str:
    """Body + neighbor paragraphs + doc-level metadata — the union of the
    reference's _body_haystack (body + neighbors) and _meta_haystack
    (filename/payer/state/section_path/summary), since the v1.3 reranker
    scores presence across body OR meta anyway (corpus_search.py:2006+)."""
    parts = [rec.text, rec.neighbor_text, rec.filename, rec.section_path,
             rec.summary, rec.payer.replace("_", " "), rec.state, rec.program]
    return "\n".join(p for p in parts if p)


def featurize_chunk(rec: ChunkRecord, lexicon: Lexicon | None, cfg: Config | None = None) -> ChunkRecord:
    """Fill the device-signal fields of a ChunkRecord in place:
    lexical_weights (always) and phrase_ids/j/d/p tags (when a lexicon is
    supplied). Tag matching runs over the enriched haystack so chunks in
    an on-topic document inherit context from their neighbors/metadata
    (the v1.2 'hayack-expansion' fix, corpus_search.py:1919-1935)."""
    cfg = cfg or get_config()
    rec.lexical_weights = build_lexical_weights(
        body=rec.text,
        filename=rec.filename,
        summary=rec.summary,
        section_path=rec.section_path,
        num_buckets=cfg.lexical_buckets,
    )
    if lexicon is not None:
        m = match_phrases(enriched_haystack(rec), lexicon)
        rec.phrase_ids = m["phrase_ids"]
        rec.j_tags = sorted(set(rec.j_tags) | set(m["j"]))
        rec.d_tags = sorted(set(rec.d_tags) | set(m["d"]))
        rec.p_tags = sorted(set(rec.p_tags) | set(m["p"]))
    return rec


def query_lexical_weights(
    query: str,
    expansion_phrases: list[str],
    df: "dict[int, int] | None",
    n_docs: int,
    num_buckets: int | None = None,
) -> dict[int, float]:
    """Query-side bucket → weight map: raw tokens OR-joined with expansion
    phrase tokens (the reference's OR-tsquery build,
    corpus_search.py:_build_or_tsquery), each weighted by IDF from the
    corpus document frequencies."""
    cfg = get_config()
    h = num_buckets or cfg.lexical_buckets
    terms: set[str] = set(tokenize_terms(normalize_query(query), drop_stopwords=True))
    for p in expansion_phrases:
        terms.update(tokenize_terms(p, drop_stopwords=True))
    out: dict[int, float] = {}
    nd = max(n_docs, 1)
    dfm = df or {}
    for t in terms:
        b = hash_bucket(t, h)
        dfb = dfm.get(b, 0)
        idf = math.log(1.0 + (nd - dfb + 0.5) / (dfb + 0.5))
        if idf > out.get(b, 0.0):
            out[b] = idf
    return out
