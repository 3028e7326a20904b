"""Host-side text, lexicon and featurization parity: the port against the
JAX package on the same inputs (all exact: these are strings, ids and
host floats computed by the same code)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch
import yaml

from mobius_rag_tpu.ingest import featurize as jfeat
from mobius_rag_tpu.query import text as jtext
from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu_torch.ingest import featurize as tfeat
from mobius_rag_tpu_torch.ingest.aho import AhoCorasick
from mobius_rag_tpu_torch.query import text as ttext
from mobius_rag_tpu_torch.query.lexicon import Lexicon
from mobius_rag_tpu_torch import testing as ttesting

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXTS = [
    "What is the timely filing deadline for Sunshine Health FL Medicaid claims?",
    "Does Sunshine Health require prior authorization for residential "
    "substance use treatment under code H0019?",
    "Durable medical equipment (DME) rentals — capped at purchase price.",
    "how many days do providers have to submit corrected claims",
    "Molina Healthcare eligibility verification via the provider portal",
    "Telehealth utilization remains above pre-pandemic baselines",
    "", "   ", "ABH formulary exceptions & coverage determinations 2024",
]

QUERIES = TEXTS[:7] + [
    "sunshine health claim filing window",
    "aetna better health florida prior auth for behavioral health",
    "preferred drug list formulary updates",
    "florida medicaid nemt transportation",
    "provider services coverage",
]


@pytest.fixture(scope="module")
def lexicons():
    return jtesting.sample_lexicon(), ttesting.sample_lexicon()


@pytest.mark.parametrize("name", ["lexicon_sample", "lexicon_full"])
def test_json_lexicon_equals_yaml(name):
    with open(os.path.join(REPO, "mobius_rag_tpu", "data", f"{name}.yaml")) as f:
        want = yaml.safe_load(f)
    with open(os.path.join(REPO, "mobius_rag_tpu_torch", "data", f"{name}.json")) as f:
        got = json.load(f)
    assert got == want


@pytest.mark.parametrize("text", TEXTS)
def test_tokenize_and_hash_agree(text):
    for kw in ({}, {"stemmed": False}, {"drop_stopwords": True}):
        assert ttext.tokenize(text, **kw) == jtext.tokenize(text, **kw)
    assert ttext.normalize_query(text) == jtext.normalize_query(text)
    for tok in jtext.tokenize(text):
        for h in (2048, 16384):
            assert ttext.hash_bucket(tok, h) == jtext.hash_bucket(tok, h)


@pytest.mark.parametrize("query", QUERIES)
def test_expand_agrees(lexicons, query):
    jlex, tlex = lexicons
    a, b = jlex.expand(query), tlex.expand(query)
    assert b.matched_codes == a.matched_codes
    assert b.phrase_slots == a.phrase_slots
    assert b.tag_ids == a.tag_ids
    assert b.expansion_phrases == a.expansion_phrases


def test_full_lexicon_expand_agrees():
    from mobius_rag_tpu.query.lexicon import Lexicon as JLexicon

    jlex = JLexicon.from_yaml(os.path.join(REPO, "mobius_rag_tpu", "data",
                                           "lexicon_full.yaml"))
    tlex = Lexicon.from_json(os.path.join(REPO, "mobius_rag_tpu_torch", "data",
                                          "lexicon_full.json"))
    assert tlex.phrase_ids == jlex.phrase_ids
    for q in QUERIES:
        a, b = jlex.expand(q), tlex.expand(q)
        assert (b.matched_codes, b.phrase_slots, b.tag_ids) == \
            (a.matched_codes, a.phrase_slots, a.tag_ids)


def test_native_aho_matches_python_automaton(lexicons):
    _, tlex = lexicons
    ordered, _ = tlex.phrase_table()
    native = AhoCorasick(ordered)
    assert native.is_native  # built from cpp/ahocorasick.cc with g++
    py = AhoCorasick.__new__(AhoCorasick)
    py.patterns, py.word_boundary, py._native = native.patterns, True, False
    py._build_python()
    for text in TEXTS + QUERIES:
        assert native.match_set(text) == py.match_set(text)
        assert native.match_positions(text) == py.match_positions(text)


@pytest.fixture(scope="module")
def toy_records(lexicons):
    jlex, tlex = lexicons
    return jtesting.toy_corpus(jlex, pad_docs=10), ttesting.toy_corpus(tlex, pad_docs=10)


def test_toy_corpus_records_agree(toy_records):
    jrecs, trecs = toy_records
    assert len(jrecs) == len(trecs)
    for a, b in zip(jrecs, trecs):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        np.testing.assert_array_equal(db.pop("embedding"), da.pop("embedding"))
        assert db == da


@pytest.mark.parametrize("i", range(10))
def test_match_phrases_agree(lexicons, toy_records, i):
    jlex, tlex = lexicons
    rec = toy_records[1][i]
    hay = tfeat.enriched_haystack(rec)
    assert hay == jfeat.enriched_haystack(toy_records[0][i])
    assert tfeat.match_phrases(hay, tlex) == jfeat.match_phrases(hay, jlex)


@pytest.mark.parametrize("query", QUERIES[:6])
def test_query_lexical_weights_agree(lexicons, query):
    jlex, _ = lexicons
    phrases = jlex.expand(query).expansion_phrases
    df = {5: 3, 17: 40, 1000: 1}
    assert tfeat.query_lexical_weights(query, phrases, df, 100, 2048) == \
        jfeat.query_lexical_weights(query, phrases, df, 100, 2048)
