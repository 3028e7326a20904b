"""The slice as a whole: SearchEngine.search of the port against the JAX
engine on the same corpus and the same requests.

Compared: the prepared query arrays, every array of unpack_out key by
key, and the assembled results (chunk ids and their order, confidence
labels, arm traces, strict counts). Tolerances: integers, bitsets and
strict counts exact; floats atol 1e-5 (float32 summation order at
D=256); ids exact except inside runs of values tied within 1e-6; dead
entries (≤ NEG_INF/2) compared as dead, since their order is arbitrary.

Two corpora: toy_corpus(pad_docs=50), and a bench-shaped random corpus
(3,000 rows, 5 authority levels, sampled d-tags) on which nearly every
d-tag candidate ties, pinning the d-tag arm's lower-row-first order."""
import jax
import numpy as np
import pytest
import torch

from mobius_rag_tpu.index.store import ChunkRecord as JRecord, ChunkStore as JStore
from mobius_rag_tpu.ingest.featurize import featurize_chunk as jfeaturize
from mobius_rag_tpu.query.engine import (QueryRequest as JRequest, SearchEngine as JEngine,
                                         _search_compiled, unpack_out as junpack)
from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu_torch.index.store import ChunkRecord as TRecord, ChunkStore as TStore
from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk as tfeaturize
from mobius_rag_tpu_torch.ops.topk import NEG_INF
from mobius_rag_tpu_torch.query.engine import (QueryRequest as TRequest,
                                               SearchEngine as TEngine, pack_out,
                                               search_batch, unpack_out)
from mobius_rag_tpu_torch import testing as ttesting

torch.set_num_threads(1)

ATOL = 1e-5
TIE = 1e-6
K = 5

# (query, request fields): every tag_mode, a known and an unknown payer,
# inherit_authority on and off, the three modes, min_similarity > 0, and
# strict-gated queries on both sides of strict_total >= k.
TOY_REQUESTS = [
    ("What is the timely filing deadline for Sunshine Health FL Medicaid claims?", {}),
    ("timely filing deadline for claims", {"payer": "aetna"}),
    ("timely filing deadline for claims", {"payer": "aetna", "inherit_authority": False}),
    ("statewide enrollment statistics", {"payer": "sunshine_health", "state": "FL"}),
    ("prior authorization behavioral health", {"payer": "no_such_payer"}),
    ("telehealth utilization behavioral health", {"tag_mode": "relaxed"}),
    ("telehealth utilization behavioral health", {"tag_mode": "none"}),
    ("preferred drug list formulary updates", {"mode": "precision"}),
    ("molina eligibility verification", {"mode": "recall", "min_similarity": 0.3}),
    ("durable medical equipment rentals", {"min_similarity": 0.15}),
    ("annual budget meeting review", {"program": "medicaid", "tag_mode": "relaxed"}),
    ("sunshine health claim filing window", {"mode": "recall", "state": "TX"}),
]


def _jq(query, kw, emb=None):
    return JRequest(query=query, embedding=emb, **kw)


def _tq(query, kw, emb=None):
    return TRequest(query=query, embedding=emb, **kw)


def port_q_numpy(q: dict) -> dict:
    out = {}
    for key, t in q.items():
        if t.dtype == torch.bfloat16:
            out[key] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[key] = t.numpy()
    return out


def jax_q_numpy(q: dict) -> dict:
    out = {}
    for key, a in jax.device_get(q).items():
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            a = a.view(np.uint16)
        elif a.dtype == np.uint32:
            a = a.view(np.int32)
        out[key] = a
    return out


def run_both(jengine, tengine, jreqs, treqs):
    jq, _ = jengine.prepare_batch(jreqs)
    tq, _ = tengine.prepare_batch(treqs)
    cfg = tengine.cfg
    jout = junpack(jax.device_get(_search_compiled(
        jengine.store.index, jq, K, cfg.over_fetch, cfg.rrf_k)), K)
    tout = unpack_out(pack_out(search_batch(
        tengine.store.index, tq, K, cfg.over_fetch, cfg.rrf_k)), K)
    return {
        "jq": jax_q_numpy(jq), "tq": port_q_numpy(tq), "jout": jout, "tout": tout,
        "jres": jengine.search(jreqs, k=K), "tres": tengine.search(treqs, k=K),
    }


def assert_topk_equal(vals, idx, want_vals, want_idx):
    live = want_vals > NEG_INF / 2
    assert ((vals > NEG_INF / 2) == live).all()
    np.testing.assert_allclose(vals[live], want_vals[live], rtol=0, atol=ATOL)
    tied = np.abs(np.diff(want_vals, axis=1)) <= TIE
    strict = live.copy()
    strict[:, 1:] &= ~tied
    strict[:, :-1] &= ~tied
    np.testing.assert_array_equal(idx[strict], want_idx[strict])


# value key that orders each id key
_ID_KEYS = {"idx": "rerank", "vec_idx": "vec_vals", "lex_idx": "lex_vals",
            "dtag_idx": "dtag_vals"}
_FLOAT_KEYS = ["rerank", "sim", "cos", "auth", "len", "jpd", "cov", "rrf", "lexn",
               "vec_vals", "lex_vals", "dtag_vals"]
OUT_KEYS = _FLOAT_KEYS + list(_ID_KEYS) + ["strict_count"]
Q_KEYS = ["vec", "payer", "state", "program", "j_bits", "d_bits", "p_bits", "min_sim",
          "inherit_authority", "tag_mode", "arm_weights", "slot_word", "slot_bit",
          "slot_jword", "slot_jbit", "slot_isj", "slot_weight", "d_tag_ids", "lex"]


def check_out_key(run, key):
    jout, tout = run["jout"], run["tout"]
    if key == "strict_count":
        np.testing.assert_array_equal(tout[key], jout[key])
    elif key in _ID_KEYS:
        v = _ID_KEYS[key]
        assert_topk_equal(tout[v], tout[key], jout[v], jout[key])
    else:
        assert tout[key].shape == jout[key].shape
        live = jout["rerank"] > NEG_INF / 2 if key not in ("vec_vals", "lex_vals",
                                                           "dtag_vals") \
            else jout[key] > NEG_INF / 2
        if key in ("vec_vals", "lex_vals", "dtag_vals"):
            assert ((tout[key] > NEG_INF / 2) == live).all()
        np.testing.assert_allclose(tout[key][live], jout[key][live], rtol=0, atol=ATOL)


def check_q_key(run, key):
    jq, tq = run["jq"], run["tq"]
    if key == "lex":
        # the JAX engine pads the bucket union to a compile bucket (128,
        # 512, 2048) with bucket 0 at weight 0; the port ships it exact
        u = len(tq["lex_buckets"])
        np.testing.assert_array_equal(tq["lex_buckets"], jq["lex_buckets"][:u])
        np.testing.assert_array_equal(tq["lex_weights"], jq["lex_weights"][:, :u])
        assert not jq["lex_weights"][:, u:].any()
    else:
        assert tq[key].dtype == jq[key].dtype, key
        np.testing.assert_array_equal(tq[key], jq[key])


def check_results(jres, tres, i):
    a, b = jres[i], tres[i]
    assert [h.chunk_id for h in b.hits] == [h.chunk_id for h in a.hits]
    assert b.confidence_label == a.confidence_label
    np.testing.assert_allclose([h.score for h in b.hits], [h.score for h in a.hits],
                               rtol=0, atol=ATOL)
    assert [[n["chunk_id"] for n in h.neighbors] for h in b.hits] == \
        [[n["chunk_id"] for n in h.neighbors] for h in a.hits]
    assert b.telemetry["strict_count"] == a.telemetry["strict_count"]
    assert b.expansion.matched_codes == a.expansion.matched_codes
    for arm in ("vector", "lexical", "dtag"):
        ta, tb = a.telemetry["arms"][arm], b.telemetry["arms"][arm]
        assert len(tb) == len(ta)
        np.testing.assert_allclose([t["score"] for t in tb], [t["score"] for t in ta],
                                   rtol=0, atol=ATOL)
        sa = np.array([t["score"] for t in ta])
        tied = np.zeros(len(sa), bool)
        if len(sa) > 1:
            d = np.abs(np.diff(sa)) <= TIE
            tied[1:] |= d
            tied[:-1] |= d
        for t_a, t_b, t in zip(ta, tb, tied):
            assert t or t_a["row"] == t_b["row"], arm


# ---------------------------------------------------------------------------
# toy corpus
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy():
    jlex, tlex = jtesting.sample_lexicon(), ttesting.sample_lexicon()
    js, ts = JStore(), TStore(device="cpu")
    js.add_chunks(jtesting.toy_corpus(jlex, pad_docs=50))
    ts.add_chunks(ttesting.toy_corpus(tlex, pad_docs=50))
    je = JEngine(js, jlex, embed_fn=jtesting.hash_embed)
    te = TEngine(ts, tlex, embed_fn=ttesting.hash_embed, device="cpu")
    run = run_both(je, te, [_jq(q, kw) for q, kw in TOY_REQUESTS],
                   [_tq(q, kw) for q, kw in TOY_REQUESTS])
    run["engines"] = (je, te)
    return run


@pytest.mark.parametrize("key", Q_KEYS)
def test_toy_prepared_batch(toy, key):
    check_q_key(toy, key)


@pytest.mark.parametrize("key", OUT_KEYS)
def test_toy_outputs(toy, key):
    check_out_key(toy, key)


@pytest.mark.parametrize("i", range(len(TOY_REQUESTS)))
def test_toy_results(toy, i):
    check_results(toy["jres"], toy["tres"], i)


def test_toy_batch_covers_the_cases(toy):
    counts = toy["tout"]["strict_count"]
    strict_rows = [i for i, (_, kw) in enumerate(TOY_REQUESTS)
                   if kw.get("tag_mode", "strict") == "strict"]
    assert any(counts[i] >= K for i in strict_rows)  # strict branch
    assert any(counts[i] < K for i in strict_rows)  # auto-relaxed branch
    assert toy["tq"]["payer"].tolist().count(-2) == 1  # the unknown payer
    assert all(r.hits for r in toy["tres"][:2])


def test_toy_pipelined_equals_search(toy):
    _, te = toy["engines"]
    reqs = [_tq(q, kw) for q, kw in TOY_REQUESTS]
    piped = te.search_pipelined([reqs[:6], reqs[6:]], k=K)
    flat = [r for batch in piped for r in batch]
    assert [[h.chunk_id for h in r.hits] for r in flat] == \
        [[h.chunk_id for h in r.hits] for r in toy["tres"]]
    assert all(r.telemetry["timings_ms"] == {} for r in flat)


# ---------------------------------------------------------------------------
# bench-shaped random corpus: ties everywhere in the d-tag arm
# ---------------------------------------------------------------------------

N_RANDOM = 3000


def _random_store(store_cls, rec_cls, featurize, lexicon, cfg_dim, h):
    rng = np.random.default_rng(7)
    vectors = rng.standard_normal((N_RANDOM, cfg_dim)).astype(np.float32)
    vectors /= np.linalg.norm(vectors, axis=1, keepdims=True)
    payers = ["sunshine_health", "aetna", "molina", ""]
    recs = []
    for i in range(N_RANDOM):
        r = rec_cls(chunk_id=f"c{i}", doc_id=f"doc{i % 300}", source_id=f"s{i}",
                    text=f"policy paragraph {i} covering claims filing and "
                         f"authorization requirements for plan {i % 97}.",
                    embedding=vectors[i], payer=payers[i % 4], state="FL",
                    authority_level=int(rng.integers(0, 5)), filename=f"doc{i % 300}.pdf")
        r.d_tags = [int(rng.integers(0, 12))]
        recs.append(r)
    for r in recs[:64]:
        featurize(r, lexicon)
    lex = np.zeros((64, h), np.float32)
    for i, r in enumerate(recs[:64]):
        for b, w in r.lexical_weights.items():
            lex[i, b % h] += w
    kw = {"device": "cpu"} if store_cls is TStore else {}
    store = store_cls(**kw)
    store.bulk_load(recs, vectors=vectors, lexical=lex)
    return store, vectors, rng


@pytest.fixture(scope="module")
def bench():
    jlex, tlex = jtesting.sample_lexicon(), ttesting.sample_lexicon()
    from mobius_rag_tpu_torch.config import get_config

    cfg = get_config()
    js, vectors, rng = _random_store(JStore, JRecord, jfeaturize, jlex,
                                     cfg.embed_dim, cfg.lexical_buckets)
    ts, _, _ = _random_store(TStore, TRecord, tfeaturize, tlex,
                             cfg.embed_dim, cfg.lexical_buckets)
    q = vectors[rng.choice(N_RANDOM, 16, replace=False)]
    q = q + 0.15 * rng.standard_normal(q.shape).astype(np.float32)
    payers = ["sunshine_health", "aetna", "molina"]
    specs = [(f"timely filing deadline for {payers[i % 3]} claims", {}) for i in range(8)]
    specs += [("claims filing authorization requirements",
               {"tag_mode": "none", "mode": "recall"})] * 4
    specs += [("prior authorization for durable medical equipment", {"payer": "aetna"}),
              ("behavioral health telehealth", {"tag_mode": "relaxed"}),
              ("claims timely filing", {"inherit_authority": False, "payer": "molina"}),
              ("pharmacy formulary", {"mode": "precision"})]
    run = run_both(JEngine(js, jlex), TEngine(ts, tlex, device="cpu"),
                   [_jq(s, kw, q[i]) for i, (s, kw) in enumerate(specs)],
                   [_tq(s, kw, q[i]) for i, (s, kw) in enumerate(specs)])
    return run


@pytest.mark.parametrize("key", OUT_KEYS)
def test_bench_outputs(bench, key):
    check_out_key(bench, key)


def test_bench_dtag_tie_order_exact(bench):
    jout, tout = bench["jout"], bench["tout"]
    vals = jout["dtag_vals"]
    live = vals > NEG_INF / 2
    # nearly every live d-tag score ties with its neighbour...
    assert (np.diff(vals, axis=1)[live[:, 1:]] == 0).mean() > 0.8
    # ...and the rows still agree exactly: lower row first, as lax.top_k
    np.testing.assert_array_equal(tout["dtag_idx"][live], jout["dtag_idx"][live])
    np.testing.assert_array_equal(tout["dtag_vals"][live], vals[live])


@pytest.mark.parametrize("i", range(16))
def test_bench_results(bench, i):
    check_results(bench["jres"], bench["tres"], i)


@pytest.mark.parametrize("kw", [{"sharded": "grid"},
                                {"sharded": "grid", "vector_backend": "ivf"}])
def test_unported_engine_options_raise(toy, kw):
    """``sharded=`` (once refused, now served): a ShardedEngine over four
    CPU shards attached to an engine over the same store gives the dense
    engine's hits; a backend given to the engine propagates into it."""
    from mobius_rag_tpu_torch.parallel import ShardedEngine, make_mesh

    _, te = toy["engines"]
    se = ShardedEngine(te.store, mesh=make_mesh(4, devices=["cpu"] * 4))
    kw = dict(kw, sharded=se)
    engine = TEngine(te.store, te.lexicon, embed_fn=ttesting.hash_embed, device="cpu", **kw)
    reqs = [_tq(q, k) for q, k in TOY_REQUESTS]
    got = engine.search(reqs, k=K)
    assert se.vector_backend == kw.get("vector_backend", "exact")
    if "vector_backend" in kw:
        assert se._ann is not None and any(r.hits for r in got)
    else:
        for a, b in zip(toy["tres"], got):
            assert [h.chunk_id for h in b.hits] == [h.chunk_id for h in a.hits]
            np.testing.assert_allclose([h.score for h in b.hits],
                                       [h.score for h in a.hits], rtol=0, atol=ATOL)
    with pytest.raises(ValueError, match="store"):
        TEngine(TStore(device="cpu"), te.lexicon, device="cpu", sharded=se)


def test_cross_encoder_raises(toy):
    """The cross-encoder stage takes a callable model (or None) and raises
    on anything else."""
    _, te = toy["engines"]
    te.cross_encoder = None
    with pytest.raises(TypeError, match="model"):
        te.cross_encoder = object()
    assert te.cross_encoder is None


# ---------------------------------------------------------------------------
# bit 31: an int32 word with its top bit set is negative
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def bit31():
    from mobius_rag_tpu.query.lexicon import Lexicon as JLexicon, LexiconEntry as JEntry
    from mobius_rag_tpu_torch.query.lexicon import Lexicon as TLexicon, LexiconEntry as TEntry

    entries = [("j", "payor.topbit", ["topbit health"], 31),
               ("d", "claims.topbit", ["topbit filing"], 31),
               ("d", "claims.wordtwo", ["second word filing"], 63)]
    runs = []
    for lex_cls, entry_cls, store_cls, rec_cls in (
            (JLexicon, JEntry, JStore, JRecord), (TLexicon, TEntry, TStore, TRecord)):
        lex = lex_cls([entry_cls(kind=k, code=c, phrases=p, tag_id=t)
                       for k, c, p, t in entries])
        rng = np.random.default_rng(11)
        recs = [rec_cls(chunk_id=f"b{i}", doc_id=f"bd{i}", text=f"row {i}",
                        embedding=rng.standard_normal(256).astype(np.float32),
                        authority_level=i % 5,
                        j_tags=[31] if i % 3 == 0 else [],
                        d_tags=[31] if i % 2 == 0 else ([63] if i % 5 == 0 else []))
                for i in range(40)]
        store = store_cls(device="cpu") if store_cls is TStore else store_cls()
        store.add_chunks(recs)
        runs.append((store, lex, rng.standard_normal((3, 256)).astype(np.float32)))
    (js, jlex, q), (ts, tlex, _) = runs
    texts = ["topbit health topbit filing", "second word filing", "topbit filing"]
    return run_both(JEngine(js, jlex), TEngine(ts, tlex, device="cpu"),
                    [_jq(t, {}, q[i]) for i, t in enumerate(texts)],
                    [_tq(t, {}, q[i]) for i, t in enumerate(texts)])


@pytest.mark.parametrize("key", OUT_KEYS)
def test_bit31_outputs(bit31, key):
    assert (bit31["tq"]["d_bits"][:, 0] < 0).any()  # the top bit is in use
    assert (bit31["tout"]["dtag_vals"] > NEG_INF / 2).any()
    check_out_key(bit31, key)
