"""The sparse lexical layout of the port (MRAG_LEXICAL_FORMAT=sparse:
postings [H, P] grown by doubling, pruned by impact at the cap, scrubbed
on recycling, repacked by compaction) against the JAX package: the host
postings mirrors equal the JAX store's exactly after the same writes,
snapshots restore both ways, and sparse ≡ dense end to end. Also the
store's mutation listeners, which the engine's ANN maintenance reads.

Tolerances: mirrors, fills and listener events exact; lexical scores
within 1e-5 of the JAX package's (the port sums each row's postings in
float64, the JAX package in float32); search hits equal, rerank scores
within 1e-4 (as tests/test_sparse_lexical.py)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu.config import Config as JConfig
from mobius_rag_tpu.index.store import ChunkStore as JStore
from mobius_rag_tpu.query.engine import lexical_raw as jlexical_raw
from mobius_rag_tpu_torch import testing as ttesting
from mobius_rag_tpu_torch.config import get_config
from mobius_rag_tpu_torch.index.store import ChunkStore as TStore, index_from_numpy
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine, lexical_raw

torch.set_num_threads(1)


def _tcfg(**kw):
    return dataclasses.replace(get_config(), **kw)


def _jcfg(**kw):
    return dataclasses.replace(JConfig(), **kw)


def _tstore(**kw):
    return TStore(_tcfg(lexical_format="sparse", **kw), device="cpu")


def _jstore(**kw):
    return JStore(_jcfg(lexical_format="sparse", **kw))


def _bf16(x):
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


def _assert_mirrors_equal(ts, js, restored=False):
    """Host mirrors and device arrays equal. A restored store's weight
    mirror holds the bf16 values the snapshot kept (in both packages)."""
    np.testing.assert_array_equal(ts._lex_cols_np, js._lex_cols_np)
    if restored:
        np.testing.assert_array_equal(_bf16(ts._lex_wts_np), _bf16(js._lex_wts_np))
    else:
        np.testing.assert_array_equal(ts._lex_wts_np, js._lex_wts_np)
    np.testing.assert_array_equal(ts._lex_fill, js._lex_fill)
    np.testing.assert_array_equal(ts.index.lex_cols.numpy(), np.asarray(js.index.lex_cols))
    np.testing.assert_array_equal(ts.index.lex_wts.view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(js.index.lex_wts).view(np.uint16))


def _engine(store, lex):
    return SearchEngine(store, lex, cfg=store.cfg, embed_fn=ttesting.hash_embed, device="cpu")


QUERIES = ("timely filing deadline for sunshine health",
           "prior authorization for H0019",
           "molina payer id for electronic claims")


def test_sparse_matches_dense_end_to_end():
    lex = ttesting.sample_lexicon()
    dense = TStore(_tcfg(lexical_format="dense"), device="cpu")
    dense.add_chunks(ttesting.toy_corpus(lex))
    sparse = _tstore(lexical_postings_init=8)
    sparse.add_chunks(ttesting.toy_corpus(lex))
    jlex = jtesting.sample_lexicon()
    js = _jstore(lexical_postings_init=8)
    js.add_chunks(jtesting.toy_corpus(jlex))
    from mobius_rag_tpu.query.engine import QueryRequest as JRequest, SearchEngine as JEngine

    je = JEngine(js, jlex, cfg=js.cfg, embed_fn=jtesting.hash_embed)
    e_dense, e_sparse = _engine(dense, lex), _engine(sparse, lex)
    for q in QUERIES:
        rd = e_dense.search(QueryRequest(query=q), k=5)[0]
        rs = e_sparse.search(QueryRequest(query=q), k=5)[0]
        rj = je.search(JRequest(query=q), k=5)[0]
        assert rs.hits
        for other in (rd, rj):
            assert [h.chunk_id for h in rs.hits] == [h.chunk_id for h in other.hits]
            for a, b in zip(rs.hits, other.hits):
                assert a.score == pytest.approx(b.score, abs=1e-4)
            assert [t["row"] for t in rs.telemetry["arms"]["lexical"][:5]] == \
                [t["row"] for t in other.telemetry["arms"]["lexical"][:5]]


def _same_bucket_records(base, n, heavier=False):
    recs = []
    for i in range(n):
        r = dataclasses.replace(base, chunk_id=f"c{i}", doc_id=f"d{i}",
                                embedding=np.ones_like(base.embedding) * (i + 1))
        if heavier:  # strictly increasing weights: the survivors are the last rows
            r.lexical_weights = {b: w + i for b, w in base.lexical_weights.items()}
        recs.append(r)
    return recs


@pytest.mark.parametrize("init,cap,heavier,n", [(8, 8192, False, 30), (8, 8, True, 20),
                                                (8, 16, False, 40)])
def test_postings_grow_and_prune_like_jax(init, cap, heavier, n):
    """Overflow doubles P; at the cap the heaviest postings stay (ties to
    the earlier posting). The port's mirrors equal the JAX store's."""
    tbase = ttesting.toy_corpus(ttesting.sample_lexicon())[0]
    jbase = jtesting.toy_corpus(jtesting.sample_lexicon())[0]
    ts = _tstore(lexical_postings_init=init, lexical_postings_max=cap)
    js = _jstore(lexical_postings_init=init, lexical_postings_max=cap)
    ts.add_chunks(_same_bucket_records(tbase, n, heavier))
    js.add_chunks(_same_bucket_records(jbase, n, heavier))
    _assert_mirrors_equal(ts, js)
    bucket = next(iter(tbase.lexical_weights)) % ts.cfg.lexical_buckets
    assert ts._lex_cols_np.shape[1] == min(cap, max(init, 1 << (n - 1).bit_length()))
    if heavier and cap == 8:
        assert set(ts._lex_cols_np[bucket].tolist()) == set(range(n - 8, n))
    else:
        assert int(ts._lex_fill[bucket]) == min(n, cap)


def test_delete_recycle_and_compaction_like_jax():
    """Deleted rows stay in the postings (masked by valid) until their row
    is recycled, which scrubs them; compaction repacks a bucket."""
    tlex, jlex = ttesting.sample_lexicon(), jtesting.sample_lexicon()
    ts, js = _tstore(lexical_postings_init=8), _jstore(lexical_postings_init=8)
    trecs, jrecs = ttesting.toy_corpus(tlex), jtesting.toy_corpus(jlex)
    ts.add_chunks(trecs)
    js.add_chunks(jrecs)
    doc = trecs[0].doc_id
    ts.delete_by_document(doc)
    js.delete_by_document(doc)
    res = _engine(ts, tlex).search(QueryRequest(query="timely filing deadline"), k=10)[0]
    assert res.hits and all(h.doc_id != doc for h in res.hits)
    _assert_mirrors_equal(ts, js)
    bucket = next(iter(trecs[0].lexical_weights)) % ts.cfg.lexical_buckets
    ts._sparse_compact(bucket)
    js._sparse_compact(bucket)
    dead = {r for r, rec in enumerate(ts.records) if rec is None}
    live_cols = ts._lex_cols_np[bucket][ts._lex_cols_np[bucket] >= 0]
    assert not dead.intersection(live_cols.tolist())
    np.testing.assert_array_equal(ts._lex_cols_np, js._lex_cols_np)
    # recycling the freed rows scrubs whatever still names them
    ts.add_chunks(ttesting.toy_corpus(tlex)[3:5])
    js.add_chunks(jtesting.toy_corpus(jlex)[3:5])
    _assert_mirrors_equal(ts, js)


def test_lexical_raw_sparse_matches_jax():
    """The scatter-add over the postings, on the JAX store's arrays and the
    JAX engine's prepared weights carried across."""
    jlex = jtesting.sample_lexicon()
    js = _jstore(lexical_postings_init=8)
    js.add_chunks(jtesting.toy_corpus(jlex, pad_docs=40))
    from mobius_rag_tpu.query.engine import QueryRequest as JRequest, SearchEngine as JEngine

    je = JEngine(js, jlex, cfg=js.cfg, embed_fn=jtesting.hash_embed)
    jq, _ = je.prepare_batch([JRequest(query=q) for q in QUERIES])
    want = np.asarray(jlexical_raw(js.index, jq))
    host = jax.device_get(js.index)
    tix = index_from_numpy({f: np.asarray(getattr(host, f)) for f in host.fields}, "cpu")
    tq = {"lex_buckets": torch.from_numpy(np.array(jq["lex_buckets"])),
          "lex_weights": torch.from_numpy(np.array(jq["lex_weights"]))}
    got = lexical_raw(tix, tq).numpy()
    assert (want > 0).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got > 0, want > 0)


@pytest.mark.parametrize("direction", ["port_to_port", "jax_to_port", "port_to_jax"])
def test_snapshot_roundtrip(tmp_path, direction):
    tlex, jlex = ttesting.sample_lexicon(), jtesting.sample_lexicon()
    path = str(tmp_path / "snap")
    ts = _tstore(lexical_postings_init=8)
    ts.add_chunks(ttesting.toy_corpus(tlex))
    js = _jstore(lexical_postings_init=8)
    js.add_chunks(jtesting.toy_corpus(jlex))
    query = QueryRequest(query="prior authorization H0019")
    before = _engine(ts, tlex).search(query, k=5)[0]
    if direction == "port_to_jax":
        ts.snapshot(path)
        restored = JStore.restore(path, js.cfg)
        _assert_mirrors_equal(ts, restored, restored=True)
        return
    (js if direction == "jax_to_port" else ts).snapshot(path)
    restored = TStore.restore(path, ts.cfg, device="cpu")
    _assert_mirrors_equal(restored, js, restored=True)
    after = _engine(restored, tlex).search(query, k=5)[0]
    assert [h.chunk_id for h in before.hits] == [h.chunk_id for h in after.hits]


def test_snapshot_format_mismatch_rejected(tmp_path):
    ts = _tstore()
    ts.add_chunks(ttesting.toy_corpus(ttesting.sample_lexicon()))
    path = str(tmp_path / "snap")
    ts.snapshot(path)
    with pytest.raises(ValueError, match="lexical_format"):
        TStore.restore(path, _tcfg(lexical_format="dense"), device="cpu")


@pytest.mark.parametrize("with_array", [False, True])
def test_bulk_load_sparse_matches_incremental_and_jax(with_array):
    tlex, jlex = ttesting.sample_lexicon(), jtesting.sample_lexicon()
    inc = _tstore(lexical_postings_init=8)
    inc.add_chunks(ttesting.toy_corpus(tlex))
    bulk = _tstore(lexical_postings_init=8)
    jbulk = _jstore(lexical_postings_init=8)
    trecs, jrecs = ttesting.toy_corpus(tlex), jtesting.toy_corpus(jlex)
    kw, jkw = {}, {}
    if with_array:
        h = bulk.cfg.lexical_buckets
        lex = np.zeros((len(trecs), h), np.float32)
        for i, r in enumerate(trecs):
            for b, w in r.lexical_weights.items():
                lex[i, b % h] += w
        kw, jkw = {"lexical": lex}, {"lexical": lex}
    bulk.bulk_load(trecs, **kw)
    jbulk.bulk_load(jrecs, **jkw)
    _assert_mirrors_equal(bulk, jbulk)
    q = QueryRequest(query="timely filing deadline for sunshine health")
    r1, r2 = _engine(inc, tlex).search(q, k=5)[0], _engine(bulk, tlex).search(q, k=5)[0]
    assert [h.chunk_id for h in r1.hits] == [h.chunk_id for h in r2.hits]


@pytest.mark.parametrize("fmt", ["dense", "sparse"])
def test_listener_events_match_jax(fmt):
    """add / delete / grow / bulk events with their rows, in order."""
    tlex, jlex = ttesting.sample_lexicon(), jtesting.sample_lexicon()
    events = {}
    for name, store, lex_mod, lex in (("port", TStore(_tcfg(lexical_format=fmt,
                                                            initial_capacity=256),
                                                      device="cpu"), ttesting, tlex),
                                      ("jax", JStore(_jcfg(lexical_format=fmt,
                                                           initial_capacity=256)),
                                       jtesting, jlex)):
        got = []
        store.listeners.append(lambda ev, rows, got=got: got.append((ev, rows)))
        recs = lex_mod.toy_corpus(lex, pad_docs=250)
        store.add_chunks(recs[:256])  # block-aligned (ROADMAP queue 3)
        store.delete_by_document(recs[0].doc_id)
        store.add_chunks(recs[256:])  # recycles, then grows
        store.invalidate_rows([5])
        g0 = store.generation
        events[name] = (got, g0)
        bulk = type(store)(**({"device": "cpu"} if name == "port" else {}),
                           cfg=store.cfg)
        bulk.listeners.append(lambda ev, rows, got=got: got.append((ev, rows)))
        bulk.bulk_load(recs[:10])
    assert events["port"] == events["jax"]
    assert [e for e, _ in events["port"][0]] == ["add", "delete", "grow", "add", "delete",
                                                 "bulk"]
