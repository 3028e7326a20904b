"""Candidate-local gating in the port (query/gating.py, ops/proj.py
ProjGate / proj_search_gated, the engine's proj wiring): the properties
tests/test_gating.py pins on the JAX package, held on the port, and the
port against the JAX package on the same corpus and requests.

Tolerances: counts, gate words, d-tag postings and d-tag arm outputs
exact; the port's local arms against its dense arms as in test_gating.py
(ids as sets where float ties make the order arbitrary); the port against
the JAX engine with the same ANN tables (carried across through the
ann_io file), every cluster probed: scores within 1e-5 (float32 sums in
another order; the port sums each row's lexical postings in float64),
ids equal except inside runs of scores tied within 1e-6."""
import dataclasses
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu.config import get_config as jget_config
from mobius_rag_tpu.index.store import ChunkStore as JStore
from mobius_rag_tpu.ops.proj import encode_qmeta as jencode_qmeta
from mobius_rag_tpu.query import gating as jgating
from mobius_rag_tpu.query.engine import QueryRequest as JRequest, SearchEngine as JEngine
from mobius_rag_tpu_torch import testing as ttesting
from mobius_rag_tpu_torch.config import get_config as tget_config
from mobius_rag_tpu_torch.index.store import ChunkRecord, ChunkStore as TStore
from mobius_rag_tpu_torch.ops.proj import (PackedProj, ProjGate, encode_qmeta,
                                           proj_search_gated, proj_search_packed)
from mobius_rag_tpu_torch.ops.topk import NEG_INF, topk_stable
from mobius_rag_tpu_torch.query import engine as eng
from mobius_rag_tpu_torch.query import gating
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine

torch.set_num_threads(1)

ATOL = 1e-5
TIE = 1e-6
_PROJ = dict(vector_backend="proj", ivf_nlist=8, ivf_nprobe=8, proj_p=64,
             lexical_format="sparse")


def _tcfg(**kw):
    return dataclasses.replace(tget_config(), **_PROJ, **kw)


def _jcfg(**kw):
    return dataclasses.replace(jget_config(), **_PROJ, **kw)


def _enrich(recs):
    # regulators (authority 4, no payer), rows in another state
    for i, r in enumerate(recs):
        if i % 11 == 0:
            r.payer = ""
            r.authority_level = 4
        if i % 7 == 0:
            r.state = "TX"
    return recs


QUERIES = [
    ("timely filing deadline for claims", dict(payer="sunshine_health", tag_mode="strict")),
    ("prior authorization for durable medical equipment", dict(tag_mode="relaxed")),
    ("eligibility verification", dict(payer="molina", state="FL", tag_mode="none")),
    ("grievances and appeals timeline", dict(payer="nonexistent_payer", tag_mode="strict")),
    ("provider credentialing requirements",
     dict(payer="sunshine_health", inherit_authority=True, tag_mode="strict")),
    ("telehealth behavioral health outpatient", dict(mode="recall", min_similarity=0.1)),
]


def _treqs():
    return [QueryRequest(query=q, **kw) for q, kw in QUERIES]


def _jreqs():
    return [JRequest(query=q, **kw) for q, kw in QUERIES]


@pytest.fixture(scope="module")
def stores():
    tlex = ttesting.sample_lexicon()
    recs = _enrich(ttesting.toy_corpus(tlex, pad_docs=150))
    dense = TStore(_tcfg(gating="dense"), device="cpu")
    dense.add_chunks(recs)
    local = TStore(_tcfg(gating="local"), device="cpu")
    local.add_chunks(recs)
    return tlex, dense, local


def _engine(store, lex):
    return SearchEngine(store, lex, cfg=store.cfg, embed_fn=ttesting.hash_embed, device="cpu")


def _prep(engine, reqs):
    q, exps = engine.prepare_batch(reqs)
    return dict(q, vec=q["vec"].float()), exps


def test_strict_counts_matches_dense(stores):
    lex, dense_store, _ = stores
    q, _ = _prep(_engine(dense_store, lex), _treqs())
    strict, _, _, _ = eng.filter_masks(dense_store.index, q)
    got = gating.strict_counts(dense_store.index, q)
    np.testing.assert_array_equal(got.numpy(), strict.sum(dim=1).numpy())
    with mock.patch.object(gating, "_COUNT_BLOCK", 64):  # several row blocks
        np.testing.assert_array_equal(gating.strict_counts(dense_store.index, q).numpy(),
                                      got.numpy())


def test_gated_scan_matches_penalized_scan(stores):
    """proj_search_gated ≡ proj_search_packed under the dense gate penalty,
    for every live candidate."""
    lex, dense_store, _ = stores
    engine = _engine(dense_store, lex)
    ann = engine.ensure_ann()
    assert isinstance(ann, PackedProj)
    q, _ = _prep(engine, _treqs())
    k = 10
    strict, relaxed, open_mask, _ = eng.filter_masks(dense_store.index, q)
    strict_total = strict.sum(dim=1, keepdim=True)
    penalty = eng.gate_penalty(strict, relaxed, open_mask, q, k)
    v_ref, i_ref = proj_search_packed(ann, q["vec"], penalty, k, 8)
    gate = ProjGate.build(ann, dense_store.index)
    qmeta, qbits = encode_qmeta(q, strict_total[:, 0] >= k)
    for level in (2, engine._batch_tag_level(_prep(engine, _treqs())[1])):
        v_new, i_new = proj_search_gated(ann, gate.words, q["vec"], qmeta, qbits, k, 8,
                                         tag_level=level, tw=dense_store.index.j_tags.shape[1])
        live = v_ref > NEG_INF / 2
        assert torch.equal(live, v_new > NEG_INF / 2)
        assert torch.equal(v_new[live], v_ref[live])
        assert torch.equal(i_new[live], i_ref[live])


def test_lexical_local_matches_dense(stores):
    lex, dense_store, _ = stores
    q, _ = _prep(_engine(dense_store, lex), _treqs())
    k, m = 10, 20
    index = dense_store.index
    strict, relaxed, open_mask, _ = eng.filter_masks(index, q)
    strict_total = strict.sum(dim=1, keepdim=True)
    penalty = eng.gate_penalty(strict, relaxed, open_mask, q, k)
    lex_raw = eng.lexical_raw(index, q)
    v_ref, i_ref = topk_stable(torch.where(lex_raw > 0, lex_raw, NEG_INF) + penalty, m)
    qmeta, qbits = encode_qmeta(q, strict_total[:, 0] >= k)
    v_new, i_new, lex_best = gating.lexical_candidates_local(index, q, qmeta, qbits, m, 2)
    live = v_ref > NEG_INF / 2
    assert torch.equal(live, v_new > NEG_INF / 2) and live.any()
    # both sum each row's postings in float64: the same values, and the
    # same order (postings space is ordered by row, like the dense arm)
    assert torch.equal(v_new[live], v_ref[live])
    assert torch.equal(i_new[live], i_ref[live].to(torch.int32))
    ref_best = torch.where(live, v_ref, 0.0).amax(dim=1)
    assert torch.equal(lex_best, ref_best)


def test_lexical_local_dense_layout_fallback(stores):
    """Local gating forced on a dense-lexical store scores every row."""
    lex, dense_store, _ = stores
    recs = [r for r in dense_store.records if r is not None]
    dl = TStore(dataclasses.replace(_tcfg(gating="local"), lexical_format="dense"),
                device="cpu")
    dl.add_chunks(recs)
    q, _ = _prep(_engine(dense_store, lex), _treqs())
    qmeta, qbits = encode_qmeta(q, torch.ones(len(QUERIES), dtype=torch.bool))
    a = gating.lexical_candidates_local(dense_store.index, q, qmeta, qbits, 20, 2)
    b = gating.lexical_candidates_local(dl.index, q, qmeta, qbits, 20, 2)
    live = a[0] > NEG_INF / 2
    assert torch.equal(live, b[0] > NEG_INF / 2)
    np.testing.assert_allclose(b[0][live].numpy(), a[0][live].numpy(), rtol=1e-4, atol=1e-5)


def test_dtag_local_matches_dense(stores):
    lex, dense_store, _ = stores
    q, _ = _prep(_engine(dense_store, lex), _treqs())
    index = dense_store.index
    m = 20
    _, _, _, meta_ok = eng.filter_masks(index, q)
    v_ref, i_ref = topk_stable(eng.dtag_raw(index, q, meta_ok), m)
    dtp = gating.DTagPostings.build(index, pd=512)
    qmeta, _ = encode_qmeta(q, torch.ones(len(QUERIES), dtype=torch.bool))
    v_new, i_new = gating.dtag_candidates_local(dtp.as_tuple(), q, qmeta, m)
    live = v_ref > NEG_INF / 2
    assert torch.equal(live, v_new > NEG_INF / 2) and live.any()
    assert torch.equal(v_new[live], v_ref[live])
    for b in range(live.shape[0]):  # authority ties: compare as sets
        assert set(i_new[b][live[b]].tolist()) == set(i_ref[b][live[b]].tolist())


def test_engine_parity_local_vs_dense(stores):
    lex, dense_store, local_store = stores
    dense, local = _engine(dense_store, lex), _engine(local_store, lex)
    assert local._local_gating_active() and not dense._local_gating_active()
    ra, rb = dense.search(_treqs(), k=8), local.search(_treqs(), k=8)
    assert any(r.hits for r in ra)
    for a, b in zip(ra, rb):
        assert {h.chunk_id for h in a.hits} == {h.chunk_id for h in b.hits}, a.query
        for ha, hb in zip(a.hits, b.hits):
            assert abs(ha.score - hb.score) < 1e-3
        assert a.telemetry["strict_count"] == b.telemetry["strict_count"]


def test_auto_gating_is_dense_on_device_residency(stores):
    lex, dense_store, _ = stores
    auto = SearchEngine(dense_store, lex, cfg=_tcfg(gating="auto"),
                        embed_fn=ttesting.hash_embed, device="cpu")
    assert not auto._local_gating_active()
    exact = SearchEngine(dense_store, lex, cfg=_tcfg(gating="local"),
                         vector_backend="exact", embed_fn=ttesting.hash_embed, device="cpu")
    assert not exact._local_gating_active() and exact.ensure_ann() is None


def test_engine_local_streaming_insert_delete(stores):
    """Incremental inserts and deletes update the tables and the gate pack
    in place: a published row is served under its payer filter, not under
    another payer's, and gone after its delete."""
    lex, _, _ = stores
    store = TStore(_tcfg(gating="local"), device="cpu")
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=60))
    engine = _engine(store, lex)
    engine.search(QueryRequest(query="warm up"), k=5)
    ann = engine._ann
    text = "Xylophone rider reimburses tuning forks within 45 days."
    emb = ttesting.hash_embed([text])[0]
    store.add_chunks([ChunkRecord(chunk_id="fresh-1", doc_id="fresh-doc",
                                  source_id="fresh-s1", text=text,
                                  embedding=emb / np.linalg.norm(emb),
                                  payer="sunshine_health", state="FL")])

    def served(payer, tag_mode):
        res = engine.search(QueryRequest(query=text, embedding=emb, payer=payer,
                                         tag_mode=tag_mode), k=5)[0]
        return any(h.chunk_id == "fresh-1" for h in res.hits)

    assert served("sunshine_health", "none")
    assert not served("molina", "strict")
    store.delete_by_document("fresh-doc")
    assert not served("sunshine_health", "none")
    assert engine._ann is ann and engine._ann_cursor == 1  # no rebuild


def test_incremental_headroom_exhaustion_rebuilds(stores):
    lex, _, _ = stores
    store = TStore(_tcfg(gating="dense", ann_reserve_slabs=1), device="cpu")
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=30))
    engine = _engine(store, lex)
    ann = engine.ensure_ann()
    cap = (ann.nlist - ann.reserve_start) * ann.pad
    rng = np.random.default_rng(0)
    store.add_chunks([ChunkRecord(chunk_id=f"n{i}", doc_id=f"nd{i}", text=f"row {i}",
                                  embedding=rng.standard_normal(store.cfg.embed_dim))
                      for i in range(cap + 1)])
    assert engine.ensure_ann() is not ann  # out of reserved slots: rebuilt
    assert engine._ann.valid.sum().item() == store.size


def test_strict_count_host_cache(stores):
    """The local path bakes host-cached strict counts into the batch: the
    same results as the in-graph count, hits on repeats, invalidation when
    the store's generation moves."""
    lex, dense_store, local_store = stores
    engine = _engine(local_store, lex)
    r1 = engine.search(_treqs(), k=8)
    assert engine._strict_cache
    n_cached = len(engine._strict_cache)
    r2 = engine.search(_treqs(), k=8)
    assert len(engine._strict_cache) == n_cached
    for a, b in zip(r1, r2):
        assert [h.chunk_id for h in a.hits] == [h.chunk_id for h in b.hits]
        assert a.telemetry["strict_count"] == b.telemetry["strict_count"]
    rd = _engine(dense_store, lex).search(_treqs(), k=8)
    for a, d in zip(r2, rd):
        assert a.telemetry["strict_count"] == d.telemetry["strict_count"]
    text = "Yodel rider reimburses alpine horns within 10 days."
    emb = ttesting.hash_embed([text])[0]
    local_store.add_chunks([ChunkRecord(chunk_id="y1", doc_id="ydoc", source_id="ys1",
                                        text=text, embedding=emb / np.linalg.norm(emb),
                                        payer="sunshine_health", state="FL")])
    r3 = engine.search(_treqs(), k=8)
    assert len(engine._strict_cache) > n_cached
    assert r3[0].telemetry["strict_count"] == r2[0].telemetry["strict_count"] + 1
    local_store.delete_by_document("ydoc")


# ---------------------------------------------------------------------------
# the port against the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """JAX and port stores of the same records, for each gating, with the
    JAX engine's ANN tables carried over to the port engine through the
    ann_io file."""
    jlex, tlex = jtesting.sample_lexicon(), ttesting.sample_lexicon()
    out = {}
    for g in ("dense", "local"):
        js = JStore(_jcfg(gating=g))
        js.add_chunks(_enrich(jtesting.toy_corpus(jlex, pad_docs=150)))
        ts = TStore(_tcfg(gating=g), device="cpu")
        ts.add_chunks(_enrich(ttesting.toy_corpus(tlex, pad_docs=150)))
        je = JEngine(js, jlex, cfg=js.cfg, embed_fn=jtesting.hash_embed)
        te = _engine(ts, tlex)
        path = str(tmp_path_factory.mktemp(f"ann_{g}") / "ann.npz")
        je.save_ann(path)
        te.load_ann(path)
        out[g] = dict(js=js, ts=ts, je=je, te=te, jres=je.search(_jreqs(), k=8),
                      tres=te.search(_treqs(), k=8))
    return out


def test_sparse_postings_match_jax(both):
    for g in ("dense", "local"):
        js, ts = both[g]["js"], both[g]["ts"]
        np.testing.assert_array_equal(ts._lex_cols_np, js._lex_cols_np)
        np.testing.assert_array_equal(ts._lex_wts_np, js._lex_wts_np)
        np.testing.assert_array_equal(ts._lex_fill, js._lex_fill)


def test_dtag_postings_match_jax(both):
    js, ts = both["local"]["js"], both["local"]["ts"]
    jd = jgating.DTagPostings.build(js.index, pd=64)
    td = gating.DTagPostings.build(ts.index, pd=64)
    for a, b in zip(td.as_tuple(), jd.as_tuple()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _local_inputs(both):
    d = both["local"]
    jq, _ = d["je"].prepare_batch(_jreqs())
    tq, _ = d["te"].prepare_batch(_treqs())
    k = 8
    jmeta, jbits = jencode_qmeta(jq, jnp.asarray(np.asarray(jq["strict_total"]) >= k))
    tmeta, tbits = encode_qmeta(tq, tq["strict_total"] >= k)
    return d, jq, tq, jmeta, jbits, tmeta, tbits


def test_local_arms_match_jax(both):
    d, jq, tq, jmeta, jbits, tmeta, tbits = _local_inputs(both)
    np.testing.assert_array_equal(tmeta.numpy(), np.asarray(jmeta))
    m = 30
    jv, ji, jbest = (np.asarray(a) for a in jgating.lexical_candidates_local(
        d["js"].index, jq, jmeta, jbits, m, 2))
    tv, ti, tbest = gating.lexical_candidates_local(d["ts"].index, tq, tmeta, tbits, m, 2)
    _assert_topk(tv.numpy(), ti.numpy(), jv, ji)
    np.testing.assert_allclose(tbest.numpy(), jbest, rtol=0, atol=ATOL)
    dv, di = (np.asarray(a) for a in jgating.dtag_candidates_local(
        jgating.DTagPostings.build(d["js"].index, pd=64).as_tuple(), jq, jmeta, m))
    tdv, tdi = gating.dtag_candidates_local(
        gating.DTagPostings.build(d["ts"].index, pd=64).as_tuple(), tq, tmeta, m)
    live = dv > NEG_INF / 2
    assert live.any()
    np.testing.assert_array_equal(tdv.numpy(), dv)
    np.testing.assert_array_equal(tdi.numpy()[live], di[live])
    jj = np.asarray(jgating.lex_signal_join(jnp.asarray(di), jnp.asarray(ji),
                                            jnp.asarray(jv)))
    tj = gating.lex_signal_join(tdi, ti, tv)
    np.testing.assert_allclose(tj.numpy(), jj, rtol=0, atol=ATOL)


def _assert_topk(vals, idx, want_vals, want_idx):
    live = want_vals > NEG_INF / 2
    assert ((vals > NEG_INF / 2) == live).all()
    np.testing.assert_allclose(vals[live], want_vals[live], rtol=0, atol=ATOL)
    tied = np.abs(np.diff(want_vals, axis=1)) <= TIE
    strict = live.copy()
    strict[:, 1:] &= ~tied
    strict[:, :-1] &= ~tied
    np.testing.assert_array_equal(idx[strict], want_idx[strict])


@pytest.mark.parametrize("g", ["dense", "local"])
@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_engine_matches_jax(both, g, i):
    a, b = both[g]["jres"][i], both[g]["tres"][i]
    assert b.telemetry["strict_count"] == a.telemetry["strict_count"]
    sa = np.array([h.score for h in a.hits])
    sb = np.array([h.score for h in b.hits])
    assert len(sa) == len(sb)
    np.testing.assert_allclose(sb, sa, rtol=0, atol=ATOL)
    tied = np.zeros(len(sa), bool)
    if len(sa) > 1:
        dd = np.abs(np.diff(sa)) <= TIE
        tied[1:] |= dd
        tied[:-1] |= dd
    for ha, hb, t in zip(a.hits, b.hits, tied):
        assert t or ha.chunk_id == hb.chunk_id
    for arm in ("vector", "lexical", "dtag"):
        ta, tb = a.telemetry["arms"][arm], b.telemetry["arms"][arm]
        assert len(ta) == len(tb), arm
        np.testing.assert_allclose([t["score"] for t in tb], [t["score"] for t in ta],
                                   rtol=0, atol=ATOL)


def test_engine_parity_exercises_the_cases(both):
    """The parity batch covers both auto-relax branches, a filter that
    admits nothing and hits on several requests."""
    res = both["local"]["tres"]
    counts = [r.telemetry["strict_count"] for r in res]
    assert any(c >= 8 for c in counts) and any(c < 8 for c in counts)
    assert sum(bool(r.hits) for r in res) >= 3
    assert both["local"]["te"]._ann_gate is not None
    assert both["dense"]["te"]._ann_gate is None


def test_has_tag_bits_does_not_wrap():
    """A query whose j bits are bit 31 of two words has j tags. The JAX
    package sums the uint32 words (``sum(axis=1) > 0``), which wraps to 0
    here, and so treats it as untagged (ROADMAP queue 3); the port tests
    for any set bit, in encode_qmeta as in its dense gate."""
    bits = np.zeros((1, 8), np.uint32)
    bits[0, :2] = 2**31
    zeros = np.zeros((1, 8), np.uint32)
    base = {"payer": np.array([-1], np.int32), "state": np.array([-1], np.int32),
            "program": np.array([-1], np.int32), "tag_mode": np.array([0], np.int32),
            "inherit_authority": np.array([0], np.float32)}
    jq = {k: jnp.asarray(v) for k, v in base.items()}
    jq.update(j_bits=jnp.asarray(bits), d_bits=jnp.asarray(zeros), p_bits=jnp.asarray(zeros))
    tq = {k: torch.from_numpy(v) for k, v in base.items()}
    tq.update(j_bits=torch.from_numpy(bits.view(np.int32)),
              d_bits=torch.from_numpy(zeros.view(np.int32)),
              p_bits=torch.from_numpy(zeros.view(np.int32)))
    jmeta, _ = jencode_qmeta(jq, jnp.asarray([True]))
    tmeta, _ = encode_qmeta(tq, torch.tensor([True]))
    assert int(jmeta[0, 6]) == 0  # the JAX package: wrapped to "no j tags"
    assert int(tmeta[0, 6]) == 1


@pytest.mark.parametrize("bits", [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 0, 1), (2**31, 0, 0)])
def test_batch_tag_level_matches_jax(bits):
    q = {name: np.zeros((3, 8), np.uint32) for name in ("j_bits", "d_bits", "p_bits")}
    for name, b in zip(("j_bits", "d_bits", "p_bits"), bits):
        q[name][1, 7] = b
    assert gating.batch_tag_level(q) == jgating.batch_tag_level(q)


def test_arm_candidates_m_other_pads_dead(stores):
    """m_other < m runs the lexical and d-tag arms at m_other and pads them
    back to m with dead entries; the vector arm keeps m."""
    lex, dense_store, local_store = stores
    for store in (dense_store, local_store):
        engine = _engine(store, lex)
        ann = engine.ensure_ann()
        q, exps = _prep(engine, _treqs())
        local = engine._ensure_local_structs(ann)
        kw = dict(ann=ann, nprobe=8, local=local, tag_level=engine._batch_tag_level(exps))
        full = eng.arm_candidates(store.index, q, 8, 20, **kw)
        cut = eng.arm_candidates(store.index, q, 8, 20, m_other=6, **kw)
        assert torch.equal(cut[0][0], full[0][0]) and torch.equal(cut[1][0], full[1][0])
        for arm in (1, 2):
            assert torch.equal(cut[0][arm][:, :6], full[0][arm][:, :6])
            assert torch.equal(cut[1][arm][:, :6], full[1][arm][:, :6])
            assert bool((cut[0][arm][:, 6:] == NEG_INF).all())
        assert torch.equal(cut[3], full[3])


def test_set_vector_backend(stores):
    lex, dense_store, _ = stores
    engine = _engine(dense_store, lex)
    assert engine.ensure_ann() is not None
    engine.set_vector_backend("exact")
    assert engine.ensure_ann() is None and engine._ann is None
    engine.set_vector_backend("proj")
    assert isinstance(engine.ensure_ann(), PackedProj)
    from mobius_rag_tpu_torch.index.ivf import IVFIndex, PackedIVF
    from mobius_rag_tpu_torch.ops.pq import PackedPQ

    for backend, cls in (("ivf", IVFIndex), ("packed", PackedIVF), ("pq", PackedPQ)):
        engine.set_vector_backend(backend)
        assert isinstance(engine.ensure_ann(), cls)
    with pytest.raises(ValueError):
        engine.set_vector_backend("hnsw")


def test_incremental_survives_ann_file(stores, tmp_path):
    """Tables loaded from an ann file keep their slot mirrors, so a publish
    after the load still goes through the reserved slabs."""
    lex, _, _ = stores
    store = TStore(_tcfg(gating="local"), device="cpu")
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=40))
    first, second = _engine(store, lex), _engine(store, lex)
    first.save_ann(str(tmp_path / "ann.npz"))
    second.load_ann(str(tmp_path / "ann.npz"))
    loaded = second._ann
    text = "Zither rider reimburses string sets within 30 days."
    emb = ttesting.hash_embed([text])[0]
    store.add_chunks([ChunkRecord(chunk_id="z1", doc_id="zdoc", source_id="zs1", text=text,
                                  embedding=emb, payer="aetna", state="FL")])
    res = second.search(QueryRequest(query=text, embedding=emb, payer="aetna",
                                     tag_mode="none"), k=5)[0]
    assert any(h.chunk_id == "z1" for h in res.hits)
    assert second._ann is loaded and second._ann_cursor == 1
    with pytest.raises(ValueError, match="rows"):
        _engine(store, lex).load_ann(str(tmp_path / "ann.npz"))  # the store moved on
