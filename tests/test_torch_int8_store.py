"""int8 row storage on the device (MRAG_VECTOR_DTYPE=int8), the port against
the JAX package (mirrors tests/test_int8_store.py).

- ``vectors`` (int8) and ``vec_scales`` bitwise against the JAX store
  through add_chunks (host quantization), a delete and a recycling
  republish, and bulk_load from records and from a float32 array (device
  quantization). Exact: the same float32 arithmetic step for step.
- snapshots both ways: int8 vectors, scales and the dequantized record
  embeddings survive either package's restore.
- the exact-int8 engine's hits against the JAX engine's: scores within
  1e-5 (float32 summation order of the dot), ids equal except inside runs
  tied within 1e-6; the proj backend over int8 rows with the JAX tables
  carried across (ann_io), every cluster probed, to the same tolerance.
- the int8 engine against the port's own float32 engine (overlap >= 0.8,
  top-1 equal), as the JAX test holds its two."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu.config import get_config as jget_config
from mobius_rag_tpu.index.store import ChunkStore as JStore
from mobius_rag_tpu.query.engine import QueryRequest as JRequest, SearchEngine as JEngine
from mobius_rag_tpu_torch import testing as ttesting
from mobius_rag_tpu_torch.config import get_config as tget_config
from mobius_rag_tpu_torch.index.store import ChunkStore as TStore
from mobius_rag_tpu_torch.ops.topk import NEG_INF
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine

torch.set_num_threads(1)

ATOL = 1e-5
TIE = 1e-6
QUERIES = [
    ("timely filing deadline for sunshine health claims", {}),
    ("prior authorization for durable medical equipment", {}),
    ("molina eligibility verification", {"payer": "molina"}),
    ("telehealth behavioral health outpatient", {"tag_mode": "none", "mode": "recall"}),
    ("grievances and appeals timeline", {"min_similarity": 0.2}),
]


def _cfgs(**kw):
    return (dataclasses.replace(jget_config(), vector_dtype="int8", **kw),
            dataclasses.replace(tget_config(), vector_dtype="int8", **kw))


def _vec_fields(store, port: bool):
    if port:
        f = store.index.to_numpy()
        return f["vectors"], f["vec_scales"], f["valid"]
    return tuple(np.asarray(jax.device_get(getattr(store.index, k)))
                 for k in ("vectors", "vec_scales", "valid"))


def _assert_vec_fields_equal(js, ts):
    jv, jsc, jval = _vec_fields(js, False)
    tv, tsc, tval = _vec_fields(ts, True)
    assert tv.dtype == jv.dtype == np.int8
    np.testing.assert_array_equal(tval, jval)
    np.testing.assert_array_equal(tv, jv)
    live = jval > 0  # dead rows' scales are whatever the write blocks left
    np.testing.assert_array_equal(tsc[live], jsc[live])
    assert (tsc[live] > 0).all() and (tsc[live] < 1).all()


@pytest.fixture(scope="module")
def written():
    jcfg, tcfg = _cfgs()
    js, ts = JStore(jcfg), TStore(tcfg, device="cpu")
    js.add_chunks(jtesting.toy_corpus(jtesting.sample_lexicon(), pad_docs=60))
    ts.add_chunks(ttesting.toy_corpus(ttesting.sample_lexicon(), pad_docs=60))
    return js, ts


def test_int8_store_dtype(written):
    _, ts = written
    assert ts.index.vectors.dtype == torch.int8
    live = ts.index.valid > 0
    assert bool((ts.index.vec_scales[live] > 0).all() and (ts.index.vec_scales[live] < 1).all())


def test_add_chunks_bitwise(written):
    _assert_vec_fields_equal(*written)


def test_delete_and_recycle_bitwise():
    jcfg, tcfg = _cfgs()
    js, ts = JStore(jcfg), TStore(tcfg, device="cpu")
    for s, mod in ((js, jtesting), (ts, ttesting)):
        s.add_chunks(mod.toy_corpus(mod.sample_lexicon(), pad_docs=30))
        s.delete_by_document("aetna_provider_manual")
        new = mod.toy_corpus(None, pad_docs=6, rng=np.random.default_rng(5))[-6:]
        for r in new:
            r.doc_id, r.chunk_id = "late-" + r.doc_id, "late-" + r.chunk_id
        s.add_chunks(new)  # recycles the freed rows: new values and scales
    _assert_vec_fields_equal(js, ts)


@pytest.mark.parametrize("source", ["records", "array"])
def test_bulk_load_bitwise(source):
    jcfg, tcfg = _cfgs()
    jrecs = jtesting.toy_corpus(jtesting.sample_lexicon(), pad_docs=40)
    trecs = ttesting.toy_corpus(ttesting.sample_lexicon(), pad_docs=40)
    kw = {}
    if source == "array":
        rng = np.random.default_rng(2)
        v = rng.standard_normal((len(trecs), tcfg.embed_dim)).astype(np.float32)
        kw = {"vectors": v / np.linalg.norm(v, axis=1, keepdims=True)}
    js, ts = JStore(jcfg), TStore(tcfg, device="cpu")
    js.bulk_load(jrecs, **kw)
    ts.bulk_load(trecs, **kw)
    _assert_vec_fields_equal(js, ts)


def _assert_restored(a, b):
    for f in ("vectors", "vec_scales", "valid"):
        np.testing.assert_array_equal(a.index.to_numpy()[f] if isinstance(a, TStore)
                                      else np.asarray(jax.device_get(getattr(a.index, f))),
                                      b.index.to_numpy()[f])
    for ra, rb in zip(a.records, b.records):
        assert (ra is None) == (rb is None)
        if ra is not None:
            np.testing.assert_array_equal(np.asarray(rb.embedding, np.float32),
                                          np.asarray(ra.embedding, np.float32))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshot_both_ways(written, writer, tmp_path):
    js, ts = written
    jcfg, tcfg = _cfgs()
    path = str(tmp_path / "snap8")
    (js if writer == "jax" else ts).snapshot(path)
    jr = JStore.restore(path, cfg=jcfg)
    tr = TStore.restore(path, cfg=tcfg, device="cpu")
    assert tr.index.vectors.dtype == torch.int8
    _assert_restored(jr, tr)
    _assert_vec_fields_equal(jr, tr)
    live = next(r for r in tr.records if r is not None)  # dequantized, not zeros
    assert np.abs(live.embedding).max() > 0
    eng = SearchEngine(tr, ttesting.sample_lexicon(), cfg=tcfg,
                       embed_fn=ttesting.hash_embed, device="cpu")
    r = eng.search(QueryRequest(query="timely filing deadline", payer="sunshine_health"),
                   k=3)[0]
    assert r.hits and r.hits[0].doc_id == "sunshine_provider_manual"


def _assert_hits_equal(a, b):
    sa = np.array([h.score for h in a.hits])
    sb = np.array([h.score for h in b.hits])
    assert len(sa) == len(sb)
    np.testing.assert_allclose(sb, sa, rtol=0, atol=ATOL)
    tied = np.zeros(len(sa), bool)
    if len(sa) > 1:
        d = np.abs(np.diff(sa)) <= TIE
        tied[1:] |= d
        tied[:-1] |= d
    for ha, hb, t in zip(a.hits, b.hits, tied):
        assert t or ha.chunk_id == hb.chunk_id
    for arm in ("vector", "lexical", "dtag"):
        ta, tb = a.telemetry["arms"][arm], b.telemetry["arms"][arm]
        assert len(ta) == len(tb), arm
        np.testing.assert_allclose([t["score"] for t in tb], [t["score"] for t in ta],
                                   rtol=0, atol=ATOL)
    assert a.telemetry["strict_count"] == b.telemetry["strict_count"]


@pytest.fixture(scope="module")
def engines(written, tmp_path_factory):
    js, ts = written
    jcfg, tcfg = _cfgs()
    je = JEngine(js, jtesting.sample_lexicon(), jcfg, embed_fn=jtesting.hash_embed)
    te = SearchEngine(ts, ttesting.sample_lexicon(), cfg=tcfg,
                      embed_fn=ttesting.hash_embed, device="cpu")
    out = {"exact": (je.search([JRequest(query=q, **kw) for q, kw in QUERIES], k=5),
                     te.search([QueryRequest(query=q, **kw) for q, kw in QUERIES], k=5))}
    # the proj backend over the same int8 rows, the JAX tables carried across
    proj = dict(vector_backend="proj", ivf_nlist=8, ivf_nprobe=8, proj_p=64)
    jcfg_p, tcfg_p = _cfgs(**proj)
    jep = JEngine(js, jtesting.sample_lexicon(), jcfg_p, embed_fn=jtesting.hash_embed)
    tep = SearchEngine(ts, ttesting.sample_lexicon(), cfg=tcfg_p,
                       embed_fn=ttesting.hash_embed, device="cpu")
    path = os.path.join(str(tmp_path_factory.mktemp("ann8")), "ann.npz")
    jep.save_ann(path)
    tep.load_ann(path)
    out["proj"] = (jep.search([JRequest(query=q, **kw) for q, kw in QUERIES], k=5),
                   tep.search([QueryRequest(query=q, **kw) for q, kw in QUERIES], k=5))
    return out


@pytest.mark.parametrize("backend", ["exact", "proj"])
@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_int8_engine_matches_jax(engines, backend, i):
    jres, tres = engines[backend]
    _assert_hits_equal(jres[i], tres[i])


def test_int8_engine_exercises_hits(engines):
    assert sum(bool(r.hits) for r in engines["exact"][1]) >= 4
    assert all(h.signals["cosine"] <= 1.01 for r in engines["exact"][1] for h in r.hits)


def test_proj_build_over_int8_rows_uses_scales(written):
    """The device build over int8 rows dequantizes with vec_scales: a
    reserved-slab insert encodes the scaled row (what the JAX engine's
    incremental path does), so its code equals encoding the float row."""
    _, ts = written
    _, tcfg = _cfgs(vector_backend="proj", ivf_nlist=8, ivf_nprobe=8, proj_p=64)
    eng = SearchEngine(ts, ttesting.sample_lexicon(), cfg=tcfg,
                       embed_fn=ttesting.hash_embed, device="cpu")
    ann = eng.ensure_ann()
    live = (ann.valid > 0) & (ann.rowids >= 0)
    rows = ann.rowids[live].long()
    x = ts.index.vectors[rows].float() * ts.index.vec_scales[rows][:, None]
    assert float(x.norm(dim=1).sub(1).abs().max()) < 0.02  # unit rows, not raw int8


def test_int8_hybrid_matches_f32():
    lex = ttesting.sample_lexicon()
    cfg32 = tget_config()
    cfg8 = dataclasses.replace(cfg32, vector_dtype="int8")
    s32, s8 = TStore(cfg32, device="cpu"), TStore(cfg8, device="cpu")
    s32.add_chunks(ttesting.toy_corpus(lex, pad_docs=60))
    s8.add_chunks(ttesting.toy_corpus(lex, pad_docs=60))
    e32 = SearchEngine(s32, lex, cfg32, embed_fn=ttesting.hash_embed, device="cpu")
    e8 = SearchEngine(s8, lex, cfg8, embed_fn=ttesting.hash_embed, device="cpu")
    for q, _ in QUERIES[:3]:
        a = [h.chunk_id for h in e32.search(QueryRequest(query=q), k=5)[0].hits]
        b = [h.chunk_id for h in e8.search(QueryRequest(query=q), k=5)[0].hits]
        assert len(set(a) & set(b)) / max(len(a), 1) >= 0.8, (q, a, b)
        assert a[0] == b[0], f"top-1 must agree for {q!r}"


def test_int8_dense_arm_dead_entries(written):
    """Gated rows stay dead through the int8 scale multiply."""
    _, ts = written
    _, tcfg = _cfgs()
    eng = SearchEngine(ts, ttesting.sample_lexicon(), cfg=tcfg,
                       embed_fn=ttesting.hash_embed, device="cpu")
    r = eng.search(QueryRequest(query="grievances", payer="no_such_payer"), k=5)[0]
    assert not r.hits
    assert all(t["score"] > NEG_INF / 2 for t in r.telemetry["arms"]["vector"])
