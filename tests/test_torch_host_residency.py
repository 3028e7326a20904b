"""Host vector residency in the port (MRAG_VECTOR_RESIDENCY=host: int8 rows
in host RAM, proj codes on the device, funnel + exact host re-rank), held
to the JAX package on the same numpy inputs.

Mirrors the non-sharded cases of tests/test_host_residency.py (those that
search with the pq backend run on proj here; host residency with pq is
held to the JAX engine in tests/test_torch_pq.py), tests/test_proj.py:120-231
and tests/test_ann_incremental.py:167, and adds:

- ``IVFIndex.build_host`` against the JAX one (same seeded draws):
  centroids within 1e-4 (float32 summation order), member tables
  identical on a well-separated corpus;
- ``PackedProj.from_ivf``'s host branch bitwise equal to the port's
  device branch on the same rows, and against the JAX host branch as
  tests/test_torch_proj.py holds the device branch;
- ``gather_cos`` (native and numpy) against the JAX one: the native
  libraries are the same source and flags, so bitwise; numpy within 1e-5;
- the funnel block of ``pack_out`` bitwise against the JAX ``pack_out``;
- ``_host_rerank`` fed one shared unpacked output: identical results;
- host-residency snapshots both ways (bitwise host arrays);
- whole-engine parity against the JAX engine on proj tables carried across
  through ann_io, every cluster probed: scores within 1e-5 (float32 order
  of the device sums), ids equal except inside runs tied within 1e-6;
- two faults found while porting (ROADMAP queue 3): the port's candidate-
  local lexical arm failed on a batch with no lexical buckets (empty query
  text), and the JAX store's bulk_load drops the capacity a store was
  built with."""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu.config import get_config as jget_config
from mobius_rag_tpu.index.ivf import IVFIndex as JIVF
from mobius_rag_tpu.index.store import ChunkRecord as JRecord, ChunkStore as JStore
from mobius_rag_tpu.ops import proj as jproj
from mobius_rag_tpu.ops import quant as jquant
from mobius_rag_tpu.query import engine as jeng
from mobius_rag_tpu.query.engine import QueryRequest as JRequest, SearchEngine as JEngine
from mobius_rag_tpu.utils import native as jnative
from mobius_rag_tpu_torch import testing as ttesting
from mobius_rag_tpu_torch.config import get_config as tget_config
from mobius_rag_tpu_torch.index.ivf import IVFIndex as TIVF
from mobius_rag_tpu_torch.index.store import ChunkRecord, ChunkStore as TStore
from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk
from mobius_rag_tpu_torch.ops import proj as tproj
from mobius_rag_tpu_torch.ops.topk import NEG_INF
from mobius_rag_tpu_torch.query import engine as teng
from mobius_rag_tpu_torch.query import gating
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine
from mobius_rag_tpu_torch.utils import native

torch.set_num_threads(1)

ATOL = 1e-5
TIE = 1e-6
DIM = int(tget_config().embed_dim)
_HOST = dict(vector_residency="host", vector_dtype="int8", vector_backend="proj",
             ivf_nprobe=10 ** 6)


def _tcfg(**kw):
    return dataclasses.replace(tget_config(), **{**_HOST, **kw})


def _jcfg(**kw):
    return dataclasses.replace(jget_config(), **{**_HOST, **kw})


def _engine(store, lex=None, **kw):
    return SearchEngine(store, lex or ttesting.sample_lexicon(), cfg=store.cfg,
                        embed_fn=ttesting.hash_embed, device="cpu", **kw)


def _unit_rows(rng, n, d=DIM):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


@pytest.fixture(scope="module")
def stores():
    lex = ttesting.sample_lexicon()
    dev_store = TStore(device="cpu")
    dev_store.add_chunks(ttesting.toy_corpus(lex, pad_docs=120))
    host_store = TStore(_tcfg(), device="cpu")
    host_store.add_chunks(ttesting.toy_corpus(lex, pad_docs=120))
    return lex, dev_store, host_store


# ---------------------------------------------------------------------------
# tests/test_host_residency.py (pq cases on proj)
# ---------------------------------------------------------------------------

def test_config_validation():
    bad = dataclasses.replace(tget_config(), vector_residency="host", vector_backend="exact")
    assert any("RESIDENCY" in p for p in bad.validate())
    bad = dataclasses.replace(tget_config(), vector_residency="host", vector_backend="proj")
    assert any("VECTOR_DTYPE=int8" in p for p in bad.validate())
    assert not _tcfg().validate()


def test_host_store_shape(stores):
    _, _, host_store = stores
    assert host_store.index.vectors.shape == (0, DIM)
    assert host_store.host_vectors is not None
    assert host_store.host_vectors.shape[0] == host_store.capacity >= host_store.size
    assert np.abs(host_store.host_vectors[:host_store.size]).max() > 0
    live = host_store.index.valid.numpy() > 0
    np.testing.assert_array_equal(host_store.index.vec_scales.numpy()[live],
                                  host_store.host_scales[live])


def test_host_residency_search_matches_dense(stores):
    """Full-probe proj + the host exact re-rank track the dense engine's
    hybrid top-k (test_host_residency.py:48 with pq, test_proj.py:120 with
    proj: the same test on the port)."""
    lex, dev_store, host_store = stores
    dense, hosty = _engine(dev_store, lex), _engine(host_store, lex)
    queries = [
        QueryRequest(query="What is the timely filing deadline for Sunshine Health FL "
                           "Medicaid claims?"),
        QueryRequest(query="prior authorization for durable medical equipment"),
        QueryRequest(query="molina eligibility verification", payer="molina"),
    ]
    recalls = []
    for q in queries:
        a = dense.search(q, k=8)[0]
        b = hosty.search(q, k=8)[0]
        assert b.hits, q.query
        ia, ib = {h.chunk_id for h in a.hits}, {h.chunk_id for h in b.hits}
        recalls.append(len(ia & ib) / max(len(ia), 1))
        assert -1.01 <= b.hits[0].signals["cosine"] <= 1.01
    assert float(np.mean(recalls)) >= 0.8, recalls


def test_host_residency_republish_and_recycle(stores):
    lex, _, _ = stores
    store = TStore(_tcfg(), device="cpu")
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=32))
    eng = _engine(store, lex)
    text = "Zugzwang rider reimburses chess clock repair within 90 days."
    rec = featurize_chunk(ChunkRecord(chunk_id="z-c0", doc_id="z_doc", text=text,
                                      embedding=ttesting.hash_embed([text])[0]), lex)
    row0 = store.publish_document("z_doc", [rec])[0]
    r = eng.search(QueryRequest(query="zugzwang chess clock repair"), k=5)[0]
    assert any(h.doc_id == "z_doc" for h in r.hits)
    text2 = "Quodlibet benefit covers improvised organ recitals only."
    rec2 = featurize_chunk(ChunkRecord(chunk_id="z-c1", doc_id="z_doc", text=text2,
                                       embedding=ttesting.hash_embed([text2])[0]), lex)
    row1 = store.publish_document("z_doc", [rec2])[0]
    assert row1 == row0  # the freed row is recycled and its host payload overwritten
    r2 = eng.search(QueryRequest(query="quodlibet organ recitals"), k=5)[0]
    assert r2.hits and r2.hits[0].chunk_id == "z-c1"
    stale = eng.search(QueryRequest(query="zugzwang chess clock repair"), k=5)[0]
    assert not any(h.chunk_id == "z-c0" for h in stale.hits)


@pytest.mark.parametrize("source", ["records", "float", "tensor", "int8", "int8_adopted"])
def test_host_residency_bulk_load_matches_jax(source):
    """bulk_load's three kinds of input (and the records): host arrays and
    the device scales bitwise against the JAX store's."""
    jrecs = jtesting.toy_corpus(jtesting.sample_lexicon(), pad_docs=40)
    trecs = ttesting.toy_corpus(ttesting.sample_lexicon(), pad_docs=40)
    n = len(trecs)
    rng = np.random.default_rng(4)
    v = _unit_rows(rng, n)
    js, ts = JStore(_jcfg()), TStore(_tcfg(), device="cpu")
    if source == "records":
        jkw = tkw = {}
    elif source == "float":
        jkw = tkw = {"vectors": v}
    elif source == "tensor":
        # the JAX store's device-array branch fails whenever the capacity
        # runs past N inside the last block (the next test), so the JAX side
        # is its float branch and the rows are compared with its
        # _quantize_block below
        jkw, tkw = {"vectors": v}, {"vectors": torch.from_numpy(v)}
    else:
        v8 = rng.integers(-127, 128, (n, DIM)).astype(np.int8)
        jkw = {"vectors": v8}
        if source == "int8":
            tkw = {"vectors": v8}
        else:  # a [capacity, D] matrix is taken as the host matrix itself
            full = np.zeros((ts.capacity, DIM), np.int8)
            full[:n] = v8
            tkw = {"vectors": full}
    js.bulk_load(jrecs, **jkw)
    ts.bulk_load(trecs, **tkw)
    if source == "int8_adopted":
        assert ts.host_vectors is tkw["vectors"]
    assert ts.index.vectors.shape[0] == 0 and ts.capacity == js.capacity
    if source == "tensor":
        q8, qs = (np.asarray(a) for a in jquant._quantize_block(jnp.asarray(v)))
        js.host_vectors[:n], js.host_scales[:n] = q8, qs
        js.index = js.index.replace(vec_scales=jnp.asarray(js.host_scales))
    np.testing.assert_array_equal(ts.host_vectors, js.host_vectors)
    np.testing.assert_array_equal(ts.host_scales, js.host_scales)
    np.testing.assert_array_equal(ts.index.vec_scales.numpy(),
                                  np.asarray(jax.device_get(js.index.vec_scales)))
    r = _engine(ts).search(QueryRequest(query="timely filing deadline"), k=5)[0]
    assert r.hits


def test_bulk_load_device_rows_past_the_last_block():
    """Device rows under host residency, N not filling the capacity: the
    JAX store writes each quantized block into a host slice cut at the
    capacity, not at N, and fails on the shape (ROADMAP queue 3); the port
    cuts at N."""
    trecs = ttesting.toy_corpus(ttesting.sample_lexicon(), pad_docs=5)
    jrecs = jtesting.toy_corpus(jtesting.sample_lexicon(), pad_docs=5)
    v = _unit_rows(np.random.default_rng(6), len(trecs))
    with pytest.raises(ValueError, match="broadcast"):
        JStore(_jcfg()).bulk_load(jrecs, vectors=jnp.asarray(v))
    ts = TStore(_tcfg(), device="cpu")
    ts.bulk_load(trecs, vectors=torch.from_numpy(v))
    q8, qs = (np.asarray(a) for a in jquant._quantize_block(jnp.asarray(v)))
    np.testing.assert_array_equal(ts.host_vectors[:len(v)], q8)
    np.testing.assert_array_equal(ts.host_scales[:len(v)], qs)
    assert not ts.host_vectors[len(v):].any() and (ts.host_scales[len(v):] == 1).all()


def test_host_residency_add_chunks_and_growth_match_jax():
    """add_chunks quantizes on the host (bitwise the JAX store's), and
    growth doubles the host arrays keeping their rows."""
    jcfg, tcfg = _jcfg(initial_capacity=256), _tcfg(initial_capacity=256)
    js, ts = JStore(jcfg), TStore(tcfg, device="cpu")
    rng = np.random.default_rng(8)
    emb = rng.standard_normal((300, DIM)).astype(np.float32)
    for s, rec in ((js, JRecord), (ts, ChunkRecord)):
        s.add_chunks([rec(chunk_id=f"g{i}", doc_id=f"d{i % 30}", text="grow",
                          embedding=emb[i]) for i in range(256)])
        s.add_chunks([rec(chunk_id=f"h{i}", doc_id="late", text="grow",
                          embedding=emb[i]) for i in range(256, 300)])
    assert ts.capacity == js.capacity == 512
    np.testing.assert_array_equal(ts.host_vectors, js.host_vectors)
    np.testing.assert_array_equal(ts.host_scales, js.host_scales)


def test_two_stage_recall_on_graded_neardups():
    """test_host_residency.py:113 (pq there, proj here): proj candidates ->
    the native host exact re-rank recovers the exact top-k on graded near-
    duplicates."""
    rng = np.random.default_rng(3)
    nb = 300
    base = _unit_rows(rng, nb)
    recs = []
    for t, eps in enumerate((0.0, 0.05, 0.12, 0.25)):
        v = base + eps * rng.standard_normal((nb, DIM)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        recs += [ChunkRecord(chunk_id=f"g{t}-{i}", doc_id=f"gd{i}", text=f"row {t} {i}",
                             embedding=v[i], authority_level=0) for i in range(nb)]
    store = TStore(_tcfg(over_fetch=8), device="cpu")
    store.add_chunks(recs)
    eng = _engine(store)
    k = 8
    q_rows = rng.choice(nb, 16, replace=False)
    qv = base[q_rows] + 0.02 * rng.standard_normal((16, DIM)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    hv = store.host_vectors[:store.size].astype(np.float32) \
        * store.host_scales[:store.size][:, None]
    oracle = np.argsort(-(qv @ hv.T), axis=1)[:, :k]
    res = eng.search([QueryRequest(query="", embedding=qv[i], tag_mode="none", mode="recall")
                      for i in range(16)], k=k)
    recalls = [len({h.row for h in r.hits} & set(map(int, oracle[i]))) / k
               for i, r in enumerate(res)]
    assert float(np.mean(recalls)) >= 0.85, recalls


@pytest.mark.parametrize("path", ["port_native", "port_numpy"])
def test_gather_cos_matches_jax(path, monkeypatch):
    """cpp/rerank.cc built by either package (same source, same flags):
    bitwise; the numpy expression the engine uses without a toolchain
    within 1e-5; out-of-range ids clamp."""
    rng = np.random.default_rng(7)
    n, d, b, w = 500, 96, 4, 12
    hv = rng.integers(-127, 128, (n, d)).astype(np.int8)
    hs = (rng.random(n).astype(np.float32) + 0.1) / 127
    idx = rng.integers(-3, n + 3, (b, w)).astype(np.int32)
    qv = _unit_rows(rng, b, d)
    want = jnative.gather_cos(hv, hs, idx, qv)
    assert want is not None
    safe = np.clip(idx, 0, n - 1)
    ref = np.einsum("bwd,bd->bw", hv[safe].astype(np.float32) * hs[safe][..., None], qv)
    if path == "port_numpy":
        monkeypatch.setattr(native, "_LIB", None)  # a machine with no C++ compiler
        assert native.gather_cos(hv, hs, idx, qv) is None
        got = ref
    else:
        calls = native.gather_cos.native_calls
        got = native.gather_cos(hv, hs, idx, qv)
        assert native.gather_cos.native_calls == calls + 1
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_engine_rerank_without_native_library(stores, monkeypatch):
    """The engine's numpy path (no toolchain) gives the native path's hits."""
    lex, _, host_store = stores
    q = QueryRequest(query="timely filing deadline for sunshine health")
    a = _engine(host_store, lex).search(q, k=5)[0]
    monkeypatch.setattr(native, "_LIB", None)
    b = _engine(host_store, lex).search(q, k=5)[0]
    assert [h.chunk_id for h in a.hits] == [h.chunk_id for h in b.hits]
    np.testing.assert_allclose([h.score for h in b.hits], [h.score for h in a.hits],
                               atol=1e-6)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_host_residency_snapshot_both_ways(stores, writer, tmp_path):
    lex, _, host_store = stores
    path = str(tmp_path / "snap")
    if writer == "port":
        host_store.snapshot(path)
        src_hv, src_hs = host_store.host_vectors, host_store.host_scales
    else:
        js = JStore(_jcfg())
        js.add_chunks(jtesting.toy_corpus(jtesting.sample_lexicon(), pad_docs=120))
        js.snapshot(path)
        src_hv, src_hs = js.host_vectors, js.host_scales
    assert os.path.exists(os.path.join(path, "host_vectors.npy"))
    restored = TStore.restore(path, cfg=_tcfg(), device="cpu")
    jrestored = JStore.restore(path, cfg=_jcfg())
    for s in (restored, jrestored):
        np.testing.assert_array_equal(s.host_vectors, src_hv)
        np.testing.assert_array_equal(s.host_scales, src_hs)
    assert restored.capacity == jrestored.capacity
    for a, b in zip(jrestored.records, restored.records):
        assert (a is None) == (b is None)
        if a is not None:  # rehydrated from the host matrix, dequantized
            np.testing.assert_array_equal(b.embedding, a.embedding)
    live = next(r for r in restored.records if r is not None)
    assert np.abs(live.embedding).max() > 0
    q = QueryRequest(query="timely filing deadline for sunshine health")
    before = _engine(host_store, lex).search(q, k=5)[0]
    after = _engine(restored, lex).search(q, k=5)[0]
    if writer == "port":
        assert [h.chunk_id for h in after.hits] == [h.chunk_id for h in before.hits]
    assert after.hits
    with pytest.raises(ValueError, match="vector_residency"):
        TStore.restore(path, cfg=tget_config(), device="cpu")


def _wide_out(rng, b, k, w):
    out = {}
    for key, mult in teng._OUT_F:
        out[key] = rng.standard_normal((b, mult * k)).astype(np.float32)
    for key, mult in teng._OUT_I:
        out[key] = rng.integers(0, 10_000, (b, mult * k)).astype(np.int32)
    out["strict_count"] = rng.integers(0, 99, b).astype(np.float32)
    for key in teng._WIDE_F:
        out[key] = rng.uniform(0, 1, (b, w)).astype(np.float32)
    out["wide_vals"] = rng.normal(size=(b, w)).astype(np.float32)
    out["wide_vals"][:, ::5] = NEG_INF  # dead candidates
    # values halfway between two bf16 numbers: pins round-to-nearest-even
    half = (np.arange(1, w + 1, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
    out["wide_lexn"][0] = half
    out["wide_cov"][1] = -half
    out["wide_idx"] = rng.integers(0, 10_000, (b, w)).astype(np.int32)
    return out


def test_wide_pack_bitwise_vs_jax():
    rng = np.random.default_rng(7)
    b, k, w = 4, 5, 32
    out = _wide_out(rng, b, k, w)
    jf, ji = (np.asarray(a) for a in jax.device_get(
        jax.jit(lambda o: jeng.pack_out(o, k, w))({key: jnp.asarray(v)
                                                   for key, v in out.items()})))
    tf, ti = teng.pack_out({key: torch.from_numpy(v) for key, v in out.items()}, w)
    assert tf.shape == jf.shape == (b, 15 * k + 3 * w)
    np.testing.assert_array_equal(tf.view(np.uint32), jf.view(np.uint32))
    np.testing.assert_array_equal(ti, ji)
    jun, tun = jeng.unpack_out((jf, ji), k, w), teng.unpack_out((tf, ti), k, w)
    assert set(jun) == set(tun)
    for key in jun:
        np.testing.assert_array_equal(tun[key], np.asarray(jun[key], tun[key].dtype),
                                      err_msg=key)
    assert (tun["wide_vals"][:, ::5] < NEG_INF / 2).all()


def test_m_other_pads_are_dead():
    """test_host_residency.py:270 on the exact backend: lexical and d-tag
    arms at m_other, dead-padded back to m; fusion never takes a pad."""
    lex = ttesting.sample_lexicon()
    store = TStore(device="cpu")
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=120))
    engine = _engine(store, lex)
    emb = ttesting.hash_embed(["timely filing for sunshine health claims"])[0]
    q, _ = engine.prepare_batch([QueryRequest(
        query="timely filing for sunshine health claims",
        embedding=emb / np.linalg.norm(emb), tag_mode="none")])
    q = dict(q, vec=q["vec"].float())
    m, m_oth = 24, 6
    vals, gidx, sigs, _ = teng.arm_candidates(store.index, q, 4, m, m_other=m_oth)
    assert vals.shape == (3, 1, m)
    for arm in (1, 2):
        assert bool((vals[arm, :, m_oth:] < NEG_INF / 2).all())
    out = teng.fuse_and_rerank(vals, gidx, sigs, q, 4, 60, m)
    assert bool(torch.isfinite(out["rerank"]).any())


# ---------------------------------------------------------------------------
# tests/test_proj.py:120-231 and tests/test_ann_incremental.py:167
# ---------------------------------------------------------------------------

def test_funnel_two_stage_recall_on_graded_neardups():
    rng = np.random.default_rng(0)
    nb = 300
    base = _unit_rows(rng, nb)
    recs = []
    for t, eps in enumerate((0.0, 0.05, 0.12, 0.25)):
        v = base + eps * rng.standard_normal((nb, DIM)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        recs += [ChunkRecord(chunk_id=f"g{t}-{i}", doc_id=f"gd{i}", text=f"row {t} {i}",
                             embedding=v[i], authority_level=0) for i in range(nb)]
    store = TStore(_tcfg(over_fetch=2, host_funnel=256, proj_p=DIM // 4), device="cpu")
    store.add_chunks(recs)
    eng = _engine(store)
    k = 8
    q_rows = rng.choice(nb, 16, replace=False)
    qv = base[q_rows] + 0.02 * rng.standard_normal((16, DIM)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    hv = store.host_vectors[:store.size].astype(np.float32) \
        * store.host_scales[:store.size][:, None]
    oracle = np.argsort(-(qv @ hv.T), axis=1)[:, :k]
    res = eng.search([QueryRequest(query="", embedding=qv[i], tag_mode="none", mode="recall")
                      for i in range(16)], k=k)
    recalls = []
    for i, r in enumerate(res):
        got = {h.row for h in r.hits}
        recalls.append(len(got & set(map(int, oracle[i]))) / k)
        assert len(got) == len(r.hits)  # no duplicate rows from the fused+funnel union
    assert float(np.mean(recalls)) >= 0.9, recalls


def test_funnel_wider_is_no_worse():
    rng = np.random.default_rng(0)
    nb = 400
    base = _unit_rows(rng, nb)
    recs = [ChunkRecord(chunk_id=f"c{i}", doc_id=f"d{i}", text=f"r {i}", embedding=base[i],
                        authority_level=0) for i in range(nb)]
    qv = base[:8] + 0.05 * rng.standard_normal((8, DIM)).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    reqs = [QueryRequest(query="", embedding=qv[i], tag_mode="none", mode="recall")
            for i in range(8)]

    def recall_at(funnel):
        store = TStore(_tcfg(over_fetch=2, host_funnel=funnel, proj_p=32), device="cpu")
        store.add_chunks(recs)
        hv = store.host_vectors[:store.size].astype(np.float32) \
            * store.host_scales[:store.size][:, None]
        oracle = np.argsort(-(qv @ hv.T), axis=1)[:, :8]
        res = _engine(store).search(reqs, k=8)
        return float(np.mean([len({h.row for h in r.hits} & set(map(int, oracle[i]))) / 8
                              for i, r in enumerate(res)]))

    narrow, wide = recall_at(16), recall_at(256)
    assert wide >= narrow - 1e-9, (narrow, wide)
    assert wide >= 0.9, wide


def test_pipelined_matches_sync_with_funnel():
    lex = ttesting.sample_lexicon()
    store = TStore(_tcfg(host_funnel=64), device="cpu")
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=64))
    eng = _engine(store, lex)
    reqs = [QueryRequest(query="timely filing deadline"),
            QueryRequest(query="prior authorization dme")]
    sync = [eng.search(r, k=5)[0] for r in reqs]
    piped = eng.search_pipelined([[r] for r in reqs], k=5)
    for a, bl in zip(sync, piped):
        assert [h.chunk_id for h in a.hits] == [h.chunk_id for h in bl[0].hits]


def test_host_residency_incremental():
    """Streaming publish goes through the reserved slabs (no rebuild) and the
    host re-rank serves a real cosine for the fresh row."""
    lex = ttesting.sample_lexicon()
    store = TStore(_tcfg(over_fetch=8, ann_reserve_slabs=2), device="cpu")
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=64))
    eng = _engine(store, lex)
    ann0 = eng.ensure_ann()
    assert eng._local_gating_active()  # gating=auto is local under host residency
    t = "Isogram policy insures heterogram typewriters quarterly."
    rec = featurize_chunk(ChunkRecord(chunk_id="i-c0", doc_id="i_doc", text=t,
                                      embedding=ttesting.hash_embed([t])[0]), lex)
    store.publish_document("i_doc", [rec])
    assert eng.ensure_ann() is ann0 and eng._ann_cursor == 1
    r = eng.search(QueryRequest(query="isogram heterogram typewriters"), k=5)[0]
    assert r.hits and r.hits[0].doc_id == "i_doc"
    assert -1.01 <= r.hits[0].signals["cosine"] <= 1.01


# ---------------------------------------------------------------------------
# build_host, from_ivf's host branch
# ---------------------------------------------------------------------------

def _separated_host_rows(n=600, d=64, clusters=8, seed=0):
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((clusters, d)).astype(np.float32) * 3
    v = centers[rng.integers(0, clusters, n)] + 0.05 * rng.standard_normal((n, d))
    v = (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)
    hv, hs = (np.asarray(a) for a in jax.device_get(jquant.quantize_rows(v)))
    valid = np.ones(n, np.float32)
    valid[::17] = 0
    return np.array(hv), np.array(hs), valid


@pytest.mark.parametrize("sample,block", [(300, 128), (10_000, 250)])
def test_build_host_matches_jax(sample, block):
    hv, hs, valid = _separated_host_rows()
    kw = dict(nlist=8, iters=5, sample=sample, block=block, choices=2, pad_factor=1.1)
    jivf = JIVF.build_host(hv, hs, valid, **kw)
    tivf = TIVF.build_host(hv, hs, valid, device="cpu", **kw)
    assert (tivf.nlist, tivf.pad) == (jivf.nlist, jivf.pad)
    np.testing.assert_allclose(tivf.centroids.numpy(), np.asarray(jivf.centroids), atol=1e-4)
    for f in ("members", "member_valid", "spill", "spill_valid"):
        np.testing.assert_array_equal(getattr(tivf, f).numpy(), np.asarray(getattr(jivf, f)),
                                      err_msg=f)


def test_build_host_empty():
    hv, hs, _ = _separated_host_rows(n=40)
    t = TIVF.build_host(hv, hs, np.zeros(40), device="cpu", nlist=4)
    j = JIVF.build_host(hv, hs, np.zeros(40), nlist=4)
    assert (t.nlist, t.pad, t.spill_count) == (j.nlist, j.pad, j.spill_count) == (4, 8, 0)


def _aniso_host_rows(n=800, d=48, seed=0):
    """Rows with a decaying spectrum (test_torch_proj.py's _aniso), so the
    residual PCA's eigenvalues are separated and the subspace determined;
    quantized by the JAX package."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)) * (1.0 / (1.0 + np.arange(d)))[None, :]
    x = x + 0.3 * rng.standard_normal((8, d))[rng.integers(0, 8, n)]
    x = (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)
    hv, hs = (np.array(a) for a in jax.device_get(jquant.quantize_rows(x)))
    valid = np.ones(n, np.float32)
    valid[::13] = 0
    return hv, hs, valid


@pytest.fixture(scope="module")
def host_tables():
    hv, hs, valid = _aniso_host_rows()
    jivf = JIVF.build_host(hv, hs, valid, nlist=8, iters=5, pad_factor=1.05, choices=1)
    assert jivf.spill_count > 0  # the spill slabs are exercised
    tivf = TIVF(*(torch.from_numpy(np.array(getattr(jivf, f))) for f in JIVF.FIELDS),
                nlist=jivf.nlist, pad=jivf.pad)
    return hv, hs, jivf, tivf


def test_from_ivf_host_branch_equals_device_branch(host_tables):
    hv, hs, _, tivf = host_tables
    host = tproj.PackedProj.from_ivf(tivf, hv, p=16, row_scales=hs, reserve_slabs=2)
    dev = tproj.PackedProj.from_ivf(tivf, torch.from_numpy(hv), p=16,
                                    row_scales=torch.from_numpy(hs), reserve_slabs=2)
    assert host.aux == dev.aux
    for f in tproj.PackedProj.FIELDS:
        assert torch.equal(getattr(host, f), getattr(dev, f)), f
    np.testing.assert_array_equal(host.build_rowids, dev.build_rowids)


def test_from_ivf_host_branch_matches_jax(host_tables):
    hv, hs, jivf, tivf = host_tables
    jpp = jproj.PackedProj.from_ivf(jivf, hv, p=16, row_scales=hs, reserve_slabs=2)
    tpp = tproj.PackedProj.from_ivf(tivf, hv, p=16, row_scales=hs, reserve_slabs=2)
    assert tpp.aux == tuple(jpp.tree_flatten()[1])
    for f in ("valid", "rowids"):
        np.testing.assert_array_equal(getattr(tpp, f).numpy(), np.asarray(getattr(jpp, f)))
    np.testing.assert_allclose(tpp.centroids.numpy(), np.asarray(jpp.centroids), atol=1e-6)
    pj, pt = np.asarray(jpp.proj, np.float64), tpp.proj.numpy().astype(np.float64)
    np.testing.assert_allclose(pt.T @ pt, pj.T @ pj, atol=1e-4)  # the same subspace
    sign = np.sign(np.sum(pt * pj, axis=1))
    live = np.asarray(jpp.valid) > 0
    ct = tpp.codes.numpy().astype(np.int32)[live] * sign.astype(np.int32)[None, :]
    cj = np.asarray(jpp.codes).astype(np.int32)[live]
    assert np.abs(ct - cj).max() <= 1 and (ct == cj).mean() >= 0.99


# ---------------------------------------------------------------------------
# the engine against the JAX engine, and the host re-rank on a shared output
# ---------------------------------------------------------------------------

QUERIES = [
    ("What is the timely filing deadline for Sunshine Health FL Medicaid claims?", {}),
    ("prior authorization for durable medical equipment", {}),
    ("molina eligibility verification", {"payer": "molina"}),
    ("telehealth behavioral health outpatient", {"tag_mode": "relaxed", "mode": "recall"}),
    ("grievances and appeals timeline", {"payer": "aetna", "min_similarity": 0.1}),
    ("", {"payer": "sunshine_health"}),  # no lexical buckets at all
]
_PARITY = dict(over_fetch=8, ivf_nlist=8, proj_p=64, lexical_format="sparse", host_funnel=64)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    js = JStore(_jcfg(**_PARITY))
    js.add_chunks(jtesting.toy_corpus(jtesting.sample_lexicon(), pad_docs=120))
    ts = TStore(_tcfg(**_PARITY), device="cpu")
    ts.add_chunks(ttesting.toy_corpus(ttesting.sample_lexicon(), pad_docs=120))
    je = JEngine(js, jtesting.sample_lexicon(), cfg=js.cfg, embed_fn=jtesting.hash_embed)
    te = _engine(ts)
    path = os.path.join(str(tmp_path_factory.mktemp("ann_host")), "ann.npz")
    je.save_ann(path)
    te.load_ann(path)
    emb = jtesting.hash_embed(["prior authorization for durable medical equipment"])[0]
    jreqs = [JRequest(query=q, embedding=None if q else emb, **kw) for q, kw in QUERIES]
    treqs = [QueryRequest(query=q, embedding=None if q else emb, **kw) for q, kw in QUERIES]
    return dict(js=js, ts=ts, je=je, te=te, jreqs=jreqs, treqs=treqs,
                jres=je.search(jreqs, k=8), tres=te.search(treqs, k=8))


def test_host_arrays_match_jax(both):
    np.testing.assert_array_equal(both["ts"].host_vectors, both["js"].host_vectors)
    np.testing.assert_array_equal(both["ts"].host_scales, both["js"].host_scales)


@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_engine_matches_jax(both, i):
    a, b = both["jres"][i], both["tres"][i]
    assert b.telemetry["strict_count"] == a.telemetry["strict_count"]
    sa = np.array([h.score for h in a.hits])
    sb = np.array([h.score for h in b.hits])
    assert len(sa) == len(sb)
    np.testing.assert_allclose(sb, sa, rtol=0, atol=ATOL)
    np.testing.assert_allclose([h.signals["cosine"] for h in b.hits],
                               [h.signals["cosine"] for h in a.hits], rtol=0, atol=ATOL)
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


def test_engine_parity_exercises_the_funnel(both):
    te = both["te"]
    assert te._device_k(8) == 64 and te._device_funnel(8) == 64
    assert te._local_gating_active() and te._ann_gate is not None
    assert sum(bool(r.hits) for r in both["tres"]) >= 4


def test_host_rerank_identical_on_shared_out(both):
    """Both packages' _host_rerank on one unpacked device output (the JAX
    program's): the same host numpy arithmetic, so identical arrays."""
    je, te = both["je"], both["te"]
    jreqs, treqs = both["jreqs"], both["treqs"]
    k = 8
    kd, fw = je._device_k(k), je._device_funnel(k)
    je.ensure_ann()
    jq, jexps = je.prepare_batch(jreqs)
    _, texps = te.prepare_batch(treqs)
    local = je._ensure_local_structs(je._ann)
    out = jeng.unpack_out(jax.device_get(jeng._search_compiled(
        je.store.index, jq, kd, je.cfg.over_fetch, je.cfg.rrf_k, je._ann,
        je.effective_nprobe, fw, 0.0, local, je._batch_tag_level(jexps))), kd, w=fw)
    out = {key: np.array(v) for key, v in out.items()}
    want = je._host_rerank(jreqs, jexps, dict(out), k)
    got = te._host_rerank(treqs, texps, dict(out), k)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], np.asarray(want[key]), err_msg=key)


def test_local_lexical_arm_with_no_buckets(both):
    """A batch whose requests have no lexical buckets (empty query text):
    the candidate-local lexical arm returns m dead entries, as the JAX
    engine's bucket-padded union scores nothing (the port shipped the
    union at its exact size and failed on the empty one)."""
    te = both["te"]
    q, exps = te.prepare_batch([both["treqs"][-1]])
    assert not q["lex_weights"].any() and q["lex_buckets"].numel() == 128
    k = 8
    qmeta, qbits = tproj.encode_qmeta(q, q["strict_total"] >= k)
    vals, idx, best = gating.lexical_candidates_local(te.store.index, q, qmeta, qbits, 16,
                                                      te._batch_tag_level(exps))
    assert vals.shape == idx.shape == (1, 16)
    assert bool((vals <= NEG_INF / 2).all()) and float(best[0]) == 0.0


def test_bulk_load_keeps_the_store_capacity():
    """The JAX store's bulk_load sizes the index from N alone, dropping the
    headroom a caller built the store with (so bench_10m.py's reserved
    ingest room is lost and the first insert doubles the host matrix);
    the port keeps max(N, the store's capacity)."""
    recs = ttesting.toy_corpus(ttesting.sample_lexicon(), pad_docs=10)
    jrecs = jtesting.toy_corpus(jtesting.sample_lexicon(), pad_docs=10)
    ts = TStore(_tcfg(), capacity=3000, device="cpu")
    js = JStore(_jcfg(), capacity=3000)
    ts.bulk_load(recs)
    js.bulk_load(jrecs)
    assert ts.capacity == ts.host_vectors.shape[0] == 3072
    assert js.capacity == 1024  # the JAX store's fault (ROADMAP queue 3)
