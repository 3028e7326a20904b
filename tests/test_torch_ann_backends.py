"""The ivf and packed vector backends of the port (index/ivf.py: PackedIVF,
ivf_search, ivf_search_packed, calibrate_nprobe), the ann files of all four
table classes (index/ann_io.py) and the engine's ivf, packed and pq
backends, held to the JAX package on the same numpy inputs.

Tolerances, with their reasons:
- PackedIVF.from_ivf on the same IVF tables: int8 values and row ids
  bitwise (the same quantizer, float32 step for step), scales and the
  spill slabs' centroids within 1e-6 (the float32 max-abs product;
  numpy's mean on both sides).
- ivf_search: scores within 1e-5 (a float32 dot of D terms summed in
  another order), ids equal except inside runs of scores tied within
  1e-6.
- ivf_search_packed on tables carried across: scores and ids bitwise
  (int8 dots summed exactly in int32, the same float32 epilogue in the
  same order, the same stable selection with its NEG_INF seeds).
- calibrate_nprobe, given the same query sample: the same curve and pick
  (well-separated clusters: no near-ties at the k-th score).
- The engine on the corpus of tests/test_vector_backend.py with the JAX
  engine's tables carried across through the ann file: hits equal by
  chunk id, scores within 1e-5 (test_torch_engine.check_results), for
  search and search_pipelined.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu.config import get_config as jget_config
from mobius_rag_tpu.index import ann_io as jann_io
from mobius_rag_tpu.index import ivf as jivf
from mobius_rag_tpu.index.store import ChunkStore as JStore
from mobius_rag_tpu.ops import pq as jpq
from mobius_rag_tpu.ops import proj as jproj
from mobius_rag_tpu.query.engine import QueryRequest as JRequest, SearchEngine as JEngine
from mobius_rag_tpu_torch import testing as ttesting
from mobius_rag_tpu_torch.config import get_config as tget_config
from mobius_rag_tpu_torch.index import ann_io as tann_io
from mobius_rag_tpu_torch.index import ivf as tivf
from mobius_rag_tpu_torch.index.store import ChunkRecord, ChunkStore as TStore
from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk
from mobius_rag_tpu_torch.ops import pq as tpq
from mobius_rag_tpu_torch.ops.topk import NEG_INF
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine
from test_torch_engine import check_results

torch.set_num_threads(1)

SCORE_TOL = 1e-5
TIE = 1e-6
SCALE_TOL = 1e-6


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def _clustered(n=1200, d=64, ncent=24, noise=0.08, seed=0):
    rng = np.random.default_rng(seed)
    centers = _unit(rng.standard_normal((ncent, d)))
    return _unit(centers[rng.integers(0, ncent, n)]
                 + noise * rng.standard_normal((n, d)).astype(np.float32)), rng


def _jtables(jann):
    return {f: np.asarray(getattr(jann, f)) for f in type(jann).FIELDS}, jann.tree_flatten()[1]


def _carry(cls, jann):
    arrays, aux = _jtables(jann)
    return cls.from_numpy(arrays, aux, "cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def check_topk(got, want, atol=SCORE_TOL):
    """Scores within atol; ids equal wherever the JAX scores are not tied
    (within TIE) with a neighbour."""
    gv, gi = (x.numpy() for x in got)
    wv, wi = (np.asarray(x) for x in want)
    np.testing.assert_allclose(gv, wv, rtol=0, atol=atol)
    tied = np.zeros(wv.shape, bool)
    d = np.abs(np.diff(wv, axis=1)) <= TIE
    tied[:, 1:] |= d
    tied[:, :-1] |= d
    np.testing.assert_array_equal(gi[~tied], wi[~tied])


@pytest.fixture(scope="module")
def built():
    """A clustered corpus, its JAX IVF tables (a tight pad, so rows spill),
    and the same tables in the port."""
    v, rng = _clustered()
    jv = jnp.asarray(v)
    ivf = jivf.IVFIndex.build(jv, nlist=16, pad_factor=1.1, choices=1)
    assert ivf.spill_count > 0
    q = _unit(v[rng.choice(len(v), 6, replace=False)]
              + 0.05 * rng.standard_normal((6, v.shape[1])).astype(np.float32))
    return {"v": v, "jv": jv, "ivf": ivf, "tivf": _carry(tivf.IVFIndex, ivf), "q": q,
            "rng": rng}


# ---------------------------------------------------------------------------
# PackedIVF.from_ivf
# ---------------------------------------------------------------------------

def _check_packed(tp, jp):
    np.testing.assert_array_equal(tp.values.numpy(), np.asarray(jp.values))
    np.testing.assert_array_equal(tp.rowids.numpy(), np.asarray(jp.rowids))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    np.testing.assert_allclose(tp.scales.numpy(), np.asarray(jp.scales), rtol=0, atol=SCALE_TOL)
    np.testing.assert_allclose(tp.centroids.numpy(), np.asarray(jp.centroids),
                               rtol=0, atol=SCALE_TOL)
    assert tp.aux == jp.tree_flatten()[1]


@pytest.mark.parametrize("block", [65536, 40])
def test_packed_from_ivf_matches_jax(built, block):
    """Float32 rows; block=40 walks several shifted fill blocks."""
    jp = jivf.PackedIVF.from_ivf(built["ivf"], built["jv"], block=block)
    tp = tivf.PackedIVF.from_ivf(built["tivf"], _t(built["v"]), block=block)
    assert tp.nlist > tp.base_nlist  # spill slabs
    _check_packed(tp, jp)


def test_packed_from_int8_source_needs_row_scales(built):
    """Rows already int8 with their per-row scales: the packed scales carry
    the rows' magnitudes (scale x row scale), as in the JAX package."""
    from mobius_rag_tpu.ops.quant import quantize_rows

    q8, sc = quantize_rows(built["jv"])
    jp = jivf.PackedIVF.from_ivf(built["ivf"], q8, row_scales=sc)
    tp = tivf.PackedIVF.from_ivf(built["tivf"], _t(np.array(q8)),
                                 row_scales=_t(np.array(sc)))
    _check_packed(tp, jp)
    unscaled = tivf.PackedIVF.from_ivf(built["tivf"], _t(np.array(q8)))
    assert not np.allclose(unscaled.scales.numpy(), tp.scales.numpy())


# ---------------------------------------------------------------------------
# ivf_search (the row-gather scan)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("pen_form", ["c", "bc"])
def test_ivf_search_matches_jax(built, dtype, pen_form):
    from mobius_rag_tpu.ops.quant import quantize_rows

    v, q, rng = built["v"], built["q"], np.random.default_rng(3)
    scales_j = scales_t = None
    if dtype == "int8":
        jrows, jsc = quantize_rows(built["jv"])
        trows, scales_t = _t(np.array(jrows)), _t(np.array(jsc))
        scales_j = jsc
    elif dtype == "bfloat16":
        jrows, trows = built["jv"].astype(jnp.bfloat16), _t(v).to(torch.bfloat16)
    else:
        jrows, trows = built["jv"], _t(v)
    shape = (len(v),) if pen_form == "c" else (len(q), len(v))
    pen = np.where(rng.random(shape) < 0.3, NEG_INF, 0.0).astype(np.float32)
    for nprobe in (2, 16):
        want = jivf.ivf_search(built["ivf"], jrows, jnp.asarray(q), jnp.asarray(pen), 10,
                               nprobe, scales_j)
        got = tivf.ivf_search(built["tivf"], trows, _t(q), _t(pen), 10, nprobe, scales_t)
        check_topk(got, want)


def test_ivf_search_chunks_queries(built, monkeypatch):
    """The query chunking (one query a chunk here) changes no id and no
    score beyond the float32 rounding of a product batched otherwise
    (the batched matrix-vector product may block its sums by batch size)."""
    args = (built["tivf"], _t(built["v"]), _t(built["q"]),
            torch.zeros(len(built["v"])), 10, 4)
    whole = tivf.ivf_search(*args)
    monkeypatch.setattr(tivf, "_GATHER_BYTES", 1)
    check_topk(tivf.ivf_search(*args), whole, atol=1e-6)


# ---------------------------------------------------------------------------
# ivf_search_packed on tables carried across
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pen_form", ["c", "bc"])
@pytest.mark.parametrize("nprobe", [1, 3, 16])
def test_ivf_search_packed_bitwise(built, pen_form, nprobe):
    """Bitwise with the JAX scan; the spill slabs are probed by every
    query (nprobe=1 leaves them most of the answer)."""
    jp = jivf.PackedIVF.from_ivf(built["ivf"], built["jv"])
    tp = _carry(tivf.PackedIVF, jp)
    assert tp.nlist > tp.base_nlist
    q, n = built["q"], len(built["v"])
    rng = np.random.default_rng(nprobe)
    shape = (n,) if pen_form == "c" else (len(q), n)
    pen = np.where(rng.random(shape) < 0.4, NEG_INF, 0.0).astype(np.float32)
    wv, wi = jivf.ivf_search_packed(jp, jnp.asarray(q), jnp.asarray(pen), 12, nprobe)
    gv, gi = tivf.ivf_search_packed(tp, _t(q), _t(pen), 12, nprobe)
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))


def test_ivf_search_packed_fewer_live_rows_than_k(built):
    """A filter that leaves fewer than k rows live: the live rows first,
    then NEG_INF entries with row 0 (the JAX scan's seeds), bitwise."""
    jp = jivf.PackedIVF.from_ivf(built["ivf"], built["jv"])
    tp = _carry(tivf.PackedIVF, jp)
    q, n = built["q"], len(built["v"])
    pen = np.full((len(q), n), NEG_INF, np.float32)
    live = np.random.default_rng(9).choice(n, 5, replace=False)
    pen[:, live] = 0.0
    pen[0] = NEG_INF  # one query with no live row at all
    wv, wi = (np.asarray(x) for x in jivf.ivf_search_packed(
        jp, jnp.asarray(q), jnp.asarray(pen), 20, 16))
    gv, gi = tivf.ivf_search_packed(tp, _t(q), _t(pen), 20, 16)
    np.testing.assert_array_equal(gv.numpy(), wv)
    np.testing.assert_array_equal(gi.numpy(), wi)
    dead = wv <= NEG_INF / 2
    assert dead.sum(axis=1).min() >= 15 and dead[0].all()
    assert (wi[dead] == 0).all() and (wv[dead] == np.float32(NEG_INF)).all()


# ---------------------------------------------------------------------------
# calibrate_nprobe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["ivf", "packed"])
def test_calibrate_nprobe_matches_jax(kind):
    """Given the same query sample, the same curve and the same pick, and
    the pick meets the target."""
    v, rng = _clustered(n=4000, d=64, ncent=64, noise=0.05, seed=4)
    jv = jnp.asarray(v)
    ivf = jivf.IVFIndex.build(jv, nlist=64)
    q = _unit(v[rng.choice(len(v), 16, replace=False)]
              + 0.02 * rng.standard_normal((16, v.shape[1])).astype(np.float32))
    if kind == "ivf":
        jann, tann = ivf, _carry(tivf.IVFIndex, ivf)
    else:
        jann = jivf.PackedIVF.from_ivf(ivf, jv)
        tann = _carry(tivf.PackedIVF, jann)
    want = jivf.calibrate_nprobe(jann, jv, q, k=10, target_recall=0.95)
    got = tivf.calibrate_nprobe(tann, _t(v), q, k=10, target_recall=0.95)
    assert got == want
    assert next(p for p in got["curve"] if p["nprobe"] == got["nprobe"])["recall"] >= 0.95
    assert len(got["curve"]) > 1


# ---------------------------------------------------------------------------
# ann files, all four classes, both ways
# ---------------------------------------------------------------------------

def _jax_tables(built):
    ivf, jv = built["ivf"], built["jv"]
    return {"IVFIndex": ivf, "PackedIVF": jivf.PackedIVF.from_ivf(ivf, jv),
            "PackedPQ": jpq.PackedPQ.from_ivf(ivf, jv, m=8, iters=4),
            "PackedProj": jproj.PackedProj.from_ivf(ivf, jv, p=16, reserve_slabs=1)}


@pytest.mark.parametrize("name", ["IVFIndex", "PackedIVF", "PackedPQ", "PackedProj"])
def test_ann_files_both_ways(built, tmp_path, name):
    jann = _jax_tables(built)[name]
    arrays, aux = _jtables(jann)
    jpath, tpath = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jann_io.save_ann(jann, jpath, meta={"backend": name, "rows": 7})
    got, meta = tann_io.load_ann(jpath, "cpu")
    assert type(got).__name__ == name and meta == {"backend": name, "rows": 7}
    assert tuple(got.aux) == tuple(aux)
    for f in type(got).FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(), arrays[f])
    tann_io.save_ann(got, tpath, meta={"backend": name, "rows": 7})
    back, meta = jann_io.load_ann(tpath, to_device=False)
    assert type(back).__name__ == name and meta["rows"] == 7
    assert back.tree_flatten()[1] == tuple(aux)
    for f in type(got).FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), arrays[f])


# ---------------------------------------------------------------------------
# the engine: ivf, packed and pq backends
# ---------------------------------------------------------------------------

QUERIES = [
    ("What is the timely filing deadline for Sunshine Health FL Medicaid claims?", {}),
    ("prior authorization for durable medical equipment", {}),
    ("molina eligibility verification", {"payer": "molina"}),
    ("grievances and appeals timeline", {"tag_mode": "relaxed"}),
    ("telehealth behavioral health outpatient", {"mode": "recall", "min_similarity": 0.1}),
    ("timely filing", {"payer": "not_a_payer"}),
]
BACKENDS = {"ivf": dict(ivf_nprobe=4), "packed": dict(ivf_nprobe=4),
            "pq": dict(ivf_nprobe=4, pq_m=32)}


@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """JAX and port engines per backend over tests/test_vector_backend.py's
    corpus, the JAX engine's tables carried to the port through its ann
    file, with each one's search and search_pipelined results."""
    jlex, tlex = jtesting.sample_lexicon(), ttesting.sample_lexicon()
    js, ts = JStore(), TStore(device="cpu")
    js.add_chunks(jtesting.toy_corpus(jlex, pad_docs=200))
    ts.add_chunks(ttesting.toy_corpus(tlex, pad_docs=200))
    jreqs = [JRequest(query=q, **kw) for q, kw in QUERIES]
    treqs = [QueryRequest(query=q, **kw) for q, kw in QUERIES]
    out = {}
    for backend, fields in BACKENDS.items():
        jcfg = dataclasses.replace(jget_config(), vector_backend=backend, **fields)
        tcfg = dataclasses.replace(tget_config(), vector_backend=backend, **fields)
        je = JEngine(js, jlex, cfg=jcfg, embed_fn=jtesting.hash_embed)
        te = SearchEngine(ts, tlex, cfg=tcfg, embed_fn=ttesting.hash_embed, device="cpu")
        path = str(tmp_path_factory.mktemp(backend) / "ann.npz")
        je.save_ann(path)
        te.load_ann(path)
        out[backend] = dict(je=je, te=te, jres=je.search(jreqs, k=8),
                            tres=te.search(treqs, k=8),
                            jpiped=je.search_pipelined([jreqs[:3], jreqs[3:]], k=8),
                            tpiped=te.search_pipelined([treqs[:3], treqs[3:]], k=8))
    return out


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("i", range(len(QUERIES)))
def test_engine_search_matches_jax(engines, backend, i):
    r = engines[backend]
    check_results(r["jres"], r["tres"], i)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_engine_pipelined_matches_jax(engines, backend):
    r = engines[backend]
    jflat = [x for b in r["jpiped"] for x in b]
    tflat = [x for b in r["tpiped"] for x in b]
    for i in range(len(tflat)):
        check_results(jflat, tflat, i)
    # and equal to the port's own search, batch by batch
    for a, b in zip(tflat, r["tres"]):
        assert [(h.chunk_id, h.score) for h in a.hits] == [(h.chunk_id, h.score)
                                                         for h in b.hits]


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_engine_serves_the_backend_tables(engines, backend):
    te = engines[backend]["te"]
    cls = {"ivf": tivf.IVFIndex, "packed": tivf.PackedIVF, "pq": tpq.PackedPQ}[backend]
    assert isinstance(te._ann, cls)
    assert any(res.hits for res in engines[backend]["tres"])


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_backend_respects_filters(engines, backend):
    """tests/test_vector_backend.py::test_ivf_backend_respects_filters for
    each backend: a payer no row has admits nothing; a payer filter admits
    only that payer's rows (and the inheritable regulator rows)."""
    te = engines[backend]["te"]
    assert engines[backend]["tres"][-1].hits == []
    res = te.search(QueryRequest(query="eligibility verification", payer="molina",
                                 inherit_authority=False), k=8)[0]
    assert res.hits and all(h.metadata["payer"] == "molina" for h in res.hits)


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_ann_rebuilds_after_publish(backend):
    """Store mutations bump the generation; the ivf, packed and pq tables
    rebuild on the next search (only proj updates in place), so a fresh
    publish is findable."""
    lex = ttesting.sample_lexicon()
    store = TStore(device="cpu")
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=50))
    cfg = dataclasses.replace(tget_config(), vector_backend=backend, ivf_nprobe=10 ** 6,
                              pq_m=32)
    eng = SearchEngine(store, lex, cfg=cfg, embed_fn=ttesting.hash_embed, device="cpu")
    eng.search(QueryRequest(query="warm"), k=3)
    gen0, tables0 = eng._ann_generation, eng._ann
    text = "Quokka Plan covers quokka chiropractic adjustments with prior approval."
    store.publish_document("quokka_doc", [featurize_chunk(ChunkRecord(
        chunk_id="quokka-c0", doc_id="quokka_doc", text=text,
        embedding=ttesting.hash_embed([text])[0]), lex)])
    res = eng.search(QueryRequest(query="quokka chiropractic adjustments"), k=3)[0]
    assert eng._ann_generation != gen0 and eng._ann is not tables0
    assert any(h.doc_id == "quokka_doc" for h in res.hits)


# ---------------------------------------------------------------------------
# auto-nprobe through the engine
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["ivf", "packed"])
def test_engine_auto_nprobe_meets_target(backend):
    """MRAG_IVF_TARGET_RECALL: ensure_ann calibrates and the engine serves
    the pick; the pick's recall on the calibration sample meets the target
    (or is the full probe)."""
    lex = ttesting.sample_lexicon()
    store = TStore(device="cpu")
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=150))
    cfg = dataclasses.replace(tget_config(), vector_backend=backend,
                              ivf_target_recall=0.95, ivf_nprobe=1)
    eng = SearchEngine(store, lex, cfg=cfg, embed_fn=ttesting.hash_embed, device="cpu")
    assert eng.search(QueryRequest(query="timely filing deadline"), k=5)[0].hits
    cal = eng._ann_calibration
    assert cal["nprobe"] == eng.effective_nprobe and cal["logged_queries"] == 0
    nlist = getattr(eng._ann, "base_nlist", eng._ann.nlist)
    pick = next(p for p in cal["curve"] if p["nprobe"] == cal["nprobe"])
    assert pick["recall"] >= 0.95 or cal["nprobe"] == nlist
    assert cal["sample_queries"] == 32


def test_engine_auto_nprobe_uses_logged_queries(tmp_path):
    """With a telemetry store attached, the calibration sample starts with
    the recent logged queries (tests/test_quant_ivf.py)."""
    from mobius_rag_tpu_torch.observability import TelemetryStore

    lex = ttesting.sample_lexicon()
    store = TStore(device="cpu")
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=150))
    tel = TelemetryStore(path=str(tmp_path / "tel.sqlite"))
    for q in ("timely filing deadline for sunshine health", "prior authorization for dme",
              "molina eligibility verification"):
        tel.record_search_event(query=q, mode="corpus", timings={}, arms={}, expansion=[],
                                results=[])
    tel.flush()
    cfg = dataclasses.replace(tget_config(), vector_backend="ivf", ivf_target_recall=0.95,
                              ivf_nprobe=1)
    eng = SearchEngine(store, lex, cfg=cfg, embed_fn=ttesting.hash_embed, telemetry=tel,
                       device="cpu")
    assert eng.search(QueryRequest(query="timely filing deadline"), k=5)[0].hits
    assert eng._ann_calibration["logged_queries"] == 3
    assert eng._ann_calibration["nprobe"] == eng.effective_nprobe


def test_engine_ann_file_keeps_the_calibrated_nprobe(tmp_path):
    """save_ann writes the calibrated nprobe; load_ann serves it (the JAX
    engine's meta, either package)."""
    lex = ttesting.sample_lexicon()
    store = TStore(device="cpu")
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=150))
    cfg = dataclasses.replace(tget_config(), vector_backend="packed", ivf_target_recall=0.95,
                              ivf_nprobe=1)
    eng = SearchEngine(store, lex, cfg=cfg, embed_fn=ttesting.hash_embed, device="cpu")
    meta = eng.save_ann(str(tmp_path / "ann.npz"))
    assert meta["nprobe"] == eng.effective_nprobe
    other = SearchEngine(store, lex, cfg=cfg, embed_fn=ttesting.hash_embed, device="cpu")
    other.load_ann(str(tmp_path / "ann.npz"))
    assert other.effective_nprobe == meta["nprobe"] and other._ann_calibration is None
    req = QueryRequest(query="timely filing deadline")
    assert [h.chunk_id for h in other.search(req, k=5)[0].hits] == \
        [h.chunk_id for h in eng.search(req, k=5)[0].hits]
