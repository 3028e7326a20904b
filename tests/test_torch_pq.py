"""Product quantization in the port (ops/pq.py) against the JAX package on
the same numpy inputs, and host residency with the pq backend through the
engine.

Tolerances, with their reasons:
- train_pq: codebooks within 1e-4 (Lloyd's float32 sums in another
  order; the corpus is well separated in every subspace, so no argmin
  flips between the two); encode_pq on the same codebooks: codes equal
  wherever the nearest codeword wins by more than 1e-4 in squared
  distance (float32 distances summed in another order may swap two
  nearly equidistant codewords).
- PackedPQ.from_ivf (device rows, and the host int8 matrix of host
  residency): the same slot layout, codebooks within 1e-4, more than 98%
  of the live codes equal (the same reason), every code equal when both
  fill from the same codebooks, the spill slabs' centroids within 1e-6
  (numpy's mean on both sides).
- pq_search_packed on tables carried across: scores within 1e-5 (the LUT
  sum over M is a float32 reduction in another order), ids equal except
  inside runs of scores tied within 1e-6; the same for
  pq_search_reranked.
- Host residency + pq through the engine, the JAX engine's tables carried
  across through its ann file: hits equal by chunk id, scores within
  1e-5 (test_torch_engine.check_results).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu.config import get_config as jget_config
from mobius_rag_tpu.index import ivf as jivf
from mobius_rag_tpu.index.store import ChunkStore as JStore
from mobius_rag_tpu.ops import pq as jpq
from mobius_rag_tpu.ops.quant import quantize_rows
from mobius_rag_tpu.query.engine import QueryRequest as JRequest, SearchEngine as JEngine
from mobius_rag_tpu_torch import testing as ttesting
from mobius_rag_tpu_torch.config import get_config as tget_config
from mobius_rag_tpu_torch.index import ivf as tivf
from mobius_rag_tpu_torch.index.store import ChunkStore as TStore
from mobius_rag_tpu_torch.ops import pq as tpq
from mobius_rag_tpu_torch.ops.topk import NEG_INF
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine
from test_torch_ann_backends import _carry, _t, _unit, check_topk
from test_torch_engine import check_results

torch.set_num_threads(1)

CODEBOOK_TOL = 1e-4
CENT_TOL = 1e-6


@pytest.mark.parametrize("d,m", [(1536, 96), (256, 96), (256, 32), (200, 96), (30, 7),
                                 (7, 4)])
def test_effective_m(d, m):
    assert tpq.effective_m(d, m) == jpq.effective_m(d, m)


def _separated(n=3000, d=32, m=4, k=6, seed=0):
    """Rows whose every subvector sits in one of k well-separated subspace
    clusters (spread 0.3 around centers 3 apart): Lloyd settles the same
    way in both packages."""
    rng = np.random.default_rng(seed)
    ds = d // m
    centers = rng.standard_normal((m, k, ds)).astype(np.float32) * 3.0
    pick = rng.integers(0, k, (n, m))
    sub = centers[np.arange(m)[None, :], pick] + 0.3 * rng.standard_normal(
        (n, m, ds)).astype(np.float32)
    return sub.reshape(n, d).astype(np.float32)


def _decisive(v, codebooks, margin):
    """[N, M] bool: the nearest codeword of each subvector beats the second
    nearest by more than `margin` in squared distance (float64)."""
    m, _, ds = codebooks.shape
    sub = v.reshape(len(v), m, ds).astype(np.float64)
    d2 = ((sub[:, :, None, :] - codebooks[None].astype(np.float64)) ** 2).sum(-1)
    two = np.sort(d2, axis=2)[:, :, :2]
    return two[..., 1] - two[..., 0] > margin


def test_train_and_encode_match_jax():
    v = _separated()
    want = np.asarray(jpq.train_pq(jnp.asarray(v), 4, iters=6, sample=2000, seed=1))
    got = tpq.train_pq(_t(v), 4, iters=6, sample=2000, seed=1)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CODEBOOK_TOL)
    # codes on the same (JAX) codebooks, in several blocks: equal wherever
    # the nearest codeword wins by a margin (within a cluster many of the
    # 256 codewords lie close together, and float32 distances summed in
    # another order may swap two nearly equidistant ones)
    cb = jnp.asarray(want)
    got_codes = tpq.encode_pq(_t(v), _t(want), block=700)
    want_codes = jpq.encode_pq(jnp.asarray(v), cb, block=700)
    decisive = _decisive(v, want, 1e-4)
    assert decisive.mean() > 0.99
    np.testing.assert_array_equal(got_codes[decisive], want_codes[decisive])
    # numpy rows train on the CPU the same way
    np.testing.assert_array_equal(tpq.train_pq(v, 4, iters=6, sample=2000, seed=1).numpy(),
                                  got.numpy())


def test_kmeans_groups_of_subspaces_change_nothing(monkeypatch):
    """Training and encoding a few subspaces at a time (the transients'
    bound) gives the same codebooks and codes as all at once."""
    v = _separated(m=8)
    whole = tpq.train_pq(_t(v), 8, iters=4, sample=1000)
    codes = tpq.encode_pq(_t(v), whole)
    monkeypatch.setattr(tpq, "_GROUP_ELEMS", 1)
    assert torch.equal(tpq.train_pq(_t(v), 8, iters=4, sample=1000), whole)
    np.testing.assert_array_equal(tpq.encode_pq(_t(v), whole), codes)


@pytest.fixture(scope="module")
def built():
    """A clustered corpus and its JAX IVF tables with spill rows."""
    rng = np.random.default_rng(2)
    n, d, ncent = 1500, 64, 20
    centers = _unit(rng.standard_normal((ncent, d)))
    v = _unit(centers[rng.integers(0, ncent, n)]
              + 0.08 * rng.standard_normal((n, d)).astype(np.float32))
    jv = jnp.asarray(v)
    ivf = jivf.IVFIndex.build(jv, nlist=16, pad_factor=1.1, choices=1)
    assert ivf.spill_count > 0
    q = _unit(v[rng.choice(n, 6, replace=False)]
              + 0.05 * rng.standard_normal((6, d)).astype(np.float32))
    return {"v": v, "jv": jv, "ivf": ivf, "tivf": _carry(tivf.IVFIndex, ivf), "q": q}


def _check_pq_tables(tp, jp):
    assert tp.aux == jp.tree_flatten()[1]
    np.testing.assert_array_equal(tp.rowids.numpy(), np.asarray(jp.rowids))
    np.testing.assert_array_equal(tp.valid.numpy(), np.asarray(jp.valid))
    np.testing.assert_allclose(tp.centroids.numpy(), np.asarray(jp.centroids),
                               rtol=0, atol=CENT_TOL)
    np.testing.assert_allclose(tp.codebooks.numpy(), np.asarray(jp.codebooks),
                               rtol=0, atol=CODEBOOK_TOL)
    codes, want = tp.codes.numpy(), np.asarray(jp.codes)
    live = np.asarray(jp.valid) > 0
    # a residual's subvector near two codewords may take either: all but a
    # few codes equal, and the codes on the same codebooks equal exactly
    assert (codes[live] == want[live]).mean() > 0.98


@pytest.mark.parametrize("residual", [True, False])
def test_packed_pq_from_ivf_device_rows(built, residual):
    jp = jpq.PackedPQ.from_ivf(built["ivf"], built["jv"], m=8, iters=5, residual=residual)
    tp = tpq.PackedPQ.from_ivf(built["tivf"], _t(built["v"]), m=8, iters=5, residual=residual)
    assert tp.nlist > tp.base_nlist
    _check_pq_tables(tp, jp)


def test_packed_pq_encodes_like_jax_on_its_codebooks(built, monkeypatch):
    """Given the JAX codebooks, the port's fill writes the JAX codes
    exactly (every slot, the invalid ones too)."""
    jp = jpq.PackedPQ.from_ivf(built["ivf"], built["jv"], m=8, iters=5)
    monkeypatch.setattr(tpq, "train_pq", lambda *a, **kw: torch.from_numpy(
        np.array(jp.codebooks)))
    tp = tpq.PackedPQ.from_ivf(built["tivf"], _t(built["v"]), m=8, iters=5, block=64)
    np.testing.assert_array_equal(tp.codes.numpy(), np.asarray(jp.codes))


def test_packed_pq_from_ivf_host_rows(built):
    """The host form (an int8 numpy matrix with row scales, the codes-only
    10M regime) against the JAX host form, and against the port's device
    form on the same rows."""
    q8, sc = (np.array(x) for x in quantize_rows(built["jv"]))
    jp = jpq.PackedPQ.from_ivf(built["ivf"], q8, m=8, iters=5, row_scales=sc)
    tp = tpq.PackedPQ.from_ivf(built["tivf"], q8, m=8, iters=5, row_scales=sc)
    _check_pq_tables(tp, jp)
    dev = tpq.PackedPQ.from_ivf(built["tivf"], _t(q8), m=8, iters=5, row_scales=_t(sc))
    for f in tpq.PackedPQ.FIELDS:
        assert torch.equal(getattr(dev, f), getattr(tp, f)), f


@pytest.mark.parametrize("residual", [True, False])
@pytest.mark.parametrize("pen_form", ["c", "bc"])
@pytest.mark.parametrize("nprobe", [2, 16])
def test_pq_search_packed_matches_jax(built, residual, pen_form, nprobe):
    jp = jpq.PackedPQ.from_ivf(built["ivf"], built["jv"], m=8, iters=5, residual=residual)
    tp = _carry(tpq.PackedPQ, jp)
    q, n = built["q"], len(built["v"])
    rng = np.random.default_rng(nprobe)
    shape = (n,) if pen_form == "c" else (len(q), n)
    pen = np.where(rng.random(shape) < 0.3, NEG_INF, 0.0).astype(np.float32)
    want = jpq.pq_search_packed(jp, jnp.asarray(q), jnp.asarray(pen), 12, nprobe)
    check_topk(tpq.pq_search_packed(tp, _t(q), _t(pen), 12, nprobe), want)


def test_pq_search_packed_probe_groups_and_fewer_live_rows(built, monkeypatch):
    """Fewer live rows than k: NEG_INF entries with row 0 after the live
    ones, as the JAX scan's seeds give; scoring a probe at a time changes
    nothing."""
    jp = jpq.PackedPQ.from_ivf(built["ivf"], built["jv"], m=8, iters=5)
    tp = _carry(tpq.PackedPQ, jp)
    q, n = built["q"], len(built["v"])
    pen = np.full((len(q), n), NEG_INF, np.float32)
    pen[:, np.random.default_rng(5).choice(n, 4, replace=False)] = 0.0
    wv, wi = (np.asarray(x) for x in jpq.pq_search_packed(
        jp, jnp.asarray(q), jnp.asarray(pen), 10, 16))
    gv, gi = tpq.pq_search_packed(tp, _t(q), _t(pen), 10, 16)
    check_topk((gv, gi), (wv, wi))
    dead = wv <= NEG_INF / 2
    assert dead.sum(axis=1).min() >= 6
    np.testing.assert_array_equal(gi.numpy()[dead], 0)
    np.testing.assert_array_equal(gv.numpy()[dead], wv[dead])
    monkeypatch.setattr(tpq, "_LUT_ELEMS", 1)
    one = tpq.pq_search_packed(tp, _t(q), _t(pen), 10, 16)
    assert torch.equal(one[0], gv) and torch.equal(one[1], gi)


def test_pq_search_reranked_matches_jax(built):
    q8, sc = (np.array(x) for x in quantize_rows(built["jv"]))
    jp = jpq.PackedPQ.from_ivf(built["ivf"], built["jv"], m=8, iters=5)
    tp = _carry(tpq.PackedPQ, jp)
    q, n = built["q"], len(built["v"])
    pen = np.where(np.random.default_rng(1).random(n) < 0.2, NEG_INF, 0.0).astype(np.float32)
    want = jpq.pq_search_reranked(jp, jnp.asarray(q), jnp.asarray(pen), 5, 4, q8, sc,
                                  over_fetch=4)
    got = tpq.pq_search_reranked(tp, _t(q), _t(pen), 5, 4, q8, sc, over_fetch=4)
    check_topk(got, want)


# ---------------------------------------------------------------------------
# host residency with the pq backend, through the engine
# ---------------------------------------------------------------------------

_HOST_PQ = dict(vector_residency="host", vector_dtype="int8", vector_backend="pq",
                ivf_nprobe=10 ** 6, over_fetch=8, ivf_nlist=8, pq_m=32,
                lexical_format="sparse", host_funnel=64)
HOST_QUERIES = [
    ("timely filing deadline for claims", dict(payer="sunshine_health")),
    ("prior authorization for durable medical equipment", dict(tag_mode="relaxed")),
    ("eligibility verification", dict(payer="molina", state="FL", tag_mode="none")),
    ("grievances and appeals timeline", dict(payer="nonexistent_payer")),
    ("telehealth behavioral health outpatient", dict(mode="recall", min_similarity=0.1)),
]


@pytest.fixture(scope="module")
def host_engines(tmp_path_factory):
    jlex, tlex = jtesting.sample_lexicon(), ttesting.sample_lexicon()
    jcfg = dataclasses.replace(jget_config(), **_HOST_PQ)
    tcfg = dataclasses.replace(tget_config(), **_HOST_PQ)
    js, ts = JStore(jcfg), TStore(tcfg, device="cpu")
    js.add_chunks(jtesting.toy_corpus(jlex, pad_docs=100))
    ts.add_chunks(ttesting.toy_corpus(tlex, pad_docs=100))
    je = JEngine(js, jlex, cfg=jcfg, embed_fn=jtesting.hash_embed)
    te = SearchEngine(ts, tlex, cfg=tcfg, embed_fn=ttesting.hash_embed, device="cpu")
    path = str(tmp_path_factory.mktemp("hostpq") / "ann.npz")
    je.save_ann(path)
    te.load_ann(path)
    jreqs = [JRequest(query=q, **kw) for q, kw in HOST_QUERIES]
    treqs = [QueryRequest(query=q, **kw) for q, kw in HOST_QUERIES]
    return dict(je=je, te=te, jres=je.search(jreqs, k=5), tres=te.search(treqs, k=5),
                tpiped=te.search_pipelined([treqs[:2], treqs[2:]], k=5))


@pytest.mark.parametrize("i", range(len(HOST_QUERIES)))
def test_host_pq_engine_matches_jax(host_engines, i):
    check_results(host_engines["jres"], host_engines["tres"], i)


def test_host_pq_engine_paths(host_engines):
    """The tables are PackedPQ, the store keeps no device rows, the funnel
    and the host re-rank run, gating stays dense (auto is local for proj
    only), and search_pipelined equals search."""
    te = host_engines["te"]
    assert isinstance(te._ann, tpq.PackedPQ)
    assert te.store.index.vectors.shape[0] == 0 and te.store.host_vectors is not None
    assert te._device_k(5) == 40 and te._device_funnel(5) == 64
    assert not te._local_gating_active()
    assert any(r.hits for r in host_engines["tres"])
    flat = [x for b in host_engines["tpiped"] for x in b]
    for a, b in zip(flat, host_engines["tres"]):
        assert [(h.chunk_id, h.score) for h in a.hits] == [(h.chunk_id, h.score)
                                                         for h in b.hits]


def test_host_pq_engine_builds_its_tables():
    """ensure_ann under host residency builds PackedPQ from the host int8
    matrix (no dense rows on the device) and serves the filters."""
    lex = ttesting.sample_lexicon()
    cfg = dataclasses.replace(tget_config(), **_HOST_PQ)
    store = TStore(cfg, device="cpu")
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=60))
    eng = SearchEngine(store, lex, cfg=cfg, embed_fn=ttesting.hash_embed, device="cpu")
    res = eng.search([QueryRequest(query="timely filing deadline", payer="sunshine_health",
                                   inherit_authority=False),
                      QueryRequest(query="timely filing", payer="not_a_payer")], k=5)
    assert isinstance(eng._ann, tpq.PackedPQ) and eng._ann.bytes_per_row == 32
    assert res[0].hits and all(h.metadata["payer"] == "sunshine_health" for h in res[0].hits)
    assert res[1].hits == []
