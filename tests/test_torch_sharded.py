"""Sharded serving in the port (mobius_rag_tpu_torch.parallel) against the
JAX package's ShardedEngine and against the port's own dense engine, on
the same corpus and requests: the twin of tests/test_sharded.py,
test_sharded_dp.py, test_sharded_host.py and test_sharded_serving.py.

The JAX side runs over S of the 8 virtual CPU devices of
tests/conftest.py; the port over ``devices=["cpu"] * S``. Compared: the
fused schema of ``search_arrays`` (rerank, signals, ids) and the
assembled results. Tolerances (tests/test_torch_engine.py's bar): ids
equal except inside runs of scores tied within 1e-6 (the bar for "gaps
above 1e-5" is met a fortiori), floats atol 1e-5, strict counts exact.
ANN tables are carried across from the JAX sharded engine (k-means on
two libraries need not place rows alike), so the per-shard scans and the
merge are what is compared; the port's own per-shard build is checked by
full-probe equality with the exact scan. The ``stack_shard_*`` functions
are held bitwise to the JAX package's on the same per-shard tables.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu.config import get_config as jget_config
from mobius_rag_tpu.index import ivf as jivf
from mobius_rag_tpu.index.store import ChunkRecord as JRecord, ChunkStore as JStore
from mobius_rag_tpu.ingest.featurize import featurize_chunk as jfeaturize
from mobius_rag_tpu.ops import pq as jpq
from mobius_rag_tpu.ops import proj as jproj
from mobius_rag_tpu.parallel.mesh import make_mesh as jmake_mesh, make_serve_mesh as jmake_serve
from mobius_rag_tpu.parallel.sharded import ShardedEngine as JSharded
from mobius_rag_tpu.query.engine import SearchEngine as JEngine
from mobius_rag_tpu_torch import testing as ttesting
from mobius_rag_tpu_torch.config import get_config as tget_config
from mobius_rag_tpu_torch.index import ivf as tivf
from mobius_rag_tpu_torch.index.store import ChunkRecord as TRecord, ChunkStore as TStore
from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk as tfeaturize
from mobius_rag_tpu_torch.ops import pq as tpq
from mobius_rag_tpu_torch.ops import proj as tproj
from mobius_rag_tpu_torch.ops.topk import NEG_INF
from mobius_rag_tpu_torch.parallel import sharded as tsharded
from mobius_rag_tpu_torch.parallel.mesh import make_mesh, make_serve_mesh
from mobius_rag_tpu_torch.parallel.sharded import ShardedEngine, on_one_device
from mobius_rag_tpu_torch.query import compiled
from mobius_rag_tpu_torch.query import engine as tengine
from mobius_rag_tpu_torch.query.engine import SearchEngine as TEngine, search_batch
from test_torch_compiled import (StandIn, _add, _card_batches, _fields, _reads_as_card,
                                 _words, _writes_replay_bitwise)
from test_torch_engine import ATOL, K, TOY_REQUESTS, _jq, _tq, assert_topk_equal, check_results

torch.set_num_threads(1)

FUSED = ["rerank", "sim", "cos", "auth", "len", "jpd", "cov", "rrf", "lexn"]
CPU = ["cpu"] * 8
ZEPHYR = ("Zephyr Plan zymurgy benefit requires prior authorization before the "
          "first fermentation consult.")


def _cfgs(**kw):
    return dataclasses.replace(jget_config(), **kw), dataclasses.replace(tget_config(), **kw)


def _twins(pad_docs=50, **kw):
    """(JAX engine, port engine) over the toy corpus with config `kw`."""
    jcfg, tcfg = _cfgs(**kw)
    jlex, tlex = jtesting.sample_lexicon(), ttesting.sample_lexicon()
    js, ts = JStore(jcfg), TStore(tcfg, device="cpu")
    js.add_chunks(jtesting.toy_corpus(jlex, pad_docs=pad_docs))
    ts.add_chunks(ttesting.toy_corpus(tlex, pad_docs=pad_docs))
    return (JEngine(js, jlex, cfg=jcfg, embed_fn=jtesting.hash_embed),
            TEngine(ts, tlex, cfg=tcfg, embed_fn=ttesting.hash_embed, device="cpu"))


def _reqs(n=len(TOY_REQUESTS)):
    return [_jq(q, kw) for q, kw in TOY_REQUESTS[:n]], [_tq(q, kw) for q, kw in TOY_REQUESTS[:n]]


def check_fused(got, want):
    """The fused schema of two runs: ids and rerank by the engine test's
    rule, every other signal within ATOL at the live positions."""
    assert got["idx"].shape == want["idx"].shape
    assert_topk_equal(got["rerank"], got["idx"], want["rerank"], want["idx"])
    live = want["rerank"] > NEG_INF / 2
    for key in FUSED[1:]:
        np.testing.assert_allclose(got[key][live], want[key][live], rtol=0, atol=ATOL, err_msg=key)


def check_hits(jres, tres, i):
    """check_results on what the JAX sharded engine reports: its fused
    schema carries no arm traces and a strict count of -1, where the port's
    results carry the global ones (held to the dense engine elsewhere)."""
    a = jres[i]
    assert a.telemetry["strict_count"] == -1 and a.telemetry["arms"]["vector"] == []
    assert tres[i].telemetry["strict_count"] >= 0
    check_results([a], [dataclasses.replace(tres[i], telemetry=a.telemetry)], 0)


def _both(je, te, jse, tse, n=len(TOY_REQUESTS), k=K):
    jr, tr = _reqs(n)
    jq, _ = je.prepare_batch(jr)
    tq, _ = te.prepare_batch(tr)
    return jse.search_arrays(jq, k), tse.search_arrays(tq, k), tq


def _dense(te, tq, k=K):
    cfg = te.cfg
    out = search_batch(te.store.index, tq, k, cfg.over_fetch, cfg.rrf_k)
    return {key: out[key].numpy() for key in FUSED + ["idx"]}


# ---------------------------------------------------------------------------
# the device grid
# ---------------------------------------------------------------------------

def test_mesh_shapes():
    m = make_serve_mesh(2, 4, devices=CPU)
    assert m.shape == {"data": 2, "shard": 4}
    assert make_serve_mesh(2, devices=CPU).shape == {"data": 2, "shard": 4}
    assert make_mesh(devices=CPU[:3]).shape == {"shard": 3}
    assert [len(g) for g in m.groups("shard")] == [4, 4]
    assert make_mesh(2, devices=["cpu", "cpu"]).groups("shard") == [[torch.device("cpu")] * 2]
    with pytest.raises(ValueError):
        make_serve_mesh(4, 4, devices=CPU)
    with pytest.raises(ValueError):
        make_mesh(9, devices=CPU)


# ---------------------------------------------------------------------------
# exact backend, dense lexical: S = 1, 2, 4, 8
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def toy():
    je, te = _twins()
    return {"je": je, "te": te, "runs": {}}


def _exact_run(toy, s):
    if s not in toy["runs"]:
        je, te = toy["je"], toy["te"]
        jse = JSharded(je.store, mesh=jmake_mesh(s))
        tse = ShardedEngine(te.store, mesh=make_mesh(s, devices=CPU))
        toy["runs"][s] = _both(je, te, jse, tse) + (tse,)
    return toy["runs"][s]


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_exact_matches_jax(toy, s):
    jout, tout, _, _ = _exact_run(toy, s)
    check_fused(tout, jout)


@pytest.mark.parametrize("s", [1, 2, 4, 8])
def test_exact_matches_dense(toy, s):
    """The merge reproduces the one-device engine: global ranks from the
    shards' lists and the global strict count."""
    _, tout, tq, _ = _exact_run(toy, s)
    check_fused(tout, _dense(toy["te"], tq))
    if s == 1:  # one shard is the dense program itself
        want = _dense(toy["te"], tq)
        for key in FUSED + ["idx"]:
            np.testing.assert_array_equal(tout[key], want[key])


@pytest.mark.parametrize("s", [2, 8])
def test_strict_counts_and_arm_lists_are_global(toy, s):
    """The global strict counts equal the dense engine's
    exactly (the batch covers both sides of the auto-relax branch), and the
    merged per-arm lists equal the dense engine's arm outputs."""
    _, _, tq, tse = _exact_run(toy, s)
    te = toy["te"]
    got = tse.search_arrays(tq, K)
    cfg = te.cfg
    want = {key: v.numpy() for key, v in search_batch(te.store.index, tq, K, cfg.over_fetch,
                                                         cfg.rrf_k).items()}
    np.testing.assert_array_equal(got["strict_count"], want["strict_count"])
    assert (got["strict_count"] >= K).any() and (got["strict_count"] < K).any()
    for arm in ("vec", "lex", "dtag"):
        live = want[f"{arm}_vals"] > NEG_INF / 2
        assert ((got[f"{arm}_vals"] > NEG_INF / 2) == live).all(), arm
        assert_topk_equal(got[f"{arm}_vals"], got[f"{arm}_idx"], want[f"{arm}_vals"],
                          want[f"{arm}_idx"])


def test_results_match_jax_sharded(toy):
    """Assembled results: the JAX sharded engine's hits; the arm traces and
    strict counts (which the JAX fused schema leaves out) the dense
    engine's."""
    je, te = toy["je"], toy["te"]
    jr, tr = _reqs()
    jres = JSharded(je.store, mesh=jmake_mesh(4)).search(je, jr, k=K)
    tres = ShardedEngine(te.store, mesh=make_mesh(4, devices=CPU)).search(te, tr, k=K)
    dense = te.search(tr, k=K)
    for i in range(len(jr)):
        check_hits(jres, tres, i)
        check_results(dense, tres, i)


def test_engine_routes_through_the_grid(toy):
    """SearchEngine(sharded=...): search and search_pipelined give the dense
    engine's hits; the pipelined batches equal search batch by batch."""
    te = toy["te"]
    tse = ShardedEngine(te.store, mesh=make_mesh(4, devices=CPU))
    serving = TEngine(te.store, te.lexicon, embed_fn=ttesting.hash_embed, device="cpu",
                      sharded=tse)
    _, tr = _reqs()
    mono = te.search(tr, k=K)
    got = serving.search(tr, k=K)
    for a, b in zip(mono, got):
        assert [h.chunk_id for h in b.hits] == [h.chunk_id for h in a.hits]
        np.testing.assert_allclose([h.score for h in b.hits], [h.score for h in a.hits],
                                   rtol=0, atol=ATOL)
        assert b.confidence_label == a.confidence_label
    batches = [tr[:5], tr[5:]]
    for piped, batch in zip(serving.search_pipelined(batches, k=K), batches):
        for c, b in zip(piped, serving.search(batch, k=K)):
            assert [h.chunk_id for h in c.hits] == [h.chunk_id for h in b.hits]
            np.testing.assert_array_equal([h.score for h in c.hits], [h.score for h in b.hits])


def test_filters_fail_closed(toy):
    te = toy["te"]
    tse = ShardedEngine(te.store, mesh=make_mesh(8, devices=CPU))
    tq, _ = te.prepare_batch([_tq("timely filing", {"payer": "not_a_payer"})])
    assert (tse.search_arrays(tq, 5)["rerank"][0] <= NEG_INF / 2).all()


# ---------------------------------------------------------------------------
# sparse lexical layout
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sparse():
    return _twins(lexical_format="sparse")


@pytest.mark.parametrize("s", [3, 4])
def test_sparse_lexical_matches_jax_and_dense(sparse, s):
    """Per-shard postings re-keyed to local rows (bf16 weights), against the
    JAX sharded engine and the port's dense engine."""
    je, te = sparse
    jout, tout, tq = _both(je, te, JSharded(je.store, mesh=jmake_mesh(s)),
                           ShardedEngine(te.store, mesh=make_mesh(s, devices=CPU)))
    check_fused(tout, jout)
    check_fused(tout, _dense(te, tq))


def test_sparse_tables_are_local(sparse):
    _, te = sparse
    tse = ShardedEngine(te.store, mesh=make_mesh(4, devices=CPU))
    for idx in tse.shards[0]:
        cols = idx.lex_cols
        assert idx.lex_wts.dtype == torch.bfloat16
        assert cols.max() < tse.c_local and cols.min() >= -1
    nnz = sum(int((idx.lex_cols >= 0).sum()) for idx in tse.shards[0])
    assert nnz == int((te.store.index.lex_cols >= 0).sum())


# ---------------------------------------------------------------------------
# data-parallel grids
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [12, 3], ids=["even", "odd"])
def test_dp_grid_matches_jax_and_1d(toy, n):
    """A [2, 4] grid: the batch splits over the data groups (an odd batch
    unpadded, results in the original order); equal to the JAX dp engine
    and to the 1-d 4-shard grid (ids equal, floats within ATOL: a smaller
    batch may sum a product in another order)."""
    je, te = toy["je"], toy["te"]
    jout, tout, tq = _both(je, te, JSharded(je.store, mesh=jmake_serve(2, 4)),
                           ShardedEngine(te.store, mesh=make_serve_mesh(2, 4, devices=CPU)), n)
    assert tout["idx"].shape[0] == n
    check_fused(tout, jout)
    one_d = ShardedEngine(te.store, mesh=make_mesh(4, devices=CPU)).search_arrays(tq, K)
    np.testing.assert_array_equal(tout["idx"], one_d["idx"])
    check_fused(tout, one_d)


def test_dp_replicas_share_a_device(toy):
    """Replicas of a shard on one device are one set of tensors."""
    te = toy["te"]
    tse = ShardedEngine(te.store, mesh=make_serve_mesh(2, 4, devices=CPU))
    assert all(a is b for a, b in zip(tse.shards[0], tse.shards[1]))
    assert len(tse._copies) == 4


# ---------------------------------------------------------------------------
# ANN backends: per-shard tables
# ---------------------------------------------------------------------------

_CLASSES = {"ivf": tivf.IVFIndex, "packed": tivf.PackedIVF, "pq": tpq.PackedPQ,
            "proj": tproj.PackedProj}


def _carry_tables(jse, tse):
    """The JAX sharded engine's stacked tables, split per shard into the
    port's classes and adopted by `tse` for the store's generation."""
    stacked = jse.ensure_ann()
    leaves, aux = stacked.tree_flatten()
    cls = _CLASSES[jse.vector_backend]
    host = [np.asarray(x) for x in jax.device_get(leaves)]
    per = [cls.from_numpy({f: a[s] for f, a in zip(cls.FIELDS, host)}, aux, "cpu")
           for s in range(tse.num_shards)]
    tse._ann = [[per[s] for s in range(len(row))] for row in tse.groups]
    tse._ann_generation = tse.store.generation
    tse._ann_backend = tse.vector_backend


@pytest.fixture(scope="module")
def ann_twins():
    return _twins(pad_docs=120)


@pytest.mark.parametrize("backend", ["ivf", "packed", "pq", "proj"])
def test_ann_backends_match_jax(ann_twins, backend):
    """Each backend's per-shard scans (4 shards, the JAX tables carried
    across) and the merge against the JAX sharded engine."""
    je, te = ann_twins
    jcfg, tcfg = (dataclasses.replace(e.cfg, ivf_nprobe=4, proj_p=64) for e in (je, te))
    jse = JSharded(je.store, mesh=jmake_mesh(4), cfg=jcfg, vector_backend=backend)
    tse = ShardedEngine(te.store, mesh=make_mesh(4, devices=CPU), cfg=tcfg,
                        vector_backend=backend)
    _carry_tables(jse, tse)
    jout, tout, _ = _both(je, te, jse, tse)
    check_fused(tout, jout)


@pytest.mark.parametrize("backend", ["ivf", "packed", "pq", "proj"])
def test_ann_full_probe_serves(ann_twins, backend):
    """The port's own per-shard build: one nlist for all shards, tables on
    a common layout; a full probe with exact row scores (ivf) equals the
    exact sharded scan, and the quantized backends keep its hits."""
    _, te = ann_twins
    cfg = dataclasses.replace(te.cfg, ivf_nprobe=100_000, proj_p=64)
    tq, _ = te.prepare_batch(_reqs()[1])
    exact = ShardedEngine(te.store, mesh=make_mesh(4, devices=CPU), cfg=cfg)
    tse = ShardedEngine(te.store, mesh=make_mesh(4, devices=CPU), cfg=cfg,
                        vector_backend=backend)
    want, got = exact.search_arrays(tq, 10), tse.search_arrays(tq, 10)
    tables = tse._ann[0]
    assert len({(t.nlist, t.pad) for t in tables}) == 1
    if backend == "ivf":
        check_fused(got, want)
    else:
        live = want["rerank"] > NEG_INF / 2
        rec = [len(set(got["idx"][i][live[i]]) & set(want["idx"][i][live[i]]))
               / max(live[i].sum(), 1) for i in range(len(live)) if live[i].any()]
        assert np.mean(rec) >= 0.8, rec


def test_backend_propagates_from_the_engine(ann_twins):
    _, te = ann_twins
    tse = ShardedEngine(te.store, mesh=make_mesh(4, devices=CPU))
    serving = TEngine(te.store, te.lexicon, embed_fn=ttesting.hash_embed, device="cpu",
                      sharded=tse, vector_backend="ivf")
    assert tse.vector_backend == "ivf"
    assert serving.search(_tq("timely filing deadline", {}), k=5)[0].hits
    assert tse._ann is not None
    serving.set_vector_backend("exact")
    assert tse.vector_backend == "exact"


def _jaxnp(tables):
    return {f: np.asarray(getattr(tables, f)) for f in type(tables).FIELDS}


def _synthetic_shards(cls_name, rng):
    """Per-shard tables of differing (base nlist, slabs, pad, spill), as
    JAX-package objects over numpy arrays."""
    out = []
    for base, extra, pad, n_spill in ((5, 1, 8, 7), (7, 0, 16, 3), (3, 2, 8, 12)):
        nlist = base + extra
        cents = rng.standard_normal((nlist, 6)).astype(np.float32)
        valid = (rng.random((nlist, pad)) > 0.3).astype(np.float32)
        rowids = rng.integers(0, 500, (nlist, pad)).astype(np.int32)
        if cls_name == "ivf":
            out.append(jivf.IVFIndex(cents[:base], rowids[:base], valid[:base],
                                     rng.integers(0, 500, n_spill).astype(np.int32),
                                     (rng.random(n_spill) > 0.5).astype(np.float32),
                                     nlist=base, pad=pad))
        elif cls_name == "packed":
            out.append(jivf.PackedIVF(cents, rng.integers(-127, 128, (nlist, pad, 6)).astype(
                np.int8), rng.random((nlist, pad)).astype(np.float32), valid, rowids,
                nlist=nlist, pad=pad, base_nlist=base))
        elif cls_name == "pq":
            out.append(jpq.PackedPQ(cents, rng.integers(0, 256, (nlist, pad, 3)).astype(
                np.uint8), rng.standard_normal((3, 256, 2)).astype(np.float32), valid, rowids,
                nlist=nlist, pad=pad, base_nlist=base))
        else:
            out.append(jproj.PackedProj(cents, rng.standard_normal((4, 6)).astype(np.float32),
                                        rng.integers(-127, 128, (nlist, pad, 4)).astype(np.int8),
                                        rng.random((nlist, pad)).astype(np.float32), valid,
                                        rowids, nlist=nlist, pad=pad, base_nlist=base))
    return out


@pytest.mark.parametrize("name", ["ivf", "packed", "pq", "proj"])
def test_stack_shard_bitwise(name):
    """stack_shard_* on the same per-shard tables: every stacked array
    bitwise the JAX package's, and the same layout numbers."""
    rng = np.random.default_rng(5)
    jshards = _synthetic_shards(name, rng)
    jfn = {"ivf": jivf.stack_shard_ivf, "packed": jivf.stack_shard_packed,
           "pq": jpq.stack_shard_pq, "proj": jproj.stack_shard_proj}[name]
    tfn = {"ivf": tivf.stack_shard_ivf, "packed": tivf.stack_shard_packed,
           "pq": tpq.stack_shard_pq, "proj": tproj.stack_shard_proj}[name]
    cls = _CLASSES[name]
    tshards = [cls.from_numpy(_jaxnp(sh), sh.tree_flatten()[1], "cpu") for sh in jshards]
    want, got = jfn(jshards), tfn(tshards)
    for f in cls.FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f).numpy()
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.aux[:3] == tuple(want.tree_flatten()[1][:3])


# ---------------------------------------------------------------------------
# live refresh
# ---------------------------------------------------------------------------

def _zephyr(pkg):
    if pkg == "jax":
        return jfeaturize(JRecord(chunk_id="zephyr-c0", doc_id="zephyr_doc", text=ZEPHYR,
                                  embedding=jtesting.hash_embed([ZEPHYR])[0]),
                          jtesting.sample_lexicon())
    return tfeaturize(TRecord(chunk_id="zephyr-c0", doc_id="zephyr_doc", text=ZEPHYR,
                              embedding=ttesting.hash_embed([ZEPHYR])[0]),
                      ttesting.sample_lexicon())


@pytest.mark.parametrize("layout", ["dense", "sparse"])
def test_live_refresh_publish_and_delete(layout):
    """A publish after construction: a scatter of the dirty rows (dense
    layout) or a re-shard (sparse postings); the document is served, and
    the results equal the JAX sharded engine's and the dense engine's;
    the delete refreshes inside search."""
    je, te = _twins(pad_docs=64, lexical_format=layout)
    jse = JSharded(je.store, mesh=jmake_mesh(4))
    tse = ShardedEngine(te.store, mesh=make_mesh(4, devices=CPU))
    serving = TEngine(te.store, te.lexicon, embed_fn=ttesting.hash_embed, device="cpu",
                      sharded=tse)
    je.store.publish_document("zephyr_doc", [_zephyr("jax")])
    te.store.publish_document("zephyr_doc", [_zephyr("port")])
    assert tse.stale
    info, jinfo = tse.refresh(), jse.refresh()
    assert info == jinfo
    assert info["mode"] == ("scatter:1" if layout == "dense" else "rebuild")
    q = _tq("zymurgy benefit fermentation consult", {})
    res = serving.search(q, k=5)[0]
    assert any(h.doc_id == "zephyr_doc" for h in res.hits)
    assert [h.chunk_id for h in res.hits] == [h.chunk_id for h in te.search(q, k=5)[0].hits]
    jout, tout, tq = _both(je, te, jse, tse)
    check_fused(tout, jout)
    check_fused(tout, _dense(te, tq))
    te.store.delete_by_document("zephyr_doc")
    assert not any(h.doc_id == "zephyr_doc" for h in serving.search(q, k=5)[0].hits)
    assert not tse.stale


def test_refresh_rebuilds_on_many_rows_grow_and_bulk(monkeypatch):
    _, te = _twins(pad_docs=16)
    tse = ShardedEngine(te.store, mesh=make_mesh(2, devices=CPU))
    assert tse.refresh() == {"refreshed": False}
    monkeypatch.setattr(tsharded, "_REBUILD_ROWS", 0)
    te.store.publish_document("zephyr_doc", [_zephyr("port")])
    assert tse.refresh() == {"refreshed": True, "mode": "rebuild"}
    monkeypatch.undo()
    cap = te.store.capacity
    recs = [tfeaturize(TRecord(chunk_id=f"g{i}", doc_id=f"grow{i}", text=f"growth row {i}",
                               embedding=ttesting.hash_embed([f"growth row {i}"])[0]),
                       te.lexicon) for i in range(cap)]
    te.store.add_chunks(recs)
    assert te.store.capacity > cap
    assert tse.refresh()["mode"] == "rebuild" and tse.c_pad >= te.store.capacity
    tq, _ = te.prepare_batch([_tq("growth row 7", {})])
    check_fused(tse.search_arrays(tq, K), _dense(te, tq))


def test_rebuilt_over_a_restored_store(toy, tmp_path):
    te = toy["te"]
    tse = ShardedEngine(te.store, mesh=make_serve_mesh(2, 2, devices=CPU))
    te.store.snapshot(str(tmp_path))
    new = TStore.restore(str(tmp_path), device="cpu")
    fresh = tse.rebuilt(new)
    assert fresh.store is new and fresh.mesh is tse.mesh
    tq, _ = te.prepare_batch(_reqs()[1])
    check_fused(fresh.search_arrays(tq, K), tse.search_arrays(tq, K))


def test_ann_rebuilds_after_publish():
    _, te = _twins(pad_docs=64)
    cfg = dataclasses.replace(te.cfg, ivf_nprobe=100_000)
    tse = ShardedEngine(te.store, mesh=make_mesh(4, devices=CPU), cfg=cfg,
                        vector_backend="ivf")
    serving = TEngine(te.store, te.lexicon, cfg=cfg, embed_fn=ttesting.hash_embed,
                      device="cpu", sharded=tse)
    serving.search(_tq("warm up", {}), k=5)
    gen0 = tse._ann_generation
    te.store.publish_document("zephyr_doc", [_zephyr("port")])
    res = serving.search(_tq("zymurgy benefit fermentation consult", {}), k=5)[0]
    assert tse._ann_generation != gen0
    assert any(h.doc_id == "zephyr_doc" for h in res.hits)


# ---------------------------------------------------------------------------
# host residency: codes-only shards, the funnel, the exact host re-rank
# ---------------------------------------------------------------------------

_HOST = dict(vector_residency="host", vector_dtype="int8", ivf_nprobe=4, proj_p=64)


@pytest.fixture(scope="module", params=["pq", "proj"])
def host(request):
    je, te = _twins(pad_docs=120, vector_backend=request.param, **_HOST)
    return request.param, je, te


@pytest.mark.parametrize("grid", ["1d", "dp"])
def test_host_residency_matches_jax(host, grid):
    """pq and proj per shard under host residency (4 shards; a [2, 2] grid):
    the merge returns k·over_fetch fused candidates and the funnel, and the
    exact host re-rank gives the JAX sharded engine's results."""
    backend, je, te = host
    assert te.store.index.vectors.shape[0] == 0
    jmesh, tmesh = ((jmake_mesh(4), make_mesh(4, devices=CPU)) if grid == "1d"
                    else (jmake_serve(2, 2), make_serve_mesh(2, 2, devices=CPU)))
    jse = JSharded(je.store, mesh=jmesh, cfg=je.cfg)
    tse = ShardedEngine(te.store, mesh=tmesh, cfg=te.cfg)
    _carry_tables(jse, tse)
    jr, tr = _reqs(7)
    jres, tres = jse.search(je, jr, k=K), tse.search(te, tr, k=K)
    for i in range(len(jr)):
        check_hits(jres, tres, i)
    assert tres[0].hits and -1.01 <= tres[0].hits[0].signals["cosine"] <= 1.01


def test_host_residency_pipelined_equals_search(host):
    backend, _, te = host
    tse = ShardedEngine(te.store, mesh=make_mesh(4, devices=CPU), cfg=te.cfg)
    serving = TEngine(te.store, te.lexicon, cfg=te.cfg, embed_fn=ttesting.hash_embed,
                      device="cpu", sharded=tse)
    _, tr = _reqs(6)
    batches = [tr[:3], tr[3:]]
    one = [r for batch in batches for r in serving.search(batch, k=K)]
    piped = [r for batch in serving.search_pipelined(batches, k=K) for r in batch]
    for a, b in zip(one, piped):
        assert [h.chunk_id for h in b.hits] == [h.chunk_id for h in a.hits]
        np.testing.assert_array_equal([h.score for h in b.hits], [h.score for h in a.hits])
    assert tse._ann is not None and tse._ann[0][0].rowids.shape == tse._ann[0][1].rowids.shape


def test_host_residency_refuses_dense_backends(host):
    _, _, te = host
    with pytest.raises(ValueError, match="pq"):
        ShardedEngine(te.store, mesh=make_mesh(2, devices=CPU), cfg=te.cfg,
                      vector_backend="ivf")
    tse = ShardedEngine(te.store, mesh=make_mesh(2, devices=CPU), cfg=te.cfg)
    with pytest.raises(ValueError, match="pq"):
        tse.set_vector_backend("exact")


# ---------------------------------------------------------------------------
# the agent over a sharded engine
# ---------------------------------------------------------------------------

def test_agent_over_sharded_engine_matches_dense():
    from mobius_rag_tpu_torch.query.agent import AgentRequest, CorpusSearchAgent

    _, te = _twins(pad_docs=100)
    sharded = TEngine(te.store, te.lexicon, embed_fn=ttesting.hash_embed, device="cpu",
                      sharded=ShardedEngine(te.store, mesh=make_mesh(8, devices=CPU)))
    mono_agent, sharded_agent = CorpusSearchAgent(te), CorpusSearchAgent(sharded)
    for q in ("What is the timely filing deadline for Sunshine Health FL Medicaid claims?",
              "Does Sunshine Health require prior authorization for H0019?",
              "molina eligibility verification"):
        a = mono_agent.run(AgentRequest(query=q))
        b = sharded_agent.run(AgentRequest(query=q))
        assert [h.chunk_id for h in a.chunks] == [h.chunk_id for h in b.chunks], q
        assert a.confidence_label == b.confidence_label
        assert a.strategy_chain == b.strategy_chain
    res = sharded.search(_tq("timely filing deadline for sunshine health claims", {}), k=1)[0]
    assert res.hits and res.hits[0].neighbors


# ---------------------------------------------------------------------------
# the sharded program captured (query/compiled.py), with the stand-in
# capture of tests/test_torch_compiled.py
# ---------------------------------------------------------------------------

# grid name -> (the port's grid over `devices`, the JAX package's)
_GRIDS = {"1d": (lambda devices: make_mesh(4, devices=devices), lambda: jmake_mesh(4)),
          "dp": (lambda devices: make_serve_mesh(2, 4, devices=devices),
                 lambda: jmake_serve(2, 4))}


def _sharded_serving(store, lexicon, cfg, mesh, **kw) -> TEngine:
    return TEngine(store, lexicon, cfg=cfg, embed_fn=ttesting.hash_embed, device=store.device,
                   sharded=ShardedEngine(store, mesh=mesh, cfg=cfg), **kw)


def _captured(serving: TEngine, max_graphs: int = compiled.MAX_GRAPHS) -> StandIn:
    """`serving` replaying its sharded engine's programs through the
    stand-in capture, reading the lexical union as a card does."""
    _reads_as_card(serving)
    serving.sharded._programs = StandIn(serving.device, max_graphs)
    serving.graphs = True
    return serving.sharded._programs


def _eager_twin(serving: TEngine) -> TEngine:
    """A second engine over `serving`'s store and grid, eager, reading the
    union as a card does."""
    tse = serving.sharded
    return _reads_as_card(_sharded_serving(serving.store, serving.lexicon, tse.cfg, tse.mesh,
                                           vector_backend=tse.vector_backend))


@pytest.mark.parametrize("grid", sorted(_GRIDS))
def test_sharded_graph_keys_match_eager_and_jax(toy, grid):
    """One graph per key of the sharded program: B, the union columns read
    and k change it; the grid's shape (dp, S) is in it; every replay gives
    the eager sharded program's results, and the JAX sharded engine's."""
    je, te = toy["je"], toy["te"]
    mesh, jmesh = _GRIDS[grid]
    serving = _sharded_serving(te.store, te.lexicon, te.cfg, mesh(CPU))
    eager = _eager_twin(serving)
    cache = _captured(serving)
    jr, tr = _reqs()
    wide = " " + " ".join(_words(40))
    runs = [(tr[:4], K), (tr[:5], K), (tr[:4], K), ([_tq(q.query + wide, {}) for q in tr[:4]], K),
            (tr[:4], K + 1), (tr[:5], K), (tr[:4], K)]
    for batch, k in runs:
        got = serving.search(batch, k=k)
        assert [_fields(r) for r in got] == [_fields(r) for r in eager.search(batch, k=k)]
    assert cache.captures == 4 and cache.replays == 3
    dp = 2 if grid == "dp" else 1
    assert {key[0] for key, _ in cache.graphs} == {K, K + 1}
    assert all(key[-2:] == (dp, 4) and key[6] is None for key, _ in cache.graphs)
    widths = {dict((n, shape) for n, shape, _ in layout)["lex_buckets"][0]
              for _, layout in cache.graphs}
    assert len(widths) == 2 and max(widths) >= 64  # the live columns rounded up
    jres = JSharded(je.store, mesh=jmesh()).search(je, jr, k=K)
    tres = serving.search(tr, k=K)  # its first run, then a replay
    tres = serving.search(tr, k=K)
    for i in range(len(jr)):
        check_hits(jres, tres, i)


@pytest.mark.parametrize("grid", sorted(_GRIDS))
def test_sharded_replay_adds_a_launch_per_shard_and_group(toy, grid, monkeypatch):
    """The masked top-k (counted here on the CPU by a stand-in wrapper)
    launches S x dp times a batch: the capture's deltas, added on every
    replay."""
    def kernel(*a, **kw):
        kernel.launches += 1
        return masked(*a, **kw)

    masked, kernel.launches = tengine.masked_topk, 0
    monkeypatch.setattr(tengine, "masked_topk", kernel)
    monkeypatch.setattr(compiled, "COUNTED", (kernel,))
    te = toy["te"]
    serving = _sharded_serving(te.store, te.lexicon, te.cfg, _GRIDS[grid][0](CPU))
    cache = _captured(serving)
    per = 4 * (2 if grid == "dp" else 1)
    for _ in range(4):
        serving.search(_reqs(4)[1], k=K)
    assert cache.captures == 1 and cache.replays == 3
    assert next(iter(cache.graphs.values())).deltas == (per,)
    assert kernel.launches == 4 * per


# case -> (config fields, grid)
_SHARDED_CASES = {
    "exact_S4": ({}, "1d"),
    "exact_dp2xS4": ({}, "dp"),
    "exact_sparse_S4": (dict(lexical_format="sparse"), "1d"),
    "ivf_S4": (dict(vector_backend="ivf", ivf_nlist=16, ivf_nprobe=8, lexical_format="sparse"),
               "1d"),
    "host_pq_S4": (dict(vector_residency="host", vector_dtype="int8", vector_backend="pq",
                        ivf_nprobe=10 ** 6, over_fetch=8, ivf_nlist=8, pq_m=32,
                        lexical_format="sparse", host_funnel=64), "1d"),
}


def _sharded_case(case: str, device: str) -> TEngine:
    fields, grid = _SHARDED_CASES[case]
    cfg = dataclasses.replace(tget_config(), initial_capacity=1024, **fields)
    lex = ttesting.sample_lexicon()
    store = TStore(cfg, device=device)
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=60))
    return _sharded_serving(store, lex, cfg, _GRIDS[grid][0]([device] * 8))


@pytest.mark.parametrize("case", sorted(_SHARDED_CASES))
def test_sharded_writes_replay_like_eager_with_stand_in(case):
    """The card test's write sequence on the CPU with the stand-in capture:
    a refresh that copies rows keeps the graphs (dense lexical, exact), a
    re-shard (sparse postings, a grow) and an ANN rebuild drop them, and
    every replay is the eager sharded program's."""
    serving = _sharded_case(case, "cpu")
    _captured(serving)
    _writes_replay_bitwise(serving)


def test_sharded_graphs_drop_after_bulk_load_and_reshard(monkeypatch):
    """A bulk_load into the empty store re-shards, and so does a refresh
    past _REBUILD_ROWS dirty rows: the next batch drops every graph and
    captures anew; the results stay the eager program's."""
    cfg = dataclasses.replace(tget_config(), initial_capacity=1024)
    lex = ttesting.sample_lexicon()
    store = TStore(cfg, device="cpu")
    serving = _sharded_serving(store, lex, cfg, make_mesh(4, devices=CPU))
    eager, cache = _eager_twin(serving), _captured(serving)
    tse = serving.sharded
    batch = _reqs(4)[1]

    def same():
        got = serving.search(batch, k=K)
        assert [_fields(r) for r in got] == [_fields(r) for r in eager.search(batch, k=K)]
        return got

    assert not any(r.hits for r in same())  # an empty store
    store.bulk_load(ttesting.toy_corpus(lex, pad_docs=30))
    assert any(r.hits for r in same())
    assert cache.captures == 2 and len(cache.graphs) == 1
    assert any(t is tse.shards[0][0].vectors for t in next(iter(cache.graphs.values())).held)
    monkeypatch.setattr(tsharded, "_REBUILD_ROWS", 0)
    _add(store, "many")
    same()
    assert cache.captures == 3 and len(cache.graphs) == 1
    assert any(t is tse.shards[0][0].vectors for t in next(iter(cache.graphs.values())).held)


def test_sharded_graph_keys_on_funnel_and_backend():
    """The funnel (host residency) and the backend's tables' class are
    in the key; the results stay the eager program's."""
    serving = _sharded_case("host_pq_S4", "cpu")
    eager, cache = _eager_twin(serving), _captured(serving)
    batch = _reqs(4)[1]
    for funnel in (64, 96, 64):
        serving.cfg = eager.cfg = dataclasses.replace(serving.cfg, host_funnel=funnel)
        got = serving.search(batch, k=K)
        assert [_fields(r) for r in got] == [_fields(r) for r in eager.search(batch, k=K)]
    assert sorted(key[1] for key, _ in cache.graphs) == [64, 96]
    assert {key[6] for key, _ in cache.graphs} == {"PackedPQ"}
    assert cache.captures == 2 and cache.replays == 1
    serving = _sharded_case("exact_S4", "cpu")
    cache = _captured(serving)
    serving.search(batch, k=K)
    assert next(iter(cache.graphs))[0][6] is None
    serving.set_vector_backend("ivf")
    serving.search(batch, k=K)
    assert [key[0][6] for key in cache.graphs] == ["IVFIndex"] and cache.captures == 2


@pytest.mark.parametrize("groups,merge,one", [
    ([["cuda:0"] * 4], "cuda:0", True),
    ([["cuda:0"] * 4] * 2, "cuda:0", True),
    ([["cpu"] * 4], "cpu", True),
    ([["cuda:0", "cuda:1", "cuda:2", "cuda:3"]], "cuda:0", False),
    ([["cuda:0"] * 4, ["cuda:1"] * 4], "cuda:0", False),
    ([["cuda:1"] * 4], "cuda:0", False)])
def test_one_device_rule(groups, merge, one):
    """A grid captures only when every device of it is the merge device:
    the rule alone, no card touched."""
    grid = [[torch.device(d) for d in row] for row in groups]
    assert on_one_device(grid, torch.device(merge)) is one


def test_graphs_true_refused_on_a_grid_of_devices(toy, monkeypatch):
    """On a grid whose devices are not all the merge device (here the CPU
    and the meta device: no card touched), graphs=True makes one captured
    program set per device (the staged route), and still raises off a
    card, passed to the constructor or set later; the default off a card
    serves eagerly."""
    te = toy["te"]
    listeners = list(te.store.listeners)
    tse = ShardedEngine(te.store, mesh=make_mesh(2, devices=["cpu", "meta"]))
    assert not tse.one_device
    try:
        with pytest.raises(ValueError, match="CUDA"):
            TEngine(te.store, te.lexicon, device="cpu", sharded=tse, graphs=True)
        serving = TEngine(te.store, te.lexicon, device="cpu", sharded=tse)
        assert serving.graphs is False
        with pytest.raises(ValueError, match="CUDA"):
            serving.graphs = True
        assert serving.graphs is False and tse._programs is None
        monkeypatch.setattr(compiled, "CapturedPrograms", StandIn)
        serving.graphs = True
        programs = serving.programs
        assert isinstance(programs, compiled.ProgramsByDevice) and tse._programs is programs
        assert list(programs.by_device) == [torch.device("cpu"), torch.device("meta")]
        assert all(isinstance(p, StandIn) for p in programs.by_device.values())
    finally:
        te.store.listeners[:] = listeners


# -- the staged route: one graph per device and stage ----------------------

# a grid over four distinct (CPU) devices, the first the store's (the merge
# device): the staged route unforced
NAMED = ["cpu", "cpu:1", "cpu:2", "cpu:3"]


def _staged(serving: TEngine) -> compiled.ProgramsByDevice:
    """`serving`, whose grid is not one device, replaying its sharded
    engine's stages through the stand-in capture (one per device),
    reading the lexical union as a card does."""
    tse = serving.sharded
    assert not tse.one_device
    _reads_as_card(serving)
    tse._programs = compiled.ProgramsByDevice(
        [tse.device] + [d for row in tse.groups for d in row], make=StandIn)
    serving._graphs = True
    return tse._programs


def _forced(monkeypatch, make):
    """What `make()` builds while ``on_one_device`` answers False: a grid of
    one device served by the staged route, as on a card the card tests
    force it."""
    with monkeypatch.context() as m:
        m.setattr(tsharded, "on_one_device", lambda groups, device: False)
        return make()


# case -> the JAX twins' config (the card cases' fields), grid
_STAGED_CASES = {case: _SHARDED_CASES[case]
                 for case in ("exact_S4", "exact_dp2xS4", "ivf_S4", "host_pq_S4")}


@pytest.mark.parametrize("case", sorted(_STAGED_CASES))
def test_staged_route_matches_one_graph_and_jax(case, monkeypatch):
    """The staged route (forced over ["cpu"] * 8, the stand-in capture)
    gives the one-graph route's results bitwise, batch by batch through
    keys that switch, and the JAX ShardedEngine's hits (its ANN tables
    carried across); its keys are the one graph's with the stage's name."""
    fields, grid = _STAGED_CASES[case]
    je, te = _twins(pad_docs=60, initial_capacity=1024, **fields)
    mesh, jmesh = _GRIDS[grid]
    one = _sharded_serving(te.store, te.lexicon, te.cfg, mesh(CPU))
    staged = _forced(monkeypatch,
                     lambda: _sharded_serving(te.store, te.lexicon, te.cfg, mesh(CPU)))
    jse = JSharded(je.store, mesh=jmesh(), cfg=je.cfg)
    if te.cfg.vector_backend != "exact":
        for serving in (one, staged):
            _carry_tables(jse, serving.sharded)
    cache, programs = _captured(one), _staged(staged)
    jr, tr = _reqs()
    for batch in (tr[:4], tr[:5], tr, tr[:4], tr):
        want = [_fields(r) for r in one.search(batch, k=K)]
        assert [_fields(r) for r in staged.search(batch, k=K)] == want
    stages = {key[1] for key, _ in programs.graphs}
    assert stages == {"count", "arms", "merge"}
    assert {key[2:] for key, _ in programs.graphs} == {key for key, _ in cache.graphs}
    assert programs.captures == 3 * cache.captures and programs.replays == 3 * cache.replays
    jres = jse.search(je, jr, k=K)
    tres = staged.search(tr, k=K)
    for i in range(len(jr)):
        check_hits(jres, tres, i)


@pytest.mark.parametrize("case", sorted(_SHARDED_CASES))
def test_staged_writes_replay_like_eager_with_stand_in(case, monkeypatch):
    """The card test's write sequence on the staged route (forced over
    ["cpu"] * 8, the stand-in capture): a refresh that copies rows keeps
    every stage's graphs, a re-shard and an ANN rebuild drop them, and
    every replay is the eager sharded program's."""
    serving = _forced(monkeypatch, lambda: _sharded_case(case, "cpu"))
    _staged(serving)
    _writes_replay_bitwise(serving)


@pytest.mark.parametrize("grid", ["named", "forced_dp"])
def test_staged_replay_adds_a_launch_per_shard_and_group(toy, grid, monkeypatch):
    """The staged route's launches (the masked top-k, counted here on the
    CPU by a stand-in wrapper) add up over its devices' stages to S x dp a
    batch, as the one graph's: over four named devices (S = 4) and forced
    over [dp 2, S 4] on one."""
    def kernel(*a, **kw):
        kernel.launches += 1
        return masked(*a, **kw)

    masked, kernel.launches = tengine.masked_topk, 0
    monkeypatch.setattr(tengine, "masked_topk", kernel)
    monkeypatch.setattr(compiled, "COUNTED", (kernel,))
    te = toy["te"]
    if grid == "named":
        serving, per = _sharded_serving(te.store, te.lexicon, te.cfg,
                                        make_mesh(4, devices=NAMED)), 4
    else:
        serving, per = _forced(monkeypatch, lambda: _sharded_serving(
            te.store, te.lexicon, te.cfg, make_serve_mesh(2, 4, devices=CPU))), 8
    eager = _eager_twin(serving)
    programs = _staged(serving)
    batch = _reqs(4)[1]
    for _ in range(4):
        got = serving.search(batch, k=K)
    assert kernel.launches == 4 * per
    assert [_fields(r) for r in got] == [_fields(r) for r in eager.search(batch, k=K)]
    arms = [e for key, e in programs.graphs.items() if key[0][1] == "arms"]
    assert sum(e.deltas[0] for e in arms) == per
    assert all(e.deltas == (0,) for key, e in programs.graphs.items() if key[0][1] != "arms")
    assert programs.replays == 3 * len(programs.graphs)


def test_staged_graphs_drop_on_every_device_after_reshard(monkeypatch):
    """Over four named devices, the stages' tables are each device's own: a
    refresh that copies rows keeps every graph; a grow and a refresh past
    _REBUILD_ROWS re-shard, and the next batch drops every device's graphs
    and captures anew on each; the results stay the eager program's."""
    cfg = dataclasses.replace(tget_config(), initial_capacity=1024)
    lex = ttesting.sample_lexicon()
    store = TStore(cfg, device="cpu")
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=30))
    serving = _sharded_serving(store, lex, cfg, make_mesh(4, devices=NAMED))
    eager, programs = _eager_twin(serving), _staged(serving)
    tse = serving.sharded
    batch = _reqs(4)[1]

    def same():
        got = serving.search(batch, k=K)
        assert [_fields(r) for r in got] == [_fields(r) for r in eager.search(batch, k=K)]

    same()
    assert [p.captures for p in programs.by_device.values()] == [3, 2, 2, 2]
    for si, dev in enumerate(tse.groups[0]):
        held = next(iter(programs[dev].graphs.values())).held
        assert any(t is tse.shards[0][si].vectors for t in held)
        assert not any(t is tse.shards[0][(si + 1) % 4].vectors for t in held)
    before = dict(programs.graphs)
    _add(store, "fresh")
    same()
    assert all(programs.graphs[key] is e for key, e in before.items())  # in place: kept
    n = store.capacity - store.size + 1  # one row past capacity: a grow
    embs = ttesting.hash_embed([f"growth row {i}" for i in range(n)])
    store.add_chunks([TRecord(chunk_id=f"g{i}", doc_id=f"g{i}", text=f"growth row {i}",
                              embedding=embs[i]) for i in range(n)])
    same()
    assert [p.captures for p in programs.by_device.values()] == [6, 4, 4, 4]
    assert not {id(e) for e in programs.graphs.values()} & {id(e) for e in before.values()}
    monkeypatch.setattr(tsharded, "_REBUILD_ROWS", 0)
    _add(store, "many")
    same()
    assert [p.captures for p in programs.by_device.values()] == [9, 6, 6, 6]
    assert len(programs.graphs) == 9


def _shards_equal_store(tse) -> None:
    cs, valid = tse.c_local, tse.store.index.valid
    for si, idx in enumerate(tse.shards[0]):
        n = max(0, min(cs, valid.shape[0] - si * cs))
        assert torch.equal(idx.valid[:n], valid[si * cs:si * cs + n]), si


def test_refresh_keeps_rows_reported_after_it_read_the_generation():
    """The store bumps its generation before it tells its listeners: a
    refresh on another thread that runs between the two must leave the
    copy stale, so that the next refresh copies the rows."""
    _, te = _twins(pad_docs=16)
    store = te.store
    tse = ShardedEngine(store, mesh=make_mesh(4, devices=CPU))
    events, listeners = [], store.listeners
    store.listeners = [lambda event, rows: events.append((event, list(rows)))]
    try:
        store.publish_document("zephyr_doc", [_zephyr("port")])
    finally:
        store.listeners = listeners
    tse.refresh()  # the generation moved; no row reported yet
    for event, rows in events:
        tse._on_store_event(event, rows)
    assert tse.stale
    assert tse.refresh()["mode"] == "scatter:1"
    _shards_equal_store(tse)


def test_refresh_from_a_writer_thread_loses_no_rows():
    """Publishes on one thread, refresh() on another, as the API's handlers
    and a searching thread do: after both, one refresh leaves every shard
    equal to the store (an event the store reports after a refresh read
    its generation still marks the copy stale)."""
    import sys
    import threading

    _, te = _twins(pad_docs=16)
    store = te.store
    tse = ShardedEngine(store, mesh=make_mesh(4, devices=CPU))
    errors = []

    def write():
        try:
            for i in range(60):
                text = f"writer row {i}"
                store.publish_document(f"w{i}", [TRecord(
                    chunk_id=f"w{i}", doc_id=f"w{i}", text=text,
                    embedding=ttesting.hash_embed([text])[0])])
        except Exception as e:  # reported by the assertion below
            errors.append(repr(e))

    def refresh():
        try:
            while writer.is_alive():
                tse.refresh()
        except Exception as e:  # reported by the assertion below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        writer = threading.Thread(target=write)
        threads = [writer] + [threading.Thread(target=refresh) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads), errors
    tse.refresh()
    assert not tse.stale
    _shards_equal_store(tse)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_sharded_on_card_matches_dense():
    """On the card, [cuda:0] * 4 shards: the exact sharded engine gives the
    dense engine's results (ids, scores within 1e-5) through the masked
    top-k kernel (4 launches a batch), captured and eager; the dispatch
    reads nothing back from the card, eager or captured (a replay: a new
    key's capture synchronizes the device on purpose)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mobius_rag_tpu_torch.ops.topk import masked_topk

    lex = ttesting.sample_lexicon()
    store = TStore(device="cuda")
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=120))
    dense = TEngine(store, lex, embed_fn=ttesting.hash_embed, device="cuda")
    tse = ShardedEngine(store, mesh=make_mesh(4, devices=["cuda"] * 4))
    serving = TEngine(store, lex, embed_fn=ttesting.hash_embed, device="cuda", sharded=tse)
    assert serving.graphs and tse.one_device
    _, tr = _reqs()
    want = dense.search(tr, k=K)
    for graphs in (False, True):
        serving.graphs = graphs
        serving.search(tr, k=K)  # warm-up: lazy module loads; captured: the capture
        before = masked_topk.launches
        got = serving.search(tr, k=K)
        assert masked_topk.launches - before == 4
        for a, b in zip(want, got):
            assert [h.chunk_id for h in b.hits] == [h.chunk_id for h in a.hits]
            np.testing.assert_allclose([h.score for h in b.hits], [h.score for h in a.hits],
                                       rtol=0, atol=ATOL)
    assert serving.programs.captures == 1 and serving.programs.replays == 1
    for graphs in (False, True):
        serving.graphs = graphs
        q, exps = serving.prepare_batch(tr)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            fetch = serving._dispatch(q, exps, None, None, K)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        out = serving._finish(tr, exps, fetch.wait(), K)
        assert out["idx"].shape == (len(tr), K)
    assert serving.programs.captures == 1 and serving.programs.replays == 2


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_SHARDED_CASES))
def test_sharded_graphs_bitwise_on_card(case):
    """The sharded program captured on a grid of this card against the same
    engine eager (``graphs=False``), bitwise, over 9 batches searched and
    pipelined, with the masked top-k launched S x dp times a batch
    captured and eager; again after a publish (a refresh in place, or a
    re-shard under sparse postings; the ANN tables rebuild), a publish
    with d-tags and a grow."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mobius_rag_tpu_torch.ops.topk import masked_topk

    serving = _sharded_case(case, "cuda")
    assert serving.graphs
    tse = serving.sharded
    exact = tse.vector_backend == "exact"
    _writes_replay_bitwise(serving, masked_topk if exact else None,
                           len(tse.groups) * tse.num_shards if exact else None)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_SHARDED_CASES))
def test_staged_graphs_bitwise_on_card(case, monkeypatch):
    """The staged route, forced over a grid of this card (one graph per
    stage: every shard on the one device, the joins same-device copies),
    against the same engine eager, bitwise, through the write sequence of
    test_sharded_graphs_bitwise_on_card (a refresh in place or a re-shard,
    a d-tag publish, a grow), the masked top-k launched S x dp times a
    batch; then against the one-graph route on the same store, bitwise,
    through another refresh and another grow (a re-shard)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mobius_rag_tpu_torch.ops.topk import masked_topk

    serving = _forced(monkeypatch, lambda: _sharded_case(case, "cuda"))
    tse = serving.sharded
    assert serving.graphs and isinstance(serving.programs, compiled.ProgramsByDevice)
    exact = tse.vector_backend == "exact"
    _writes_replay_bitwise(serving, masked_topk if exact else None,
                           len(tse.groups) * tse.num_shards if exact else None)
    assert {key[0][1] for key in serving.programs.graphs} == {"count", "arms", "merge"}
    one = _sharded_serving(serving.store, serving.lexicon, tse.cfg, tse.mesh,
                           vector_backend=tse.vector_backend)
    assert one.graphs and one.sharded.one_device
    batches = _card_batches()

    def same(tag):
        # one ANN build for both (two k-means builds on the card need not agree)
        for t in (tse, one.sharded):
            t.refresh()
        if not exact:
            tse.ensure_ann()
            one.sharded._ann, one.sharded._ann_generation, one.sharded._ann_backend = \
                tse._ann, tse._ann_generation, tse._ann_backend
        for b in batches:
            want = [_fields(r) for r in one.search(b, k=K)]
            assert [_fields(r) for r in serving.search(b, k=K)] == want, tag
        piped = serving.search_pipelined(batches, k=K)
        assert [[_fields(r) for r in b] for b in piped] == \
            [[_fields(r) for r in b] for b in one.search_pipelined(batches, k=K)], tag

    same("first")
    batches.append(_add(serving.store, "again"))
    same("after a refresh")
    store = serving.store
    n = store.capacity - store.size + 1
    embs = ttesting.hash_embed([f"regrowth row {i}" for i in range(n)])
    store.add_chunks([TRecord(chunk_id=f"r{i}", doc_id=f"r{i}", text=f"regrowth row {i}",
                              embedding=embs[i]) for i in range(n)])
    same("after a re-shard")


@pytest.mark.cuda
def test_sharded_writer_thread_on_card():
    """A writer thread publishes documents and refresh()es the sharded
    engine (as the API's publish handlers do) while another thread searches
    it, batches of new keys captured and replayed; one publish grows the
    store (a re-shard), the rest are copied in place. Both succeed, and
    afterwards every batch replays bitwise what the eager program
    returns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _writer_and_searcher(_sharded_case("exact_S4", "cuda"))


@pytest.mark.cuda
def test_staged_writer_thread_on_card(monkeypatch):
    """The writer and the searching thread of
    test_sharded_writer_thread_on_card on the staged route (forced over
    [cuda:0] * 4: one graph per stage, joined by same-device copies)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    serving = _forced(monkeypatch, lambda: _sharded_case("exact_S4", "cuda"))
    assert isinstance(serving.programs, compiled.ProgramsByDevice)
    _writer_and_searcher(serving)


def _writer_and_searcher(serving: TEngine) -> None:
    import threading

    store, tse = serving.store, serving.sharded
    assert serving.graphs
    batches = _card_batches()
    errors, published = [], []

    def write():
        try:
            for i in range(8):
                n = store.capacity - store.size + 1 if i == 4 else 2  # the fifth grows
                texts = [f"writer doc {i} row {j}" for j in range(n)]
                embs = ttesting.hash_embed(texts)
                store.publish_document(f"w{i}", [
                    TRecord(chunk_id=f"w{i}-{j}", doc_id=f"w{i}", text=t, embedding=embs[j])
                    for j, t in enumerate(texts)])
                tse.refresh()
                published.append(i)
        except Exception as e:  # reported by the assertion below
            errors.append(("write", repr(e)))

    def search():
        try:
            for _ in range(3):
                for b in batches:
                    serving.search(b, k=K)
        except Exception as e:  # reported by the assertion below
            errors.append(("search", repr(e)))

    threads = [threading.Thread(target=write), threading.Thread(target=search)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors and not any(t.is_alive() for t in threads), errors
    assert len(published) == 8 and serving.programs.captures >= 2
    serving.graphs = False
    want = [[_fields(r) for r in serving.search(b, k=K)] for b in batches]
    serving.graphs = True
    assert [[_fields(r) for r in serving.search(b, k=K)] for b in batches] == want
    assert any(h.chunk_id == "w7-0" for h in serving.search(
        [tengine.QueryRequest(query="writer doc 7 row 0",
                              embedding=ttesting.hash_embed(["writer doc 7 row 0"])[0])],
        k=K)[0].hits)


# ---------------------------------------------------------------------------
# the API's sharded hooks
# ---------------------------------------------------------------------------

def test_api_keeps_the_sharded_engine_current(tmp_path):
    """A publish through the index RPC route refreshes the attached sharded
    engine through the store's listeners; a restore rebuilds it over the
    restored store, on the same grid."""
    import asyncio

    from aiohttp.test_utils import TestClient, TestServer

    from mobius_rag_tpu_torch.api.server import build_app
    from mobius_rag_tpu_torch.index.service import record_to_wire
    from test_torch_api import _context_under

    ctx = _context_under(tmp_path)
    ctx.store.add_chunks(ttesting.toy_corpus(ctx.engine.lexicon, pad_docs=8))
    mesh = make_mesh(2, devices=CPU)
    ctx.engine.sharded = ShardedEngine(ctx.store, mesh=mesh)
    rec = _zephyr("port")

    async def scenario():
        client = TestClient(TestServer(build_app(ctx)))
        await client.start_server()
        try:
            r = await client.post("/internal/index/publish", json={
                "doc_id": "zephyr_doc", "records": [record_to_wire(rec)]})
            assert r.status == 200
            r = await client.post("/api/query", json={"query": "zymurgy fermentation consult"})
            assert any(h["doc_id"] == "zephyr_doc" for h in (await r.json())["results"])
            assert not ctx.engine.sharded.stale
            r = await client.post("/admin/snapshot", json={})
            assert r.status == 200
            r = await client.post("/admin/restore", json={})
            assert r.status == 200
        finally:
            await client.close()

    old = ctx.engine.sharded
    asyncio.run(scenario())
    assert ctx.engine.sharded is not old and ctx.engine.sharded.store is ctx.store
    assert ctx.engine.sharded.mesh is mesh
