"""The port's overlapped SearchEngine.search_pipelined: it dispatches every
batch before it fetches any, and must return what one `search` per batch
returns, batch by batch, with empty timings.

Against the port's own `search` (the same operations on the same inputs):
hit ids, scores, similarities and signals, neighbours, confidence labels,
arm traces and strict counts all exactly equal. Against the JAX engine's
`search_pipelined` on the same seeded inputs: the tolerances of
tests/test_torch_engine.py (scores within 1e-5, ids equal except inside
runs of scores tied within 1e-6). Cases: the toy corpus, the 3,000-row
random corpus of test_torch_engine.py, the proj backend under dense and
under candidate-local gating (the JAX engine's ANN tables carried over
through the ann file), host residency with the funnel, and mixed batch
sizes; and the proj backend with MRAG_ANN_APPROX_TOPK=0.95, which both
packages serve exactly off a TPU.

On a card (`cuda`-marked, skipped here): each batch's dispatch (its
device program, the output packing and the non-blocking copies) runs
under torch.cuda.set_sync_debug_mode("error"), so nothing in it reads a
device value back, and each batch is prepared and dispatched well inside
a sleep of the card in front of it; and the strict counts of local gating come
back while the compute stream is still busy, so they wait only on their
own stream."""
import dataclasses
import time

import numpy as np
import pytest
import torch

from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu.config import get_config as jget_config
from mobius_rag_tpu.index.store import ChunkRecord as JRecord, ChunkStore as JStore
from mobius_rag_tpu.ingest.featurize import featurize_chunk as jfeaturize
from mobius_rag_tpu.query.engine import QueryRequest as JRequest, SearchEngine as JEngine
from mobius_rag_tpu_torch import testing as ttesting
from mobius_rag_tpu_torch.config import get_config as tget_config
from mobius_rag_tpu_torch.index.store import ChunkRecord as TRecord, ChunkStore as TStore
from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk as tfeaturize
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine, filter_masks
from test_torch_engine import N_RANDOM, TOY_REQUESTS, _random_store, check_results

torch.set_num_threads(1)

K = 5
_PROJ = dict(vector_backend="proj", ivf_nlist=8, ivf_nprobe=8, proj_p=64,
             lexical_format="sparse")
_HOST = dict(vector_residency="host", vector_dtype="int8", vector_backend="proj",
             ivf_nprobe=10 ** 6, over_fetch=8, ivf_nlist=8, proj_p=64,
             lexical_format="sparse", host_funnel=64)
# (query, request fields): payer filters on both sides of strict_total >= k,
# a filter that admits nothing, every tag_mode, recall with min_sim
FILTERED = [
    ("timely filing deadline for claims", dict(payer="sunshine_health")),
    ("prior authorization for durable medical equipment", dict(tag_mode="relaxed")),
    ("eligibility verification", dict(payer="molina", state="FL", tag_mode="none")),
    ("grievances and appeals timeline", dict(payer="nonexistent_payer")),
    ("provider credentialing requirements", dict(payer="aetna")),
    ("telehealth behavioral health outpatient", dict(mode="recall", min_similarity=0.1)),
]


def _split(reqs, sizes):
    out, off = [], 0
    for n in sizes:
        out.append(reqs[off:off + n])
        off += n
    assert off == len(reqs)
    return out


def _toy(tmp, sizes=(5, 1, 6)):
    jlex, tlex = jtesting.sample_lexicon(), ttesting.sample_lexicon()
    js, ts = JStore(), TStore(device="cpu")
    js.add_chunks(jtesting.toy_corpus(jlex, pad_docs=50))
    ts.add_chunks(ttesting.toy_corpus(tlex, pad_docs=50))
    return (JEngine(js, jlex, embed_fn=jtesting.hash_embed),
            SearchEngine(ts, tlex, embed_fn=ttesting.hash_embed, device="cpu"),
            _split([JRequest(query=q, **kw) for q, kw in TOY_REQUESTS], sizes),
            _split([QueryRequest(query=q, **kw) for q, kw in TOY_REQUESTS], sizes))


def _random(tmp):
    cfg = tget_config()
    jlex, tlex = jtesting.sample_lexicon(), ttesting.sample_lexicon()
    js, vectors, rng = _random_store(JStore, JRecord, jfeaturize, jlex, cfg.embed_dim,
                                     cfg.lexical_buckets)
    ts, _, _ = _random_store(TStore, TRecord, tfeaturize, tlex, cfg.embed_dim,
                             cfg.lexical_buckets)
    q = vectors[rng.choice(N_RANDOM, 12, replace=False)]
    q = q + 0.15 * rng.standard_normal(q.shape).astype(np.float32)
    payers = ["sunshine_health", "aetna", "molina"]
    specs = [(f"timely filing deadline for {payers[i % 3]} claims", {}) for i in range(8)]
    specs += [("claims filing authorization requirements",
               {"tag_mode": "none", "mode": "recall"})] * 4
    sizes = (4, 4, 4)
    return (JEngine(js, jlex), SearchEngine(ts, tlex, device="cpu"),
            _split([JRequest(query=s, embedding=q[i], **kw)
                    for i, (s, kw) in enumerate(specs)], sizes),
            _split([QueryRequest(query=s, embedding=q[i], **kw)
                    for i, (s, kw) in enumerate(specs)], sizes))


def _enrich(recs):
    for i, r in enumerate(recs):  # regulators and rows in another state
        if i % 11 == 0:
            r.payer, r.authority_level = "", 4
        if i % 7 == 0:
            r.state = "TX"
    return recs


def _ann_pair(tmp, fields, enrich=False, pad=100):
    """JAX and port engines over the same records with the JAX engine's
    ANN tables carried over to the port through the ann file."""
    jlex, tlex = jtesting.sample_lexicon(), ttesting.sample_lexicon()
    jcfg = dataclasses.replace(jget_config(), **fields)
    tcfg = dataclasses.replace(tget_config(), **fields)
    js, ts = JStore(jcfg), TStore(tcfg, device="cpu")
    jrecs, trecs = jtesting.toy_corpus(jlex, pad_docs=pad), ttesting.toy_corpus(tlex, pad_docs=pad)
    js.add_chunks(_enrich(jrecs) if enrich else jrecs)
    ts.add_chunks(_enrich(trecs) if enrich else trecs)
    je = JEngine(js, jlex, cfg=jcfg, embed_fn=jtesting.hash_embed)
    te = SearchEngine(ts, tlex, cfg=tcfg, embed_fn=ttesting.hash_embed, device="cpu")
    path = str(tmp / "ann.npz")
    je.save_ann(path)
    te.load_ann(path)
    sizes = (3, 3)  # one batch shape: one compile of the JAX program
    return (je, te, _split([JRequest(query=q, **kw) for q, kw in FILTERED], sizes),
            _split([QueryRequest(query=q, **kw) for q, kw in FILTERED], sizes))


CASES = {
    "toy": _toy,
    "random_3000": _random,
    "proj_dense": lambda tmp: _ann_pair(tmp, dict(_PROJ, gating="dense"), enrich=True),
    "proj_local": lambda tmp: _ann_pair(tmp, dict(_PROJ, gating="local"), enrich=True),
    "host_funnel": lambda tmp: _ann_pair(tmp, _HOST),
    # an approximate final top-k asked for: both engines select exactly
    "proj_approx_topk": lambda tmp: _ann_pair(tmp, dict(_PROJ, gating="dense",
                                                        ann_approx_topk=0.95), enrich=True),
    "mixed_sizes": lambda tmp: _toy(tmp, sizes=(1, 3, 2, 5, 1)),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cache = {}

    def get(name):
        if name not in cache:
            je, te, jb, tb = CASES[name](tmp_path_factory.mktemp(name))
            cache[name] = dict(te=te, piped=te.search_pipelined(tb, k=K),
                               sync=[te.search(b, k=K) for b in tb],
                               jpiped=je.search_pipelined(jb, k=K))
        return cache[name]
    return get


def _fields(res):
    """Everything a SearchResult reports but its timings."""
    tel = res.telemetry
    return (res.query, res.confidence_label, res.expansion.matched_codes,
            [(h.row, h.chunk_id, h.doc_id, h.score, h.similarity, h.signals, h.metadata,
              h.neighbors) for h in res.hits],
            tel["arms"], tel["strict_count"], tel["expansion_log"], tel["mode"])


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_equals_search_per_batch(runs, case):
    r = runs(case)
    assert [len(b) for b in r["piped"]] == [len(b) for b in r["sync"]]
    for piped, sync in zip(r["piped"], r["sync"]):
        for a, b in zip(piped, sync):
            assert _fields(a) == _fields(b)
            assert a.telemetry["timings_ms"] == {}
    assert any(res.hits for batch in r["piped"] for res in batch)


@pytest.mark.parametrize("case", list(CASES))
def test_pipelined_matches_jax_pipelined(runs, case):
    r = runs(case)
    jflat = [x for b in r["jpiped"] for x in b]
    tflat = [x for b in r["piped"] for x in b]
    assert len(jflat) == len(tflat)
    for i in range(len(tflat)):
        check_results(jflat, tflat, i)


def test_cases_exercise_the_paths(runs):
    assert runs("proj_local")["te"]._ann_gate is not None
    assert runs("proj_dense")["te"]._ann_gate is None
    assert runs("proj_approx_topk")["te"].cfg.ann_approx_topk == 0.95
    host = runs("host_funnel")["te"]
    assert host._device_funnel(K) == 64 and host._device_k(K) == K * 8
    counts = [res.telemetry["strict_count"] for b in runs("proj_local")["piped"] for res in b]
    assert any(c >= K for c in counts) and any(c < K for c in counts)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

def _card_engine(backend: str, gating: str):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    fields = dict(_PROJ, gating=gating) if backend == "proj" else {}
    cfg = dataclasses.replace(tget_config(), **fields)
    lex = ttesting.sample_lexicon()
    store = TStore(cfg, device="cuda")
    store.add_chunks(_enrich(ttesting.toy_corpus(lex, pad_docs=150)))
    return SearchEngine(store, lex, cfg=cfg, embed_fn=ttesting.hash_embed, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("backend,gating", [("exact", "dense"), ("proj", "dense"),
                                            ("proj", "local")])
def test_dispatch_never_waits_on_card(backend, gating):
    engine = _card_engine(backend, gating)
    reqs = [QueryRequest(query=q, **kw) for q, kw in FILTERED]
    batches = [reqs, reqs[:2], reqs[3:]]
    want = [engine.search(b, k=K) for b in batches]  # builds the tables and kernels
    ann = engine.ensure_ann()
    local = engine._ensure_local_structs(ann)
    assert (local is not None) == (gating == "local")
    pending = []
    for batch in batches:
        # each batch prepared and enqueued while the card sleeps in front of
        # it: the host finishes well inside the sleep, so nothing in it
        # waited for the card (one batch's launches fit the launch queue;
        # several would fill it, and the host would block on the queue)
        torch.cuda.synchronize()
        ready = torch.cuda.Event()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        ready.record()
        start.record()
        torch.cuda._sleep(1_000_000_000)
        end.record()
        t0 = time.perf_counter()
        q, exps = engine.prepare_batch(batch, ready)
        torch.cuda.set_sync_debug_mode("error")
        try:
            fetch = engine._dispatch(q, exps, ann, local, K)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        host_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        assert host_ms < start.elapsed_time(end) / 2, "the dispatch waited for the card"
        pending.append((batch, exps, fetch))
    for (batch, exps, fetch), sync in zip(pending, want):
        got = engine._assemble(list(batch), exps, engine._finish(batch, exps, fetch.wait(), K), K)
        assert [_fields(a) for a in got] == [_fields(b) for b in sync]
    piped = engine.search_pipelined(batches, k=K)
    assert [[_fields(a) for a in b] for b in piped] == [[_fields(a) for a in b] for b in want]


@pytest.mark.cuda
def test_strict_counts_wait_on_their_own_stream_on_card():
    engine = _card_engine("proj", "local")
    reqs = [QueryRequest(query=q, **kw) for q, kw in FILTERED]
    engine.search(reqs, k=K)
    fresh = [QueryRequest(query="timely filing", payer=p) for p in ("aetna", "molina")]
    ready = torch.cuda.Event()
    ready.record()
    torch.cuda._sleep(2_000_000_000)  # about a second of one busy SM
    q, _ = engine.prepare_batch(fresh, ready)  # two filter signatures not yet counted
    busy = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert busy, "the strict counts waited for the compute stream"
    strict = filter_masks(engine.store.index, q)[0]  # the dense gate's count
    assert torch.equal(q["strict_total"], strict.sum(dim=1))
