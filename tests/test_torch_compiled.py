"""The captured search programs (``mobius_rag_tpu_torch/query/compiled.py``)
and the lexical union pads they key on.

On the CPU:
- ``prepare_batch``'s ``lex_buckets`` and ``lex_weights`` against the JAX
  engine's, bitwise, for unions of 1, 128, 129, 600 and 2,100 buckets (every
  pad of ``_BUCKET_PADS`` and the bucket count past the largest), and the
  search results of those batches against the JAX engine's, at
  tests/test_torch_engine.py's tolerances;
- the union columns the device program reads: on a card the live ones
  rounded up (``_union_width``), sharded or not, on the CPU exactly the
  live ones; ``_device_batch`` (profile_engine's) reads the same;
- the cache's bookkeeping with a stand-in for the capture (the program run
  eagerly, a replay running it again into the static outputs): the key
  changes with B, the union columns read, k, the funnel, a grow, a
  bulk_load and an ANN rebuild, and holds across in-place add_chunks and
  deletes; the LRU bound; the tables' tensors held by each graph; the
  launch counters' deltas added on every replay; results equal to the
  eager program's; and the card test's write sequence for every backend;
- ``graphs=None`` on a CPU engine runs eagerly, ``graphs=True`` raises;
- the encoders' captured forwards (models/encoder.CapturedForward) with
  the stand-in: keys (batch or pair bucket, sequence bucket), an in-place
  load_tree keeping them and a new module dropping them, the LRU bound,
  ``graphs=True`` on the CPU raising; and both /admin/profile handlers and
  capture_trace starting and stopping the profiler under compiled.LOCK.

On a card (``cuda``-marked, skipped here; ``scripts/card_tests.py``): the
replay bitwise against the eager program (``graphs=False``) for exact
float32, bf16 and int8 rows, proj under dense and local gating, ivf,
packed, pq and the host funnel, over 9 batches (searched and pipelined)
spanning two batch sizes, several union widths and, under local gating,
two tag levels; again after an in-place add, after a write carrying
d-tags and after a grow; kernel launches equal captured and eager (one a
batch where the path launches one); a writer thread publishing inside
the captures; two threads searching one engine at once; which calls
of another thread each capture mode refuses; and an ingesting, a
searching and a profiling thread on one engine and one encoder."""
import dataclasses

import numpy as np
import pytest
import torch

from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu.config import get_config as jget_config
from mobius_rag_tpu.index.store import ChunkStore as JStore
from mobius_rag_tpu.query.engine import QueryRequest as JRequest, SearchEngine as JEngine
from mobius_rag_tpu_torch import testing as ttesting
from mobius_rag_tpu_torch.config import get_config as tget_config
from mobius_rag_tpu_torch.index.store import ChunkRecord as TRecord, ChunkStore as TStore
from mobius_rag_tpu_torch.models import cross_encoder as tce
from mobius_rag_tpu_torch.models import encoder as tenc
from mobius_rag_tpu_torch.ops.proj_scan import proj_blocks, proj_gated_blocks
from mobius_rag_tpu_torch.ops.topk import masked_topk
from mobius_rag_tpu_torch.query import compiled
from mobius_rag_tpu_torch.query.compiled import CapturedPrograms
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine, _union_width
from mobius_rag_tpu_torch.query.text import hash_bucket, normalize_query, tokenize_terms
from test_torch_engine import check_results, jax_q_numpy, port_q_numpy

torch.set_num_threads(1)

K = 5
H = 4096  # lexical buckets: room for a 2,100-bucket union past the largest pad
UNIONS = {1: 128, 128: 128, 129: 512, 600: 2048, 2100: H}  # union size -> padded width


def _words(n: int) -> list[str]:
    """n words whose tokens fall into n distinct lexical buckets."""
    out, seen = [], set()
    i = 0
    while len(out) < n:
        w = f"zq{i}v"
        i += 1
        (tok,) = tokenize_terms(normalize_query(w), drop_stopwords=True)
        b = hash_bucket(tok, H)
        if b not in seen:
            seen.add(b)
            out.append(w)
    return out


def _texts(n_buckets: int, b: int = 4) -> list[str]:
    """b query texts whose union holds exactly n_buckets buckets (the
    words dealt round-robin; a request with no word of its own repeats the
    first word)."""
    words = _words(n_buckets)
    texts = [" ".join(words[i::b]) or words[0] for i in range(b)]
    return texts


@pytest.fixture(scope="module")
def padded():
    jcfg = dataclasses.replace(jget_config(), lexical_buckets=H)
    tcfg = dataclasses.replace(tget_config(), lexical_buckets=H)
    jlex, tlex = jtesting.sample_lexicon(), ttesting.sample_lexicon()
    js, ts = JStore(jcfg), TStore(tcfg, device="cpu")
    js.add_chunks(jtesting.toy_corpus(jlex, pad_docs=20))
    ts.add_chunks(ttesting.toy_corpus(tlex, pad_docs=20))
    je = JEngine(js, jlex, cfg=jcfg, embed_fn=jtesting.hash_embed)
    te = SearchEngine(ts, tlex, cfg=tcfg, embed_fn=ttesting.hash_embed, device="cpu")
    return je, te


@pytest.mark.parametrize("n_buckets", sorted(UNIONS))
def test_union_pads_match_jax(padded, n_buckets):
    je, te = padded
    texts = _texts(n_buckets)
    jq, _ = je.prepare_batch([JRequest(query=t) for t in texts])
    tq, _ = te.prepare_batch([QueryRequest(query=t) for t in texts])
    jq, tq = jax_q_numpy(jq), port_q_numpy(tq)
    assert int((tq["lex_weights"] != 0).any(axis=0).sum()) == n_buckets
    assert tq["lex_buckets"].shape == (UNIONS[n_buckets],)
    assert tq["lex_weights"].shape == (len(texts), UNIONS[n_buckets])
    for key in ("lex_buckets", "lex_weights"):
        assert tq[key].dtype == jq[key].dtype
        np.testing.assert_array_equal(tq[key], jq[key])
    assert not tq["lex_weights"][:, n_buckets:].any()
    assert not tq["lex_buckets"][n_buckets:].any()
    assert te.prepare_host([QueryRequest(query=t) for t in texts])[0].union == n_buckets


@pytest.mark.parametrize("union,u,want", [(0, 128, 16), (1, 128, 16), (16, 128, 16),
                                          (17, 128, 32), (128, 128, 128), (129, 512, 256),
                                          (600, 2048, 1024), (2100, 4096, 4096)])
def test_union_columns_read(union, u, want):
    """The device program reads the live columns rounded up to a power of
    two, at least 16, within the padded width."""
    assert _union_width(union, u) == want


@pytest.mark.parametrize("device,sharded,rounded", [("cpu", None, False),
                                                    ("cuda", None, True),
                                                    ("cuda", "a grid", True),
                                                    ("cpu", "a grid", False)])
def test_union_columns_read_by_engine(device, sharded, rounded):
    """A card's program, one-device or sharded, captured or not, reads
    _union_width columns; the CPU's, which never captures, reads exactly
    the live ones. The rule alone: no card is touched."""
    engine = _toy_engine()
    host, _ = engine.prepare_host(_reqs(3))
    assert 16 < host.union < 32 and host["lex_buckets"].shape == (128,)
    engine.device, engine.sharded = torch.device(device), sharded
    assert engine._union_read(host) == (32 if rounded else host.union)


def test_device_batch_is_what_the_program_reads():
    """``_device_batch`` (profile_engine's batch) is the batch cut to the
    columns read, queries in bf16; prepare_batch
    keeps the JAX engine's padded union, and its host arrays ride along."""
    engine = _toy_engine()
    host, _ = engine.prepare_host(_reqs(3))
    got = engine._device_batch(host)
    assert got["lex_buckets"].shape == (host.union,)
    assert got["lex_weights"].shape == (3, host.union) and got["vec"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["lex_weights"].numpy(), host["lex_weights"][:, :host.union])
    full, _ = engine.prepare_batch(_reqs(3))
    assert full["lex_buckets"].shape == (128,) and full.host.union == host.union
    for key in host:
        np.testing.assert_array_equal(full.host[key], host[key])


@pytest.mark.parametrize("n_buckets", sorted(UNIONS))
def test_padded_batches_search_like_jax(padded, n_buckets):
    je, te = padded
    # a real query beside the made-up words, so that every arm scores something
    texts = [t + " timely filing deadline claims" for t in _texts(n_buckets)]
    jres = je.search([JRequest(query=t) for t in texts], k=K)
    tres = te.search([QueryRequest(query=t) for t in texts], k=K)
    assert any(r.hits for r in tres)
    for i in range(len(texts)):
        check_results(jres, tres, i)


# ---------------------------------------------------------------------------
# the cache's bookkeeping, with a stand-in for the capture
# ---------------------------------------------------------------------------

class _Replay:
    """A stand-in graph: replaying runs the program again on the static
    inputs and writes its outputs into the static outputs."""

    def __init__(self, program, static, outputs):
        self.program, self.static, self.outputs = program, static, outputs

    def replay(self):
        counts = [fn.launches for fn in compiled.COUNTED]  # a replay runs no Python
        outputs, new = self.outputs, self.program(self.static)
        if isinstance(outputs, torch.Tensor):  # an encoder's forward, a sharded stage
            outputs, new = (outputs,), (new,)
        with torch.inference_mode():  # a sharded stage's outputs are inference tensors
            for out, fresh in zip(outputs, new):
                out.copy_(fresh)
        for fn, n in zip(compiled.COUNTED, counts):
            fn.launches = n


class StandIn(CapturedPrograms):
    """CapturedPrograms on the CPU: the capture runs the program eagerly
    (so the launch counters move as a real capture moves them)."""

    def _check_device(self) -> None:
        pass

    def _capture(self, program, static):
        outputs = program(static)
        return _Replay(program, static, outputs), outputs

    def run(self, key, held, q, program, inputs=None):
        # on a card the engine copies a replay's static outputs to the host
        # right behind it (PendingFetch); on the CPU it keeps the arrays
        # it is given, so the stand-in hands out the copies
        out = super().run(key, held, q, program, inputs)
        if isinstance(out, torch.Tensor):  # an encoder's forward
            return out.clone()
        return tuple(t.clone() for t in out)


def _reads_as_card(engine: SearchEngine) -> SearchEngine:
    """`engine` reading the lexical union as an engine on a card reads it
    (the live columns rounded up by _union_width), so that a stand-in and
    an eager engine on the CPU run the card's program."""
    engine._union_read = lambda q: _union_width(q.union, q["lex_buckets"].shape[0])
    return engine


def _stand_in(engine: SearchEngine, max_graphs: int = compiled.MAX_GRAPHS) -> StandIn:
    _reads_as_card(engine)
    engine._programs = StandIn(engine.device, max_graphs)
    engine._graphs = True
    return engine._programs


def _fields(res):
    return (res.confidence_label, res.telemetry["strict_count"],
            [(h.chunk_id, h.score, h.similarity, h.signals) for h in res.hits],
            {a: [(t["row"], t["score"]) for t in v] for a, v in res.telemetry["arms"].items()})


def _toy_engine(**cfg_fields) -> SearchEngine:
    cfg = dataclasses.replace(tget_config(), **cfg_fields)
    lex = ttesting.sample_lexicon()
    store = TStore(cfg, device="cpu")
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=20))
    return SearchEngine(store, lex, cfg=cfg, embed_fn=ttesting.hash_embed, device="cpu")


def _reqs(n: int, extra: str = "") -> list[QueryRequest]:
    texts = ["timely filing deadline for claims", "prior authorization requirements",
             "behavioral health telehealth", "eligibility verification molina"]
    return [QueryRequest(query=texts[i % len(texts)] + extra, payer="aetna" if i % 3 else "")
            for i in range(n)]


def test_graphs_default_is_eager_on_cpu_and_true_raises():
    engine = _toy_engine()
    assert engine.graphs is False and engine._programs is None
    assert engine.search(_reqs(2), k=K)[0].hits
    with pytest.raises(ValueError, match="CUDA"):
        SearchEngine(engine.store, engine.lexicon, cfg=engine.cfg, device="cpu", graphs=True)
    with pytest.raises(ValueError, match="CUDA"):
        engine.graphs = True
    assert engine.graphs is False


def test_key_changes_on_b_union_pad_and_k_and_results_match_eager():
    engine = _toy_engine()
    eager = _reads_as_card(SearchEngine(engine.store, engine.lexicon, cfg=engine.cfg,
                                        embed_fn=ttesting.hash_embed, device="cpu",
                                        graphs=False))
    cache = _stand_in(engine)
    wide = " " + " ".join(_words(140)[4:])  # pushes a 2-request union past 128 buckets
    runs = [(_reqs(2), K), (_reqs(3), K), (_reqs(2), K), (_reqs(2, wide), K),
            (_reqs(2), K + 1), (_reqs(3), K), (_reqs(2, wide), K)]
    for batch, k in runs:
        got = engine.search(batch, k=k)
        assert [_fields(r) for r in got] == [_fields(r) for r in eager.search(batch, k=k)]
    assert cache.captures == 4 and cache.replays == 3
    pads = {engine.prepare_host(b)[0]["lex_buckets"].shape[0] for b, _ in runs}
    assert pads == {128, 512}
    widths = {dict((name, shape) for name, shape, _ in layout)["lex_buckets"][0]
              for _, layout in cache.graphs}
    # the live columns rounded up (16 and 24 live: 16 and 32; past 128: 256), not the pads
    assert widths == {16, 32, 256}
    ks = {key[0] for key, _ in cache.graphs}
    assert ks == {K, K + 1}
    piped = engine.search_pipelined([b for b, _ in runs], k=K)
    want = [eager.search(b, k=K) for b, _ in runs]
    assert [[_fields(r) for r in b] for b in piped] == [[_fields(r) for r in b] for b in want]


def test_key_holds_across_in_place_writes_and_changes_on_grow_and_bulk_load():
    engine = _toy_engine(initial_capacity=512)
    store = engine.store
    cache = _stand_in(engine)
    batch = _reqs(2)
    engine.search(batch, k=K)
    entry = next(iter(cache.graphs.values()))
    assert entry.held[0] is store.index.vectors  # the graph keeps its tables alive
    assert any(t is store.index.lexical for t in entry.held)
    index0 = store.index
    emb = ttesting.hash_embed(["fresh zebra rider policy"])[0]
    store.add_chunks([TRecord(chunk_id="fresh-1", doc_id="fresh", text="fresh zebra rider",
                              embedding=emb, payer="aetna")])
    got = engine.search([QueryRequest(query="fresh zebra rider", embedding=emb)] * 2, k=K)
    assert store.index is index0 and cache.captures == 1 and cache.replays == 1
    assert got[0].hits[0].chunk_id == "fresh-1"  # the replay reads the in-place write
    store.delete_by_document("fresh")
    got = engine.search([QueryRequest(query="fresh zebra rider", embedding=emb)] * 2, k=K)
    assert cache.captures == 1 and all(h.chunk_id != "fresh-1" for h in got[0].hits)
    # grow: a new index, the old graphs dropped at the next batch
    n = store.capacity - store.size + 1  # one row past capacity, free rows reused first
    embs = ttesting.hash_embed([f"growth row {i}" for i in range(n)])
    store.add_chunks([TRecord(chunk_id=f"g{i}", doc_id=f"g{i}", text=f"growth row {i}",
                              embedding=embs[i]) for i in range(n)])
    assert store.index is not index0
    engine.search(batch, k=K)
    assert cache.captures == 2 and len(cache.graphs) == 1
    assert next(iter(cache.graphs.values())).held[0] is store.index.vectors


def test_key_changes_on_bulk_load():
    cfg = dataclasses.replace(tget_config(), initial_capacity=512)
    lex = ttesting.sample_lexicon()
    store = TStore(cfg, device="cpu")
    engine = SearchEngine(store, lex, cfg=cfg, embed_fn=ttesting.hash_embed, device="cpu")
    eager = _reads_as_card(SearchEngine(store, lex, cfg=cfg, embed_fn=ttesting.hash_embed,
                                        device="cpu"))
    cache = _stand_in(engine)
    batch = _reqs(2)
    assert not any(r.hits for r in engine.search(batch, k=K))  # an empty store
    index0 = store.index
    store.bulk_load(ttesting.toy_corpus(lex, pad_docs=5))
    assert store.index is not index0
    got = engine.search(batch, k=K)
    assert any(r.hits for r in got)
    assert [_fields(r) for r in got] == [_fields(r) for r in eager.search(batch, k=K)]
    assert cache.captures == 2 and len(cache.graphs) == 1


@pytest.mark.parametrize("backend", ["proj", "ivf"])
def test_key_changes_on_ann_rebuild_not_on_incremental_proj_writes(backend):
    """An add goes into proj's reserved slabs in place (the key holds);
    ivf rebuilds its tables (the key changes)."""
    engine = _toy_engine(vector_backend=backend, ivf_nlist=8, ivf_nprobe=8, proj_p=64,
                         lexical_format="sparse", gating="dense")
    cache = _stand_in(engine)
    batch = _reqs(2)
    engine.search(batch, k=K)
    ann0 = engine._ann
    tables = ann0.codes if backend == "proj" else ann0.members
    assert any(t is tables for t in next(iter(cache.graphs.values())).held)
    emb = ttesting.hash_embed(["reserved slab rider"])[0]
    engine.store.add_chunks([TRecord(chunk_id="r-1", doc_id="r", text="reserved slab rider",
                                     embedding=emb)])
    got = engine.search([QueryRequest(query="reserved slab rider", embedding=emb)] * 2, k=K)
    assert got[0].hits[0].chunk_id == "r-1"
    if backend == "proj":
        assert engine._ann is ann0 and cache.captures == 1 and cache.replays == 1
    else:
        assert engine._ann is not ann0 and cache.captures == 2 and len(cache.graphs) == 1


def test_key_changes_on_the_funnel():
    engine = _toy_engine(vector_residency="host", vector_dtype="int8", vector_backend="proj",
                         ivf_nprobe=10 ** 6, over_fetch=8, ivf_nlist=8, proj_p=64,
                         lexical_format="sparse", host_funnel=64)
    eager = _reads_as_card(SearchEngine(engine.store, engine.lexicon, cfg=engine.cfg,
                                        embed_fn=ttesting.hash_embed, device="cpu"))
    cache = _stand_in(engine)
    batch = _reqs(2)
    for funnel in (64, 96, 64):
        engine.cfg = eager.cfg = dataclasses.replace(engine.cfg, host_funnel=funnel)
        got = engine.search(batch, k=K)
        assert [_fields(r) for r in got] == [_fields(r) for r in eager.search(batch, k=K)]
    assert sorted(key[1] for key, _ in cache.graphs) == [64, 96]
    assert cache.captures == 2 and cache.replays == 1


def test_lru_bound():
    engine = _toy_engine()
    cache = _stand_in(engine, max_graphs=2)
    for b in (1, 2, 3, 1):
        engine.search(_reqs(b), k=K)
    batch_sizes = [dict((n, s) for n, s, _ in layout)["vec"][0] for _, layout in cache.graphs]
    assert batch_sizes == [3, 1] and cache.captures == 4  # 1 was evicted by 3, then recaptured


def test_launch_deltas_added_per_replay(monkeypatch):
    def kernel():
        kernel.launches += 1

    kernel.launches = 0
    monkeypatch.setattr(compiled, "COUNTED", (kernel,))
    cache = StandIn("cpu")

    def program(q):
        kernel()
        kernel()
        return (q["x"] * 2.0,)

    def host(x):
        return {"vec": np.zeros((2, 4), np.float32), "x": np.asarray(x, np.float32)}

    out = cache.run(("key",), [], host([1, 2, 3]), program)
    assert kernel.launches == 2  # the eager first run; the capture's two are taken back
    assert cache.captures == 1 and cache.graphs[next(iter(cache.graphs))].deltas == (2,)
    for i in range(3):
        out = cache.run(("key",), [], host([i, 5, 6]), program)
        np.testing.assert_array_equal(out[0].numpy(), [2 * i, 10, 12])
    assert kernel.launches == 8 and cache.replays == 3


# ---------------------------------------------------------------------------
# the encoders' forwards (models/encoder.CapturedForward)
# ---------------------------------------------------------------------------

def _encoder(**kw) -> tenc.EncoderModel:
    """A tiny encoder on the CPU whose texts reach three sequence buckets
    (64, 128 and max_seq 256)."""
    cfg = dataclasses.replace(tenc.EncoderConfig.tiny(), max_seq=256)
    return tenc.EncoderModel(cfg, device="cpu", **kw)


def _model_stand_in(model, max_graphs: int = compiled.MAX_GRAPHS) -> StandIn:
    model._programs = StandIn(model.device, max_graphs)
    model._graphs = True
    return model._programs


def _texts_of(n: int, words: int, tag: str = "") -> list[str]:
    return [" ".join(f"w{(i * 7 + j) % 50}" for j in range(words)) + f" {tag}{i}"
            for i in range(n)]


# (texts, words a text) per call → the (batch bucket, length) keys it reaches
_ENCODER_CALLS = [((3, 10), [(8, 64)]), ((3, 10), [(8, 64)]), ((1, 100), [(1, 128)]),
                  ((9, 200), [(32, 256)]), ((130, 10), [(128, 64), (8, 64)]),
                  ((33, 100), [(128, 128)]), ((9, 10), [(32, 64)])]


def test_encoder_keys_are_bucket_and_length():
    """One graph per (batch bucket, sequence bucket) of the padded block:
    the replays and the first runs give the eager model's rows bitwise,
    without the padded rows."""
    model, eager = _encoder(), _encoder(graphs=False)
    cache = _model_stand_in(model)
    keys = []
    for (n, words), reached in _ENCODER_CALLS:
        texts = _texts_of(n, words)
        got = model(texts)
        assert got.shape == (n, model.cfg.out_dim)
        np.testing.assert_array_equal(got, eager(texts))
        keys += [k for k in reached if k not in keys]
    assert sorted(key for key, _ in cache.graphs) == sorted(keys)
    assert all(layout == (("tokens", key, torch.int32),) for key, layout in cache.graphs)
    assert cache.captures == len(keys) == 6 and cache.replays == 2


def test_cross_encoder_keys_are_pair_bucket_and_length(monkeypatch):
    """The cross-encoder's graphs are keyed on (pair bucket, sequence
    bucket), at either pair step; its logits are the eager model's."""
    cfg = tce.CrossEncoderConfig(dataclasses.replace(tenc.EncoderConfig.tiny(), max_seq=256))
    model = tce.CrossEncoderModel(cfg, device="cpu")
    eager = tce.CrossEncoderModel(cfg, model.module.params_tree(), device="cpu", graphs=False)
    cache = _model_stand_in(model)
    for step in (32, 8):
        monkeypatch.setattr(model, "pair_step", step)
        monkeypatch.setattr(eager, "pair_step", step)
        for n, words in ((10, 10), (10, 100), (3, 200), (10, 10)):
            docs = _texts_of(n, words)
            np.testing.assert_array_equal(model("a query", docs), eager("a query", docs))
    assert sorted(key for key, _ in cache.graphs) == [(8, 256), (16, 64), (16, 128),
                                                      (32, 64), (32, 128)]
    assert cache.captures == 5 and cache.replays == 3


def test_encoder_graphs_follow_the_module():
    """An in-place load_tree (or a training step) keeps the graphs, and their
    replays read the new parameters; a new module drops them."""
    model = _encoder()
    cache = _model_stand_in(model)
    texts = _texts_of(3, 10)
    model(texts)
    fresh = tenc.init_params(model.cfg, torch.Generator().manual_seed(5))
    model.module.load_tree(fresh)
    got = model(texts)
    assert cache.captures == 1 and cache.replays == 1
    np.testing.assert_array_equal(got, _encoder(params=fresh, graphs=False)(texts))
    model.module = tenc.Encoder(model.cfg, fresh, device="cpu")
    np.testing.assert_array_equal(model(texts), got)
    assert cache.captures == 2 and len(cache.graphs) == 1
    assert next(iter(cache.graphs.values())).held[0] is model.module.embed


def test_encoder_lru_bound():
    model = _encoder()
    cache = _model_stand_in(model, max_graphs=2)
    for n in (1, 5, 20, 1):
        model(_texts_of(n, 10))
    assert [key for key, _ in cache.graphs] == [(32, 64), (1, 64)] and cache.captures == 4


def test_encoder_graphs_true_on_cpu_raises():
    model = _encoder()
    assert model.graphs is False and model._programs is None
    for make in (lambda: _encoder(graphs=True),
                 lambda: tce.CrossEncoderModel(tce.CrossEncoderConfig.tiny(), device="cpu",
                                               graphs=True)):
        with pytest.raises(ValueError, match="CUDA"):
            make()
    with pytest.raises(ValueError, match="CUDA"):
        model.graphs = True
    assert model.graphs is False


class _RecordingLock:
    """compiled.LOCK's stand-in: whether it is held, and how often it was
    taken."""

    def __init__(self):
        self.held, self.taken = False, 0

    def __enter__(self):
        assert not self.held
        self.held, self.taken = True, self.taken + 1

    def __exit__(self, *exc):
        self.held = False


@pytest.fixture
def profiler_log(monkeypatch):
    """compiled.LOCK replaced by a recording lock and torch.profiler.profile
    by a recorder: the log holds (event, lock held) for each profiler start
    and stop and each search."""
    lock, log = _RecordingLock(), []

    class Profile:
        def __init__(self, activities=None):
            pass

        def start(self):
            log.append(("start", lock.held))

        def stop(self):
            log.append(("stop", lock.held))

        def export_chrome_trace(self, path):
            with open(path, "w") as f:
                f.write('{"traceEvents": []}')

    real = SearchEngine.search

    def search(self, *a, **kw):
        log.append(("search", lock.held))
        return real(self, *a, **kw)

    monkeypatch.setattr(compiled, "LOCK", lock)
    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(SearchEngine, "search", search)
    return log


def test_capture_trace_starts_and_stops_under_the_lock(profiler_log, tmp_path):
    from mobius_rag_tpu_torch.profiling import capture_trace

    out = capture_trace(_toy_engine(), _reqs(2), k=K, n_batches=2, logdir=str(tmp_path))
    assert out["ok"]
    assert profiler_log == [("search", False), ("start", True), ("search", False),
                            ("search", False), ("stop", True)]


def test_profile_routes_start_and_stop_under_the_lock(profiler_log, tmp_path):
    """Both handlers registered at POST /admin/profile (api/extended.py's,
    which aiohttp serves, and api/server.py's) start and stop the profiler
    under compiled.LOCK, and search without it."""
    import asyncio

    from mobius_rag_tpu_torch.api.server import build_app
    from test_torch_api import _context_under

    ctx = _context_under(tmp_path)
    ctx.store.add_chunks(ttesting.toy_corpus(ctx.engine.lexicon))
    handlers = [route.handler for route in build_app(ctx).router.routes()
                if route.method == "POST" and route.resource.canonical == "/admin/profile"]
    assert len(handlers) == 2

    class Request:
        can_read_body = True

        async def json(self):
            return {"iters": 1, "k": K, "trace": True, "repetitions": 2}

    for handler in handlers:
        profiler_log.clear()
        resp = asyncio.new_event_loop().run_until_complete(handler(Request()))
        assert resp.status == 200
        starts = [i for i, (event, _) in enumerate(profiler_log) if event == "start"]
        assert len(starts) == 1 and profiler_log[-1] == ("stop", True)
        assert profiler_log[starts[0]] == ("start", True)
        inside = profiler_log[starts[0] + 1:-1]
        assert inside and all(e == ("search", False) for e in inside)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

_PROJ = dict(vector_backend="proj", ivf_nlist=16, ivf_nprobe=8, proj_p=128,
             lexical_format="sparse")
_IVF = dict(ivf_nlist=16, ivf_nprobe=8, lexical_format="sparse")
# case -> (config fields, the kernel its program launches once a batch, or
# None where no hand kernel is on the path)
_CARD_CASES = {
    "exact_f32": (dict(vector_dtype="float32"), masked_topk),
    "exact_bf16": (dict(vector_dtype="bfloat16"), masked_topk),
    "exact_int8": (dict(vector_dtype="int8"), masked_topk),
    "proj_dense": (dict(_PROJ, vector_dtype="bfloat16", gating="dense"), proj_blocks),
    "proj_local": (dict(_PROJ, gating="local"), proj_gated_blocks),
    "ivf": (dict(_IVF, vector_backend="ivf"), None),
    "packed": (dict(_IVF, vector_backend="packed"), proj_blocks),
    "pq": (dict(_IVF, vector_backend="pq", pq_m=32), None),
    "host_funnel": (dict(vector_residency="host", vector_dtype="int8", vector_backend="proj",
                         ivf_nprobe=10 ** 6, over_fetch=8, ivf_nlist=8, proj_p=64,
                         lexical_format="sparse", host_funnel=64), proj_gated_blocks),
}
# the four cases whose kernel launches exactly once a batch, asserted so
_ONE_LAUNCH = ("exact_f32", "exact_bf16", "exact_int8", "proj_dense")


def _card_batches() -> list[list[QueryRequest]]:
    """9 batches: sizes 2 and 8, unions within 128 buckets and past them,
    and one whose queries name no tag (tag level 0 under local gating)."""
    wide = " ".join(_words(160))
    out = []
    for j in range(8):
        n = 8 if j % 2 else 2
        extra = f" {wide}" if j % 4 >= 2 else ""
        out.append(_reqs(n, extra))
    out.append([QueryRequest(query=" ".join(_words(12)), payer="aetna")] * 2)
    return out


def _case_engine(case: str, device: str) -> SearchEngine:
    cfg = dataclasses.replace(tget_config(), initial_capacity=1024, **_CARD_CASES[case][0])
    lex = ttesting.sample_lexicon()
    store = TStore(cfg, device=device)
    store.add_chunks(ttesting.toy_corpus(lex, pad_docs=60))
    return SearchEngine(store, lex, cfg=cfg, embed_fn=ttesting.hash_embed, device=device)


def _add(store, name: str, **fields) -> list[QueryRequest]:
    """One record named `name` added; a batch of two requests that find it."""
    text = f"{name} zebra rider policy"
    emb = ttesting.hash_embed([text])[0]
    store.add_chunks([TRecord(chunk_id=f"{name}-1", doc_id=name, text=text, embedding=emb,
                              payer="aetna", **fields)])
    return [QueryRequest(query=text, embedding=emb)] * 2


def _writes_replay_bitwise(engine: SearchEngine, kernel=None, per_batch: int | None = None
                           ) -> None:
    """The replay against the eager program (``graphs=False``, the same
    engine) over every batch, searched and pipelined, bitwise; each
    counted kernel launched as often captured as eager (`kernel`, on a
    card: `per_batch` times a batch, or at all). Then again after an add
    (in place for exact and proj: the graphs kept; ivf, packed and pq
    rebuild their tables; under sharding a refresh copies the row in
    place, or re-shards the sparse postings), after an add that carries
    d-tags (local gating rebuilds its d-tag postings: new graphs) and
    after a grow (new graphs)."""
    store, cache = engine.store, engine.programs
    batches = _card_batches()
    widths = {engine._union_read(engine.prepare_host(b)[0]) for b in batches}
    assert len(widths) >= 2 and len({len(b) for b in batches}) >= 2

    def both(tag):
        engine.graphs = False
        before = [fn.launches for fn in compiled.COUNTED]
        want = [[_fields(r) for r in engine.search(b, k=K)] for b in batches]
        eager = [fn.launches - n for fn, n in zip(compiled.COUNTED, before)]
        engine.graphs = True
        before = [fn.launches for fn in compiled.COUNTED]
        got = [[_fields(r) for r in engine.search(b, k=K)] for b in batches]
        piped = [[_fields(r) for r in b] for b in engine.search_pipelined(batches, k=K)]
        graph = [fn.launches - n for fn, n in zip(compiled.COUNTED, before)]
        assert graph == [2 * n for n in eager], tag
        if kernel is not None and engine.device.type == "cuda":  # the CPU counts none
            launched = eager[compiled.COUNTED.index(kernel)]
            assert launched == per_batch * len(batches) if per_batch else launched > 0, tag
        assert got == want, tag
        assert piped == want, tag

    both("first")
    captures = cache.captures
    assert cache.replays > 0
    if engine._local_gating_active():
        assert len({key[6] for key, _ in cache.graphs}) >= 2  # tag levels 0 and 2
        assert all("strict_total" in dict((n, s) for n, s, _ in layout)
                   for _, layout in cache.graphs)
    def kept(before: dict) -> bool:
        """Whether every graph of `before` is still the one its key replays
        (in place) or none is (new tables: every key captured again)."""
        same = [cache.graphs.get(key) is entry for key, entry in before.items()]
        assert all(same) or not any(same)
        return all(same)

    in_place = engine.vector_backend in ("exact", "proj")
    if engine.sharded is not None:
        in_place = engine.vector_backend == "exact" and engine.cfg.lexical_format == "dense"
    before = dict(cache.graphs)
    batches.append(_add(store, "fresh"))
    both("after an add")
    assert any(h.chunk_id == "fresh-1" for h in engine.search(batches[-1], k=K)[0].hits)
    assert kept(before) == in_place
    before = dict(cache.graphs)
    batches.append(_add(store, "tagged", d_tags=[0, 2], j_tags=[1]))
    both("after a d-tag write")
    # local gating rebuilds its d-tag postings; ivf, packed and pq their tables
    assert kept(before) == (in_place and not engine._local_gating_active())
    captures = cache.captures
    index0 = store.index
    n = store.capacity - store.size + 1  # one row past capacity, free rows reused first
    embs = ttesting.hash_embed([f"growth row {i}" for i in range(n)])
    store.add_chunks([TRecord(chunk_id=f"g{i}", doc_id=f"g{i}", text=f"growth row {i}",
                              embedding=embs[i]) for i in range(n)])
    assert store.index is not index0
    both("after a grow")
    assert cache.captures > captures


@pytest.mark.parametrize("case", sorted(_CARD_CASES))
def test_writes_replay_like_eager_with_stand_in(case):
    """The card test's sequence on the CPU with the stand-in capture: the
    bookkeeping of every backend across in-place adds, d-tag postings
    rebuilds, ANN rebuilds and a grow."""
    engine = _case_engine(case, "cpu")
    _stand_in(engine)
    _writes_replay_bitwise(engine)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_CARD_CASES))
def test_replay_bitwise_on_card(case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    engine = _case_engine(case, "cuda")
    assert engine.graphs
    _writes_replay_bitwise(engine, _CARD_CASES[case][1], 1 if case in _ONE_LAUNCH else None)


# Captures open on the main thread, one for each call another thread makes
# meanwhile (allocate device memory, copy synchronously, wait on an event,
# synchronize the device), in one capture mode: whether the call went
# through and whether the capture stood. Run in a process of its own,
# since an invalidated capture may leave the allocator's state behind.
_MODE_PROBE = r"""
import json, sys, threading
import torch
mode = sys.argv[1]
x = torch.zeros(1024, device="cuda")

def event_sync():
    e = torch.cuda.Event()
    e.record()
    e.synchronize()

calls = {"malloc": lambda: torch.empty(64 << 20, dtype=torch.uint8, device="cuda"),
         "sync copy": lambda: torch.ones(4, device="cuda").cpu(),
         "event sync": event_sync,
         "device sync": torch.cuda.synchronize}
out = {}
for name, call in calls.items():
    err = []

    def other():
        try:
            call()
        except RuntimeError as e:
            err.append(str(e).splitlines()[0])

    g = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(g, capture_error_mode=mode):
            y = x + 1
            t = threading.Thread(target=other)
            t.start()
            t.join()
        g.replay()
        torch.cuda.synchronize()
        stood = bool((y == 1).all())
    except RuntimeError:
        stood = False
    out[name] = {"refused": err[0] if err else None, "capture stood": stood}
print(json.dumps(out))
"""


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["global", "thread_local"])
def test_capture_mode_and_other_threads_on_card(mode):
    """Why the engine captures in "thread_local" mode and under a lock:
    under "global", another thread's allocation and synchronous copy are
    refused while a capture is open (the served API publishes documents on
    other threads while the micro-batcher's thread captures); under
    "thread_local" they and an event wait go through and the capture
    stands. A device-wide synchronize is refused in either mode, and
    breaks the capture: ``torch.cuda.graph`` makes one on entry, so the
    engine never opens two captures at once (compiled.LOCK)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import json
    import subprocess
    import sys

    run = subprocess.run([sys.executable, "-c", _MODE_PROBE, mode], capture_output=True,
                         text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    got = json.loads(run.stdout.strip().splitlines()[-1])
    assert got["device sync"]["refused"] and not got["device sync"]["capture stood"], got
    for name in ("malloc", "sync copy", "event sync"):
        if mode == "thread_local":
            assert got[name] == {"refused": None, "capture stood": True}, (name, got)
    if mode == "global":
        assert got["malloc"]["refused"] and got["sync copy"]["refused"], got


@pytest.mark.cuda
def test_two_searching_threads_on_card():
    """Two threads search one engine at once, each batch of a new key
    captured: under compiled.LOCK no capture opens while another is open
    and no replay lands between another's replay and its copies; every
    result is the eager program's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import threading

    engine = _case_engine("exact_f32", "cuda")
    batches = _card_batches()
    engine.graphs = False
    want = [[_fields(r) for r in engine.search(b, k=K)] for b in batches]
    engine.graphs = True
    got, errors = {}, []

    def searcher(name, order):
        try:
            for _ in range(3):
                for i in order:
                    got.setdefault((name, i), []).append(
                        [_fields(r) for r in engine.search(batches[i], k=K)])
        except Exception as e:  # reported by the assertion below
            errors.append(repr(e))

    n = len(batches)
    threads = [threading.Thread(target=searcher, args=("up", range(n))),
               threading.Thread(target=searcher, args=("down", range(n - 1, -1, -1)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert engine._programs.captures >= 4 and engine._programs.replays > 0
    for (_, i), runs in got.items():
        assert all(r == want[i] for r in runs), i


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["exact_f32", "proj_local"])
def test_writer_thread_during_captures_on_card(case, monkeypatch):
    """Documents published on another thread while the engine's captures
    are open (inside each capture the program starts a publish on a
    thread and waits for it: some publishes carry d-tags, one grows the
    store): both sides succeed, and afterwards every batch replays
    bitwise what the eager program returns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import threading

    from mobius_rag_tpu_torch.query import engine as engine_mod

    engine = _case_engine(case, "cuda")
    store = engine.store
    errors, published = [], []

    def publish():
        i = len(published)
        try:
            n = store.capacity - store.size + 1 if i == 2 else 2  # the third grows the store
            texts = [f"writer doc {i} row {j}" for j in range(n)]
            embs = ttesting.hash_embed(texts)
            store.publish_document(f"w{i}", [
                TRecord(chunk_id=f"w{i}-{j}", doc_id=f"w{i}", text=t, embedding=embs[j],
                        d_tags=[0, 2] if i % 2 else []) for j, t in enumerate(texts)])
            published.append(i)
        except Exception as e:  # reported by the assertion below
            errors.append(repr(e))

    real = engine_mod.pack_device

    def pack_device(out, fw):
        if torch.cuda.is_current_stream_capturing():
            t = threading.Thread(target=publish)
            t.start()
            t.join()
        return real(out, fw)

    monkeypatch.setattr(engine_mod, "pack_device", pack_device)
    batches = _card_batches()
    for b in batches:  # every new key captures, with a publish inside
        engine.search(b, k=K)
    assert not errors, errors
    assert len(published) == engine._programs.captures >= 3
    monkeypatch.setattr(engine_mod, "pack_device", real)
    engine.graphs = False
    want = [[_fields(r) for r in engine.search(b, k=K)] for b in batches]
    engine.graphs = True
    got = [[_fields(r) for r in engine.search(b, k=K)] for b in batches]
    assert got == want


@pytest.mark.cuda
def test_ingest_search_and_profiler_threads_on_card():
    """Three threads on one engine and one encoder: one ingests (embeds
    documents and publishes them), one searches batches of new keys whose
    queries the encoder embeds, and one opens and closes torch.profiler
    with CUDA activity through the port's profiler (locked_profiler, as
    both /admin/profile routes do) until the other two are done. Both
    caches keep 2 graphs, so keys are captured again and again while the
    profiler starts and stops. All three succeed; each embedding the
    threads made is bitwise the eager encoder's on the same texts, and
    afterwards every batch's replay is bitwise the eager program's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import threading

    from mobius_rag_tpu_torch.profiling import locked_profiler

    engine = _case_engine("exact_f32", "cuda")
    cfg = dataclasses.replace(tenc.EncoderConfig.tiny(), max_seq=256,
                              out_dim=engine.cfg.embed_dim)
    model = tenc.EncoderModel(cfg, device="cuda", seed=2)
    eager = tenc.EncoderModel(cfg, model.module.params_tree(), device="cuda", graphs=False)
    engine.embed_fn = model
    model._programs.max_graphs = engine._programs.max_graphs = 2
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    errors, ingested, searched, profiles = [], [], [], []
    done = threading.Event()

    def ingest():
        try:
            for i in range(12):
                texts = _texts_of((1, 5, 20)[i % 3], (10, 100, 200)[i % 3], f"ingest{i} ")
                embs = model(texts)
                engine.store.publish_document(f"ing{i}", [
                    TRecord(chunk_id=f"ing{i}-{j}", doc_id=f"ing{i}", text=t, embedding=embs[j])
                    for j, t in enumerate(texts)])
                ingested.append((texts, embs))
        except Exception as e:  # reported by the assertion below
            errors.append(("ingest", repr(e)))

    def search():
        try:
            for i in range(12):
                batch = [QueryRequest(query=f"{q.query} search{i}", payer=q.payer)
                         for q in _reqs((1, 3, 9, 20)[i % 4])]
                engine.search(batch, k=K)
                searched.append(batch)
        except Exception as e:  # reported by the assertion below
            errors.append(("search", repr(e)))

    def profile():
        try:
            while not done.is_set():
                with locked_profiler(acts):
                    torch.ones(1 << 20, device="cuda").sum()
                profiles.append(1)
        except Exception as e:  # reported by the assertion below
            errors.append(("profile", repr(e)))

    workers = [threading.Thread(target=ingest), threading.Thread(target=search)]
    profiler = threading.Thread(target=profile)
    profiler.start()
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    done.set()
    profiler.join()
    assert not errors, errors
    assert len(ingested) == len(searched) == 12 and profiles
    assert model._programs.captures > 2 and engine._programs.captures > 2
    for texts, embs in ingested:
        np.testing.assert_array_equal(embs, eager(texts))
    for batch in searched:
        got = np.stack([engine._embed_cache[r.query.strip().lower()] for r in batch])
        np.testing.assert_array_equal(got, eager([r.query for r in batch]))
    engine.graphs = False
    want = [[_fields(r) for r in engine.search(b, k=K)] for b in searched]
    engine.graphs = True
    assert [[_fields(r) for r in engine.search(b, k=K)] for b in searched] == want
