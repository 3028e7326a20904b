"""The sparse lexical arm (``ops.lexical``): its dispatch on the CPU, the
engine's path through it, and, on a card (marked ``cuda``; skipped
without one), the Hopper kernels against the plain version, bitwise.

- On the CPU ``lexical_topk`` is the plain version and counts no launch;
  its signals are a gather of the plain scores; bad inputs raise.
- The engine's lexical stage (``engine.lexical_candidates``) under the
  sparse layout is ``lexical_topk``; under the dense layout the [B, U] x
  [U, C] product and a stable sort, as before.
- On the card, at the benchmark's shapes (B 32, C 1,000,192, P 8,192,
  U 64 and 128, m 40, and m 1,500; postings on every 50th row, bf16
  weights on a 1/8 grid so that rows tie; one query all gated, one with
  no live bucket, one with fewer live rows than m): values, ids (dead
  entries included)
  and signals bitwise. The sharded engine (four shards of one card, rows
  offset on three) and the one-device engine, captured, against the same
  engines eager through the plain version: equal results and packed
  outputs, bitwise."""
import dataclasses

import numpy as np
import pytest
import torch

from mobius_rag_tpu_torch import testing as ttesting
from mobius_rag_tpu_torch.config import get_config as tget_config
from mobius_rag_tpu_torch.index.store import ChunkStore as TStore
from mobius_rag_tpu_torch.ops.lexical import (lexical_signals, lexical_topk,
                                              lexical_topk_reference)
from mobius_rag_tpu_torch.ops.topk import NEG_INF, topk_stable
from mobius_rag_tpu_torch.query import engine as tengine
from mobius_rag_tpu_torch.query.engine import SearchEngine as TEngine
from test_torch_compiled import _fields, _reqs

K = 5


def _toy(fmt: str, device: str = "cpu", capacity: int = 1024, pad_docs: int = 60) -> TEngine:
    """The toy corpus; past 60 padding documents they come first, so that
    the documents the requests find lie on the later rows."""
    cfg = dataclasses.replace(tget_config(), initial_capacity=capacity, lexical_format=fmt)
    lex = ttesting.sample_lexicon()
    store = TStore(cfg, device=device)
    recs = ttesting.toy_corpus(lex, pad_docs=pad_docs)
    if pad_docs > 60:
        own = len(ttesting.toy_corpus(lex))
        recs = recs[own:] + recs[:own]
    store.add_chunks(recs)
    return TEngine(store, lex, cfg=cfg, embed_fn=ttesting.hash_embed, device=device)


def _stage_inputs(engine: TEngine, reqs):
    """A batch's device inputs and the dense gate's penalty, as the engine's
    program forms them."""
    q = engine._device_batch(engine.prepare_host(reqs)[0])
    q = dict(q, vec=q["vec"].float())
    index = engine.store.index
    strict, relaxed, open_mask, _ = tengine.filter_masks(index, q)
    return index, q, tengine.gate_penalty(strict, relaxed, open_mask, q, K)


def test_cpu_dispatch_is_the_plain_version_and_counts_no_launch():
    engine = _toy("sparse")
    index, q, pen = _stage_inputs(engine, _reqs(4))
    before = lexical_topk.launches
    vals, idx, scores = lexical_topk(q["lex_weights"], q["lex_buckets"], index.lex_cols,
                                     index.lex_wts, pen, 20)
    assert lexical_topk.launches == before
    rv, ri, lex = lexical_topk_reference(q["lex_weights"], q["lex_buckets"], index.lex_cols,
                                         index.lex_wts, pen, 20)
    assert torch.equal(vals, rv) and torch.equal(idx, ri) and torch.equal(scores, lex)
    assert torch.equal(scores, tengine.lexical_raw(index, q))
    assert (vals[:, 0] > 0).all()  # the toy queries score rows
    rows = torch.arange(index.capacity).expand(4, -1).contiguous()
    assert torch.equal(lexical_signals(scores, rows), lex)


@pytest.mark.parametrize("fmt", ["sparse", "dense"])
def test_engine_lexical_stage_is_the_layouts_plain_route(fmt):
    """The stage's (vals, idx, signals) under either layout: the where +
    penalty + stable sort over lexical_raw, as the engine ran it before
    the kernel (and as the CPU still does)."""
    engine = _toy(fmt)
    index, q, pen = _stage_inputs(engine, _reqs(4))
    vals, idx, sig_of = tengine.lexical_candidates(index, q, pen, 20)
    lex = tengine.lexical_raw(index, q)
    rv, ri = topk_stable(torch.where(lex > 0, lex, NEG_INF) + pen, 20)
    assert torch.equal(vals, rv) and torch.equal(idx, ri)
    assert torch.equal(sig_of(ri), torch.gather(lex, 1, ri))


@pytest.mark.parametrize("bad", ["shape", "dtype", "m", "device"])
def test_bad_inputs_raise(bad):
    w = torch.ones(2, 4)
    buckets = torch.arange(4, dtype=torch.int32)
    cols = torch.zeros(8, 3, dtype=torch.int32)
    wts = torch.ones(8, 3, dtype=torch.bfloat16)
    pen = torch.zeros(2, 10)
    m = 5
    if bad == "shape":
        buckets = buckets[:3]
    elif bad == "dtype":
        wts = wts.float()
    elif bad == "m":
        m = 11
    else:
        w, buckets, cols, wts, pen = (t.to("meta") for t in (w, buckets, cols, wts, pen))
    with pytest.raises((ValueError, TypeError)):
        lexical_topk(w, buckets, cols, wts, pen, m)


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

def _benchmark_batch(u: int, seed: int):
    """A batch at the benchmark's shapes on the card: 16,384 buckets of
    8,192 postings, filled left (skewed: most few, some full, with holes
    in a few) with rows that are multiples of 50; bf16 weights on a 1/8
    grid; the union's first 3/4 columns live, each query naming about 20
    of them; query 1 all gated, query 2 naming no bucket, query 3 one
    short bucket; the rest gated at 30-90%, as gate_penalty writes it."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    h, p, c, b = 16384, 8192, 1_000_192, 32

    def rand(*shape):
        return torch.rand(shape, device="cuda", generator=g)

    fill = (p * rand(h) ** 6).long()
    fill[:64] = p
    fill[64] = 3
    slot = torch.arange(p, device="cuda")
    rows = 50 * torch.randint(0, 20000, (h, p), device="cuda", generator=g)
    cols = torch.where(slot[None] < fill[:, None], rows, -1).to(torch.int32)
    holes = (rand(h, p) < 0.1) & (torch.arange(h, device="cuda")[:, None] % 97 == 0)
    cols[holes] = -1
    wts = torch.where(cols >= 0, torch.ceil(rand(h, p) * 16) / 8, 0.0).to(torch.bfloat16)
    live = (u * 3) // 4
    buckets = torch.zeros(u, dtype=torch.int32, device="cuda")
    buckets[:live] = torch.randperm(h - 1, device="cuda", generator=g)[:live].to(torch.int32) + 1
    buckets[0] = 0  # a full bucket
    buckets[1] = 64  # the short one
    weights = torch.where(rand(b, u) < 20 / live, rand(b, u) * 9 + 1, 0.0)
    weights[:, live:] = 0.0
    weights[:, 0] = torch.where(torch.arange(b, device="cuda") % 4 == 0, 2.0, 0.0)
    weights[2] = 0.0
    weights[3] = 0.0
    weights[3, 1] = 1.5
    open_share = 0.1 + 0.6 * rand(b, 1)
    gate = (rand(b, c) < open_share).float()
    gate[1] = 0.0
    pen = (1.0 - gate) * NEG_INF
    return weights, buckets, cols, wts, pen.contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("u,m", [(64, 40), (128, 40), (128, 1500)])
def test_kernel_matches_plain_on_card(u, m):
    """m = 1,500: two selection rounds of at most 1,024 keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    weights, buckets, cols, wts, pen = _benchmark_batch(u, 2500 + u)
    before = lexical_topk.launches
    vals, idx, scores = lexical_topk(weights, buckets, cols, wts, pen, m)
    torch.cuda.synchronize()
    assert lexical_topk.launches == before + 1
    rv, ri, lex = lexical_topk_reference(weights, buckets, cols, wts, pen, m)
    assert torch.equal(vals.view(torch.int32), rv.view(torch.int32))
    assert torch.equal(idx, ri)
    g = torch.Generator(device="cuda").manual_seed(u)
    rows = torch.cat([ri, torch.randint(0, pen.shape[1], (32, 3 * m), device="cuda",
                                        generator=g)], dim=1)
    got = lexical_signals(scores, rows)
    assert torch.equal(got.view(torch.int32), torch.gather(lex, 1, rows).view(torch.int32))
    # the batch holds what it claims: ties, dead tails of both kinds, a
    # query with no live row and one with fewer than m
    assert (rv[:, 1:] == rv[:, :-1]).logical_and(rv[:, 1:] > 0).any()
    assert (rv[1] < 0).all() and (rv[1] == NEG_INF).any() and (rv[2] < 0).all()
    assert 0 < int((rv[3] > 0).sum()) < m


def _search_packed(engine: TEngine, reqs) -> tuple[np.ndarray, np.ndarray]:
    ann, local = engine._tables()
    prep, exps = engine.prepare_host(reqs)
    packed = engine._packed(prep, exps, ann, local, K)
    return packed[0].cpu().numpy().view(np.int32), packed[1].cpu().numpy()


@pytest.mark.cuda
def test_captured_engine_on_card_equals_eager_plain(monkeypatch):
    """The one-device engine's program captured, with the kernels, against
    the same program eager through the plain version: pack_device's two
    arrays bitwise, on batches within and past 16 union columns."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    engine = _toy("sparse", "cuda")
    assert engine.graphs
    wide = " " + " ".join(f"w{i} policy claim" for i in range(30))
    batches = [_reqs(4), _reqs(8, wide), _reqs(3, " appeal")]
    before = lexical_topk.launches
    got = []
    for reqs in batches:
        _search_packed(engine, reqs)  # the capture, then a replay
        got.append(_search_packed(engine, reqs))
    assert lexical_topk.launches - before == 2 * len(batches)
    assert engine.programs.replays >= len(batches)
    engine.graphs = False
    monkeypatch.setattr(tengine, "lexical_topk", lexical_topk_reference)
    for reqs, (f, i) in zip(batches, got):
        wf, wi = _search_packed(engine, reqs)
        assert np.array_equal(f, wf) and np.array_equal(i, wi)


@pytest.mark.cuda
def test_sharded_engine_on_card_equals_plain(monkeypatch):
    """Four shards of one card (rows offset on shards 1-3, a strict count
    shared by all): the kernels launch once a shard and a batch, and the
    results, arm lists included, equal the plain version's, eager and
    captured."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mobius_rag_tpu_torch.parallel.mesh import make_mesh
    from mobius_rag_tpu_torch.parallel.sharded import ShardedEngine

    engine = _toy("sparse", "cuda", capacity=256, pad_docs=250)
    reqs = _reqs(6, " appeal deadline")
    tse = ShardedEngine(engine.store, mesh=make_mesh(4, devices=["cuda"] * 4), cfg=engine.cfg)
    serving = TEngine(engine.store, engine.lexicon, cfg=engine.cfg,
                      embed_fn=ttesting.hash_embed, device="cuda", sharded=tse)
    got = {}
    for graphs in (False, True):
        serving.graphs = graphs
        serving.search(reqs, k=K)  # warm-up; captured: the capture
        before = lexical_topk.launches
        got[graphs] = [_fields(r) for r in serving.search(reqs, k=K)]
        assert lexical_topk.launches - before == 4
    lexical_rows = [row for f in got[False] for row, _ in f[3]["lexical"]]
    assert max(lexical_rows) >= 2 * tse.c_local
    serving.graphs = False
    monkeypatch.setattr(tengine, "lexical_topk", lexical_topk_reference)
    want = [_fields(r) for r in serving.search(reqs, k=K)]
    assert got[False] == want and got[True] == want
