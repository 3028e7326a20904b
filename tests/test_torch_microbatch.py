"""The port's micro-batcher (mobius_rag_tpu_torch/query/microbatch.py):
each case of tests/test_microbatch.py held on it, and the real-engine
drains on the port's engine on the CPU: a deep queue drains through the
overlapped search_pipelined, and every caller gets what a search of its
request alone returns."""
import asyncio
import time

import numpy as np
import pytest

from mobius_rag_tpu_torch.query.engine import QueryRequest
from mobius_rag_tpu_torch.query.microbatch import (_BUCKETS, MicroBatcher, OverloadedError,
                                                   make_batcher)


class FakeResult:
    def __init__(self, query, hits):
        self.query = query
        self.hits = hits


class FakeEngine:
    """Records batch sizes; sleeps to simulate device time so that
    arrivals during a batch accumulate."""

    def __init__(self, delay_s=0.03):
        self.batches = []
        self.delay_s = delay_s

    def search(self, reqs, k=10):
        self.batches.append(len(reqs))
        time.sleep(self.delay_s)
        return [FakeResult(r.query, list(range(k))) for r in reqs]


def _run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


def test_constants_match_the_jax_batcher():
    assert _BUCKETS == (1, 2, 4, 8, 16, 32)
    assert MicroBatcher.PIPELINE_DEPTH == 4


def test_single_request_runs_immediately():
    eng = FakeEngine(delay_s=0.0)
    b = MicroBatcher(eng)

    async def go():
        res = await b.search_one(QueryRequest(query="q0"), 5)
        assert res.query == "q0" and len(res.hits) == 5

    _run(go())
    assert eng.batches == [1]


def test_concurrent_arrivals_batch_up():
    eng = FakeEngine(delay_s=0.05)
    b = MicroBatcher(eng)

    async def go():
        tasks = [asyncio.ensure_future(b.search_one(QueryRequest(query=f"q{i}"), 10))
                 for i in range(9)]
        # the first launches alone and the rest queue behind its batch
        await asyncio.sleep(0.01)
        tasks += [asyncio.ensure_future(b.search_one(QueryRequest(query=f"q{9 + i}"), 10))
                  for i in range(7)]
        res = await asyncio.gather(*tasks)
        assert [r.query for r in res] == [f"q{i}" for i in range(16)]

    _run(go())
    assert sum(eng.batches) >= 16  # padding counts
    assert len(eng.batches) <= 4
    assert b.stats["queries"] == 16
    assert b.stats["max_batch_seen"] >= 7


def test_bucket_padding():
    eng = FakeEngine(delay_s=0.05)
    b = MicroBatcher(eng)

    async def go():
        t1 = asyncio.ensure_future(b.search_one(QueryRequest(query="a"), 10))
        await asyncio.sleep(0.01)
        rest = [asyncio.ensure_future(b.search_one(QueryRequest(query=f"b{i}"), 10))
                for i in range(5)]
        await asyncio.gather(t1, *rest)

    _run(go())
    assert eng.batches[0] == 1
    assert all(n in _BUCKETS for n in eng.batches)


@pytest.mark.parametrize("n,want", [(1, 1), (2, 2), (3, 4), (5, 8), (9, 16), (17, 32),
                                    (40, 32)])
def test_bucket_ladder(n, want):
    assert MicroBatcher._bucket(n) == want


def test_mixed_k_cuts_per_caller():
    eng = FakeEngine(delay_s=0.05)
    b = MicroBatcher(eng)

    async def go():
        t1 = asyncio.ensure_future(b.search_one(QueryRequest(query="x"), 10))
        await asyncio.sleep(0.01)
        t2 = asyncio.ensure_future(b.search_one(QueryRequest(query="k3"), 3))
        t3 = asyncio.ensure_future(b.search_one(QueryRequest(query="k7"), 7))
        r1, r2, r3 = await asyncio.gather(t1, t2, t3)
        assert (len(r1.hits), len(r2.hits), len(r3.hits)) == (10, 3, 7)

    _run(go())


def test_engine_error_propagates_to_all_waiters():
    class Boom(FakeEngine):
        def search(self, reqs, k=10):
            raise ValueError("tag_mode bogus")

    b = MicroBatcher(Boom())

    async def go():
        t1 = asyncio.ensure_future(b.search_one(QueryRequest(query="x"), 5))
        t2 = asyncio.ensure_future(b.search_one(QueryRequest(query="y"), 5))
        for t in (t1, t2):
            with pytest.raises(ValueError, match="bogus"):
                await t

    _run(go())
    b.engine = FakeEngine(delay_s=0.0)  # the batcher recovers

    async def again():
        res = await b.search_one(QueryRequest(query="z"), 2)
        assert len(res.hits) == 2

    _run(again())


def test_env_gate(monkeypatch):
    monkeypatch.setenv("MRAG_MICROBATCH", "0")
    assert make_batcher(object()) is None
    monkeypatch.setenv("MRAG_MICROBATCH", "1")
    assert isinstance(make_batcher(object()), MicroBatcher)


def test_env_sizes(monkeypatch):
    monkeypatch.setenv("MRAG_MICROBATCH_MAX", "8")
    monkeypatch.delenv("MRAG_MICROBATCH_MAX_QUEUE", raising=False)
    b = MicroBatcher(object())
    assert (b.max_batch, b.max_queue) == (8, 128)
    monkeypatch.setenv("MRAG_MICROBATCH_MAX_QUEUE", "5")
    assert MicroBatcher(object()).max_queue == 5


def test_overload_sheds_with_bounded_queue():
    b = MicroBatcher(FakeEngine(delay_s=0.05), max_batch=2, max_queue=3)

    async def go():
        tasks = []
        shed = 0
        for i in range(10):
            try:
                tasks.append(asyncio.ensure_future(
                    b.search_one(QueryRequest(query=f"q{i}"), 5)))
            except OverloadedError:
                shed += 1
            await asyncio.sleep(0)
        done = await asyncio.gather(*tasks, return_exceptions=True)
        shed += sum(isinstance(r, OverloadedError) for r in done)
        assert shed > 0, "no request was shed at queue depth 3"
        assert [r for r in done if not isinstance(r, Exception)]
        assert b.stats["shed"] == shed

    _run(go())


def test_deep_queue_drains_through_pipelined_path():
    calls = {"sync": 0, "pipelined": []}

    class Eng:
        def search(self, reqs, k=10):
            calls["sync"] += 1
            return [FakeResult(r.query, list(range(k))) for r in reqs]

        def search_pipelined(self, batches, k=10):
            calls["pipelined"].append([len(b) for b in batches])
            time.sleep(0.01)
            return [[FakeResult(r.query, list(range(k))) for r in b] for b in batches]

    b = MicroBatcher(Eng(), max_batch=4)

    async def go():
        tasks = [asyncio.ensure_future(b.search_one(QueryRequest(query=f"q{i}"), 5))
                 for i in range(12)]
        res = await asyncio.gather(*tasks)
        assert [r.query for r in res] == [f"q{i}" for i in range(12)]
        assert all(len(r.hits) == 5 for r in res)

    _run(go())
    assert calls["pipelined"], "the backlog never used the pipelined path"
    assert all(len(g) <= MicroBatcher.PIPELINE_DEPTH for g in calls["pipelined"])
    assert b.stats["queries"] == 12


# ---------------------------------------------------------------------------
# the port's engine on the CPU
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engine():
    from mobius_rag_tpu_torch.index.store import ChunkStore
    from mobius_rag_tpu_torch.query.engine import SearchEngine
    from mobius_rag_tpu_torch.testing import hash_embed, sample_lexicon, toy_corpus

    lex = sample_lexicon()
    store = ChunkStore(device="cpu")
    store.add_chunks(toy_corpus(lex, pad_docs=20))
    return SearchEngine(store, lex, embed_fn=hash_embed, device="cpu")


def test_real_engine_through_batcher(engine):
    b = MicroBatcher(engine)

    async def go():
        tasks = [asyncio.ensure_future(b.search_one(QueryRequest(
            query="timely filing deadline for sunshine health claims"), 5))
            for _ in range(4)]
        return await asyncio.gather(*tasks)

    res = _run(go())
    assert all(r.hits for r in res)
    assert len({tuple(h.row for h in r.hits) for r in res}) == 1


@pytest.mark.parametrize("max_batch,n", [(2, 8), (4, 23)])
def test_real_engine_pipelined_drain_matches_sync(engine, max_batch, n):
    """A deep queue drains through the engine's overlapped pipeline; every
    caller's hits equal a search of its request alone, scores within 1e-5
    (the batch's matrix product may sum in another order than B=1's)."""
    b = MicroBatcher(engine, max_batch=max_batch)
    seen = []
    real = engine.search_pipelined

    def counted(batches, k=None):
        seen.append([len(x) for x in batches])
        return real(batches, k=k)

    engine.search_pipelined = counted
    queries = [f"timely filing deadline {i % 3}" for i in range(n)]
    try:
        async def go():
            tasks = [asyncio.ensure_future(b.search_one(QueryRequest(query=q), 5))
                     for q in queries]
            return await asyncio.gather(*tasks)

        res = _run(go())
    finally:
        del engine.search_pipelined
    assert seen, "the backlog never drained through search_pipelined"
    for q, r in zip(queries, res):
        want = engine.search(QueryRequest(query=q), k=5)[0]
        assert [h.row for h in r.hits] == [h.row for h in want.hits], q
        np.testing.assert_allclose([h.score for h in r.hits], [h.score for h in want.hits],
                                   rtol=0, atol=1e-5)
