"""The port's stage profiler (mobius_rag_tpu_torch.profiling) against the
JAX package's on twin engines: the same keys, stages and value types (the
times themselves are not compared), the ``profile`` telemetry event, the
refusal for a sharded engine, a Chrome trace from ``capture_trace`` and
the ``/admin/profile`` route."""
import asyncio
import json
import os

import pytest
import torch

from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu.index.store import ChunkStore as JStore
from mobius_rag_tpu.observability import TelemetryStore as JTelemetry
from mobius_rag_tpu.profiling import profile_engine as jprofile
from mobius_rag_tpu.query.engine import QueryRequest as JRequest, SearchEngine as JEngine
from mobius_rag_tpu_torch import testing as ttesting
from mobius_rag_tpu_torch.index.store import ChunkStore as TStore
from mobius_rag_tpu_torch.observability import TelemetryStore
from mobius_rag_tpu_torch.parallel import ShardedEngine, make_mesh
from mobius_rag_tpu_torch.profiling import capture_trace, profile_engine
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine

torch.set_num_threads(1)

QUERIES = ["timely filing deadline", "prior authorization for dme"]


def _types(x):
    if isinstance(x, dict):
        return {k: _types(v) for k, v in x.items()}
    return type(x).__name__


@pytest.fixture(scope="module")
def twins(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("profiling")
    jlex, tlex = jtesting.sample_lexicon(), ttesting.sample_lexicon()
    js, ts = JStore(), TStore(device="cpu")
    js.add_chunks(jtesting.toy_corpus(jlex, pad_docs=64))
    ts.add_chunks(ttesting.toy_corpus(tlex, pad_docs=64))
    tel = TelemetryStore(str(tmp / "port.sqlite"))
    je = JEngine(js, jlex, embed_fn=jtesting.hash_embed, telemetry=JTelemetry(str(tmp / "j.sqlite")))
    te = SearchEngine(ts, tlex, embed_fn=ttesting.hash_embed, telemetry=tel, device="cpu")
    return je, te, tel


@pytest.mark.parametrize("backend", ["exact", "ivf"])
def test_profile_matches_jax_schema(twins, backend):
    je, te, tel = twins
    je.set_vector_backend(backend)
    te.set_vector_backend(backend)
    try:
        want = jprofile(je, [JRequest(query=q) for q in QUERIES], k=5, iters=2)
        got = profile_engine(te, [QueryRequest(query=q) for q in QUERIES], k=5, iters=2)
    finally:
        je.set_vector_backend("exact")
        te.set_vector_backend("exact")
    assert _types(got) == _types(want)
    for key in ("batch", "k", "corpus_rows", "backend", "iters"):
        assert got[key] == want[key], key
    stages = got["device_stages_ms"]
    if backend == "exact":
        assert set(stages) == {"filters", "vector", "lexical", "dtag", "arms", "full_pipeline"}
        assert got["signals_ms"] >= 0 and got["fusion_rerank_ms"] >= 0
    else:
        assert set(stages) == {"full_pipeline"}
    assert all(v > 0 for v in stages.values())
    assert got["host_prepare_ms"] >= 0 and got["host_assemble_ms"] >= 0
    tel.flush()
    assert any(e.get("mode") == "profile" for e in tel.recent_search_events(5))


def test_profile_refuses_a_sharded_engine(twins):
    _, te, _ = twins
    sharded = SearchEngine(te.store, te.lexicon, embed_fn=ttesting.hash_embed, device="cpu",
                           sharded=ShardedEngine(te.store, mesh=make_mesh(2, devices=["cpu"] * 2)))
    with pytest.raises(ValueError, match="sharded"):
        profile_engine(sharded, [QueryRequest(query="x")], k=5)


def test_capture_trace_writes_a_chrome_trace(twins, tmp_path):
    _, te, _ = twins
    out = capture_trace(te, [QueryRequest(query=q) for q in QUERIES], k=5, n_batches=2,
                        logdir=str(tmp_path / "trace"))
    assert out["ok"] and out["batches"] == 2
    assert out["trace_file"] == os.path.join(str(tmp_path / "trace"), "trace.json")
    with open(out["trace_file"]) as f:
        events = json.load(f)["traceEvents"]
    assert any("topk" in str(e.get("name", "")) or "addmm" in str(e.get("name", ""))
               or "aten::" in str(e.get("name", "")) for e in events)


def test_profile_endpoint(tmp_path):
    from aiohttp.test_utils import TestClient, TestServer

    from mobius_rag_tpu_torch.api.server import build_app
    from test_torch_api import _context_under

    ctx = _context_under(tmp_path)
    ctx.store.add_chunks(ttesting.toy_corpus(ctx.engine.lexicon))

    async def scenario():
        client = TestClient(TestServer(build_app(ctx)))
        await client.start_server()
        try:
            r = await client.post("/admin/profile", json={"iters": 1, "k": 5, "trace": True})
            assert r.status == 200
            body = await r.json()
            assert "full_pipeline" in body["profile"]["device_stages_ms"]
            assert body["trace"]["ok"] and os.path.exists(body["trace"]["trace_file"])
        finally:
            await client.close()

    asyncio.new_event_loop().run_until_complete(scenario())
