"""The port's index RPC (mobius_rag_tpu_torch.index.service and the
server's /internal/index routes): the twin of tests/test_index_service.py.

Wire records are byte-equal between the packages (the same JSON text for
the same record, and each package reads the other's); an embedding worker
publishes into a live port server over a real socket, through the port's
client and through the JAX package's, and a sharded engine attached to
the server serves the published rows."""
import asyncio
import json
import threading
import time

import numpy as np
import pytest
import torch

from mobius_rag_tpu.index.service import (RemoteIndexClient as JClient,
                                          record_from_wire as jfrom_wire,
                                          record_to_wire as jto_wire)
from mobius_rag_tpu.index.store import ChunkRecord as JRecord
from mobius_rag_tpu.ingest.queue import JobQueue as JQueue
from mobius_rag_tpu.ingest.worker import EmbeddingWorker as JWorker
from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu_torch import testing as ttesting
from mobius_rag_tpu_torch.index.service import (RemoteIndexClient, record_from_wire,
                                                record_to_wire)
from mobius_rag_tpu_torch.index.store import ChunkRecord
from mobius_rag_tpu_torch.ingest.queue import JobQueue
from mobius_rag_tpu_torch.ingest.worker import EMBEDDING_KIND, EmbeddingWorker
from mobius_rag_tpu_torch.query.engine import QueryRequest

torch.set_num_threads(1)


def _record(cls, rng):
    return cls(chunk_id="c0", doc_id="d", text="body text (with) \\ escapes",
               embedding=rng.standard_normal(256).astype("float32"),
               j_tags=[1], d_tags=[2, 3], phrase_ids=[7], payer="aetna", state="FL",
               lexical_weights={5: 1.5, 9: 0.25}, page=3, extra={"kind": "fact"})


def test_record_wire_bytes_equal_both_ways():
    t = _record(ChunkRecord, np.random.default_rng(0))
    j = _record(JRecord, np.random.default_rng(0))
    tw, jw = record_to_wire(t), jto_wire(j)
    assert json.dumps(tw, sort_keys=True) == json.dumps(jw, sort_keys=True)
    assert json.dumps(tw) == json.dumps(jw)  # the same key order too
    back = record_from_wire(jw)
    assert back.chunk_id == t.chunk_id and back.lexical_weights == t.lexical_weights
    assert back.extra == t.extra and back.page == 3 and back.d_tags == [2, 3]
    np.testing.assert_array_equal(back.embedding, t.embedding)
    jback = jfrom_wire(tw)
    np.testing.assert_array_equal(jback.embedding, j.embedding)
    assert json.dumps(jto_wire(jback)) == json.dumps(tw)


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """A port server on a real socket (its own thread and loop), with a
    ShardedEngine over two CPU shards attached to its engine."""
    from aiohttp import web

    from mobius_rag_tpu_torch.api.server import build_app
    from mobius_rag_tpu_torch.parallel import ShardedEngine, make_mesh
    from test_torch_api import _context_under

    ctx = _context_under(tmp_path_factory.mktemp("serving"))
    ctx.store.add_chunks(ttesting.toy_corpus(ctx.engine.lexicon, pad_docs=8))
    ctx.engine.sharded = ShardedEngine(ctx.store, mesh=make_mesh(2, devices=["cpu"] * 2))
    app = build_app(ctx)
    state = {}
    loop = asyncio.new_event_loop()

    def run():
        asyncio.set_event_loop(loop)
        runner = web.AppRunner(app)
        loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        loop.run_until_complete(site.start())
        state["port"] = site._server.sockets[0].getsockname()[1]
        loop.run_forever()

    threading.Thread(target=run, daemon=True).start()
    for _ in range(200):
        if "port" in state:
            break
        time.sleep(0.05)
    yield ctx, f"http://127.0.0.1:{state['port']}"
    loop.call_soon_threadsafe(loop.stop)


def _units(doc, texts):
    return [{"source_id": f"{doc}-p{i}", "kind": "paragraph", "text": t,
             "section_path": "Filing", "page": i + 1, "j_tags": [], "d_tags": [], "p_tags": []}
            for i, t in enumerate(texts)]


TEXTS = ["Remote plan timely filing deadline is 198 days from the date of service.",
         "Remote plan prior authorization decisions arrive within 6 calendar days."]


def test_remote_publish_reaches_live_index(serving, tmp_path):
    ctx, url = serving
    lex = ttesting.sample_lexicon()
    queue = JobQueue(str(tmp_path / "jobs.sqlite"))
    units = _units("rdoc", TEXTS)
    queue.enqueue(EMBEDDING_KIND, {"doc_id": "remote_doc", "units": units,
                                   "meta": {"filename": "Remote Plan Manual.txt",
                                            "payer": "remote", "state": "FL",
                                            "authority_level": 3}})
    client = RemoteIndexClient(url)
    assert EmbeddingWorker(queue, client, lex, ttesting.hash_embed).run_loop(max_jobs=1) == 1
    # the serving process's live store has the rows: no snapshot hop
    assert any(r is not None and r.doc_id == "remote_doc" for r in ctx.store.records)
    # the attached sharded engine serves them (refreshed through the listeners)
    res = ctx.engine.search(QueryRequest(query="remote plan timely filing deadline 198 days"),
                            k=3)[0]
    assert any(h.doc_id == "remote_doc" for h in res.hits)
    assert not ctx.engine.sharded.stale
    assert client.embedded_source_ids("remote_doc") == {"rdoc-p0", "rdoc-p1"}
    # republish with one unit dropped
    queue2 = JobQueue(str(tmp_path / "jobs2.sqlite"))
    queue2.enqueue(EMBEDDING_KIND, {"doc_id": "remote_doc", "units": units[:1],
                                    "meta": {"filename": "Remote Plan Manual.txt",
                                             "payer": "remote"}})
    EmbeddingWorker(queue2, client, lex, ttesting.hash_embed).run_loop(max_jobs=1)
    assert client.embedded_source_ids("remote_doc") == {"rdoc-p0"}
    assert client.delete_by_document("remote_doc") == 1
    assert client.embedded_source_ids("remote_doc") == set()


def test_jax_worker_publishes_into_the_port_server(serving, tmp_path):
    """The JAX package's worker and client against the port's server: the
    wire format is shared."""
    ctx, url = serving
    queue = JQueue(str(tmp_path / "jjobs.sqlite"))
    queue.enqueue(EMBEDDING_KIND, {"doc_id": "jax_doc", "units": _units("jdoc", TEXTS),
                                   "meta": {"filename": "J.txt", "payer": "remote"}})
    client = JClient(url)
    assert JWorker(queue, client, jtesting.sample_lexicon(),
                   jtesting.hash_embed).run_loop(max_jobs=1) == 1
    rows = ctx.store.rows_for_document("jax_doc")
    assert len(rows) == 2
    assert client.embedded_source_ids("jax_doc") == {"jdoc-p0", "jdoc-p1"}
    rec = ctx.store.record(rows[0])
    np.testing.assert_allclose(np.linalg.norm(rec.embedding), 1.0, atol=1e-5)
    assert client.delete_by_document("jax_doc") == 2


def test_add_chunks_route_and_bad_bodies(serving):
    ctx, url = serving
    client = RemoteIndexClient(url)
    rec = ChunkRecord(chunk_id="x0", doc_id="xdoc", text="extra row",
                      embedding=ttesting.hash_embed(["extra row"])[0])
    rows = client.add_chunks([rec])
    assert ctx.store.record(rows[0]).chunk_id == "x0"
    with pytest.raises(Exception, match="400"):
        client._post("/internal/index/publish", {"records": []})
    assert client.delete_by_document("xdoc") == 1
