"""The port's host services: observability.py (TelemetryStore, the engine's
search_events rows, JSON logging, severity, progress events),
clients.py, providers_external.py and curator.py.

The telemetry store is held to the JAX package's: the same searches write
the same search_events rows (scores and signals within 1e-5, the engines'
float32 tolerance; timings empty on the pipelined path and with the same
keys on `search`), and the engine's _logged_query_vectors reads the same
queries back. The HTTP clients run with urllib.request.urlopen mocked, as
tests/test_clients_durable.py and test_providers_external.py drive the
JAX package's against local servers. Every sqlite file lives under
tmp_path."""
import io
import json
import logging
import sqlite3
import urllib.error
import urllib.request

import numpy as np
import pytest

from mobius_rag_tpu import curator as jcurator
from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu.index.store import ChunkStore as JStore
from mobius_rag_tpu.observability import TelemetryStore as JTelemetry
from mobius_rag_tpu.query.engine import QueryRequest as JRequest, SearchEngine as JEngine
from mobius_rag_tpu_torch import clients, curator, observability, providers_external as pe
from mobius_rag_tpu_torch import testing as ttesting
from mobius_rag_tpu_torch.index.store import ChunkStore
from mobius_rag_tpu_torch.query.agent import AgentRequest, CorpusSearchAgent
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine

ATOL = 1e-5
QUERIES = [("What is the timely filing deadline for Sunshine Health FL Medicaid claims?", {}),
           ("prior authorization behavioral health", {"payer": "aetna"}),
           ("molina eligibility verification", {"mode": "recall", "min_similarity": 0.3}),
           ("statewide enrollment statistics", {"tag_mode": "none"})]


def _rows(path):
    conn = sqlite3.connect(path)
    try:
        return conn.execute("SELECT query, mode, timings, arms, expansion, results, extra "
                            "FROM search_events ORDER BY rowid").fetchall()
    finally:
        conn.close()


@pytest.fixture(scope="module")
def logged(tmp_path_factory):
    """The same searches through a JAX and a port engine, each with its
    package's TelemetryStore: one pipelined call, then one search."""
    tmp = tmp_path_factory.mktemp("telemetry")
    jt, tt = JTelemetry(str(tmp / "j.sqlite")), observability.TelemetryStore(str(tmp / "t.sqlite"))
    js, ts = JStore(), ChunkStore(device="cpu")
    js.add_chunks(jtesting.toy_corpus(jtesting.sample_lexicon(), pad_docs=20))
    ts.add_chunks(ttesting.toy_corpus(ttesting.sample_lexicon(), pad_docs=20))
    je = JEngine(js, jtesting.sample_lexicon(), embed_fn=jtesting.hash_embed, telemetry=jt)
    te = SearchEngine(ts, ttesting.sample_lexicon(), embed_fn=ttesting.hash_embed,
                      telemetry=tt, device="cpu")
    jreqs = [JRequest(query=q, **kw) for q, kw in QUERIES]
    treqs = [QueryRequest(query=q, **kw) for q, kw in QUERIES]
    je.search_pipelined([jreqs[:2], jreqs[2:]], k=5)
    te.search_pipelined([treqs[:2], treqs[2:]], k=5)
    je.search(jreqs[:1], k=5)
    te.search(treqs[:1], k=5)
    jt.flush()
    tt.flush()
    out = dict(j=_rows(str(tmp / "j.sqlite")), t=_rows(str(tmp / "t.sqlite")), je=je, te=te,
               tt=tt)
    yield out
    jt.close()
    tt.close()


def test_search_events_match_jax(logged):
    jrows, trows = logged["j"], logged["t"]
    assert len(trows) == len(jrows) == len(QUERIES) + 1
    for a, b in zip(jrows, trows):
        assert b[:2] == a[:2]  # query, mode
        ta, tb = json.loads(a[2]), json.loads(b[2])
        assert sorted(tb) == sorted(ta)
        assert (tb == {}) == (ta == {})
        assert [json.loads(x) for x in b[3:5]] == [json.loads(x) for x in a[3:5]]  # arms, expansion
        assert json.loads(b[6]) == json.loads(a[6])  # strict count, confidence
        ra, rb = json.loads(a[5]), json.loads(b[5])
        assert [r["chunk_id"] for r in rb] == [r["chunk_id"] for r in ra]
        for x, y in zip(ra, rb):
            assert sorted(y["signals"]) == sorted(x["signals"])
            np.testing.assert_allclose([y["score"]] + [y["signals"][s] for s in sorted(x["signals"])],
                                       [x["score"]] + [x["signals"][s] for s in sorted(x["signals"])],
                                       rtol=0, atol=ATOL)
    assert any(json.loads(r[5]) for r in trows)
    assert json.loads(trows[-1][2]).keys() == {"prepare", "device"}


def test_recent_search_events_and_logged_vectors(logged):
    events = logged["tt"].recent_search_events(limit=50)
    assert {e["query"] for e in events} == {q for q, _ in QUERIES}
    got = logged["te"]._logged_query_vectors(3)
    want = logged["je"]._logged_query_vectors(3)
    assert got.shape == want.shape == (3, got.shape[1])
    np.testing.assert_array_equal(got, want)
    engine = SearchEngine(logged["te"].store, logged["te"].lexicon, device="cpu")
    assert engine._logged_query_vectors(3) is None  # no telemetry attached


def test_telemetry_errors_and_severity(tmp_path):
    t = observability.TelemetryStore(str(tmp_path / "t.sqlite"))
    try:
        t.record_error("worker", TimeoutError("connection timeout"), {"doc_id": "d1"})
        t.record_error("worker", ValueError("bad shape"))
        t.flush()
        assert len(t.recent_errors()) == 2
        warn = t.recent_errors(severity="warning")
        assert len(warn) == 1 and "timeout" in warn[0]["message"]
        assert t.error_stats()["by_service"]["worker"]["warning"]["count"] == 1
        assert t.resolve_errors_for_doc("d1") == 1
        assert t.error_stats()["unresolved"] == 1
    finally:
        t.close()


@pytest.mark.parametrize("exc,want", [(TimeoutError("connection timeout"), "warning"),
                                      (ValueError("bad shape"), "error"),
                                      (AssertionError("integrity violated"), "critical"),
                                      ("HTTP 503 from upstream", "warning")])
def test_classify_severity(exc, want):
    assert observability.classify_severity(exc) == want


def test_agent_decisions_persist(tmp_path):
    t = observability.TelemetryStore(str(tmp_path / "t.sqlite"))
    try:
        store = ChunkStore(device="cpu")
        lex = ttesting.sample_lexicon()
        store.add_chunks(ttesting.toy_corpus(lex, pad_docs=10))
        agent = CorpusSearchAgent(SearchEngine(store, lex, embed_fn=ttesting.hash_embed,
                                               device="cpu"))
        agent.observers.append(t.record_decision)
        res = agent.run(AgentRequest(query="sunshine health timely filing"))
        t.flush()
        dec = t.recent_decisions()
        assert dec[0]["agent_id"] == res.agent_id and dec[0]["chain"] == res.strategy_chain
        trace = t.trace(res.agent_id)
        assert trace["answer"] == res.answer and trace["narrative"] == res.narrative
        assert t.grade_decision(res.agent_id, "correct")
        assert t.recent_decisions()[0]["grade"] == "correct"
        roll = t.decisions_rollup()["strategies"][res.decision["strategy"]]
        assert roll["n"] == 1
    finally:
        t.close()


def test_progress_emitter_and_json_logging():
    p = observability.ProgressEmitter()
    seen = []
    p.subscribe("c1", seen.append)
    p.emit("c1", "extract", pages=3)
    p.emit("c1", "embed", done=10)
    p.emit("other", "x")
    assert [e["stage"] for e in p.events("c1")] == ["extract", "embed"]
    assert [e["seq"] for e in p.events("c1")] == [0, 1] and len(seen) == 2
    assert p.events("c1", since_seq=0)[0]["stage"] == "embed"
    rec = logging.LogRecord("lg", logging.INFO, "f.py", 1, "hello %s", ("x",), None)
    rec.search_id = "s123"
    out = json.loads(observability.JsonFormatter("svc").format(rec))
    assert (out["msg"], out["service"], out["search_id"]) == ("hello x", "svc", "s123")


def test_default_telemetry_path_is_the_data_dir(tmp_path, monkeypatch):
    from mobius_rag_tpu_torch import config

    monkeypatch.setattr(config, "get_config",
                        lambda: config.Config(data_dir=str(tmp_path / "data")))
    monkeypatch.setattr(observability, "get_config", config.get_config)
    t = observability.TelemetryStore()
    try:
        assert (tmp_path / "data" / "telemetry.sqlite").exists()
    finally:
        t.close()


# ---------------------------------------------------------------------------
# clients and providers_external, urllib mocked
# ---------------------------------------------------------------------------

class _Resp(io.BytesIO):
    def __init__(self, body: bytes, charset: str = "utf-8"):
        super().__init__(body)
        self.headers = self

    def get_content_charset(self):
        return "utf-8"

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


@pytest.fixture
def wire(monkeypatch):
    """urlopen replaced by a script: route(request) → (status, payload);
    payload a dict (JSON) or str (text). Records every request."""
    state = {"requests": [], "route": None}

    def urlopen(req, timeout=None):
        body = json.loads(req.data) if req.data else None
        state["requests"].append({"url": req.full_url, "method": req.get_method(),
                                  "headers": dict(req.header_items()), "body": body})
        status, payload = state["route"](req.full_url, body, state)
        data = payload.encode() if isinstance(payload, str) else json.dumps(payload).encode()
        if status >= 400:
            raise urllib.error.HTTPError(req.full_url, status, "err", {}, io.BytesIO(data))
        return _Resp(data)

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    monkeypatch.setattr(pe.time, "sleep", lambda s: None)
    return state


def test_http_llm_client_sends_stage_and_retries(wire):
    wire["route"] = lambda url, body, st: ((500, {}) if len(st["requests"]) == 1
                                           else (200, {"completion": "ok"}))
    out = clients.HTTPLLMClient("http://llm.local/gen", backoff_s=0.0).generate(
        "q?", stage="synthesis", max_tokens=64)
    assert out == "ok" and len(wire["requests"]) == 2
    assert wire["requests"][0]["body"]["stage"] == "synthesis"
    assert wire["requests"][0]["body"]["max_tokens"] == 64


def test_http_llm_client_4xx_raises_at_once(wire):
    wire["route"] = lambda url, body, st: (400, {"error": "bad"})
    with pytest.raises(clients.LLMHTTPError, match="400"):
        clients.HTTPLLMClient("http://llm.local/gen", backoff_s=0.0).generate("q")
    assert len(wire["requests"]) == 1


def test_get_llm_client_env_selection(monkeypatch, wire):
    for var in ("MRAG_LLM_URL", "MRAG_LLM_PROVIDER"):
        monkeypatch.delenv(var, raising=False)
    assert isinstance(clients.get_llm_client(), clients.OfflineLLMStub)
    assert isinstance(clients.get_llm_client("http://x/llm"), clients.HTTPLLMClient)
    monkeypatch.setenv("MRAG_LLM_PROVIDER", "openai")
    monkeypatch.setenv("MRAG_OPENAI_API_KEY", "sk-env")
    monkeypatch.setenv("MRAG_OPENAI_BASE_URL", "http://oai.local")
    c = clients.get_llm_client()
    assert isinstance(c, pe.OpenAILLMClient)
    wire["route"] = lambda url, body, st: (200, {"choices": [{"message": {
        "content": "echo:" + body["messages"][-1]["content"]}}]})
    assert c.generate("x") == "echo:x"
    assert wire["requests"][0]["url"] == "http://oai.local/v1/chat/completions"


def test_offline_stub_and_fact_store():
    stub = clients.OfflineLLMStub()
    out = stub.generate("Q\n\n[passage 0]\nalpha text\n[passage 1]\nbeta text", stage="s")
    assert out == "alpha text [citation: passage 0]\nbeta text [citation: passage 1]"
    assert stub.transcript[0]["stage"] == "s"
    assert stub.generate("no passages").startswith("UNKNOWN")
    web = clients.OfflineWebStub()
    assert web.offline and web.search("x") == [] and web.fetch("u") == ""
    facts = clients.StaticFactStore([{"payer": "molina", "patterns": ["payer id"], "fact": "f"}])
    assert facts.lookup("What is the PAYER ID?")["fact"] == "f"
    assert facts.lookup("payer id", payer="aetna") is None


def test_openai_embeddings_batch_and_reorder(wire):
    def route(url, body, st):
        return 200, {"data": [{"index": i, "embedding": [float(i + 1)] * body["dimensions"]}
                              for i in reversed(range(len(body["input"])))]}

    wire["route"] = route
    p = pe.OpenAIEmbeddingProvider(base_url="http://oai.local", api_key="sk-test", dim=8,
                                   batch_size=2)
    out = p.embed(["a", "b", "c"])
    assert out.shape == (3, 8)
    np.testing.assert_array_equal(out[:, 0], [1.0, 2.0, 1.0])
    assert len(wire["requests"]) == 2
    r = wire["requests"][0]
    assert r["url"] == "http://oai.local/v1/embeddings"
    assert r["headers"]["Authorization"] == "Bearer sk-test" and r["body"]["input"] == ["a", "b"]


def test_openai_llm_contract(wire):
    wire["route"] = lambda url, body, st: (200, {"choices": [{"message": {"content": "done"}}]})
    c = pe.OpenAILLMClient(base_url="http://oai.local", api_key="k", model="gpt-x")
    assert c.generate("hello", system="sys", stage="synthesis") == "done"
    body = wire["requests"][0]["body"]
    assert body["messages"][0] == {"role": "system", "content": "sys"}
    assert body["metadata"] == {"stage": "synthesis"} and body["model"] == "gpt-x"


def test_vertex_contracts(wire, monkeypatch):
    def route(url, body, st):
        if url.endswith(":predict"):
            dim = body["parameters"]["outputDimensionality"]
            return 200, {"predictions": [{"embeddings": {"values": [float(len(i["content"]))]
                                                          * dim}} for i in body["instances"]]}
        return 200, {"candidates": [{"content": {"parts": [
            {"text": "v:"}, {"text": body["contents"][0]["parts"][0]["text"]}]}}]}

    wire["route"] = route
    p = pe.VertexEmbeddingProvider(base_url="http://vx.local", project="p1",
                                   location="us-central1", token="tok", dim=4)
    out = p.embed(["ab", "xyz"])
    np.testing.assert_array_equal(out[:, 0], [2.0, 3.0])
    assert wire["requests"][0]["url"] == ("http://vx.local/v1/projects/p1/locations/"
                                          "us-central1/publishers/google/models/"
                                          "gemini-embedding-001:predict")
    monkeypatch.setenv("MRAG_VERTEX_BASE_URL", "http://vx.local")
    monkeypatch.setenv("MRAG_VERTEX_PROJECT", "p1")
    monkeypatch.setenv("MRAG_VERTEX_TOKEN", "tok")
    monkeypatch.setenv("MRAG_LLM_PROVIDER", "vertex")
    c = clients.get_llm_client()
    assert isinstance(c, pe.VertexLLMClient)
    assert c.generate("question", system="rules", max_tokens=64) == "v:question"
    body = wire["requests"][-1]["body"]
    assert body["systemInstruction"] == {"parts": [{"text": "rules"}]}
    assert body["generationConfig"]["maxOutputTokens"] == 64


def test_providers_require_credentials(monkeypatch):
    for var in ("MRAG_OPENAI_API_KEY", "MRAG_VERTEX_PROJECT", "MRAG_VERTEX_TOKEN",
                "MRAG_GOOGLE_CSE_KEY", "MRAG_GOOGLE_CSE_CX"):
        monkeypatch.delenv(var, raising=False)
    for make in (pe.OpenAIEmbeddingProvider, pe.OpenAILLMClient, pe.VertexEmbeddingProvider,
                 pe.VertexLLMClient, pe.GoogleCSEWebClient):
        with pytest.raises(ValueError):
            make()


def test_malformed_response_raises(wire):
    wire["route"] = lambda url, body, st: (200, {"unexpected": True})
    with pytest.raises(clients.LLMHTTPError):
        pe.OpenAILLMClient(base_url="http://oai.local", api_key="k").generate("x")
    with pytest.raises(clients.LLMHTTPError):
        clients.HTTPLLMClient("http://llm.local", backoff_s=0.0).generate("x")


_DDG_PAGE = ('<a class="result__a" href="/l/?uddg=https%3A%2F%2Fpayer.example%2Fmanual.pdf">'
             '<b>Provider</b> Manual</a><a class="result__snippet">Filing &amp; limits</a>'
             '<a class="result__a" href="https://b.example/x">Second</a>')


def test_web_clients(wire, monkeypatch):
    def route(url, body, st):
        if "customsearch" in url:
            return 200, {"items": [{"title": "T", "link": "https://a.example", "snippet": "S"}]}
        if "/html/" in url:
            return 200, _DDG_PAGE
        return 200, "page body"

    wire["route"] = route
    g = pe.GoogleCSEWebClient(base_url="http://cse.local", key="k", cx="c")
    assert g.search("timely filing") == [{"title": "T", "url": "https://a.example",
                                          "snippet": "S"}]
    assert "q=timely+filing" in wire["requests"][0]["url"]
    d = pe.DDGHTMLWebClient(base_url="http://ddg.local")
    assert d.search("manual") == [
        {"title": "Provider Manual", "url": "https://payer.example/manual.pdf",
         "snippet": "Filing & limits"},
        {"title": "Second", "url": "https://b.example/x", "snippet": ""}]
    assert d.fetch("https://b.example/x") == "page body"

    class Broken:
        def search(self, query, max_results=5):
            raise OSError("down")

        def fetch(self, url, timeout_s=8.0):
            raise OSError("down")

    chain = pe.FallbackWebClient(Broken(), d)
    assert chain.search("manual")[0]["url"] == "https://payer.example/manual.pdf"
    assert chain.fetch("https://b.example/x") == "page body"
    monkeypatch.delenv("MRAG_WEB_PROVIDER", raising=False)
    assert pe.get_web_client() is None
    monkeypatch.setenv("MRAG_WEB_PROVIDER", "ddg")
    assert isinstance(pe.get_web_client(), pe.DDGHTMLWebClient)
    monkeypatch.setenv("MRAG_WEB_PROVIDER", "carrier-pigeon")
    with pytest.raises(ValueError):
        pe.get_web_client()


# ---------------------------------------------------------------------------
# curator
# ---------------------------------------------------------------------------

URLS = ["https://www.sunshinehealth.com/providers/manual.pdf", "ahca.myflorida.com/policy/x",
        "https://www.aetna.com/", "https://example.org/blog", "https://www.cms.gov/pdl.html"]


@pytest.mark.parametrize("url", URLS)
def test_classify_url_matches_jax(url):
    assert curator.classify_url(url) == jcurator.classify_url(url)


def test_curator_registry(tmp_path):
    c = curator.Curator(path=str(tmp_path / "curator.sqlite"))
    assert c.bulk_upsert(URLS) == len(URLS)
    c.curate(URLS[0], approve=True, notes="ok")
    c.mark_ingested(URLS[1], "doc-1")
    got = {s.url: s for s in c.search()}
    assert got[URLS[0]].status == "curated" and got[URLS[0]].payer == "sunshine_health"
    assert got[URLS[1]].status == "ingested" and got[URLS[1]].meta["doc_id"] == "doc-1"
    assert [s.url for s in c.search(payer="sunshine_health")] == [URLS[0]]
    assert c.stats()["by_status"]["discovered"] == 3
    assert c.probe(URLS[0]) == {"probed": False, "reason": "offline (no probe hook)"}
    hooked = curator.Curator(path=str(tmp_path / "c2.sqlite"),
                             probe_fn=lambda url: {"robots_disallowed": True})
    assert hooked.probe(URLS[0]) == {"probed": True, "robots_disallowed": True}
