"""The port's HTTP front door (mobius_rag_tpu_torch.api) against the JAX
package's: tests/test_api.py's scenario and a sample of
tests/test_api_{browse,extended,ops}.py's requests, sent through aiohttp's
TestClient to both apps, built by ``AppContext.build(embed_fn=hash_embed,
lexicon=sample_lexicon())`` over the toy corpus. The JSON bodies must be
equal apart from time stamps, uuids, timings and version strings (floats
within 1e-5). The eval routes run the ported harness (run_eval, calibrate,
the bank loader, the judge and the fact checker's grade rollup) and answer
alike. The routes of the last modules ported (the PDF export, the Drive
router, the integrity report, the index RPC and the stage profiler)
answer alike too; the profiler's timings and its note are not compared.

Each package's app runs in a subprocess of its own (this file run as a
script), so that each has its own data directory: both packages default
their sqlite stores and the file blob store to ``data_dir``, which is read
once per process.
"""
import asyncio
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLOAT_TOL = 1e-5
# keys whose values are time stamps, uuids, timings or versions
VOLATILE = {"agent_id", "run_id", "job_id", "chunking_job", "id", "ts", "ts_ms",
            "created_at", "updated_at", "started_at", "finished_at", "enqueued_at",
            "claimed_at", "last_tick", "at", "time", "mtime", "version", "sha",
            "latency_ms", "elapsed_ms", "timings", "stage_ms", "search_id",
            "decision_id", "trace_id", "total_ms", "device_ms", "wall_ms", "timings_ms",
            "ms", "latency_ms_median", "latency_ms_p95", "calib_id"}
# uuids under a key that elsewhere holds stable ids; the stage profiler's
# timings, its id and its note (which says how each package's stages run)
VOLATILE_IN = {"curator_add": {"source_id"},
               "profile": {"profile_id", "note", "host_prepare_ms", "host_assemble_ms",
                           "signals_ms", "fusion_rerank_ms", "filters", "vector",
                           "lexical", "dtag", "arms", "full_pipeline"}}

_MANUAL = (b"SUNSHINE HEALTH MANUAL\n\nTIMELY FILING\n"
           b"Participating providers must submit claims within 180 days.\n\n"
           b"PRIOR AUTHORIZATION\nH0019 requires prior authorization.")

# (name, method, path, request kwargs, expectation): "equal" — both apps
# answer alike.
SCENARIO = [
    ("health", "get", "/health", {}, "equal"),
    ("upload", "post", "/upload?filename=sunshine_manual.txt&payer=Sunshine%20Health"
     "&state=FL&authority_level=4&instant=1", {"data": _MANUAL.decode()}, "equal"),
    ("documents", "get", "/documents", {}, "equal"),
    ("document", "get", "/documents/{doc_id}", {}, "equal"),
    ("query", "post", "/api/query",
     {"json": {"query": "timely filing deadline", "payer": "sunshine_health"}}, "equal"),
    ("query_recall", "post", "/api/query",
     {"json": {"query": "molina eligibility verification", "mode": "recall", "k": 5}},
     "equal"),
    ("agent", "post", "/api/skills/v1/corpus_search_agent",
     {"json": {"query": "Does Sunshine Health require prior authorization for H0019?"}},
     "equal"),
    ("trace", "get", "/api/decisions/{agent_id}/trace", {}, "equal"),
    ("flush", None, None, {}, None),
    ("search_events", "get", "/api/search_events?limit=5", {}, "equal"),
    ("pipeline_health", "get", "/pipeline_health", {}, "equal"),
    ("lexicon_add", "post", "/api/lexicon/entries",
     {"json": {"kind": "d", "code": "claims.participating",
               "phrases": ["participating providers"]}}, "equal"),
    ("retag", "post", "/admin/retag", {"json": {}}, "equal"),
    ("prompts", "post", "/config/prompts",
     {"json": {"stage": "synthesis", "version": "v1", "text": "Synthesize {q}"}}, "equal"),
    ("llm_put", "post", "/config/llm",
     {"json": {"name": "default", "provider": "offline", "secrets": {"api_key": "sekrit"}}},
     "equal"),
    ("llm_list", "get", "/config/llm", {}, "equal"),
    ("query_batch", "post", "/api/query_batch", {"json": {"queries": [
        {"query": "timely filing deadline", "payer": "sunshine_health"},
        {"query": "molina eligibility verification"}], "k": 3}}, "equal"),
    ("query_batch_empty", "post", "/api/query_batch", {"json": {"queries": []}}, "equal"),
    ("ns_create", "post", "/admin/org-docs", {"json": {"name": "org-a"}}, "equal"),
    ("ns_dup", "post", "/admin/org-docs", {"json": {"name": "org-a"}}, "equal"),
    ("ns_chunks", "post", "/admin/org-docs/org-a/chunks", {"json": {"chunks": [
        {"doc_id": "d1", "text": "org A private policy about telehealth coverage"}]}},
     "equal"),
    ("ns_query", "post", "/admin/org-docs/org-a/query",
     {"json": {"query": "telehealth coverage"}}, "equal"),
    ("ns_list", "get", "/admin/org-docs", {}, "equal"),
    ("curator_add", "post", "/api/curator/sources",
     {"json": {"url": "https://www.sunshinehealth.com/providers/manual.pdf"}}, "equal"),
    ("curator_stats", "get", "/api/curator/stats", {}, "equal"),
    ("version", "get", "/version", {}, "equal"),
    ("health_deep", "get", "/health/deep", {}, "equal"),
    ("doc_status", "get", "/documents/{doc_id}/status", {}, "equal"),
    ("doc_detail", "get", "/documents/{doc_id}/detail", {}, "equal"),
    ("doc_pages", "get", "/documents/{doc_id}/pages", {}, "equal"),
    ("doc_markdown", "get", "/documents/{doc_id}/download/markdown", {}, "equal"),
    ("lexicon_stats", "get", "/policy/lexicon/stats", {}, "equal"),
    ("doc_search", "get", "/documents/search?q=sunshine", {}, "equal"),
    ("vector_search", "get", "/admin/vector_search?q=timely+filing&k=3", {}, "equal"),
    ("repository_audit", "get", "/admin/repository_audit", {}, "equal"),
    ("nightly_runs", "get", "/admin/nightly/runs", {}, "equal"),
    ("microbatch", "get", "/admin/microbatch", {}, "equal"),
    ("eval_run", "post", "/api/eval/run", {"json": {"bank": "toy"}}, "equal"),
    ("grade_rollup", "get", "/api/eval/runs/{run_id}/grade_rollup", {}, "equal"),
    ("eval_calibrate", "post", "/api/eval/calibrate", {"json": {"bank": "toy"}}, "equal"),
    ("eval_bank", "get", "/api/eval/bank?name=toy", {}, "equal"),
    ("fact_compare", "post", "/api/eval/fact_compare",
     {"json": {"answer_a": "180 days", "answer_b": "no", "must_facts": ["180 days"]}},
     "equal"),
    ("pdf", "get", "/documents/{doc_id}/pdf", {}, "equal"),
    ("drive_status", "get", "/drive/status", {}, "equal"),
    ("integrity", "get", "/admin/integrity", {}, "equal"),
    ("internal_publish", "post", "/internal/index/publish",
     {"json": {"doc_id": "x", "records": []}}, "equal"),
    ("profile", "post", "/admin/profile", {"json": {"iters": 1}}, "equal"),
    ("delete", "delete", "/documents/{doc_id}", {}, "equal"),
    ("query_after_delete", "post", "/api/query",
     {"json": {"query": "timely filing deadline", "payer": "sunshine_health"}}, "equal"),
    ("bad_query", "post", "/api/query", {"json": {}}, "equal"),
    ("bad_mode", "post", "/api/query", {"json": {"query": "x", "mode": "bogus"}}, "equal"),
    ("missing_doc", "get", "/documents/nope", {}, "equal"),
]


def _scenario(pkg: str) -> list:
    """Run SCENARIO against `pkg`'s app ("jax" or "port"); (name, status,
    body) per request."""
    from aiohttp.test_utils import TestClient, TestServer

    if pkg == "jax":
        from mobius_rag_tpu.api.server import AppContext, build_app
        from mobius_rag_tpu.testing import hash_embed, sample_lexicon, toy_corpus
        ctx = AppContext.build(embed_fn=hash_embed, lexicon=sample_lexicon())
    else:
        from mobius_rag_tpu_torch.api.server import AppContext, build_app
        from mobius_rag_tpu_torch.testing import hash_embed, sample_lexicon, toy_corpus
        ctx = AppContext.build(embed_fn=hash_embed, lexicon=sample_lexicon(), device="cpu")
    ctx.store.add_chunks(toy_corpus(ctx.engine.lexicon))
    out, ids = [], {}

    async def run():
        client = TestClient(TestServer(build_app(ctx)))
        await client.start_server()
        try:
            for name, method, path, kw, _ in SCENARIO:
                if method is None:
                    ctx.telemetry.flush()
                    continue
                r = await getattr(client, method)(path.format(**ids), **kw)
                raw = await r.read()
                try:
                    body = json.loads(raw)
                except (json.JSONDecodeError, UnicodeDecodeError):
                    body = raw.decode("utf-8", "replace")
                if isinstance(body, dict):
                    for key in ("doc_id", "agent_id", "run_id"):
                        if key in body and key not in ids:
                            ids[key] = body[key]
                out.append((name, r.status, body))
        finally:
            await client.close()

    asyncio.run(run())
    return out


def _normal(x, drop=frozenset()):
    if isinstance(x, dict):
        return {k: _normal(v, drop) for k, v in x.items() if k not in VOLATILE | drop}
    if isinstance(x, list):
        return [_normal(v, drop) for v in x]
    return x


def _same(a, b, where="") -> list:
    """Differences between two normalized bodies (floats within FLOAT_TOL)."""
    if isinstance(a, float) and isinstance(b, (int, float)) or \
            isinstance(b, float) and isinstance(a, (int, float)):
        return [] if abs(a - b) <= FLOAT_TOL else [f"{where}: {a} != {b}"]
    if isinstance(a, dict) and isinstance(b, dict):
        if set(a) != set(b):
            return [f"{where}: keys {sorted(set(a) ^ set(b))}"]
        return [d for k in a for d in _same(a[k], b[k], f"{where}.{k}")]
    if isinstance(a, list) and isinstance(b, list):
        if len(a) != len(b):
            return [f"{where}: {len(a)} items != {len(b)}"]
        return [d for i, (u, v) in enumerate(zip(a, b)) for d in _same(u, v, f"{where}[{i}]")]
    return [] if a == b else [f"{where}: {a!r} != {b!r}"]


@pytest.fixture(scope="module")
def responses(tmp_path_factory):
    """Both apps' answers to SCENARIO, each from its own process and data
    directory."""
    procs = {}
    for pkg in ("jax", "port"):
        base = tmp_path_factory.mktemp(pkg)
        # one JAX CPU device, as the port reports one
        env = dict(os.environ, MRAG_DATA_DIR=str(base / "data"), JAX_PLATFORMS="cpu",
                   XLA_FLAGS="",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        procs[pkg] = (subprocess.Popen(
            [sys.executable, __file__, pkg, str(base / "out.json")], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), base / "out.json")
    out = {}
    for pkg, (proc, path) in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{pkg} scenario failed:\n{err[-4000:]}"
        with open(path) as f:
            out[pkg] = {name: (status, body) for name, status, body in json.load(f)}
    return out


@pytest.mark.parametrize("name", [s[0] for s in SCENARIO if s[4] == "equal"])
def test_route_answers_like_jax(responses, name):
    (ps, pb), (js, jb) = responses["port"][name], responses["jax"][name]
    assert ps == js, (name, pb, jb)
    drop = VOLATILE_IN.get(name, frozenset())
    diffs = _same(_normal(pb, drop), _normal(jb, drop), name)
    assert not diffs, diffs[:10]


def test_scenario_known_answers(responses):
    """tests/test_api.py's checks, on the port's answers."""
    port = responses["port"]
    assert port["upload"][0] == 200 and not port["upload"][1]["deduped"]
    assert "180 days" in port["query"][1]["results"][0]["text"]
    agent = port["agent"][1]
    assert not agent["refused"] and agent["strategy_chain"]
    assert port["trace"][1]["decision"]["strategy"] in "abcds"
    assert port["search_events"][1]["events"]
    assert port["retag"][1]["retagged_chunks"] >= 2
    assert port["llm_list"][1]["configs"][0]["secrets"]["api_key"] == "***"
    assert port["delete"][1]["deleted_chunks"] >= 2
    doc_id = port["upload"][1]["doc_id"]
    assert any(h["doc_id"] == doc_id for h in port["query"][1]["results"])
    assert all(h["doc_id"] != doc_id for h in port["query_after_delete"][1]["results"])
    assert [port[n][0] for n in ("bad_query", "bad_mode", "missing_doc", "ns_dup")] == \
        [400, 400, 404, 409]
    run = port["eval_run"][1]
    assert run["aggregates"]["n"] == 5 and run["aggregates"]["citation_rate"] == 1.0
    assert port["grade_rollup"][1]["strategies"]
    assert set(port["eval_calibrate"][1]["per_run"]) == {"a", "b", "c", "d", "s", "natural"}
    bank = port["eval_bank"][1]
    assert bank["name"] == "bank_toy.yaml" and bank["n_queries"] == 5
    assert bank["sha"] == responses["jax"]["eval_bank"][1]["sha"]
    assert port["fact_compare"][1]["winner"] == "a"
    assert port["pdf"][1].startswith("%PDF") and port["pdf"][1] == responses["jax"]["pdf"][1]
    assert port["integrity"][1]["counts"]["host_records"] > 0
    assert port["internal_publish"][1] == {"rows": []}
    assert set(port["profile"][1]["profile"]["device_stages_ms"]) == \
        {"filters", "vector", "lexical", "dtag", "arms", "full_pipeline"}


def _context_under(tmp_path):
    """An AppContext like AppContext.build's, over hash_embed and the sample
    lexicon on the CPU, with every sqlite file and blob under tmp_path."""
    from mobius_rag_tpu_torch.api.server import AppContext
    from mobius_rag_tpu_torch.candidates import CandidateStore
    from mobius_rag_tpu_torch.curator import Curator
    from mobius_rag_tpu_torch.eval_harness.db import EvalDB
    from mobius_rag_tpu_torch.index.store import ChunkStore
    from mobius_rag_tpu_torch.ingest.pipeline import IngestPipeline
    from mobius_rag_tpu_torch.ingest.queue import JobQueue
    from mobius_rag_tpu_torch.ingest.worker import FileDocumentStore
    from mobius_rag_tpu_torch.observability import TelemetryStore
    from mobius_rag_tpu_torch.providers import LLMConfigRegistry, PromptRegistry
    from mobius_rag_tpu_torch.query.agent import CorpusSearchAgent
    from mobius_rag_tpu_torch.query.engine import SearchEngine
    from mobius_rag_tpu_torch.tenancy import NamespaceRegistry
    from mobius_rag_tpu_torch.testing import hash_embed, sample_lexicon

    lex, store = sample_lexicon(), ChunkStore(device="cpu")
    telemetry = TelemetryStore(str(tmp_path / "telemetry.sqlite"))
    engine = SearchEngine(store, lex, embed_fn=hash_embed, telemetry=telemetry, device="cpu")
    curator = Curator(str(tmp_path / "curator.sqlite"))
    candidates = CandidateStore(str(tmp_path / "candidates.sqlite"))
    pipeline = IngestPipeline(store, lex, hash_embed, candidate_sink=candidates.record,
                              queue=JobQueue(str(tmp_path / "jobs.sqlite")),
                              docs=FileDocumentStore(str(tmp_path / "documents")))
    return AppContext(store=store, engine=engine,
                      agent=CorpusSearchAgent(engine, curator=curator), pipeline=pipeline,
                      telemetry=telemetry, eval_db=EvalDB(str(tmp_path / "eval.sqlite")),
                      llm_configs=LLMConfigRegistry(), prompts=PromptRegistry(),
                      namespaces=NamespaceRegistry(lex, hash_embed, telemetry=telemetry,
                                                   device="cpu"),
                      curator=curator, candidates=candidates)


def test_admin_auth(tmp_path, monkeypatch):
    """The admin middleware: 401 without the key when MRAG_ADMIN_KEY is set,
    200 with it; other routes stay open."""
    from aiohttp.test_utils import TestClient, TestServer

    from mobius_rag_tpu_torch.api.server import build_app

    ctx = _context_under(tmp_path)
    monkeypatch.setenv("MRAG_ADMIN_KEY", "s3cret")

    async def scenario():
        client = TestClient(TestServer(build_app(ctx)))
        await client.start_server()
        try:
            r = await client.post("/admin/cleanup-stale-jobs", json={})
            assert r.status == 401
            r = await client.post("/admin/cleanup-stale-jobs", json={},
                                  headers={"X-Admin-Key": "s3cret"})
            assert r.status == 200
            assert (await client.get("/health")).status == 200
        finally:
            await client.close()

    asyncio.run(scenario())


def test_appcontext_build_defaults():
    """AppContext.build's defaults: the cuda device and the onchip
    provider; the cross-encoder checkpoint raises, naming its ROADMAP
    item; the lexicon path defaults to the port's full JSON lexicon."""
    import inspect

    from mobius_rag_tpu_torch import providers
    from mobius_rag_tpu_torch.api.server import AppContext
    from mobius_rag_tpu_torch.config import get_config

    assert inspect.signature(AppContext.build).parameters["device"].default == "cuda"
    assert providers._PROVIDER_FACTORIES["onchip"] is providers.OnChipProvider
    assert os.getenv("MRAG_EMBED_PROVIDER", "onchip") == "onchip"
    path = get_config().lexicon_path
    assert path.endswith(os.path.join("mobius_rag_tpu_torch", "data", "lexicon_full.json"))
    from mobius_rag_tpu_torch.query.lexicon import Lexicon

    assert len(Lexicon.load(path).entries) > 100


def test_cross_encoder_checkpoint_raises(monkeypatch, tmp_path):
    """MRAG_CROSS_ENCODER_CKPT naming no checkpoint fails the build (as in
    the JAX package) instead of serving without the stage."""
    import dataclasses

    from mobius_rag_tpu_torch.api import server

    cfg = dataclasses.replace(server.get_config(),
                              cross_encoder_ckpt=str(tmp_path / "nonexistent"))
    monkeypatch.setattr(server, "get_config", lambda: cfg)
    with pytest.raises(FileNotFoundError, match="encoder.json"):
        server.AppContext.build(device="cpu")


def test_providers_registry(tmp_path):
    """The embedding registry and the YAML-backed registries (PyYAML is
    imported only where a directory is read)."""
    from mobius_rag_tpu_torch import providers
    from mobius_rag_tpu_torch.testing import hash_embed

    hp = providers.get_embedding_provider("hash")
    assert hp.name == "hash" and (hp.embed(["a b"]) == hash_embed(["a b"])).all()
    with pytest.raises(ValueError, match="unknown embedding provider"):
        providers.get_embedding_provider("nope")
    with pytest.raises(ValueError, match="MRAG_EMBED_URL"):
        providers.get_embedding_provider("external")
    (tmp_path / "llm").mkdir()
    (tmp_path / "llm" / "a.yaml").write_text("provider: http\nparams: {api_key: k, t: 1}\n")
    reg = providers.LLMConfigRegistry(str(tmp_path / "llm"))
    assert reg.list_redacted() == [{"name": "a", "provider": "http", "model": "",
                                    "params": {"api_key": "***", "t": 1}, "secrets": {}}]
    (tmp_path / "prompts" / "synthesis").mkdir(parents=True)
    (tmp_path / "prompts" / "synthesis" / "v1.yaml").write_text("text: hello\n")
    pr = providers.PromptRegistry(str(tmp_path / "prompts"))
    assert pr.get("synthesis").text == "hello"


if __name__ == "__main__":
    with open(sys.argv[2], "w") as f:
        json.dump(_scenario(sys.argv[1]), f, default=str)
