"""HTTP API — the thin host shell over the query engine (the port of
``mobius_rag_tpu.api.server``).

Covers the reference's operative surface (app/main.py ~150 endpoints +
app/routers/{skills,eval}.py), collapsed to the endpoints that carry the
platform's behavior. FastAPI isn't available in this image, so the
server is aiohttp.web; handlers are thin — every operation delegates to
the framework modules.

Endpoint map (reference anchor → here):
  POST /upload                      (main.py:5126)  → upload + instant path
  GET  /documents[, /{id}]          (main.py:4182)  → registry + status
  DELETE /documents/{id}            (delete + index invalidation)
  POST /api/query                   (main.py:11935) → engine.search
  POST /api/skills/v1/corpus_search (routers/skills.py:36)
  POST /api/skills/v1/corpus_search_agent (routers/skills.py:92)
  GET  /pipeline_health             (main.py:1977)  → queue depths + index stats
  GET  /api/search_events           (main.py:13561)
  GET  /api/decisions[, /{id}/trace]
  GET  /api/errors
  GET  /api/progress/{cid}          (progress poll; SSE at /stream)
  POST /api/eval/run, /api/eval/calibrate; GET /api/eval/runs[/{id}]
  GET/POST /api/lexicon[, /entries]
  GET/POST /config/llm, /config/prompts
  POST /admin/retag                 (main.py:3419 in-process retag)
  POST /admin/snapshot, /admin/restore
  POST /admin/cleanup-stale-jobs    (main.py:2323)
  GET  /health
Admin auth: X-Admin-Key required on /admin/* + /config/* when
MRAG_ADMIN_KEY is set (main.py:548 middleware parity).

The port imports aiohttp only in ``build_app``, ``main`` and the route
modules, so ``AppContext`` (the library entry point) works without it.
Every handler of the JAX app is served. A ``parallel.ShardedEngine``
attached as ``ctx.engine.sharded`` refreshes after publishes and deletes
(through the store's listeners) and is rebuilt on a restore. Run:
``python -m mobius_rag_tpu_torch.api.server --port 8000 [--provider hash]
[--device cpu]``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any

from mobius_rag_tpu_torch.config import get_config
from mobius_rag_tpu_torch.eval_harness.db import EvalDB
from mobius_rag_tpu_torch.index.store import ChunkStore
from mobius_rag_tpu_torch.ingest.pipeline import IngestPipeline
from mobius_rag_tpu_torch.observability import PROGRESS, TelemetryStore
from mobius_rag_tpu_torch.providers import LLMConfig, LLMConfigRegistry, PromptRegistry
from mobius_rag_tpu_torch.query.agent import AgentRequest, CorpusSearchAgent
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine


@dataclasses.dataclass
class AppContext:
    store: ChunkStore
    engine: SearchEngine
    agent: CorpusSearchAgent
    pipeline: IngestPipeline
    telemetry: TelemetryStore
    eval_db: EvalDB
    llm_configs: LLMConfigRegistry
    prompts: PromptRegistry
    namespaces: Any = None  # tenancy.NamespaceRegistry
    curator: Any = None  # curator.Curator
    nightly: Any = None  # nightly.NightlyOrchestrator
    candidates: Any = None  # candidates.CandidateStore
    # scratch for ops endpoints (vacuum status, etc.)
    extra_state: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def build(cls, *, embed_fn=None, lexicon=None, llm=None,
              store=None, device="cuda") -> "AppContext":
        from mobius_rag_tpu_torch.curator import Curator
        from mobius_rag_tpu_torch.providers import get_embedding_provider
        from mobius_rag_tpu_torch.query.lexicon import Lexicon
        from mobius_rag_tpu_torch.tenancy import NamespaceRegistry

        # Entrypoints load the curated production lexicon (MRAG_LEXICON_PATH,
        # default = packaged full lexicon) — never the toy test sample.
        lexicon = lexicon or Lexicon.load(get_config().lexicon_path)
        embed_fn = embed_fn or get_embedding_provider(device=device).embed
        # serve a pre-built index when given
        store = store or ChunkStore(device=device)
        telemetry = TelemetryStore()
        engine = SearchEngine(store, lexicon, embed_fn=embed_fn,
                              telemetry=telemetry, device=store.device)
        if get_config().cross_encoder_ckpt:
            from mobius_rag_tpu_torch.models.checkpoint import load_encoder
            from mobius_rag_tpu_torch.models.cross_encoder import (
                CrossEncoderConfig, CrossEncoderModel)

            ce_params, ce_cfg = load_encoder(get_config().cross_encoder_ckpt)
            engine.cross_encoder = CrossEncoderModel(
                CrossEncoderConfig(ce_cfg), ce_params, device=store.device)
        from mobius_rag_tpu_torch.candidates import CandidateStore

        curator = Curator()
        agent = CorpusSearchAgent(engine, llm=llm, curator=curator)
        agent.observers.append(telemetry.record_decision)
        candidates = CandidateStore()
        # Each context gets its OWN job queue file: two contexts sharing
        # one queue would claim each other's jobs and fail them against
        # the wrong DocumentStore (a cross-context job-theft race that
        # surfaced as flaky 404s in the test suite). Standalone worker
        # processes opt into a shared queue explicitly via --queue.
        import uuid as _uuid

        from mobius_rag_tpu_torch.ingest.queue import JobQueue

        queue = JobQueue(os.path.join(
            get_config().data_dir, f"jobs-{_uuid.uuid4().hex[:8]}.sqlite"))
        from mobius_rag_tpu_torch.blobstore import get_document_store

        pipeline = IngestPipeline(store, lexicon, embed_fn, llm=llm,
                                  candidate_sink=candidates.record,
                                  queue=queue, docs=get_document_store())
        ctx = cls(store=store, engine=engine, agent=agent, pipeline=pipeline,
                  telemetry=telemetry, eval_db=EvalDB(),
                  llm_configs=LLMConfigRegistry(), prompts=PromptRegistry(),
                  namespaces=NamespaceRegistry(lexicon, embed_fn,
                                               telemetry=telemetry,
                                               device=store.device),
                  curator=curator, candidates=candidates)
        from mobius_rag_tpu_torch.nightly import NightlyOrchestrator

        ctx.nightly = NightlyOrchestrator(ctx)
        return ctx


def _json(data: Any, status: int = 200):
    from aiohttp import web

    return web.json_response(data, status=status, dumps=lambda d: json.dumps(d, default=str))


def _err(msg: str, status: int = 400):
    return _json({"error": msg}, status)


async def admin_auth_middleware(request, handler):
    key = os.getenv("MRAG_ADMIN_KEY", "")
    path = request.path
    if (path.startswith("/admin") or path.startswith("/config")
            or path.startswith("/internal")):
        if key:
            if request.headers.get("X-Admin-Key") != key:
                return _err("admin key required", 401)
        else:
            # No admin key configured: the admin surface (SQL console,
            # snapshot/restore, profiler) is loopback-only, so widening
            # --host can never expose it unauthenticated.
            peer = request.remote or ""
            if peer not in ("", "127.0.0.1", "::1", "localhost"):
                return _err(
                    "admin/config routes require MRAG_ADMIN_KEY for "
                    "non-loopback access", 403)
    try:
        return await handler(request)
    except json.JSONDecodeError:
        return _err("request body must be valid JSON", 400)


def _data_subpath(sub: str | None, default_name: str) -> str:
    """Resolve a caller-supplied path strictly inside data_dir — admin
    snapshot/profile writes must not be able to target arbitrary
    filesystem locations."""
    base = os.path.realpath(get_config().data_dir)
    target = os.path.realpath(
        sub if sub else os.path.join(base, default_name))
    if target != base and not target.startswith(base + os.sep):
        raise ValueError(f"path must be inside data_dir ({base})")
    return target


def build_app(ctx: AppContext):
    from aiohttp import web

    app = web.Application(middlewares=[web.middleware(admin_auth_middleware)],
                          client_max_size=110 * 1024 * 1024)
    r = app.router

    # Extended surface FIRST: aiohttp resolves in registration order, and
    # fixed paths like /documents/search must win over /documents/{doc_id}.
    from mobius_rag_tpu_torch.api.extended import register_extended_routes
    from mobius_rag_tpu_torch.api.ops import register_ops_routes

    # ops first: its fixed paths (/documents/retag/status) must win over
    # extended's dynamic /documents/{doc_id}/status; the reverse holds no
    # shadowing (ops' dynamic routes share no fixed-path prefix+method
    # with extended's fixed routes)
    register_ops_routes(r, ctx)
    register_extended_routes(r, ctx)

    # ---- health / ops ---------------------------------------------------

    async def console(request):
        path = os.path.join(os.path.dirname(__file__), "console.html")
        return web.FileResponse(path)

    async def health(request):
        return _json({"status": "ok", "chunks": ctx.store.size,
                      "capacity": ctx.store.capacity})

    async def pipeline_health(request):
        return _json({
            "queue_depths": ctx.pipeline.queue.depths(),
            "index": {"chunks": ctx.store.size, "capacity": ctx.store.capacity,
                      "documents": len(ctx.pipeline.docs.docs)},
            "recent_errors": ctx.telemetry.recent_errors(5),
        })

    # ---- ingest ---------------------------------------------------------

    async def upload(request):
        data = await request.read()
        q = request.query
        if not data:
            return _err("empty body")
        instant_q = q.get("instant", "")
        try:
            res = ctx.pipeline.upload(
                data, q.get("filename", "upload.txt"),
                payer=q.get("payer", ""), state=q.get("state", ""),
                program=q.get("program", ""),
                authority_level=int(q.get("authority_level", 0)),
                summary=q.get("summary", ""),
                instant=None if not instant_q
                else instant_q.lower() in ("1", "true", "yes"),
            )
        except ValueError as e:
            return _err(str(e), 413 if "exceeds" in str(e) else 400)
        return _json(dataclasses.asdict(res))

    async def documents(request):
        docs = [
            {"doc_id": d.doc_id, "filename": d.filename, "payer": d.payer,
             "state": d.state, "program": d.program,
             "chunks": len([r for r in ctx.store._doc_rows.get(d.doc_id, [])
                            if ctx.store.records[r] is not None])}
            for d in ctx.pipeline.docs.docs.values()
        ]
        return _json({"documents": docs})

    async def document_detail(request):
        doc_id = request.match_info["doc_id"]
        d = ctx.pipeline.docs.get(doc_id)
        if d is None:
            return _err("not found", 404)
        rows = ctx.store._doc_rows.get(doc_id, [])
        chunks = [
            {"chunk_id": rec.chunk_id, "section_path": rec.section_path,
             "page": rec.page, "text": rec.text[:300]}
            for r in rows if (rec := ctx.store.record(r)) is not None
        ]
        return _json({"doc_id": doc_id, "filename": d.filename,
                      "payer": d.payer, "chunks": chunks})

    async def document_delete(request):
        doc_id = request.match_info["doc_id"]
        n = ctx.store.delete_by_document(doc_id)
        ctx.pipeline.docs.docs.pop(doc_id, None)
        return _json({"deleted_chunks": n})

    # ---- query ------------------------------------------------------------

    # Adaptive micro-batching (query/microbatch.py): concurrent
    # batch-of-1 arrivals fold into one compiled program invocation,
    # and the engine call leaves the event loop (the reference blocks a
    # worker per query; here the loop stays live during device time).
    from mobius_rag_tpu_torch.query.microbatch import OverloadedError, make_batcher

    batcher = make_batcher(ctx.engine)

    # Per-request input validation lives HERE, before the batcher:
    # engine.search validates per-request fields but raises for the
    # whole batch, so a malformed request co-batched with valid ones
    # would 400 its neighbors (round-4 advisor finding). k is clamped
    # so one caller can't force a new compile shape / memory spike on
    # the shared batch.
    _QUERY_MODES = ("corpus", "precision", "recall")
    _TAG_MODES = ("strict", "relaxed", "none")
    MAX_QUERY_K = int(os.getenv("MRAG_MAX_QUERY_K", "100"))

    async def query(request):
        body = await request.json()
        if not body.get("query"):
            return _err("missing 'query'")
        mode = body.get("mode", "corpus")
        if mode not in _QUERY_MODES:
            return _err(f"mode must be one of {_QUERY_MODES}")
        tag_mode = body.get("tag_mode", "strict")
        if tag_mode not in _TAG_MODES:
            return _err(f"tag_mode must be one of {_TAG_MODES}")
        try:
            min_sim = float(body.get("min_similarity", 0.0))
            k = max(1, min(int(body.get("k", 10)), MAX_QUERY_K))
        except (TypeError, ValueError):
            return _err("k and min_similarity must be numbers")
        qreq = QueryRequest(
            query=body["query"], mode=mode,
            payer=body.get("payer", ""), state=body.get("state", ""),
            program=body.get("program", ""),
            min_similarity=min_sim,
            tag_mode=tag_mode,
        )
        try:
            if batcher is not None:
                res = await batcher.search_one(qreq, k)
            else:
                res = ctx.engine.search(qreq, k=k)[0]
        except OverloadedError as e:
            return _json({"error": str(e)}, status=503)
        except ValueError as e:
            return _err(str(e))
        return _json({
            "query": res.query, "confidence_label": res.confidence_label,
            "results": [
                {"chunk_id": h.chunk_id, "doc_id": h.doc_id, "text": h.text,
                 "score": h.score, "similarity": h.similarity,
                 "signals": h.signals, "metadata": h.metadata}
                for h in res.hits
            ],
            "expansion": res.expansion.matched_codes,
            "telemetry": res.telemetry,
        })

    async def skill_corpus_search(request):
        return await query(request)

    async def skill_agent(request):
        body = await request.json()
        if not body.get("query"):
            return _err("missing 'query'")
        try:
            # preference fields pass through as None when absent so the
            # caller-mode preset (router :118-160) supplies the defaults
            acc = body.get("accuracy_need")
            rec = body.get("recall_demand")
            res = ctx.agent.run(AgentRequest(
                query=body["query"], mode=body.get("mode"),
                payer=body.get("payer", ""), state=body.get("state", ""),
                program=body.get("program", ""), k=int(body.get("k", 10)),
                caller_mode=body.get("caller_mode"),
                accuracy_need=None if acc is None else float(acc),
                recall_demand=None if rec is None else float(rec),
                speed_budget=body.get("speed_budget"),
                answer_shape=body.get("answer_shape"),
            ))
        except ValueError as e:
            return _err(str(e))
        return _json({
            "agent_id": res.agent_id, "answer": res.answer,
            "confidence_label": res.confidence_label, "refused": res.refused,
            "strategy_chain": res.strategy_chain, "decision": res.decision,
            "gate": res.gate, "profile": res.profile,
            "improvement_hint": res.improvement_hint,
            "narrative": res.narrative,
            "chunks": [
                {"chunk_id": h.chunk_id, "doc_id": h.doc_id, "text": h.text,
                 "score": h.score, "metadata": h.metadata}
                for h in res.chunks
            ],
            "telemetry": res.telemetry,
        })

    # ---- observability -------------------------------------------------------

    async def search_events(request):
        return _json({"events": ctx.telemetry.recent_search_events(
            int(request.query.get("limit", 50)))})

    async def decisions(request):
        return _json({"decisions": ctx.telemetry.recent_decisions(
            int(request.query.get("limit", 50)))})

    async def decision_trace(request):
        ctx.telemetry.flush()
        trace = ctx.telemetry.trace(request.match_info["agent_id"])
        return _json(trace) if trace else _err("not found", 404)

    async def errors(request):
        return _json({"errors": ctx.telemetry.recent_errors(
            int(request.query.get("limit", 50)),
            request.query.get("severity"))})

    async def progress(request):
        cid = request.match_info["cid"]
        since = int(request.query.get("since", -1))
        return _json({"events": PROGRESS.events(cid, since)})

    async def progress_stream(request):
        cid = request.match_info["cid"]
        resp = web.StreamResponse(headers={"Content-Type": "text/event-stream",
                                           "Cache-Control": "no-cache"})
        await resp.prepare(request)
        import asyncio

        seen = -1
        for _ in range(600):  # bounded stream (~60 s at 0.1 s polls)
            events = PROGRESS.events(cid, seen)
            for e in events:
                seen = e["seq"]
                await resp.write(f"data: {json.dumps(e)}\n\n".encode())
            if events and events[-1]["stage"] in ("done", "failed"):
                break
            await asyncio.sleep(0.1)
        await resp.write_eof()
        return resp

    # ---- eval --------------------------------------------------------------

    async def eval_run(request):
        body = await request.json()
        from mobius_rag_tpu_torch.eval_harness.run import run_eval

        bank = body.get("bank", "toy")
        # GET /api/eval/active reads this while the run is in flight
        ctx.extra_state["eval_active"] = {"bank": bank, "started_at": time.time()}
        try:
            out = run_eval(ctx.agent, bank,
                           forced_mode=body.get("mode"),
                           k=int(body.get("k", 10)), db=ctx.eval_db)
        finally:
            ctx.extra_state["eval_active"] = None
        return _json({"run_id": out.run_id, "aggregates": out.aggregates})

    async def eval_calibrate(request):
        body = await request.json()
        from mobius_rag_tpu_torch.eval_harness.calibrate import calibrate

        bank = body.get("bank", "toy")
        ctx.extra_state["calibration_active"] = {"bank": bank,
                                                 "started_at": time.time()}
        try:
            out = calibrate(ctx.agent, bank,
                            k=int(body.get("k", 10)), db=ctx.eval_db)
            ctx.extra_state["calibration_last"] = {
                "bank": bank, "calib_id": out.get("calib_id"),
                "finished_at": time.time()}
        finally:
            ctx.extra_state["calibration_active"] = None
        return _json(out)

    async def eval_runs(request):
        return _json({"runs": ctx.eval_db.list_runs(
            int(request.query.get("limit", 50)))})

    async def eval_run_detail(request):
        run_id = request.match_info["run_id"]
        run = ctx.eval_db.run(run_id)
        if run is None:
            return _err("not found", 404)
        return _json({**run, "results": ctx.eval_db.results(run_id)})

    async def eval_pr_curve(request):
        """Per-strategy precision/recall sweep over a confidence
        threshold τ (routers/eval.py:1368 pr_curve). Results carry
        confidence tiers; tier→score {low:.33, medium:.66, high:1.0};
        at each τ a query is ANSWERED if its tier score ≥ τ; precision =
        correct/answered, recall = correct-and-answered/all. Human
        verdict overrides count (effective_verdict)."""
        run_id = request.match_info["run_id"]
        results = ctx.eval_db.results(run_id)
        if not results:
            return _err("no results for run", 404)
        n_steps = max(5, min(101, int(request.query.get("n_steps", 21))))
        tier_score = {"high": 1.0, "medium": 0.66, "low": 0.33, "abstain": 0.0}
        by_strategy: dict[str, list] = {}
        for r in results:
            sid = (r.get("strategy_chain") or ["?"])[-1]
            by_strategy.setdefault(sid, []).append(r)
        curves = {}
        for sid, rows in sorted(by_strategy.items()):
            pts = []
            for i in range(n_steps):
                tau = i / (n_steps - 1)
                answered = [r for r in rows
                            if tier_score.get(r.get("confidence"), 0.0) >= tau
                            and not r.get("refused")]
                correct = [r for r in answered
                           if r.get("effective_verdict") == "correct"]
                pts.append({
                    "tau": round(tau, 3),
                    "answered": len(answered),
                    "precision": round(len(correct) / len(answered), 4)
                    if answered else None,
                    "recall": round(len(correct) / len(rows), 4),
                })
            curves[sid] = pts
        return _json({"run_id": run_id, "axis": "confidence_tier",
                      "curves": curves})

    async def eval_grade_rollup(request):
        """Two-grade QA rollup per strategy (routers/eval.py:224):
        retrieval grade = chunk recall, synthesis grade = grounding,
        mean ± std, with the fact-checker σ noise band."""
        import statistics as stats

        from mobius_rag_tpu_torch.eval_harness.fact_checker import (
            FACT_CHECKER_SIGMA, FACT_CHECKER_VERSION)

        run_id = request.match_info["run_id"]
        results = ctx.eval_db.results(run_id)
        if not results:
            return _err("no results for run", 404)
        by: dict[str, list] = {}
        for r in results:
            by.setdefault((r.get("strategy_chain") or ["?"])[-1], []).append(r)
        strategies = {}
        for sid, rows in sorted(by.items()):
            ret = [r.get("chunk_recall", 0.0) for r in rows]
            syn = [r.get("grounding", 0.0) for r in rows]
            strategies[sid] = {
                "n": len(rows),
                "retrieval_mean": round(stats.mean(ret), 3),
                "retrieval_std": round(stats.pstdev(ret), 3),
                "synthesis_mean": round(stats.mean(syn), 3),
                "synthesis_std": round(stats.pstdev(syn), 3),
                "gap_mean": round(stats.mean(r - s for r, s in zip(ret, syn)), 3),
            }
        return _json({"run_id": run_id, "strategies": strategies,
                      "sigma_noise": FACT_CHECKER_SIGMA,
                      "fact_checker_version": FACT_CHECKER_VERSION})

    async def eval_verdict_patch(request):
        """Human-verdict override on one result (routers/eval.py:1151):
        body {verdict: correct|partial|incorrect|null, reasoning, by}."""
        body = await request.json()
        verdict = body.get("verdict")
        if verdict is not None and verdict not in ("correct", "partial",
                                                   "incorrect"):
            return _err("verdict must be correct|partial|incorrect|null")
        out = ctx.eval_db.patch_verdict(
            request.match_info["run_id"], request.match_info["query_id"],
            verdict, reasoning=body.get("reasoning", ""),
            by=body.get("by", ""))
        return _json(out) if out else _err("result not found", 404)

    async def prod_rollup(request):
        return _json(ctx.telemetry.decisions_rollup(
            float(request.query.get("window_hours", 24))))

    def _editable_bank_path(rel: str) -> str:
        """Editable banks live under data_dir/banks — the reference banks
        (eval_bank_dir) are the read-only parity oracle."""
        base = os.path.realpath(os.path.join(get_config().data_dir, "banks"))
        target = os.path.realpath(os.path.join(base, rel))
        if target != base and not target.startswith(base + os.sep):
            raise ValueError(f"bank path must live under {base}")
        return target

    async def eval_bank_get(request):
        """Read a bank as JSON (routers/eval.py:902). `name` resolves
        through the standard loader (reference banks included, read-only);
        `path` reads an editable bank under data_dir/banks."""
        from mobius_rag_tpu_torch.eval_harness.bank import load_bank

        rel = request.query.get("path")
        if rel:
            try:
                path = _editable_bank_path(rel)
            except ValueError as e:
                return _err(str(e), 403)
            if not os.path.exists(path):
                return _err("bank not found", 404)
            bank = load_bank(path)
        else:
            try:
                bank = load_bank(request.query.get("name", "toy"))
            except FileNotFoundError as e:
                return _err(str(e), 404)
        return _json({"name": bank.name, "version": bank.version,
                      "sha": bank.sha, "n_queries": len(bank.queries),
                      "queries": [q.raw for q in bank.queries]})

    async def eval_bank_put(request):
        """Write an editable bank (routers/eval.py:928 PUT semantics):
        validates id/query per entry, rejects duplicates, backs up the
        previous version to <name>.bak."""
        import yaml as _yaml

        body = await request.json()
        queries = body.get("queries")
        if not isinstance(queries, list) or not queries:
            return _err("body.queries must be a non-empty list")
        seen = set()
        cleaned = []
        for i, q in enumerate(queries):
            if not isinstance(q, dict):
                return _err(f"query[{i}] not a dict")
            qid = (q.get("id") or "").strip()
            text = (q.get("query") or "").strip()
            if not qid:
                return _err(f"query[{i}] missing id")
            if not text:
                return _err(f"query[{i}] ({qid}) missing query text")
            if qid in seen:
                return _err(f"duplicate id: {qid}")
            seen.add(qid)
            cleaned.append({k: v for k, v in q.items()
                            if v not in (None, "", [], {})})
        try:
            path = _editable_bank_path(body.get("rel_path") or "custom.yaml")
        except ValueError as e:
            return _err(str(e), 403)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        if os.path.exists(path):
            with open(path) as f:
                prev = f.read()
            with open(path + ".bak", "w") as f:
                f.write(prev)
        with open(path, "w") as f:
            _yaml.safe_dump(
                {"bank_version": body.get("bank_version", "custom"),
                 "queries": cleaned},
                f, sort_keys=False, allow_unicode=True, width=120)
        return _json({"path": path, "n_queries": len(cleaned)})

    # ---- lexicon ----------------------------------------------------------------

    async def lexicon_list(request):
        lex = ctx.engine.lexicon
        return _json({"entries": [
            {"kind": e.kind, "code": e.code, "tag_id": e.tag_id,
             "selectivity": e.selectivity, "phrases": e.phrases}
            for e in lex.entries
        ]})

    async def lexicon_add(request):
        body = await request.json()
        from mobius_rag_tpu_torch.query.lexicon import LexiconEntry

        try:
            entry = ctx.engine.lexicon.add_entry(LexiconEntry(
                kind=body["kind"], code=body["code"],
                phrases=body.get("phrases", []),
                selectivity=float(body.get("selectivity", 0.8)),
            ))
        except (KeyError, ValueError) as e:
            return _err(f"bad entry: {e}")
        return _json({"added": entry.full_code, "tag_id": entry.tag_id})

    async def lexicon_candidates(request):
        return _json({"candidates": ctx.candidates.pending(
            min_occurrences=int(request.query.get("min_occurrences", 2)),
            limit=int(request.query.get("limit", 100)))})

    async def lexicon_candidate_review(request):
        body = await request.json()
        if not body.get("phrase"):
            return _err("missing 'phrase'")
        out = ctx.candidates.review(
            body["phrase"], approve=bool(body.get("approve", False)),
            lexicon=ctx.engine.lexicon if body.get("approve") else None,
            kind=body.get("kind", "d"), code=body.get("code", ""))
        if not out["found"]:
            return _err("candidate not found", 404)
        return _json(out)

    # ---- eval timeline / compare -----------------------------------------------

    async def eval_timeline(request):
        """Runs over time (+ drift vs the previous run of the same bank) —
        routers/eval.py timeline/drift parity."""
        runs = ctx.eval_db.list_runs(int(request.query.get("limit", 100)))
        bank = request.query.get("bank")
        if bank:
            runs = [r for r in runs if bank in (r["bank_name"] or "")]
        runs = sorted(runs, key=lambda r: r["started_at"] or 0)
        out = []
        prev: dict | None = None
        for r in runs:
            agg = r["aggregates"] or {}
            drift = None
            if prev and agg and prev.get("aggregates"):
                drift = {
                    key: round(agg.get(key, 0) - prev["aggregates"].get(key, 0), 4)
                    for key in ("accuracy", "mean_chunk_recall", "answer_rate")
                }
            out.append({**r, "drift": drift})
            if agg:
                prev = r
        return _json({"timeline": out})

    async def eval_compare(request):
        """Per-query diff between two runs (routers/eval.py compare)."""
        a, b = request.query.get("run_a"), request.query.get("run_b")
        if not a or not b:
            return _err("need run_a and run_b")
        ra = {r["query_id"]: r for r in ctx.eval_db.results(a)}
        rb = {r["query_id"]: r for r in ctx.eval_db.results(b)}
        if not ra or not rb:
            return _err("unknown run id(s)", 404)
        diffs = []
        for qid in sorted(set(ra) | set(rb)):
            xa, xb = ra.get(qid), rb.get(qid)
            diffs.append({
                "query_id": qid,
                "a": {"verdict": xa and xa["judge_verdict"],
                      "recall": xa and xa["chunk_recall"]},
                "b": {"verdict": xb and xb["judge_verdict"],
                      "recall": xb and xb["chunk_recall"]},
                "changed": bool(xa and xb and
                                xa["judge_verdict"] != xb["judge_verdict"]),
            })
        return _json({"run_a": a, "run_b": b, "diffs": diffs,
                      "changed": sum(d["changed"] for d in diffs)})

    # ---- documents: original bytes + pdf export -----------------------------------

    async def document_file(request):
        d = ctx.pipeline.docs.get(request.match_info["doc_id"])
        if d is None:
            return _err("not found", 404)
        return web.Response(body=d.data, content_type="application/octet-stream",
                            headers={"Content-Disposition":
                                     f'attachment; filename="{d.filename}"'})

    async def document_pdf(request):
        """Consolidated document markdown → PDF (markdown_to_pdf.py parity)."""
        from mobius_rag_tpu_torch.export_pdf import markdown_to_pdf

        doc_id = request.match_info["doc_id"]
        rows = ctx.store._doc_rows.get(doc_id, [])
        recs = [r for i in rows if (r := ctx.store.record(i)) is not None]
        if not recs:
            return _err("not found", 404)
        md = "\n\n".join(
            (f"## {r.section_path}\n\n{r.text}" if r.section_path else r.text)
            for r in recs
        )
        pdf = markdown_to_pdf(f"# {doc_id}\n\n{md}", title=doc_id)
        return web.Response(body=pdf, content_type="application/pdf")

    # ---- drive import ---------------------------------------------------------------

    async def drive_import(request):
        """Import a drive folder via the configured client (offline pods
        have none → 501 with the reason, matching the gated-feature
        pattern)."""
        from mobius_rag_tpu_torch.drive import import_folder

        client = getattr(ctx, "drive_client", None)
        if client is None:
            return _err("no drive client configured (set ctx.drive_client)", 501)
        body = await request.json()
        if not body.get("folder_id"):
            return _err("missing 'folder_id'")
        out = import_folder(ctx.pipeline, client, body["folder_id"],
                            manuals_only=bool(body.get("manuals_only", True)))
        return _json(dataclasses.asdict(out))

    # ---- admin DB console ---------------------------------------------------------

    async def sql_console(request):
        """Read-only SQL over the host-side sqlite stores (main.py:12438
        DB-browser parity). Admin-gated by the middleware; connections
        are opened query_only so writes are impossible."""
        import sqlite3

        body = await request.json()
        sql = (body.get("sql") or "").strip()
        target = body.get("db", "telemetry")
        if not sql:
            return _err("missing 'sql'")
        paths = {
            "telemetry": ctx.telemetry._path,
            "eval": os.path.join(get_config().data_dir, "eval.sqlite"),
            "jobs": ctx.pipeline.queue.path,  # per-context queue file
            "curator": os.path.join(get_config().data_dir, "curator.sqlite"),
            "candidates": os.path.join(get_config().data_dir, "candidates.sqlite"),
        }
        if target not in paths:
            return _err(f"db must be one of {sorted(paths)}")
        try:
            conn = sqlite3.connect(f"file:{paths[target]}?mode=ro", uri=True)
            conn.execute("PRAGMA query_only = ON")
            cur = conn.execute(sql)
            cols = [c[0] for c in cur.description or []]
            rows = cur.fetchmany(int(body.get("limit", 200)))
            conn.close()
        except sqlite3.Error as e:
            return _err(f"sql error: {e}")
        return _json({"columns": cols, "rows": rows})

    # ---- config ----------------------------------------------------------------

    async def llm_configs_list(request):
        return _json({"configs": ctx.llm_configs.list_redacted()})

    async def llm_configs_put(request):
        body = await request.json()
        if not body.get("name"):
            return _err("missing 'name'")
        ctx.llm_configs.upsert(LLMConfig(
            name=body["name"], provider=body.get("provider", "offline"),
            model=body.get("model", ""), params=body.get("params", {}),
            secrets=body.get("secrets", {})))
        return _json({"ok": True})

    async def prompts_list(request):
        return _json({"prompts": ctx.prompts.list_all()})

    async def prompts_put(request):
        body = await request.json()
        for key in ("stage", "version", "text"):
            if not body.get(key):
                return _err(f"missing '{key}'")
        pv = ctx.prompts.put(body["stage"], body["version"], body["text"])
        return _json({"sha": pv.sha})

    # ---- admin ------------------------------------------------------------------

    async def query_batch(request):
        """Batched multi-query endpoint — the throughput shape the device
        pipeline is built for (the reference is strictly one query per
        request; SURVEY §7 phase 4)."""
        body = await request.json()
        queries = body.get("queries") or []
        if not queries or not isinstance(queries, list):
            return _err("missing 'queries' (non-empty list)")
        if len(queries) > 256:
            return _err("at most 256 queries per batch", 413)
        try:
            reqs = [QueryRequest(
                query=q["query"], mode=q.get("mode", "corpus"),
                payer=q.get("payer", ""), state=q.get("state", ""),
                program=q.get("program", ""), tag_mode=q.get("tag_mode", "strict"),
            ) for q in queries]
        except (KeyError, TypeError):
            return _err("each query needs at least {'query': ...}")
        try:
            results = ctx.engine.search(reqs, k=int(body.get("k", 10)))
        except ValueError as e:
            return _err(str(e))
        return _json({"results": [
            {"query": r.query, "confidence_label": r.confidence_label,
             "hits": [{"chunk_id": h.chunk_id, "doc_id": h.doc_id,
                       "score": h.score, "text": h.text[:500]} for h in r.hits]}
            for r in results
        ]})

    # ---- namespaces (org-docs parity) ---------------------------------------

    async def ns_list(request):
        return _json({"namespaces": ctx.namespaces.list()})

    async def ns_create(request):
        body = await request.json()
        try:
            ns = ctx.namespaces.create(body.get("name", ""))
        except ValueError as e:
            return _err(str(e), 409 if "exists" in str(e) else 400)
        return _json({"name": ns.name})

    async def ns_delete(request):
        ok = ctx.namespaces.delete(request.match_info["name"])
        return _json({"deleted": ok}) if ok else _err("not found", 404)

    async def ns_add_chunks(request):
        ns = ctx.namespaces.get(request.match_info["name"])
        if ns is None:
            return _err("not found", 404)
        body = await request.json()
        from mobius_rag_tpu_torch.index.store import ChunkRecord
        from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk

        items = body.get("chunks") or []
        if not items:
            return _err("missing 'chunks'")
        texts = [c.get("text", "") for c in items]
        vecs = ctx.engine.embed_fn(texts)
        recs = []
        for c, v in zip(items, vecs):
            rec = ChunkRecord(
                chunk_id=c.get("chunk_id") or f"{c.get('doc_id', 'doc')}-{len(recs)}",
                doc_id=c.get("doc_id", "doc"), text=c.get("text", ""),
                embedding=v, payer=c.get("payer", ""), state=c.get("state", ""),
            )
            recs.append(featurize_chunk(rec, ctx.engine.lexicon))
        rows = ns.store.add_chunks(recs)
        return _json({"added": len(rows)})

    async def ns_query(request):
        ns = ctx.namespaces.get(request.match_info["name"])
        if ns is None:
            return _err("not found", 404)
        body = await request.json()
        if not body.get("query"):
            return _err("missing 'query'")
        res = ns.engine.search(QueryRequest(query=body["query"]),
                               k=int(body.get("k", 10)))[0]
        return _json({"results": [
            {"chunk_id": h.chunk_id, "doc_id": h.doc_id, "text": h.text,
             "score": h.score} for h in res.hits]})

    # ---- curator --------------------------------------------------------------

    async def curator_sources(request):
        srcs = ctx.curator.search(payer=request.query.get("payer", ""),
                                  status=request.query.get("status", ""),
                                  q=request.query.get("q", ""))
        return _json({"sources": [dataclasses.asdict(s) for s in srcs]})

    async def curator_upsert(request):
        body = await request.json()
        if not body.get("url"):
            return _err("missing 'url'")
        src = ctx.curator.upsert(body["url"], title=body.get("title"),
                                 notes=body.get("notes"))
        return _json(dataclasses.asdict(src))

    async def curator_curate(request):
        body = await request.json()
        if not body.get("url"):
            return _err("missing 'url'")
        src = ctx.curator.curate(body["url"], approve=bool(body.get("approve", True)),
                                 notes=body.get("notes", ""))
        return _json(dataclasses.asdict(src))

    async def microbatch_stats(request):
        if batcher is None:
            return _json({"enabled": False})
        return _json({"enabled": True, **batcher.stats,
                      "queue_depth": len(batcher._queue)})

    async def curator_stats(request):
        return _json(ctx.curator.stats())

    async def curator_probe(request):
        body = await request.json()
        if not body.get("url"):
            return _err("missing 'url'")
        return _json(ctx.curator.probe(body["url"]))

    async def curator_mark_ingested(request):
        body = await request.json()
        if not body.get("url"):
            return _err("missing 'url'")
        src = ctx.curator.mark_ingested(body["url"], body.get("doc_id", ""))
        return _json(dataclasses.asdict(src))

    async def curator_classify(request):
        from mobius_rag_tpu_torch.curator import classify_url

        body = await request.json()
        if not body.get("url"):
            return _err("missing 'url'")
        return _json(classify_url(body["url"]))

    # ---- integrity / nightly -----------------------------------------------------

    async def integrity(request):
        from mobius_rag_tpu_torch.integrity import integrity_report

        return _json(integrity_report(ctx))

    async def integrity_fix(request):
        from mobius_rag_tpu_torch.integrity import integrity_remediate

        return _json(integrity_remediate(ctx))

    async def nightly_run(request):
        try:
            run_id = ctx.nightly.start()
        except RuntimeError as e:
            return _err(str(e), 409)
        return _json({"run_id": run_id})

    async def nightly_status(request):
        return _json(ctx.nightly.status())

    async def retag(request):
        """In-process retag sweep: re-run Path-B/featurization over every
        live chunk with the CURRENT lexicon (main.py:3419 parity)."""
        from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk

        lex = ctx.engine.lexicon
        by_doc: dict[str, list] = {}
        for rec in ctx.store.records:
            if rec is not None:
                by_doc.setdefault(rec.doc_id, []).append(rec)
        n = 0
        for doc_id, recs in by_doc.items():
            for rec in recs:
                featurize_chunk(rec, lex)
                n += 1
            ctx.store.publish_document(doc_id, recs)
        return _json({"retagged_chunks": n, "documents": len(by_doc)})

    async def profile(request):
        """Capture a torch.profiler trace while exercising the search
        pipeline (SURVEY §5.1: per-kernel timing in the same search_id-
        keyed structure the reference logs). Returns the trace file's
        directory (a Chrome trace, for Perfetto)."""
        import torch

        from mobius_rag_tpu_torch.profiling import locked_profiler

        body = await request.json()
        try:
            trace_dir = _data_subpath(
                body.get("dir"),
                os.path.join("profiles", str(int(time.time()))))
        except ValueError as e:
            return _err(str(e), 403)
        os.makedirs(trace_dir, exist_ok=True)
        queries = body.get("queries") or ["profile warm query"]
        reps = int(body.get("repetitions", 3))
        activities = [torch.profiler.ProfilerActivity.CPU]
        if ctx.store.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with locked_profiler(activities) as prof:
            for _ in range(reps):
                ctx.engine.search([QueryRequest(query=q) for q in queries],
                                  k=int(body.get("k", 10)))
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
        return _json({"trace_dir": trace_dir, "repetitions": reps,
                      "queries": len(queries)})

    async def snapshot(request):
        body = await request.json()
        try:
            path = _data_subpath(body.get("path"), "snapshot")
        except ValueError as e:
            return _err(str(e), 403)
        ctx.store.snapshot(path)
        out = {"path": path, "chunks": ctx.store.size}
        # ANN tables persist WITH the snapshot (reference HNSW-in-Postgres
        # durability): a restore reloads them instead of re-running
        # k-means (+minutes at the 10M config)
        if ctx.engine.vector_backend != "exact" and body.get("include_ann", True):
            out["ann"] = ctx.engine.save_ann(os.path.join(path, "ann.npz"))
        return _json(out)

    async def restore(request):
        """Swap in a store restored from a snapshot (the durable-resume
        counterpart of /admin/snapshot). Every component holding the old
        store is rebound; an attached sharded engine is rebuilt over it."""
        body = await request.json()
        try:
            path = _data_subpath(body.get("path"), "snapshot")
        except ValueError as e:
            return _err(str(e), 403)
        if not os.path.exists(os.path.join(path, "store.json")):
            return _err(f"no snapshot at {path}", 404)
        try:
            new_store = ChunkStore.restore(path, device=ctx.store.device)
        except ValueError as e:
            return _err(f"restore failed: {e}", 409)
        ctx.store = new_store
        ctx.engine.store = new_store
        ctx.pipeline.store = new_store
        ctx.pipeline.embedding_worker.store = new_store
        if ctx.engine.sharded is not None:
            ctx.engine.sharded = ctx.engine.sharded.rebuilt(new_store)
        out = {"path": path, "chunks": new_store.size}
        ann_path = os.path.join(path, "ann.npz")
        if ctx.engine.vector_backend != "exact" and os.path.exists(ann_path):
            try:
                out["ann"] = ctx.engine.load_ann(ann_path)
            except ValueError as e:
                # stale/mismatched ann file: serve via a fresh build
                # rather than failing the restore
                out["ann_skipped"] = str(e)
        return _json(out)

    async def cleanup_stale(request):
        return _json({"cleaned": ctx.pipeline.queue.cleanup_stale()})

    # ---- internal index RPC (durable index serving — no snapshot hop) -----

    async def internal_publish(request):
        """Remote publish from a worker process straight into the LIVE
        device index (index/service.py wire format). An attached sharded
        engine refreshes through the store's mutation listeners."""
        from mobius_rag_tpu_torch.index.service import record_from_wire

        body = await request.json()
        doc_id = body.get("doc_id")
        if not doc_id or not isinstance(body.get("records"), list):
            return _err("need doc_id and records")
        try:
            recs = [record_from_wire(d) for d in body["records"]]
            rows = ctx.store.publish_document(doc_id, recs)
        except (KeyError, ValueError, RuntimeError) as e:
            return _err(f"publish failed: {e}", 409)
        return _json({"rows": rows})

    async def internal_add_chunks(request):
        from mobius_rag_tpu_torch.index.service import record_from_wire

        body = await request.json()
        if not isinstance(body.get("records"), list):
            return _err("need records")
        try:
            recs = [record_from_wire(d) for d in body["records"]]
            rows = ctx.store.add_chunks(recs)
        except (KeyError, ValueError) as e:
            return _err(f"add failed: {e}", 409)
        return _json({"rows": rows})

    async def internal_delete(request):
        body = await request.json()
        if not body.get("doc_id"):
            return _err("need doc_id")
        return _json({"deleted_chunks":
                      ctx.store.delete_by_document(body["doc_id"])})

    async def internal_source_ids(request):
        doc_id = request.match_info["doc_id"]
        return _json({"source_ids":
                      sorted(ctx.store.embedded_source_ids(doc_id))})

    async def vector_backend(request):
        """Select the vector-arm scan backend (exact | ivf | packed |
        pq | proj) —
        the production-scan switch (reference vector_store.py:306 factory
        role). ANN tables build lazily on the next search."""
        body = await request.json()
        try:
            ctx.engine.set_vector_backend(body.get("backend", ""))
        except ValueError as e:
            return _err(str(e))
        return _json({"backend": ctx.engine.vector_backend})

    # ---- routes -----------------------------------------------------------------

    r.add_get("/", console)
    r.add_static("/static/",
                 os.path.join(os.path.dirname(__file__), "static"))
    r.add_get("/health", health)
    r.add_get("/pipeline_health", pipeline_health)
    r.add_post("/upload", upload)
    r.add_get("/documents", documents)
    r.add_get("/documents/{doc_id}", document_detail)
    r.add_delete("/documents/{doc_id}", document_delete)
    r.add_post("/api/query", query)
    r.add_post("/api/skills/v1/corpus_search", skill_corpus_search)
    r.add_post("/api/skills/v1/corpus_search_agent", skill_agent)
    r.add_get("/api/search_events", search_events)
    r.add_get("/api/decisions", decisions)
    r.add_get("/api/decisions/{agent_id}/trace", decision_trace)
    r.add_get("/api/errors", errors)
    r.add_get("/api/progress/{cid}", progress)
    r.add_get("/api/progress/{cid}/stream", progress_stream)
    r.add_post("/api/eval/run", eval_run)
    r.add_post("/api/eval/calibrate", eval_calibrate)
    r.add_get("/api/eval/runs", eval_runs)
    r.add_get("/api/eval/runs/{run_id}", eval_run_detail)
    r.add_get("/api/lexicon", lexicon_list)
    r.add_post("/api/lexicon/entries", lexicon_add)
    r.add_get("/api/lexicon/candidates", lexicon_candidates)
    r.add_post("/api/lexicon/candidates/review", lexicon_candidate_review)
    r.add_get("/api/eval/timeline", eval_timeline)
    r.add_get("/api/eval/compare", eval_compare)
    r.add_get("/api/eval/runs/{run_id}/pr_curve", eval_pr_curve)
    r.add_get("/api/eval/runs/{run_id}/grade_rollup", eval_grade_rollup)
    r.add_patch("/api/eval/results/{run_id}/{query_id}/verdict", eval_verdict_patch)
    r.add_get("/api/observe/prod_rollup", prod_rollup)
    r.add_get("/api/eval/bank", eval_bank_get)
    r.add_put("/api/eval/bank", eval_bank_put)
    r.add_get("/documents/{doc_id}/file", document_file)
    r.add_get("/documents/{doc_id}/pdf", document_pdf)
    r.add_post("/admin/drive/import", drive_import)
    r.add_post("/admin/sql", sql_console)
    r.add_get("/config/llm", llm_configs_list)
    r.add_post("/config/llm", llm_configs_put)
    r.add_get("/config/prompts", prompts_list)
    r.add_post("/config/prompts", prompts_put)
    r.add_post("/api/query_batch", query_batch)
    r.add_get("/admin/org-docs", ns_list)
    r.add_post("/admin/org-docs", ns_create)
    r.add_delete("/admin/org-docs/{name}", ns_delete)
    r.add_post("/admin/org-docs/{name}/chunks", ns_add_chunks)
    r.add_post("/admin/org-docs/{name}/query", ns_query)
    r.add_get("/api/curator/sources", curator_sources)
    r.add_post("/api/curator/sources", curator_upsert)
    r.add_post("/api/curator/curate", curator_curate)
    r.add_get("/api/curator/stats", curator_stats)
    r.add_post("/api/curator/probe", curator_probe)
    r.add_post("/api/curator/mark-ingested", curator_mark_ingested)
    r.add_post("/api/curator/classify", curator_classify)
    r.add_get("/admin/microbatch", microbatch_stats)
    r.add_get("/admin/integrity", integrity)
    r.add_post("/admin/integrity/remediate", integrity_fix)
    r.add_post("/admin/nightly/run", nightly_run)
    r.add_get("/admin/nightly/status", nightly_status)
    r.add_post("/admin/profile", profile)
    r.add_post("/admin/retag", retag)
    r.add_post("/admin/snapshot", snapshot)
    r.add_post("/admin/restore", restore)
    r.add_post("/admin/cleanup-stale-jobs", cleanup_stale)
    r.add_post("/admin/vector_backend", vector_backend)
    r.add_post("/internal/index/publish", internal_publish)
    r.add_post("/internal/index/add_chunks", internal_add_chunks)
    r.add_post("/internal/index/delete", internal_delete)
    r.add_get("/internal/index/source_ids/{doc_id}", internal_source_ids)
    return app


def main() -> None:
    import argparse
    import gc

    from aiohttp import web

    ap = argparse.ArgumentParser()
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--provider", default=None, help="embedding provider name")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the index, the engine and the encoder")
    args = ap.parse_args()

    from mobius_rag_tpu_torch.observability import setup_logging
    from mobius_rag_tpu_torch.providers import get_embedding_provider

    log = setup_logging("mrag-api")
    embed = get_embedding_provider(args.provider, device=args.device)
    from mobius_rag_tpu_torch.clients import get_llm_client

    # generation client: MRAG_LLM_URL → HTTP proxy adapter, else the
    # offline extractive stub (llm_manager_client.py:211 role)
    ctx = AppContext.build(embed_fn=embed.embed, llm=get_llm_client(),
                           device=args.device)
    # Warm the search path (the encoder included) so the first request
    # does not pay the kernels' lazy module loads.
    try:
        ctx.engine.search(QueryRequest(query="warmup"),
                          k=get_config().default_k)
        log.info("search pipeline warmed")
    except Exception as e:  # warmup is best-effort
        log.warning("warmup skipped: %s", e)
    # Keep what is loaded out of the garbage collector: a full collection
    # walks every chunk record (1.6-1.8 s at 1M rows) and stalls every
    # request in flight. Records loaded later are still collected.
    gc.collect()
    gc.freeze()
    web.run_app(build_app(ctx), host=args.host, port=args.port)


if __name__ == "__main__":
    main()
