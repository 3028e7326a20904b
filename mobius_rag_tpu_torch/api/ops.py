"""Operator API breadth — the reference endpoint groups that round-2
review flagged as the residual surface gap (reference app/main.py +
app/routers/*; ~174 routes vs our ~109). Every handler delegates to an
existing framework capability; none of these touch device arrays except
through ChunkStore's publish contract.

Groups:
  /routing/*, /observe/decisions/{id}/grade — router observability +
      the human decision-grading loop (routers/routing.py)
  /api/eval/{active,drift,…}                — eval depth (routers/eval.py)
  /documents/{id}/{detail,publish-status,chunking/*,embedding/start,
      extract/restart,publish,retag}, /documents/retag[/status],
      PATCH /documents/{id}                 — per-document job control
  /admin/{repository_audit,list_blocked_docs,block_*_pending,
      dedupe_policy_paragraphs,normalize-payer,reset_bloated_docs,
      backfill_chunk_tags,vector_search,retag-in-place*,nightly/runs*}
  /drive/*                                  — Drive sync router over
      drive.HTTPDrive (OAuth url/callback, scan, import)
  /documents/import-from-html, import-scraped-pages
  /config/llm/{name}[,/test], /config/llm/providers,
      /config/prompts/{stage}/{version}, /config/prompts/names
  /api/uploads/{doc_id}/progress
  /policy/lines, /documents/{id}/policy/{lines,candidates},
      /documents/{id}/policy-line-tags, /policy/candidates/aggregate*,
      /policy/candidates/{id}/review, PATCH /policy/lexicon/tags/…,
      /policy/lexicon/tag-details

Ported from ``mobius_rag_tpu.api.ops`` with the port's imports.
"""
from __future__ import annotations

import os
import threading
import time
from typing import Any

from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk
from mobius_rag_tpu_torch.ingest.worker import CHUNKING_KIND


def _json(data: Any, status: int = 200):
    import json as _j

    from aiohttp import web

    return web.json_response(data, status=status,
                             dumps=lambda d: _j.dumps(d, default=str))


def _err(msg: str, status: int = 400):
    return _json({"error": msg}, status)


def _live_docs(ctx) -> dict[str, list]:
    by_doc: dict[str, list] = {}
    for rec in ctx.store.records:
        if rec is not None:
            by_doc.setdefault(rec.doc_id, []).append(rec)
    return by_doc


def _republish(ctx, doc_id: str, recs) -> int:
    ctx.store.publish_document(doc_id, recs)
    return len(recs)


def register_ops_routes(r, ctx) -> None:  # noqa: C901 — route table
    # -- routing observability ------------------------------------------------

    async def routing_decisions(request):
        limit = int(request.query.get("limit", 50))
        return _json({"decisions": ctx.telemetry.recent_decisions(limit)})

    async def routing_decision(request):
        agent_id = request.match_info["agent_id"]
        for d in ctx.telemetry.recent_decisions(1000):
            if d["agent_id"] == agent_id:
                d["trace"] = ctx.telemetry.trace(agent_id)
                return _json(d)
        return _err("decision not found", 404)

    async def routing_stats(request):
        hours = float(request.query.get("window_hours", 24.0))
        return _json(ctx.telemetry.decisions_rollup(hours))

    async def decision_grade(request):
        body = await request.json()
        grade = body.get("grade", "")
        if grade not in ("good", "bad", "mixed", ""):
            return _err("grade must be good|bad|mixed (or '' to clear)")
        ok = ctx.telemetry.grade_decision(
            request.match_info["agent_id"], grade, body.get("notes", ""))
        return _json({"ok": ok}, 200 if ok else 404)

    # -- eval depth -------------------------------------------------------------

    async def eval_active(request):
        return _json({"active": ctx.extra_state.get("eval_active")})

    async def eval_run_progress(request):
        run_id = request.match_info["run_id"]
        run = ctx.eval_db.run(run_id)
        if run is None:
            return _err("run not found", 404)
        results = ctx.eval_db.results(run_id)
        return _json({
            "run_id": run_id,
            "results": len(results),
            "finalized": bool(run.get("aggregates")),
            "bank": run.get("bank_name"),
        })

    async def eval_result_detail(request):
        run_id = request.match_info["run_id"]
        qid = request.match_info["query_id"]
        for res in ctx.eval_db.results(run_id):
            if res.get("query_id") == qid:
                return _json(res)
        return _err("result not found", 404)

    async def eval_drift(request):
        """Aggregate drift across the most recent runs of one bank
        (reference GET /eval/drift): key metrics side by side plus the
        delta of the newest run vs the oldest in the window."""
        bank = request.query.get("bank", "")
        n = int(request.query.get("n", 10))

        def _short(name: str) -> str:
            # stored bank_name is the YAML basename ("bank_toy.yaml",
            # "queries_cmhc.yaml"); callers pass the short name ("toy")
            name = name.rsplit("/", 1)[-1]
            name = name.removesuffix(".yaml")
            return name.removeprefix("bank_").removeprefix("queries_")

        runs = [run for run in ctx.eval_db.list_runs(200)
                if not bank or run.get("bank_name") == bank
                or _short(run.get("bank_name") or "") == _short(bank)][:n]
        keys = ("accuracy", "mean_chunk_recall", "answer_rate",
                "citation_rate", "latency_ms_median")
        series = []
        for run in runs:
            agg = run.get("aggregates") or {}
            series.append({"run_id": run["run_id"],
                           "ts": run.get("started_at"),
                           "bank": run.get("bank_name"),
                           **{k: agg.get(k) for k in keys}})
        drift = {}
        finalized = [s for s in series if s.get("accuracy") is not None]
        if len(finalized) >= 2:
            new, old = finalized[0], finalized[-1]
            drift = {k: round((new[k] or 0) - (old[k] or 0), 4)
                     for k in keys if isinstance(new.get(k), (int, float))
                     and isinstance(old.get(k), (int, float))}
        return _json({"runs": series, "drift_newest_vs_oldest": drift})

    async def eval_fact_compare(request):
        """Judge two answers against the same rubric (reference
        POST /eval/fact_compare — the A/B answer comparison tool)."""
        from mobius_rag_tpu_torch.eval_harness.judge import judge_answer

        body = await request.json()
        must = body.get("must_facts") or []
        bonus = body.get("bonus_facts") or []
        forbidden = body.get("forbidden_facts") or []
        out = {}
        for side in ("a", "b"):
            ans = body.get(f"answer_{side}", "")
            jr = judge_answer(ans, must, bonus, forbidden)
            out[side] = {"score": jr.score, "verdict": jr.verdict,
                         "must": jr.verdicts.must, "bonus": jr.verdicts.bonus,
                         "forbidden": jr.verdicts.forbidden}
        out["winner"] = ("a" if out["a"]["score"] > out["b"]["score"]
                         else "b" if out["b"]["score"] > out["a"]["score"]
                         else "tie")
        return _json(out)

    async def eval_calibration_status(request):
        return _json({"active": ctx.extra_state.get("calibration_active"),
                      "last": ctx.extra_state.get("calibration_last")})

    # -- document lifecycle -----------------------------------------------------

    def _doc_blob(doc_id: str):
        return ctx.pipeline.docs.get(doc_id)

    async def doc_detail(request):
        """Everything the repository drill-down needs in one call
        (reference GET /documents/{id}/detail)."""
        doc_id = request.match_info["doc_id"]
        rows = ctx.store.rows_for_document(doc_id)
        blob = _doc_blob(doc_id)
        if not rows and blob is None:
            return _err("document not found", 404)
        recs = [ctx.store.records[i] for i in rows]
        facts = sum(1 for rec in recs if (rec.extra or {}).get("kind") == "fact")
        meta = recs[0] if recs else blob
        return _json({
            "doc_id": doc_id,
            "filename": getattr(meta, "filename", ""),
            "payer": getattr(meta, "payer", ""),
            "state": getattr(meta, "state", ""),
            "program": getattr(meta, "program", ""),
            "authority_level": getattr(meta, "authority_level", 0),
            "summary": getattr(meta, "summary", ""),
            "chunks": len(rows),
            "pages": len({rec.page for rec in recs}),
            "facts": facts,
            "has_blob": blob is not None,
            "blob_bytes": len(blob.data) if blob is not None else 0,
            "jobs": ctx.pipeline.queue.jobs_for_doc(doc_id)[:10],
        })

    async def doc_publish_status(request):
        """Published-vs-queue reconciliation (reference
        GET /documents/{id}/publish-status)."""
        doc_id = request.match_info["doc_id"]
        rows = ctx.store.rows_for_document(doc_id)
        jobs = ctx.pipeline.queue.jobs_for_doc(doc_id)
        pending = [j for j in jobs if j["status"] in ("queued", "running")]
        failed = [j for j in jobs if j["status"] == "failed"]
        return _json({
            "doc_id": doc_id,
            "published_chunks": len(rows),
            "published": bool(rows),
            "pending_jobs": pending,
            "failed_jobs": failed,
            "source_ids": len(ctx.store._source_ids.get(doc_id, ())),
        })

    def _fail_doc_jobs(doc_id: str, kind: str) -> int:
        n = 0
        for j in ctx.pipeline.queue.jobs_for_doc(doc_id):
            if j["kind"] == kind and j["status"] in ("queued", "running"):
                ctx.pipeline.queue.fail(j["job_id"], "stopped by operator",
                                        retry=False)
                n += 1
        return n

    async def doc_chunking_start(request):
        doc_id = request.match_info["doc_id"]
        if _doc_blob(doc_id) is None:
            return _err("no stored blob for document", 404)
        job_id = ctx.pipeline.queue.enqueue(
            CHUNKING_KIND, {"doc_id": doc_id},
            dedupe_key=f"chunk-{doc_id}-manual-{int(time.time())}")
        return _json({"job_id": job_id})

    async def doc_chunking_stop(request):
        doc_id = request.match_info["doc_id"]
        return _json({"stopped": _fail_doc_jobs(doc_id, CHUNKING_KIND)})

    async def doc_chunking_kill_reset(request):
        """Stop in-flight chunking, clear resume partials, re-enqueue
        from scratch (reference POST /documents/{id}/chunking/
        kill-and-reset)."""
        doc_id = request.match_info["doc_id"]
        if _doc_blob(doc_id) is None:
            return _err("no stored blob for document", 404)
        stopped = 0
        for j in ctx.pipeline.queue.jobs_for_doc(doc_id):
            if j["kind"] == CHUNKING_KIND:
                if j["status"] in ("queued", "running"):
                    ctx.pipeline.queue.fail(j["job_id"], "kill-and-reset",
                                            retry=False)
                    stopped += 1
                ctx.pipeline.queue.clear_partials(j["job_id"])
        job_id = ctx.pipeline.queue.enqueue(
            CHUNKING_KIND, {"doc_id": doc_id},
            dedupe_key=f"chunk-{doc_id}-reset-{int(time.time())}")
        return _json({"stopped": stopped, "job_id": job_id})

    async def doc_embedding_start(request):
        """Re-embed the document's LIVE chunks with the current encoder
        and republish (reference POST /documents/{id}/embedding/start —
        there it re-runs the embed worker; our chunks carry their text,
        so re-embedding needs no chunking pass)."""
        doc_id = request.match_info["doc_id"]
        rows = ctx.store.rows_for_document(doc_id)
        if not rows:
            return _err("document has no published chunks", 404)
        recs = [ctx.store.records[i] for i in rows]
        embs = ctx.pipeline.embed_fn([rec.text for rec in recs])
        for rec, emb in zip(recs, embs):
            rec.embedding = emb
        return _json({"re_embedded": _republish(ctx, doc_id, recs)})

    async def doc_extract_restart(request):
        """Fresh extract→chunk→embed from the stored blob (reference
        POST /documents/{id}/extract/restart)."""
        doc_id = request.match_info["doc_id"]
        if _doc_blob(doc_id) is None:
            return _err("no stored blob for document", 404)
        job_id = ctx.pipeline.queue.enqueue(
            CHUNKING_KIND, {"doc_id": doc_id},
            dedupe_key=f"chunk-{doc_id}-extract-{int(time.time())}")
        drained = ctx.pipeline.drain(max_jobs_per_kind=4)
        return _json({"job_id": job_id, **drained})

    async def doc_publish(request):
        """Force republish of the document's live records (reference
        POST /documents/{id}/publish → publish_sync)."""
        doc_id = request.match_info["doc_id"]
        rows = ctx.store.rows_for_document(doc_id)
        if not rows:
            return _err("document has no chunks to publish", 404)
        recs = [ctx.store.records[i] for i in rows]
        return _json({"published": _republish(ctx, doc_id, recs)})

    async def doc_retag(request):
        """Refeaturize ONE document against the current lexicon and
        republish (reference POST /documents/{id}/retag)."""
        doc_id = request.match_info["doc_id"]
        rows = ctx.store.rows_for_document(doc_id)
        if not rows:
            return _err("document not found", 404)
        recs = [ctx.store.records[i] for i in rows]
        for rec in recs:
            featurize_chunk(rec, ctx.engine.lexicon)
        return _json({"retagged": _republish(ctx, doc_id, recs)})

    async def doc_patch(request):
        """Edit document metadata across all its chunks + blob, then
        republish (reference PATCH /documents/{id})."""
        from mobius_rag_tpu_torch.ingest.metadata import canonicalize_metadata

        doc_id = request.match_info["doc_id"]
        rows = ctx.store.rows_for_document(doc_id)
        if not rows:
            return _err("document not found", 404)
        body = await request.json()
        allowed = {"filename", "payer", "state", "program",
                   "authority_level", "summary"}
        updates = {k: v for k, v in body.items() if k in allowed}
        if not updates:
            return _err(f"no editable fields in body (allowed: {sorted(allowed)})")
        if {"payer", "state", "program"} & updates.keys():
            canon = canonicalize_metadata(
                payer=str(updates.get("payer", "")),
                state=str(updates.get("state", "")),
                program=str(updates.get("program", "")))
            for k in ("payer", "state", "program"):
                if k in updates:
                    updates[k] = canon[k]
        recs = [ctx.store.records[i] for i in rows]
        for rec in recs:
            for k, v in updates.items():
                setattr(rec, k, v)
            # metadata feeds tag featurization (payer/state tags)
            featurize_chunk(rec, ctx.engine.lexicon)
        blob = _doc_blob(doc_id)
        if blob is not None:
            for k, v in updates.items():
                if hasattr(blob, k):
                    setattr(blob, k, v)
            ctx.pipeline.docs.put(blob)
        return _json({"updated": updates,
                      "republished": _republish(ctx, doc_id, recs)})

    # -- bulk retag (background, stoppable) --------------------------------------

    def _retag_state() -> dict:
        return ctx.extra_state.setdefault(
            "retag_job", {"status": "idle", "done": 0, "total": 0,
                          "stop": False, "started_at": None})

    def _retag_worker():
        st = _retag_state()
        by_doc = _live_docs(ctx)
        st.update(status="running", done=0, total=len(by_doc),
                  stop=False, started_at=time.time())
        for doc_id, recs in by_doc.items():
            if st["stop"]:
                st["status"] = "stopped"
                return
            for rec in recs:
                featurize_chunk(rec, ctx.engine.lexicon)
            _republish(ctx, doc_id, recs)
            st["done"] += 1
        st["status"] = "done"

    async def docs_retag_bulk(request):
        """Corpus-wide background retag (reference POST /documents/retag
        + /admin/retag-in-place): refeaturize every live chunk with the
        CURRENT lexicon, republishing per document so search stays
        consistent mid-sweep."""
        st = _retag_state()
        if st["status"] == "running":
            return _err("retag already running", 409)
        threading.Thread(target=_retag_worker, daemon=True).start()
        return _json({"started": True})

    async def docs_retag_status(request):
        st = dict(_retag_state())
        st.pop("stop", None)
        return _json(st)

    async def docs_retag_stop(request):
        st = _retag_state()
        st["stop"] = True
        return _json({"stopping": st["status"] == "running"})

    async def uploads_progress(request):
        """Per-upload progress roll-up (reference
        GET /api/uploads/{id}/progress): queue jobs + published rows."""
        doc_id = request.match_info["doc_id"]
        jobs = ctx.pipeline.queue.jobs_for_doc(doc_id)
        return _json({
            "doc_id": doc_id,
            "jobs": jobs,
            "published_chunks": len(ctx.store.rows_for_document(doc_id)),
            "done": bool(jobs) and all(j["status"] == "done" for j in jobs),
        })

    # ---- route table part 1 (the rest is registered below) ----
    r.add_get("/routing/decisions", routing_decisions)
    r.add_get("/routing/decisions/{agent_id}", routing_decision)
    r.add_get("/routing/stats", routing_stats)
    r.add_patch("/observe/decisions/{agent_id}/grade", decision_grade)
    r.add_get("/api/eval/active", eval_active)
    r.add_get("/api/eval/runs/{run_id}/progress", eval_run_progress)
    r.add_get("/api/eval/results/{run_id}/{query_id}", eval_result_detail)
    r.add_get("/api/eval/drift", eval_drift)
    r.add_post("/api/eval/fact_compare", eval_fact_compare)
    r.add_get("/api/eval/calibration/status", eval_calibration_status)
    r.add_get("/documents/{doc_id}/detail", doc_detail)
    r.add_get("/documents/{doc_id}/publish-status", doc_publish_status)
    r.add_post("/documents/{doc_id}/chunking/start", doc_chunking_start)
    r.add_post("/documents/{doc_id}/chunking/stop", doc_chunking_stop)
    r.add_post("/documents/{doc_id}/chunking/kill-and-reset",
               doc_chunking_kill_reset)
    r.add_post("/documents/{doc_id}/embedding/start", doc_embedding_start)
    r.add_post("/documents/{doc_id}/extract/restart", doc_extract_restart)
    r.add_post("/documents/{doc_id}/publish", doc_publish)
    r.add_post("/documents/{doc_id}/retag", doc_retag)
    r.add_patch("/documents/{doc_id}", doc_patch)
    r.add_post("/documents/retag", docs_retag_bulk)
    r.add_get("/documents/retag/status", docs_retag_status)
    r.add_post("/admin/retag-in-place", docs_retag_bulk)
    r.add_get("/admin/retag-in-place/status", docs_retag_status)
    r.add_post("/admin/retag-in-place/stop", docs_retag_stop)
    r.add_get("/api/uploads/{doc_id}/progress", uploads_progress)

    _register_admin_ops(r, ctx)
    _register_drive_and_imports(r, ctx)
    _register_config_depth(r, ctx)
    _register_policy_depth(r, ctx)


def _register_admin_ops(r, ctx) -> None:  # noqa: C901 — route table
    from mobius_rag_tpu_torch.query.engine import QueryRequest

    async def repository_audit(request):
        """Corpus-wide per-document health table (reference
        GET /admin/repository_audit): chunk counts, tag coverage,
        blob presence, authority distribution."""
        docs = []
        for doc_id, recs in sorted(_live_docs(ctx).items()):
            tagged = sum(1 for rec in recs
                         if rec.j_tags or rec.d_tags or rec.p_tags)
            docs.append({
                "doc_id": doc_id,
                "chunks": len(recs),
                "tagged_fraction": round(tagged / len(recs), 3),
                "payer": recs[0].payer,
                "state": recs[0].state,
                "authority_level": max(rec.authority_level for rec in recs),
                "has_blob": ctx.pipeline.docs.get(doc_id) is not None,
                "facts": sum(1 for rec in recs
                             if (rec.extra or {}).get("kind") == "fact"),
            })
        return _json({"documents": docs, "n": len(docs),
                      "total_chunks": sum(d["chunks"] for d in docs)})

    def _blocked() -> list[dict]:
        return ctx.extra_state.setdefault("blocked_docs", [])

    async def list_blocked_docs(request):
        return _json({"blocked": _blocked()})

    def _block_pending(pred, reason: str) -> list[dict]:
        out = []
        for j in ctx.pipeline.queue.jobs_by_status("queued",
                                                   kind=CHUNKING_KIND):
            doc_id = j["payload"].get("doc_id", "")
            if not pred(j, doc_id):
                continue
            ctx.pipeline.queue.fail(j["job_id"], f"blocked: {reason}",
                                    retry=False)
            entry = {"doc_id": doc_id, "job_id": j["job_id"],
                     "reason": reason, "ts": time.time()}
            _blocked().append(entry)
            out.append(entry)
        return out

    async def block_junk_pending(request):
        """Block queued chunking jobs whose blob is missing or too small
        to be a real document (reference POST /admin/block_junk_pending)."""
        body = await request.json() if request.can_read_body else {}
        min_bytes = int(body.get("min_bytes", 256))

        def junk(j, doc_id):
            blob = ctx.pipeline.docs.get(doc_id)
            return blob is None or len(blob.data) < min_bytes

        blocked = _block_pending(junk, f"junk (<{min_bytes} bytes or no blob)")
        return _json({"blocked": blocked, "n": len(blocked)})

    async def block_old_pending(request):
        """Block queued chunking jobs older than N days (reference
        POST /admin/block_old_pending — stale backlog triage)."""
        body = await request.json() if request.can_read_body else {}
        days = float(body.get("days", 7.0))
        cutoff = time.time() - days * 86400.0
        blocked = _block_pending(
            lambda j, d: (j.get("created_at") or 0) < cutoff,
            f"older than {days:g} days")
        return _json({"blocked": blocked, "n": len(blocked)})

    async def dedupe_policy_paragraphs(request):
        """Drop duplicate chunk texts within each document and republish
        (reference POST /admin/dedupe_policy_paragraphs)."""
        removed: dict[str, int] = {}
        for doc_id, recs in _live_docs(ctx).items():
            seen: set[str] = set()
            keep = []
            for rec in recs:
                key = " ".join(rec.text.split()).lower()
                if key in seen:
                    continue
                seen.add(key)
                keep.append(rec)
            if len(keep) < len(recs):
                removed[doc_id] = len(recs) - len(keep)
                _republish(ctx, doc_id, keep)
        return _json({"documents_deduped": len(removed),
                      "chunks_removed": sum(removed.values()),
                      "by_doc": removed})

    async def normalize_payer(request):
        """Re-canonicalize payer/state across all records; republish the
        documents that changed (reference POST /admin/normalize-payer +
        /admin/fix_payer_canonical)."""
        from mobius_rag_tpu_torch.ingest.metadata import (canonical_payer,
                                                          canonical_state)

        changed: dict[str, int] = {}
        for doc_id, recs in _live_docs(ctx).items():
            dirty = 0
            for rec in recs:
                payer = canonical_payer(rec.payer)
                state = canonical_state(rec.state)
                if payer != rec.payer or state != rec.state:
                    rec.payer, rec.state = payer, state
                    featurize_chunk(rec, ctx.engine.lexicon)
                    dirty += 1
            if dirty:
                changed[doc_id] = dirty
                _republish(ctx, doc_id, recs)
        return _json({"documents_changed": len(changed),
                      "chunks_changed": sum(changed.values())})

    async def reset_bloated_docs(request):
        """Re-chunk documents whose chunk count exploded (reference
        POST /admin/reset_bloated_docs): delete + re-enqueue from blob;
        documents with no stored blob are reported, never deleted."""
        body = await request.json() if request.can_read_body else {}
        max_chunks = int(body.get("max_chunks", 1000))
        reset, skipped = [], []
        for doc_id, recs in _live_docs(ctx).items():
            if len(recs) <= max_chunks:
                continue
            if ctx.pipeline.docs.get(doc_id) is None:
                skipped.append({"doc_id": doc_id, "chunks": len(recs),
                                "reason": "no blob to re-chunk from"})
                continue
            ctx.store.delete_by_document(doc_id)
            job_id = ctx.pipeline.queue.enqueue(
                CHUNKING_KIND, {"doc_id": doc_id},
                dedupe_key=f"chunk-{doc_id}-bloat-{int(time.time())}")
            reset.append({"doc_id": doc_id, "chunks": len(recs),
                          "job_id": job_id})
        return _json({"reset": reset, "skipped": skipped,
                      "max_chunks": max_chunks})

    async def backfill_chunk_tags(request):
        """Featurize chunks that carry no tags at all (reference
        POST /admin/backfill_chunk_tags)."""
        touched: dict[str, int] = {}
        for doc_id, recs in _live_docs(ctx).items():
            bare = [rec for rec in recs
                    if not (rec.j_tags or rec.d_tags or rec.p_tags
                            or rec.lexical_weights)]
            if not bare:
                continue
            for rec in bare:
                featurize_chunk(rec, ctx.engine.lexicon)
            touched[doc_id] = len(bare)
            _republish(ctx, doc_id, recs)
        return _json({"documents": len(touched),
                      "chunks_backfilled": sum(touched.values())})

    async def vector_search_debug(request):
        """Raw vector-arm probe, tag gating off (reference
        GET /admin/vector_search — the index debug surface)."""
        q = request.query.get("q", "")
        if not q:
            return _err("q parameter required")
        k = min(int(request.query.get("k", 10)), 50)
        result = ctx.engine.search(
            QueryRequest(query=q, tag_mode="none"), k=k)[0]
        return _json({"query": q, "hits": [
            {"row": h.row, "chunk_id": h.chunk_id, "doc_id": h.doc_id,
             "similarity": round(h.similarity, 4),
             "score": round(h.score, 4), "text": h.text[:200]}
            for h in result.hits]})

    async def nightly_runs(request):
        return _json({"runs": [
            {"run_id": s.get("run_id"), "stopped": s.get("stopped"),
             "steps": {name: st["status"]
                       for name, st in (s.get("steps") or {}).items()}}
            for s in reversed(ctx.nightly.history)]})

    async def nightly_run_detail(request):
        run_id = request.match_info["run_id"]
        for s in ctx.nightly.history:
            if s.get("run_id") == run_id:
                return _json(s)
        if ctx.nightly.run_id == run_id:
            return _json(ctx.nightly.status())
        return _err("nightly run not found", 404)

    async def nightly_stop(request):
        return _json({"stopping": ctx.nightly.stop()})

    r.add_get("/admin/repository_audit", repository_audit)
    r.add_get("/admin/list_blocked_docs", list_blocked_docs)
    r.add_post("/admin/block_junk_pending", block_junk_pending)
    r.add_post("/admin/block_old_pending", block_old_pending)
    r.add_post("/admin/dedupe_policy_paragraphs", dedupe_policy_paragraphs)
    r.add_post("/admin/normalize-payer", normalize_payer)
    r.add_post("/admin/fix_payer_canonical", normalize_payer)
    r.add_post("/admin/reset_bloated_docs", reset_bloated_docs)
    r.add_post("/admin/backfill_chunk_tags", backfill_chunk_tags)
    r.add_get("/admin/vector_search", vector_search_debug)
    r.add_get("/admin/nightly/runs", nightly_runs)
    r.add_get("/admin/nightly/runs/{run_id}", nightly_run_detail)
    r.add_post("/admin/nightly/stop", nightly_stop)


def _register_drive_and_imports(r, ctx) -> None:  # noqa: C901 — route table
    from mobius_rag_tpu_torch.drive import HTTPDrive, classify_file, import_folder

    def _drive_client():
        """Injected client first (tests / alternate backends), then an
        env-configured HTTPDrive, else None (503 on use)."""
        injected = ctx.extra_state.get("drive_client")
        if injected is not None:
            return injected
        env = os.environ.get
        if env("MRAG_DRIVE_ACCESS_TOKEN") or env("MRAG_DRIVE_REFRESH_TOKEN"):
            return HTTPDrive()
        return None

    async def drive_status(request):
        client = _drive_client()
        env = os.environ.get
        return _json({
            "connected": client is not None,
            "client": type(client).__name__ if client else None,
            "auth_mode": ("static_token" if env("MRAG_DRIVE_ACCESS_TOKEN")
                          else "refresh_token" if env("MRAG_DRIVE_REFRESH_TOKEN")
                          else "injected" if client is not None else None),
            "last_import": ctx.extra_state.get("drive_last_import"),
        })

    async def drive_auth_url(request):
        """Build the OAuth consent URL (reference GET /drive/auth-url).
        Needs only the client id — no egress."""
        client_id = os.environ.get("MRAG_DRIVE_CLIENT_ID", "")
        if not client_id:
            return _err("MRAG_DRIVE_CLIENT_ID not configured", 503)
        import urllib.parse

        redirect = request.query.get(
            "redirect_uri",
            os.environ.get("MRAG_DRIVE_REDIRECT_URI",
                           "http://localhost:8080/drive/callback"))
        params = urllib.parse.urlencode({
            "client_id": client_id,
            "redirect_uri": redirect,
            "response_type": "code",
            "scope": "https://www.googleapis.com/auth/drive.readonly",
            "access_type": "offline",
            "prompt": "consent",
        })
        base = os.environ.get("MRAG_DRIVE_AUTH_URL",
                              "https://accounts.google.com/o/oauth2/v2/auth")
        return _json({"auth_url": f"{base}?{params}"})

    async def drive_callback(request):
        """Exchange the consent code for a refresh token (reference
        GET /drive/callback) and hold it for this process."""
        code = request.query.get("code", "")
        if not code:
            return _err("code parameter required")
        import json as _j
        import urllib.parse
        import urllib.request

        env = os.environ.get
        body = urllib.parse.urlencode({
            "client_id": env("MRAG_DRIVE_CLIENT_ID", ""),
            "client_secret": env("MRAG_DRIVE_CLIENT_SECRET", ""),
            "code": code,
            "grant_type": "authorization_code",
            "redirect_uri": request.query.get(
                "redirect_uri", env("MRAG_DRIVE_REDIRECT_URI",
                                    "http://localhost:8080/drive/callback")),
        }).encode()
        token_url = env("MRAG_DRIVE_TOKEN_URL",
                        "https://oauth2.googleapis.com/token")
        req = urllib.request.Request(token_url, data=body, method="POST")
        req.add_header("Content-Type", "application/x-www-form-urlencoded")
        try:
            with urllib.request.urlopen(req, timeout=30.0) as resp:
                tok = _j.loads(resp.read().decode())
        except Exception as e:
            return _err(f"token exchange failed: {e}", 502)
        refresh = tok.get("refresh_token", "")
        if refresh:
            # process-scoped credential: HTTPDrive() picks it up from env
            os.environ["MRAG_DRIVE_REFRESH_TOKEN"] = refresh
        return _json({"connected": bool(refresh),
                      "has_refresh_token": bool(refresh)})

    async def drive_disconnect(request):
        had = bool(os.environ.pop("MRAG_DRIVE_REFRESH_TOKEN", None))
        had |= bool(os.environ.pop("MRAG_DRIVE_ACCESS_TOKEN", None))
        ctx.extra_state.pop("drive_client", None)
        return _json({"disconnected": had})

    async def drive_folder_files(request):
        client = _drive_client()
        if client is None:
            return _err("drive not connected", 503)
        try:
            files = client.list_folder(request.match_info["folder_id"])
        except Exception as e:
            return _err(f"drive list failed: {e}", 502)
        return _json({"files": files})

    async def drive_scan_folder(request):
        """Classify a folder's files WITHOUT importing (reference
        POST /drive/scan-folder — the import preview)."""
        client = _drive_client()
        if client is None:
            return _err("drive not connected", 503)
        body = await request.json()
        folder_id = body.get("folder_id", "")
        if not folder_id:
            return _err("folder_id required")
        try:
            files = client.list_folder(folder_id)
        except Exception as e:
            return _err(f"drive list failed: {e}", 502)
        return _json({"files": [
            {**f, **classify_file(f["name"])} for f in files]})

    async def drive_import_folder(request):
        """Import a folder through the normal ingest path (reference
        POST /drive/import-folder / /documents/import-from-drive)."""
        client = _drive_client()
        if client is None:
            return _err("drive not connected", 503)
        body = await request.json()
        folder_id = body.get("folder_id", "")
        if not folder_id:
            return _err("folder_id required")
        res = import_folder(ctx.pipeline, client, folder_id,
                            manuals_only=bool(body.get("manuals_only", True)))
        summary = {"scanned": res.scanned, "imported": res.imported,
                   "skipped": res.skipped, "ts": time.time(),
                   "folder_id": folder_id}
        ctx.extra_state["drive_last_import"] = summary
        return _json(summary)

    async def import_from_html(request):
        """Direct HTML ingestion (reference POST /documents/
        import-from-html): body {html, filename, payer?, state?, …}."""
        body = await request.json()
        html = body.get("html", "")
        if not html:
            return _err("html required")
        filename = body.get("filename") or "import.html"
        if not filename.lower().endswith((".html", ".htm")):
            filename += ".html"
        res = ctx.pipeline.upload(
            html.encode(), filename,
            payer=body.get("payer", ""), state=body.get("state", ""),
            program=body.get("program", ""),
            authority_level=int(body.get("authority_level", 0)))
        return _json({"doc_id": res.doc_id, "deduped": res.deduped,
                      "job_id": res.chunking_job})

    async def import_scraped_pages(request):
        """Bulk scraped-page ingestion (reference POST /documents/
        import-scraped-pages): [{url, html, payer?, state?}] — payer/
        state inferred from the URL via the curator when absent."""
        from mobius_rag_tpu_torch.curator import classify_url

        body = await request.json()
        pages = body.get("pages") or []
        if not isinstance(pages, list) or not pages:
            return _err("pages list required")
        out = []
        for page in pages[:200]:
            url, html = page.get("url", ""), page.get("html", "")
            if not html:
                out.append({"url": url, "error": "no html"})
                continue
            cls = classify_url(url) if url else {}
            name = (url.rstrip("/").rsplit("/", 1)[-1] or "page") + ".html"
            res = ctx.pipeline.upload(
                html.encode(), name,
                payer=page.get("payer") or cls.get("payer", ""),
                state=page.get("state") or cls.get("state", ""))
            out.append({"url": url, "doc_id": res.doc_id,
                        "deduped": res.deduped})
        return _json({"imported": out, "n": len(out)})

    r.add_get("/drive/status", drive_status)
    r.add_get("/drive/auth-url", drive_auth_url)
    r.add_get("/drive/callback", drive_callback)
    r.add_delete("/drive/disconnect", drive_disconnect)
    r.add_get("/drive/folders/{folder_id}/files", drive_folder_files)
    r.add_post("/drive/scan-folder", drive_scan_folder)
    r.add_post("/drive/import-folder", drive_import_folder)
    r.add_post("/documents/import-from-drive", drive_import_folder)
    r.add_post("/documents/import-from-html", import_from_html)
    r.add_post("/documents/import-scraped-pages", import_scraped_pages)


def _register_config_depth(r, ctx) -> None:  # noqa: C901 — route table
    from mobius_rag_tpu_torch.providers import LLMConfig

    async def llm_providers(request):
        """Known provider kinds + providers currently configured
        (reference GET /config/llm/providers)."""
        configured = sorted({c.provider for c in ctx.llm_configs.configs.values()})
        return _json({"builtin": ["offline", "http", "onchip", "hash"],
                      "configured": configured})

    async def llm_get(request):
        cfg = ctx.llm_configs.get(request.match_info["name"])
        if cfg is None:
            return _err("llm config not found", 404)
        return _json(cfg.redacted())

    async def llm_put(request):
        body = await request.json()
        name = request.match_info["name"]
        cfg = LLMConfig(name=name, provider=body.get("provider", "offline"),
                        model=body.get("model", ""),
                        params=body.get("params") or {},
                        secrets=body.get("secrets") or {})
        ctx.llm_configs.upsert(cfg)
        return _json(cfg.redacted())

    async def llm_test(request):
        """Smoke-test a configured LLM (reference POST /config/llm/
        {version}/test): ping the provider with a one-token prompt."""
        from mobius_rag_tpu_torch.clients import (HTTPLLMClient, LLMHTTPError,
                                                  OfflineLLMStub)

        cfg = ctx.llm_configs.get(request.match_info["name"])
        if cfg is None:
            return _err("llm config not found", 404)
        t0 = time.time()
        try:
            if cfg.provider == "http":
                url = cfg.params.get("url") or cfg.secrets.get("url", "")
                if not url:
                    return _err("http provider config has no url")
                client = HTTPLLMClient(url, model=cfg.model)
            else:
                client = OfflineLLMStub()
            out = client.generate("Reply with the single word: pong",
                                  stage="test", max_tokens=8)
            return _json({"ok": True, "provider": cfg.provider,
                          "latency_ms": round((time.time() - t0) * 1e3, 1),
                          "reply": out[:120]})
        except (LLMHTTPError, OSError) as e:
            return _json({"ok": False, "provider": cfg.provider,
                          "error": str(e)[:300]}, 502)

    async def prompt_names(request):
        return _json({"names": sorted(ctx.prompts.prompts.keys())})

    async def prompt_get(request):
        pv = ctx.prompts.get(request.match_info["stage"],
                             request.match_info["version"])
        if pv is None:
            return _err("prompt version not found", 404)
        return _json({"stage": pv.stage, "version": pv.version,
                      "sha": pv.sha, "text": pv.text})

    async def prompt_put(request):
        body = await request.json()
        text = body.get("text", "")
        if not text:
            return _err("text required")
        pv = ctx.prompts.put(request.match_info["stage"],
                             request.match_info["version"], text)
        return _json({"stage": pv.stage, "version": pv.version, "sha": pv.sha})

    async def prompt_delete(request):
        ok = ctx.prompts.delete(request.match_info["stage"],
                                request.match_info["version"])
        return _json({"deleted": ok}, 200 if ok else 404)

    r.add_get("/config/llm/providers", llm_providers)
    r.add_get("/config/llm/{name}", llm_get)
    r.add_put("/config/llm/{name}", llm_put)
    r.add_post("/config/llm/{name}/test", llm_test)
    r.add_post("/config/prompts/names", prompt_names)
    r.add_get("/config/prompts/{stage}/{version}", prompt_get)
    r.add_put("/config/prompts/{stage}/{version}", prompt_put)
    r.add_post("/config/prompts/{stage}/{version}", prompt_put)
    r.add_delete("/config/prompts/{stage}/{version}", prompt_delete)


def _register_policy_depth(r, ctx) -> None:  # noqa: C901 — route table
    def _tag_names(rec) -> list[str]:
        lex = ctx.engine.lexicon
        by_id = {"j": {}, "d": {}, "p": {}}
        for e in lex.entries:
            if e.tag_id >= 0:
                by_id[e.kind][e.tag_id] = e.code
        out = []
        for kind, ids in (("j", rec.j_tags), ("d", rec.d_tags),
                          ("p", rec.p_tags)):
            out.extend(f"{kind}:{by_id[kind].get(t, t)}" for t in ids)
        return out

    async def policy_lines(request):
        """Corpus-wide chunk/tag table (reference GET /policy/lines —
        there a per-line tagging table; our tagging unit is the chunk).
        Filter by ?code=kind:code, paginate with ?offset/?limit."""
        code = request.query.get("code", "")
        offset = int(request.query.get("offset", 0))
        limit = min(int(request.query.get("limit", 100)), 500)
        lines = []
        for doc_id, recs in sorted(_live_docs(ctx).items()):
            for rec in recs:
                tags = _tag_names(rec)
                if code and code not in tags:
                    continue
                lines.append({"doc_id": doc_id, "chunk_id": rec.chunk_id,
                              "page": rec.page, "tags": tags,
                              "text": rec.text[:160]})
        return _json({"total": len(lines),
                      "lines": lines[offset:offset + limit]})

    async def doc_policy_lines(request):
        doc_id = request.match_info["doc_id"]
        rows = ctx.store.rows_for_document(doc_id)
        if not rows:
            return _err("document not found", 404)
        recs = [ctx.store.records[i] for i in rows]
        return _json({"doc_id": doc_id, "lines": [
            {"chunk_id": rec.chunk_id, "page": rec.page,
             "tags": _tag_names(rec), "text": rec.text[:200]}
            for rec in recs]})

    async def doc_policy_line_tags(request):
        """Per-document tag histogram (reference
        GET /documents/{id}/policy-line-tags)."""
        doc_id = request.match_info["doc_id"]
        rows = ctx.store.rows_for_document(doc_id)
        if not rows:
            return _err("document not found", 404)
        counts: dict[str, int] = {}
        for i in rows:
            for tag in _tag_names(ctx.store.records[i]):
                counts[tag] = counts.get(tag, 0) + 1
        return _json({"doc_id": doc_id, "tag_counts": dict(
            sorted(counts.items(), key=lambda kv: -kv[1]))})

    async def doc_policy_candidates(request):
        doc_id = request.match_info["doc_id"]
        return _json({"doc_id": doc_id,
                      "candidates": ctx.candidates.for_doc(doc_id)})

    async def candidates_aggregate(request):
        status = request.query.get("status") or None
        limit = min(int(request.query.get("limit", 500)), 2000)
        return _json({"candidates": ctx.candidates.aggregate(
            status=status, limit=limit)})

    async def candidates_aggregate_review_bulk(request):
        """Approve/reject a batch of phrases corpus-wide (reference
        POST /policy/candidates/aggregate/review-bulk)."""
        body = await request.json()
        phrases = body.get("phrases") or []
        approve = bool(body.get("approve", False))
        lex = ctx.engine.lexicon if approve and body.get("promote") else None
        out = [ctx.candidates.review(p, approve=approve, lexicon=lex,
                                     kind=body.get("kind", "d"))
               for p in phrases[:500]]
        return _json({"reviewed": out, "n": len(out)})

    async def candidate_review(request):
        """Single-candidate review (reference POST /policy/candidates/
        {candidate_id}/review) — candidates are keyed by phrase."""
        body = await request.json()
        out = ctx.candidates.review(
            request.match_info["phrase"],
            approve=bool(body.get("approve", False)),
            lexicon=ctx.engine.lexicon if body.get("promote") else None,
            kind=body.get("kind", "d"), code=body.get("code", ""))
        return _json(out, 200 if out["found"] else 404)

    async def lexicon_tag_patch(request):
        """Tune a live lexicon entry (reference PATCH /policy/lexicon/
        tags/{kind}/{code}). Selectivity only: phrase changes go through
        the candidates review path so tag bitsets stay consistent."""
        kind = request.match_info["kind"]
        code = request.match_info["code"]
        body = await request.json()
        if "selectivity" not in body:
            return _err("only 'selectivity' is editable here; add phrases "
                        "via /api/lexicon/candidates/review promotion")
        sel = float(body["selectivity"])
        if not 0.0 <= sel <= 1.0:
            return _err("selectivity must be in [0, 1]")
        for e in ctx.engine.lexicon.entries:
            if e.kind == kind and e.code == code:
                e.selectivity = sel
                ctx.engine.lexicon._expand_cache.clear()
                return _json({"kind": kind, "code": code,
                              "selectivity": sel})
        return _err("lexicon entry not found", 404)

    async def lexicon_tag_details(request):
        """Query-param variant of the tag-detail drilldown (reference
        GET /policy/lexicon/tag-details?kind=&code=)."""
        kind = request.query.get("kind", "")
        code = request.query.get("code", "")
        for e in ctx.engine.lexicon.entries:
            if e.kind == kind and e.code == code:
                docs = 0
                chunks = 0
                for recs in _live_docs(ctx).values():
                    hit = [rec for rec in recs if e.tag_id in
                           {"j": rec.j_tags, "d": rec.d_tags,
                            "p": rec.p_tags}[kind]]
                    chunks += len(hit)
                    docs += bool(hit)
                return _json({"kind": kind, "code": code,
                              "phrases": e.phrases, "tag_id": e.tag_id,
                              "selectivity": e.selectivity,
                              "documents": docs, "chunks": chunks})
        return _err("lexicon entry not found", 404)

    r.add_get("/policy/lines", policy_lines)
    r.add_get("/documents/{doc_id}/policy/lines", doc_policy_lines)
    r.add_get("/documents/{doc_id}/policy-line-tags", doc_policy_line_tags)
    r.add_get("/documents/{doc_id}/policy/candidates", doc_policy_candidates)
    r.add_get("/policy/candidates/aggregate", candidates_aggregate)
    r.add_post("/policy/candidates/aggregate/review-bulk",
               candidates_aggregate_review_bulk)
    r.add_post("/policy/candidates/{phrase}/review", candidate_review)
    r.add_patch("/policy/lexicon/tags/{kind}/{code:.+}", lexicon_tag_patch)
    r.add_get("/policy/lexicon/tag-details", lexicon_tag_details)
