"""Observability: structured logging, persisted telemetry, progress (the port of
``mobius_rag_tpu.observability``).
events, error tracking.

Reference parity (SURVEY §5.1/§5.5):
- JSON structured logging with service names (app/logging_setup.py:47-130);
- search_events — per-search timings/arm-hits/scoring-trace rows
  (corpus_search.py:3187-3240; feed at main.py:13561);
- rag_query_decisions + rag_query_traces — one decision row + one
  full-trace row per agent run, keep-all retention ("anything shown to
  the user must be persisted", migration add_rag_query_traces.py:1-41);
- processing_errors + severity classification (app/services/
  error_tracker.py:12,95);
- progress_emit — fire-and-forget ordered stage events consumed by a
  chat/UI frontend (app/services/progress_emit.py:68), here an
  in-process pub/sub with bounded queues.

Backing store is sqlite (host side; the hot path never blocks on it —
writes go through a fire-and-forget buffer like the reference's
fire-and-forget decision persistence, corpus_search_agent.py:3402).
"""
from __future__ import annotations

import json
import logging
import os
import queue
import sqlite3
import threading
import time
import uuid
from typing import Any, Callable

from mobius_rag_tpu_torch.config import get_config

# ---------------------------------------------------------------------------
# JSON logging
# ---------------------------------------------------------------------------


class JsonFormatter(logging.Formatter):
    def __init__(self, service: str):
        super().__init__()
        self.service = service

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "ts": round(record.created, 3),
            "level": record.levelname,
            "service": self.service,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        for key in ("search_id", "agent_id", "job_id", "doc_id", "stage"):
            if hasattr(record, key):
                out[key] = getattr(record, key)
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def setup_logging(service: str, level: int = logging.INFO) -> logging.Logger:
    root = logging.getLogger()
    root.setLevel(level)
    for h in list(root.handlers):
        root.removeHandler(h)
    handler = logging.StreamHandler()
    handler.setFormatter(JsonFormatter(service))
    root.addHandler(handler)
    return logging.getLogger(service)


# ---------------------------------------------------------------------------
# Error tracker
# ---------------------------------------------------------------------------

SEVERITIES = ("info", "warning", "error", "critical")

_TRANSIENT_MARKERS = ("timeout", "temporarily", "connection", "unavailable",
                      "rate limit", "429", "503")


def classify_severity(exc: BaseException | str) -> str:
    """Transient infra blips are warnings (retried); data problems are
    errors; invariant breaks are critical (error_tracker.py:95 intent)."""
    text = str(exc).lower()
    if any(m in text for m in _TRANSIENT_MARKERS):
        return "warning"
    if isinstance(exc, (AssertionError,)) or "integrity" in text:
        return "critical"
    return "error"


# ---------------------------------------------------------------------------
# Telemetry store
# ---------------------------------------------------------------------------

_SCHEMA = """
CREATE TABLE IF NOT EXISTS search_events (
  search_id TEXT PRIMARY KEY, ts REAL, query TEXT, mode TEXT,
  timings TEXT, arms TEXT, expansion TEXT, results TEXT, extra TEXT
);
CREATE TABLE IF NOT EXISTS query_decisions (
  agent_id TEXT PRIMARY KEY, ts REAL, query TEXT, strategy TEXT,
  chain TEXT, query_class TEXT, contour TEXT, confidence TEXT,
  refused INTEGER, priors_version TEXT, scores TEXT, latency_ms REAL
);
CREATE TABLE IF NOT EXISTS query_traces (
  agent_id TEXT PRIMARY KEY, ts REAL, trace TEXT
);
CREATE TABLE IF NOT EXISTS processing_errors (
  error_id TEXT PRIMARY KEY, ts REAL, service TEXT, severity TEXT,
  message TEXT, context TEXT, resolved INTEGER DEFAULT 0
);
"""


class TelemetryStore:
    """Durable telemetry with a background writer thread (hot path
    enqueues; flush() drains for tests/shutdown)."""

    def __init__(self, path: str | None = None):
        base = path or os.path.join(get_config().data_dir, "telemetry.sqlite")
        os.makedirs(os.path.dirname(base), exist_ok=True)
        self._path = base
        self._q: queue.Queue[tuple[str, tuple]] = queue.Queue(maxsize=10000)
        self._pending = 0
        self._pending_lock = threading.Lock()
        self._stop = threading.Event()
        # reader connection + schema FIRST (the writer thread's WAL pragma
        # used to race this executescript, die on 'database is locked',
        # and silently blackhole every write)
        self._read_conn = sqlite3.connect(base, check_same_thread=False,
                                          timeout=30.0)
        self._read_lock = threading.Lock()
        with self._read_lock:
            self._read_conn.executescript(_SCHEMA)
            # schema migration for pre-`resolved` telemetry files (the
            # reference's 64-migration ladder collapses to additive
            # ALTERs on the host stores)
            cols = [r[1] for r in self._read_conn.execute(
                "PRAGMA table_info(processing_errors)")]
            if "resolved" not in cols:
                self._read_conn.execute(
                    "ALTER TABLE processing_errors "
                    "ADD COLUMN resolved INTEGER DEFAULT 0")
            dcols = [r[1] for r in self._read_conn.execute(
                "PRAGMA table_info(query_decisions)")]
            # human-grading loop (reference PATCH /observe/decisions/
            # {correlation_id}/grade): operators grade prod decisions
            if "grade" not in dcols:
                self._read_conn.execute(
                    "ALTER TABLE query_decisions ADD COLUMN grade TEXT")
                self._read_conn.execute(
                    "ALTER TABLE query_decisions ADD COLUMN grade_notes TEXT")
            self._read_conn.commit()
        self._thread = threading.Thread(target=self._writer, daemon=True)
        self._thread.start()

    # -- writer thread --------------------------------------------------------

    def _writer(self) -> None:
        conn = sqlite3.connect(self._path, timeout=30.0)
        for attempt in range(10):  # WAL switch can transiently contend
            try:
                conn.execute("PRAGMA journal_mode=WAL")
                break
            except sqlite3.OperationalError:
                time.sleep(0.05 * (attempt + 1))
        while not (self._stop.is_set() and self._q.empty()):
            try:
                sql, args = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            try:
                conn.execute(sql, args)
                conn.commit()
            except sqlite3.Error:
                logging.getLogger("telemetry").exception("telemetry write failed")
            finally:
                with self._pending_lock:
                    self._pending -= 1

    def _submit(self, sql: str, args: tuple) -> None:
        try:
            with self._pending_lock:
                self._pending += 1
            self._q.put_nowait((sql, args))
        except queue.Full:
            with self._pending_lock:
                self._pending -= 1
            # fire-and-forget: drop telemetry before blocking the query path

    def flush(self, timeout_s: float = 5.0) -> None:
        """Wait for every submitted write to COMMIT (queue emptiness alone
        races with the in-flight item)."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            with self._pending_lock:
                if self._pending == 0:
                    return
            time.sleep(0.01)

    def close(self) -> None:
        self.flush()
        self._stop.set()
        self._thread.join(timeout=2)

    # -- writes ---------------------------------------------------------------

    def record_search_event(self, *, search_id: str | None = None, query: str,
                            mode: str, timings: dict, arms: dict,
                            expansion: list, results: list,
                            extra: dict | None = None) -> str:
        sid = search_id or uuid.uuid4().hex[:16]
        self._submit(
            "INSERT OR REPLACE INTO search_events VALUES (?,?,?,?,?,?,?,?,?)",
            (sid, time.time(), query[:500], mode, json.dumps(timings),
             json.dumps(arms), json.dumps(expansion), json.dumps(results),
             json.dumps(extra or {})),
        )
        return sid

    def record_decision(self, agent_result) -> None:
        """Persist decision + full trace for an AgentResult (the
        observer hooked onto CorpusSearchAgent.observers)."""
        r = agent_result
        self._submit(
            "INSERT OR REPLACE INTO query_decisions "
            "(agent_id, ts, query, strategy, chain, query_class, contour, "
            "confidence, refused, priors_version, scores, latency_ms) "
            "VALUES (?,?,?,?,?,?,?,?,?,?,?,?)",
            (r.agent_id, time.time(), r.query[:500],
             r.decision.get("strategy", ""), json.dumps(r.strategy_chain),
             r.profile.get("query_class", ""), r.gate.get("contour", ""),
             r.confidence_label, int(r.refused),
             r.decision.get("priors_version", ""),
             json.dumps(r.decision.get("scores", {})),
             r.telemetry.get("elapsed_ms", 0.0)),
        )
        trace = {
            "query": r.query, "answer": r.answer,
            "chunks": [{"chunk_id": c.chunk_id, "doc_id": c.doc_id,
                        "score": c.score, "signals": c.signals} for c in r.chunks],
            "decision": r.decision, "gate": r.gate, "profile": r.profile,
            "telemetry": r.telemetry, "hint": r.improvement_hint,
            "narrative": getattr(r, "narrative", ""),
        }
        self._submit(
            "INSERT OR REPLACE INTO query_traces VALUES (?,?,?)",
            (r.agent_id, time.time(), json.dumps(trace)),
        )

    def record_error(self, service: str, exc: BaseException | str,
                     context: dict | None = None) -> None:
        self._submit(
            "INSERT INTO processing_errors VALUES (?,?,?,?,?,?,0)",
            (uuid.uuid4().hex, time.time(), service, classify_severity(exc),
             str(exc)[:2000], json.dumps(context or {})),
        )

    # -- reads ------------------------------------------------------------------

    def _query(self, sql: str, args: tuple = ()) -> list[tuple]:
        with self._read_lock:
            return self._read_conn.execute(sql, args).fetchall()

    def recent_search_events(self, limit: int = 50) -> list[dict[str, Any]]:
        rows = self._query(
            "SELECT search_id, ts, query, mode, timings, arms, results "
            "FROM search_events ORDER BY ts DESC LIMIT ?", (limit,))
        return [{"search_id": r[0], "ts": r[1], "query": r[2], "mode": r[3],
                 "timings": json.loads(r[4]), "arms": json.loads(r[5]),
                 "results": json.loads(r[6])} for r in rows]

    def recent_decisions(self, limit: int = 50) -> list[dict[str, Any]]:
        rows = self._query(
            "SELECT agent_id, ts, query, strategy, chain, query_class, contour, "
            "confidence, refused, latency_ms, grade FROM query_decisions "
            "ORDER BY ts DESC LIMIT ?", (limit,))
        return [{"agent_id": r[0], "ts": r[1], "query": r[2], "strategy": r[3],
                 "chain": json.loads(r[4]), "query_class": r[5], "contour": r[6],
                 "confidence": r[7], "refused": bool(r[8]), "latency_ms": r[9],
                 "grade": r[10]}
                for r in rows]

    def grade_decision(self, agent_id: str, grade: str,
                       notes: str = "") -> bool:
        """Operator grade on a persisted decision (reference
        PATCH /observe/decisions/{correlation_id}/grade). Synchronous
        write — the grader expects read-your-write on the next fetch."""
        with self._read_lock:
            cur = self._read_conn.execute(
                "UPDATE query_decisions SET grade=?, grade_notes=? "
                "WHERE agent_id=?", (grade, notes, agent_id))
            self._read_conn.commit()
            return cur.rowcount > 0

    def decisions_rollup(self, window_hours: float = 24.0) -> dict[str, Any]:
        """Per-strategy rollup over recent PROD decisions (the reference's
        /observe/prod_rollup): n, confidence distribution, refusal rate,
        mean latency. Prod has no gold facts, so confidence is the live
        signal (the reference's synthesis_grade analogue)."""
        since = time.time() - window_hours * 3600.0
        rows = self._query(
            "SELECT strategy, confidence, refused, latency_ms "
            "FROM query_decisions WHERE ts >= ?", (since,))
        by: dict[str, dict[str, Any]] = {}
        for strategy, confidence, refused, latency in rows:
            s = by.setdefault(strategy or "?", {
                "n": 0, "refused": 0, "latency_ms_sum": 0.0,
                "confidence": {"high": 0, "medium": 0, "low": 0, "abstain": 0},
            })
            s["n"] += 1
            s["refused"] += int(refused)
            s["latency_ms_sum"] += float(latency or 0.0)
            if confidence in s["confidence"]:
                s["confidence"][confidence] += 1
        out = {}
        for sid, s in sorted(by.items()):
            out[sid] = {
                "n": s["n"],
                "refusal_rate": round(s["refused"] / s["n"], 4),
                "latency_ms_mean": round(s["latency_ms_sum"] / s["n"], 2),
                "confidence": s["confidence"],
            }
        return {"window_hours": window_hours, "strategies": out}

    def trace(self, agent_id: str) -> dict[str, Any] | None:
        rows = self._query("SELECT trace FROM query_traces WHERE agent_id=?",
                           (agent_id,))
        return json.loads(rows[0][0]) if rows else None

    def recent_errors(self, limit: int = 50, severity: str | None = None,
                      *, include_resolved: bool = True,
                      doc_id: str | None = None) -> list[dict]:
        sql = ("SELECT error_id, ts, service, severity, message, context, "
               "resolved FROM processing_errors WHERE 1=1")
        args: tuple = ()
        if severity:
            sql += " AND severity=?"
            args += (severity,)
        if not include_resolved:
            sql += " AND resolved=0"
        if doc_id:
            # context is a JSON blob; doc linkage rides its doc_id field
            sql += " AND context LIKE ?"
            args += (f'%"doc_id": "{doc_id}"%',)
        sql += " ORDER BY ts DESC LIMIT ?"
        rows = self._query(sql, args + (limit,))
        return [{"error_id": r[0], "ts": r[1], "service": r[2],
                 "severity": r[3], "message": r[4],
                 "context": json.loads(r[5]), "resolved": bool(r[6])}
                for r in rows]

    def error_stats(self) -> dict[str, Any]:
        """Counts by service × severity + unresolved total (the
        reference's GET /errors/stats rollup, main.py errors surface)."""
        rows = self._query(
            "SELECT service, severity, COUNT(*), SUM(1-resolved) "
            "FROM processing_errors GROUP BY service, severity")
        by_service: dict[str, dict] = {}
        total = unresolved = 0
        for svc, sev, n, unres in rows:
            by_service.setdefault(svc, {})[sev] = {
                "count": n, "unresolved": unres or 0}
            total += n
            unresolved += unres or 0
        return {"total": total, "unresolved": unresolved,
                "by_service": by_service}

    def resolve_error(self, error_id: str) -> bool:
        with self._read_lock:
            cur = self._read_conn.execute(
                "UPDATE processing_errors SET resolved=1 WHERE error_id=?",
                (error_id,))
            self._read_conn.commit()
        return cur.rowcount > 0

    def resolve_errors_for_doc(self, doc_id: str) -> int:
        with self._read_lock:
            cur = self._read_conn.execute(
                "UPDATE processing_errors SET resolved=1 "
                "WHERE resolved=0 AND context LIKE ?",
                (f'%"doc_id": "{doc_id}"%',))
            self._read_conn.commit()
        return cur.rowcount


# ---------------------------------------------------------------------------
# Progress emitter (in-process pub/sub; the SSE feed's source)
# ---------------------------------------------------------------------------


class ProgressEmitter:
    """Ordered, bounded, fire-and-forget stage-progress events keyed by a
    correlation id (progress_emit.py semantics: PHI-safe fields only —
    callers pass stage names and counters, never raw text)."""

    def __init__(self, max_events_per_cid: int = 500):
        self._events: dict[str, list[dict]] = {}
        self._subs: dict[str, list[Callable[[dict], None]]] = {}
        self._lock = threading.Lock()
        self._max = max_events_per_cid

    def emit(self, cid: str, stage: str, **fields: Any) -> None:
        event = {"cid": cid, "stage": stage, "ts": time.time(),
                 "seq": None, **fields}
        with self._lock:
            lst = self._events.setdefault(cid, [])
            event["seq"] = len(lst)
            if len(lst) < self._max:
                lst.append(event)
            subs = list(self._subs.get(cid, ())) + list(self._subs.get("*", ()))
        for cb in subs:
            try:
                cb(event)
            except Exception:
                pass

    def subscribe(self, cid: str, cb: Callable[[dict], None]) -> None:
        with self._lock:
            self._subs.setdefault(cid, []).append(cb)

    def events(self, cid: str, since_seq: int = -1) -> list[dict]:
        with self._lock:
            return [e for e in self._events.get(cid, []) if e["seq"] > since_seq]


PROGRESS = ProgressEmitter()
