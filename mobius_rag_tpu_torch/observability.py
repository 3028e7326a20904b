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

Spans and counters (the port's own; see that section): the query path's
layer boundaries as spans, the device program's stages as timing events
inside it, and plain counters, in one process-wide :data:`RECORDER`.
Spans and stage marks record exactly while a ``torch.profiler`` session
collects in the process, so a traced benchmark run or ``POST
/admin/profile {"trace": true}`` traces, and nothing else does.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import os
import queue
import sqlite3
import threading
import time
import uuid
from typing import Any, Callable, NamedTuple

import torch
from torch.autograd import profiler as torch_profiler

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


# ---------------------------------------------------------------------------
# Spans and counters
# ---------------------------------------------------------------------------

# Span records a recorder keeps; the oldest go first.
RING = 65_536
# The device program's stages, in order. Each is timed from the mark before
# it (the program's start, for the first) to its own mark.
STAGES = ("gate", "vector", "lexical", "dtag", "fusion")


def tracing() -> bool:
    """Whether spans and stage readings record: exactly while a
    ``torch.profiler`` session collects in this process (torch's own
    process-wide flag, which every profiler session sets)."""
    return torch_profiler._is_profiler_enabled


class SpanRecord(NamedTuple):
    """One closed span. Times are ns on ``time.time_ns``'s clock, the one
    ``torch.profiler`` stamps its events on; ``parent`` is the id of the
    span around it; ``self_ns`` is its duration less what its children
    cover."""

    id: int
    name: str
    start: int
    end: int
    parent: int | None
    batch: int | None
    thread: int
    attrs: dict
    self_ns: int


class Span:
    """A span while it is open (:meth:`Recorder.span`, :meth:`Recorder.open`).
    ``start`` and ``end`` (ns, ``time.time_ns``) are stamped whether or not
    tracing is on, so a caller can time its stages from them."""

    __slots__ = ("rec", "name", "batch", "attrs", "start", "end", "id", "parent",
                 "child_ns", "thread", "twin", "split")

    def __init__(self, rec: "Recorder", name: str, batch: int | None, attrs: dict):
        self.rec, self.name, self.batch, self.attrs = rec, name, batch, attrs
        self.end = None
        self.split: dict[str, int] | None = None  # an open()ed span's children, ns by name

    def __enter__(self) -> "Span":
        if tracing():
            self.rec._begin(self, stacked=True)
        else:  # the stamps alone
            self.rec = None
            self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.rec is None:
            self.end = time.time_ns()
        else:
            self.rec._end(self)
        return False


class Recorder:
    """The spans, stage readings and counters of one process (:data:`RECORDER`).

    A span (:meth:`span`) is a context manager. While tracing it records its
    name, start, end and parent (the span open around it on its thread), a
    batch id (the one given, else its parent's, else the one its thread
    last took up: :meth:`take_batch`) and a few attributes, into a ring of
    :data:`RING` records (:meth:`records`; kept as plain tuples, which the
    cyclic collector stops tracking, so that a full ring does not bring on
    full collections) and running totals by name (count, total and self
    time, and the time of each child name); and it is a
    ``torch.profiler.record_function`` named ``mrag:<name>``, so it lands on
    the profiler's timeline beside the device's events. Its start is
    stamped as the twin's enter returns and its end as the twin's exit
    returns, which keeps each within tens of microseconds of the twin's
    own. Off, a span stamps its start and end and records nothing.

    A span that closes after the profiler has stopped is not kept.
    :meth:`open` and :meth:`close` make a span that opens in one call and
    closes in another (``query.starved``). It stays off the thread's stack:
    the spans that close on its thread outside any other span while it is
    open count as its children, for the part of them it covers. The
    recorder holds every such span until it ends, and it ends with its
    profiler session at the latest: :meth:`end_session` (which
    ``profiling.locked_profiler`` calls before it stops a profiler, and
    :meth:`reset` first) ends every one still open; one closed while no
    profiler runs is dropped. (A profiler started and stopped elsewhere,
    twice with no dispatch between, would hand the first session's span
    to the second.)

    Counters (:attr:`counts`) are plain integers: the batches whose stage
    marks were read and skipped (:meth:`read_stages`), and what the query
    path adds while tracing (:meth:`count`)."""

    def __init__(self, size: int = RING):
        self._lock = threading.Lock()
        self._local = threading.local()
        self._ids = itertools.count()
        self.size = size
        self.reset()

    def reset(self) -> None:
        """Forget every record, total and count (the spans still open end
        first: :meth:`end_session`)."""
        if hasattr(self, "_floating"):
            self.end_session()
        with self._lock:
            self.ring: collections.deque[tuple] = collections.deque(maxlen=self.size)
            self.totals: dict[str, list[int]] = {}  # name -> [count, total ns, self ns]
            self.children: dict[str, dict[str, int]] = {}  # name -> child name -> ns
            self.stages: dict[str, list] = {}  # stage -> [batches read, total ms]
            self.counts: collections.Counter = collections.Counter()
            self._floating: list[Span] = []

    def span(self, name: str, batch: int | None = None, **attrs) -> Span:
        return Span(self, name, batch, attrs)

    def open(self, name: str, batch: int | None = None, **attrs) -> Span | None:
        """A span left open for :meth:`close`; None while tracing is off."""
        if not tracing():
            return None
        sp = Span(self, name, batch, attrs)
        self._begin(sp, stacked=False)
        sp.split = {}
        with self._lock:
            self._floating.append(sp)
        return sp

    def close(self, sp: Span | None) -> None:
        """End a span :meth:`open` made, unless :meth:`end_session` has
        ended it. The span open outside any other on this thread now,
        begun after it, counts as its child up to now."""
        if sp is None:
            return
        stack = self._stack()
        with self._lock:
            if sp not in self._floating:
                return
            self._floating.remove(sp)
            if stack and sp.thread == threading.get_ident():
                part = time.time_ns() - max(stack[0].start, sp.start)
                sp.child_ns += part
                sp.split[stack[0].name] = sp.split.get(stack[0].name, 0) + part
        self._end(sp)

    def end_session(self) -> None:
        """End every span :meth:`open` made that is still open, now: called
        while a profiler still runs, its session keeps them up to its stop.
        No later session may inherit one: a ``record_function`` exited, or
        destroyed, under a session other than the one it entered in
        crashes the process."""
        with self._lock:
            spans, self._floating = self._floating, []
        for sp in spans:
            self._end(sp)

    def records(self) -> list[SpanRecord]:
        """The ring's records, oldest first."""
        with self._lock:
            return [SpanRecord(*r[:7], dict(zip(r[8::2], r[9::2])), r[7]) for r in self.ring]

    def count(self, name: str, n: int) -> None:
        """Add `n` to counter `name` while tracing; nothing otherwise."""
        if tracing():
            with self._lock:
                self.counts[name] += n

    def take_batch(self, batch: int | None) -> None:
        """The batch id this thread's spans take when given none outside
        any other span: the batch the thread works on now."""
        self._local.batch = batch

    def read_stages(self, marks: "StageMarks", run: int, batch: int | None) -> None:
        """One batch's stage marks (`marks`, from its dispatch, the `run`-th
        that returned them) read into the stage totals, or counted skipped
        where a later dispatch has recorded them again."""
        if marks.runs != run:
            with self._lock:
                self.counts["marks_skipped"] += 1
            return
        ms = marks.elapsed_ms()
        with self._lock:
            self.counts["marks_read"] += 1
            for stage, v in ms.items():
                tot = self.stages.setdefault(stage, [0, 0.0])
                tot[0] += 1
                tot[1] += v

    def summary(self) -> dict:
        """The totals: by span name its count and total and self ms, and
        the ms of each of its children's names; by stage the batches read
        and their total ms; the counters."""
        with self._lock:
            return {
                "spans": {n: {"count": c, "total_ms": t / 1e6, "self_ms": s / 1e6}
                          for n, (c, t, s) in self.totals.items()},
                "children": {n: {c: ns / 1e6 for c, ns in kids.items()}
                             for n, kids in self.children.items()},
                "stages": {s: {"count": c, "total_ms": ms} for s, (c, ms) in self.stages.items()},
                "counts": dict(self.counts),
            }

    def _stack(self) -> list[Span]:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _begin(self, sp: Span, stacked: bool) -> None:
        stack = self._stack()
        parent = stack[-1] if stacked and stack else None
        sp.parent = parent
        if sp.batch is None:
            sp.batch = parent.batch if parent is not None else getattr(self._local, "batch", None)
        sp.id = next(self._ids)
        sp.thread = threading.get_ident()
        sp.child_ns = 0
        sp.twin = torch_profiler.record_function(f"mrag:{sp.name}")
        sp.twin.__enter__()
        sp.start = time.time_ns()
        if stacked:
            stack.append(sp)

    def _end(self, sp: Span) -> None:
        sp.twin.__exit__(None, None, None)
        sp.end = time.time_ns()
        stack = self._stack()
        if sp in stack:
            stack.remove(sp)
        if tracing():  # a span the profiler's stop cut is not kept
            self._store(sp)
        # what a caller keeps of a closed span is its stamps
        sp.twin = sp.parent = sp.rec = None

    def _store(self, sp: Span) -> None:
        dur = sp.end - sp.start
        parent = sp.parent
        with self._lock:
            if parent is not None:
                parent.child_ns += dur
                self._add_child(parent.name, sp.name, dur)
            else:
                for f in self._floating:
                    part = sp.end - max(sp.start, f.start)
                    if f.thread == sp.thread and part > 0:
                        f.child_ns += part
                        f.split[sp.name] = f.split.get(sp.name, 0) + part
            for child, ns in (sp.split or {}).items():
                self._add_child(sp.name, child, ns)
            tot = self.totals.setdefault(sp.name, [0, 0, 0])
            tot[0] += 1
            tot[1] += dur
            tot[2] += dur - sp.child_ns
            # flat: a tuple holding no other container is untracked at once
            self.ring.append((sp.id, sp.name, sp.start, sp.end,
                              None if parent is None else parent.id, sp.batch, sp.thread,
                              dur - sp.child_ns, *itertools.chain(*sp.attrs.items())))

    def _add_child(self, name: str, child: str, ns: int) -> None:
        kids = self.children.setdefault(name, {})
        kids[child] = kids.get(child, 0) + ns


RECORDER = Recorder()


def span(name: str, batch: int | None = None, **attrs) -> Span:
    """A span of :data:`RECORDER` (:meth:`Recorder.span`)."""
    return RECORDER.span(name, batch, **attrs)


class Flight:
    """One engine's batches in flight (dispatched, not yet fetched), and its
    ``query.starved`` span: open from the fetch that leaves none in flight
    until the engine's next dispatch has put its batch in flight (its
    program and copies enqueued), while the device has nothing of the
    engine's to run. Whatever the host does meanwhile lies under it: the
    last assembly, the caller's own loop, the next preparation and the
    dispatch's upload and launch. A batch leaves the flight once
    (``PendingFetch.leave``): at its fetch, or where its caller gives it
    up unfetched (a failed batch before it)."""

    def __init__(self, recorder: Recorder | None = None):
        self.rec = recorder or RECORDER
        self._lock = threading.Lock()
        self.n = 0
        self.starved: Span | None = None

    def sent(self) -> None:
        """A batch is in flight: ``query.starved`` closes."""
        with self._lock:
            self.n += 1
            sp, self.starved = self.starved, None
        self.rec.close(sp)

    def left(self, batch: int | None) -> None:
        """`batch` has left the flight; the last to leave opens
        ``query.starved``."""
        with self._lock:
            self.n -= 1
            if self.n == 0 and self.starved is None:
                self.starved = self.rec.open("query.starved", batch=batch)


class StageMarks:
    """Timing events at the stage boundaries of one device program
    (:data:`STAGES`; the first, "start", at the program's start), made by
    :func:`mark` while :func:`stage_marks` collects them. On a card each is
    a ``torch.cuda.Event(enable_timing=True, external=True)`` recorded on
    the current stream: inside a CUDA graph's capture that is an
    event-record node, which every replay records again, so the marks of a
    captured program belong to its graph (they ride its static outputs).
    On the CPU, which runs the program eagerly and in order, a mark takes
    the host clock (ns, ``time.time_ns``). ``runs`` counts the dispatches
    that returned these marks: a batch's reading is its own only while no
    later dispatch has."""

    def __init__(self, device):
        self.on_card = torch.device(device).type == "cuda"
        self.stamps: list[tuple[str, Any]] = []
        self.runs = 0

    def mark(self, stage: str) -> None:
        if self.on_card:
            stamp = torch.cuda.Event(enable_timing=True, external=True)
            stamp.record()
        else:
            stamp = time.time_ns()
        self.stamps.append((stage, stamp))

    def elapsed_ms(self) -> dict[str, float]:
        """ms of each stage, from the mark before it to its own. The events
        are read without a synchronize: call it once they have completed."""
        out = {}
        for (_, a), (stage, b) in zip(self.stamps, self.stamps[1:]):
            out[stage] = a.elapsed_time(b) if self.on_card else (b - a) / 1e6
        return out


_MARKS = threading.local()


@contextlib.contextmanager
def stage_marks(device):
    """Collect this thread's :func:`mark` calls inside the block into a new
    :class:`StageMarks` (yielded), marked "start" on entry."""
    marks = StageMarks(device)
    outer = getattr(_MARKS, "current", None)
    _MARKS.current = marks
    try:
        marks.mark("start")
        yield marks
    finally:
        _MARKS.current = outer


def mark(stage: str) -> None:
    """The end of `stage` of the device program this thread runs, where a
    collector is open (:func:`stage_marks`); nothing elsewhere."""
    marks = getattr(_MARKS, "current", None)
    if marks is not None:
        marks.mark(stage)
