"""Durable host-side job queue: sqlite with lease-based claims.

The TPU-native stand-in for the reference's Postgres job tables +
``FOR UPDATE SKIP LOCKED`` claims (chunking_jobs / embedding_jobs;
embedding_worker.py:393-399), keeping the same safety patterns
(SURVEY §5.2/§5.3):

- claims are leases: a claimed job carries a lease_expires timestamp;
  an expired lease makes the job claimable again (zombie recovery —
  worker/db.py:46, worker/main.py:128);
- inserts are idempotent on a client-generated dedupe key
  (ON CONFLICT DO NOTHING discipline);
- every state change appends an event row (ChunkingEvent parity) that
  observers can tail.

Ported from ``mobius_rag_tpu.ingest.queue`` with the port's imports.
"""
from __future__ import annotations

import dataclasses
import json
import os
import sqlite3
import threading
import time
import uuid
from typing import Any

from mobius_rag_tpu_torch.config import get_config

_SCHEMA = """
CREATE TABLE IF NOT EXISTS jobs (
  job_id TEXT PRIMARY KEY,
  kind TEXT NOT NULL,
  dedupe_key TEXT,
  payload TEXT NOT NULL,
  status TEXT NOT NULL DEFAULT 'queued',
  priority INTEGER NOT NULL DEFAULT 0,
  attempts INTEGER NOT NULL DEFAULT 0,
  max_attempts INTEGER NOT NULL DEFAULT 3,
  claimed_by TEXT,
  lease_expires REAL,
  error TEXT,
  created_at REAL, updated_at REAL,
  UNIQUE(kind, dedupe_key)
);
CREATE INDEX IF NOT EXISTS idx_jobs_claim ON jobs (kind, status, priority);
CREATE TABLE IF NOT EXISTS job_events (
  event_id INTEGER PRIMARY KEY AUTOINCREMENT,
  job_id TEXT, stage TEXT, payload TEXT, ts REAL
);
CREATE TABLE IF NOT EXISTS job_partials (
  job_id TEXT, part_key TEXT, payload TEXT, ts REAL,
  PRIMARY KEY (job_id, part_key)
);
CREATE TABLE IF NOT EXISTS worker_ticks (
  worker_id TEXT PRIMARY KEY,
  kind TEXT,
  last_tick REAL
);
"""


@dataclasses.dataclass
class Job:
    job_id: str
    kind: str
    payload: dict[str, Any]
    status: str
    attempts: int
    priority: int = 0
    error: str | None = None


class JobQueue:
    def __init__(self, path: str | None = None, *, lease_seconds: float = 300.0):
        base = path or os.path.join(get_config().data_dir, "jobs.sqlite")
        os.makedirs(os.path.dirname(base), exist_ok=True)
        self.path = base
        # shared across worker threads (nightly sweeps, API handlers) —
        # sqlite serializes writers; the RLock protects claim's
        # read-then-update transaction
        self.conn = sqlite3.connect(base, timeout=30.0, check_same_thread=False)
        self._lock = threading.RLock()
        self.conn.execute("PRAGMA journal_mode=WAL")
        self.conn.executescript(_SCHEMA)
        self.lease_seconds = lease_seconds

    # -- producer -------------------------------------------------------------

    def enqueue(self, kind: str, payload: dict[str, Any], *,
                dedupe_key: str | None = None, priority: int = 0,
                max_attempts: int = 3) -> str | None:
        """Returns job_id, or None when an ACTIVE (queued/running) job with
        the same dedupe key exists. A finished (done/failed) job with the
        same key does not block re-enqueue — reprocessing a document after
        completion is a supported operation (the reference's restart
        endpoints, main.py:11343)."""
        job_id = uuid.uuid4().hex
        now = time.time()
        key = dedupe_key or job_id
        with self._lock, self.conn:
            row = self.conn.execute(
                "SELECT job_id, status FROM jobs WHERE kind=? AND dedupe_key=?",
                (kind, key)).fetchone()
            if row is not None:
                if row[1] in ("queued", "running"):
                    return None
                # finished — retire the old row's key so the new one can claim it
                self.conn.execute(
                    "UPDATE jobs SET dedupe_key=job_id WHERE job_id=?", (row[0],))
            self.conn.execute(
                "INSERT INTO jobs (job_id, kind, dedupe_key, payload, "
                "priority, max_attempts, created_at, updated_at) "
                "VALUES (?,?,?,?,?,?,?,?)",
                (job_id, kind, key, json.dumps(payload), priority,
                 max_attempts, now, now),
            )
        self.emit(job_id, "enqueued", {"kind": kind})
        return job_id

    # -- consumer ---------------------------------------------------------------

    def claim(self, kind: str, worker_id: str) -> Job | None:
        """Atomic claim of the best runnable job: queued, or running with
        an expired lease (zombie)."""
        now = time.time()
        with self._lock, self.conn:  # read-then-update must be atomic across threads
            row = self.conn.execute(
                "SELECT job_id, payload, attempts, priority FROM jobs "
                "WHERE kind=? AND (status='queued' OR "
                "      (status='running' AND lease_expires < ?)) "
                "AND attempts < max_attempts "
                "ORDER BY priority DESC, created_at ASC LIMIT 1",
                (kind, now),
            ).fetchone()
            if row is None:
                return None
            job_id, payload, attempts, priority = row
            self.conn.execute(
                "UPDATE jobs SET status='running', claimed_by=?, attempts=?, "
                "lease_expires=?, updated_at=? WHERE job_id=?",
                (worker_id, attempts + 1, now + self.lease_seconds, now, job_id),
            )
        self.emit(job_id, "claimed", {"worker": worker_id, "attempt": attempts + 1})
        return Job(job_id, kind, json.loads(payload), "running", attempts + 1, priority)

    # -- worker liveness -------------------------------------------------------
    # The reference's worker HTTP shells 503 when the in-process tick is
    # stale >120s so the platform replaces the instance
    # (worker_server_chunking.py:8-35). Here liveness ALSO lands in the
    # shared queue DB so the API process's /health/deep sees the whole
    # worker fleet, not just itself.

    # a worker silent this long is treated as decommissioned, not stale
    WORKER_EXPIRY_S = 3600.0

    def worker_tick(self, worker_id: str, kind: str) -> None:
        """Record a liveness heartbeat for a worker process (called once
        per poll loop, independent of any claimed job)."""
        with self._lock:
            self.conn.execute(
                "INSERT INTO worker_ticks (worker_id, kind, last_tick) "
                "VALUES (?,?,?) ON CONFLICT(worker_id) DO UPDATE SET "
                "kind=excluded.kind, last_tick=excluded.last_tick",
                (worker_id, kind, time.time()))
            self.conn.commit()

    def worker_liveness(self, stale_after_s: float = 120.0) -> dict[str, Any]:
        """Fleet liveness: every worker seen within WORKER_EXPIRY_S, with
        tick age and staleness. `ok` is False when ANY active worker's
        newest tick is stale (the /health/deep 503 trigger)."""
        now = time.time()
        with self._lock:
            rows = self.conn.execute(
                "SELECT worker_id, kind, last_tick FROM worker_ticks "
                "WHERE last_tick > ?", (now - self.WORKER_EXPIRY_S,)).fetchall()
        workers = {
            wid: {"kind": kind, "tick_age_s": round(now - t, 1),
                  "stale": (now - t) > stale_after_s}
            for wid, kind, t in rows
        }
        return {"ok": not any(w["stale"] for w in workers.values()),
                "workers": workers}

    def deregister_worker(self, worker_id: str) -> None:
        """Graceful-shutdown path: a worker that exits cleanly removes its
        tick so it never reads as stale."""
        with self._lock:
            self.conn.execute("DELETE FROM worker_ticks WHERE worker_id=?",
                              (worker_id,))
            self.conn.commit()

    def heartbeat(self, job_id: str) -> None:
        with self._lock:
            self.conn.execute(
                "UPDATE jobs SET lease_expires=?, updated_at=? WHERE job_id=?",
                (time.time() + self.lease_seconds, time.time(), job_id))
            self.conn.commit()

    def complete(self, job_id: str, result: dict[str, Any] | None = None) -> None:
        with self._lock:
            self.conn.execute(
                "UPDATE jobs SET status='done', updated_at=? WHERE job_id=?",
                (time.time(), job_id))
            self.conn.commit()
        self.emit(job_id, "done", result or {})

    def fail(self, job_id: str, error: str, *, retry: bool = True) -> None:
        """Failed attempt: requeue (until max_attempts) or park as failed."""
        with self._lock:
            row = self.conn.execute(
                "SELECT attempts, max_attempts FROM jobs WHERE job_id=?", (job_id,)
            ).fetchone()
            status = "queued" if (retry and row and row[0] < row[1]) else "failed"
            self.conn.execute(
                "UPDATE jobs SET status=?, error=?, updated_at=? WHERE job_id=?",
                (status, error[:2000], time.time(), job_id))
            self.conn.commit()
        self.emit(job_id, "failed" if status == "failed" else "requeued",
                  {"error": error[:500]})

    # -- partial results (mid-job resume) -----------------------------------

    def save_partial(self, job_id: str, part_key: str, payload: dict[str, Any]) -> None:
        """Persist a per-unit partial result so a re-claimed job resumes
        instead of redoing expensive work (the reference's paragraph-skip
        resume, worker/coordinator.py:235-239)."""
        with self._lock:
            self.conn.execute(
                "INSERT OR REPLACE INTO job_partials VALUES (?,?,?,?)",
                (job_id, part_key, json.dumps(payload), time.time()))
            self.conn.commit()

    def partials(self, job_id: str) -> dict[str, dict[str, Any]]:
        with self._lock:
            rows = self.conn.execute(
                "SELECT part_key, payload FROM job_partials WHERE job_id=?",
                (job_id,)).fetchall()
        return {k: json.loads(p) for k, p in rows}

    def clear_partials(self, job_id: str) -> None:
        with self._lock:
            self.conn.execute("DELETE FROM job_partials WHERE job_id=?", (job_id,))
            self.conn.commit()

    # -- observability --------------------------------------------------------------

    def emit(self, job_id: str, stage: str, payload: dict[str, Any]) -> None:
        with self._lock:
            self.conn.execute(
                "INSERT INTO job_events (job_id, stage, payload, ts) VALUES (?,?,?,?)",
                (job_id, stage, json.dumps(payload), time.time()))
            self.conn.commit()

    def events(self, job_id: str) -> list[dict[str, Any]]:
        with self._lock:
            rows = self.conn.execute(
                "SELECT stage, payload, ts FROM job_events WHERE job_id=? "
                "ORDER BY event_id", (job_id,)).fetchall()
        return [{"stage": s, "ts": t, **json.loads(p)} for s, p, t in rows]

    def job(self, job_id: str) -> dict[str, Any] | None:
        with self._lock:
            row = self.conn.execute(
                "SELECT kind, status, attempts, error, payload FROM jobs WHERE job_id=?",
                (job_id,)).fetchone()
        if row is None:
            return None
        return {"job_id": job_id, "kind": row[0], "status": row[1],
                "attempts": row[2], "error": row[3], "payload": json.loads(row[4])}

    def jobs_for_doc(self, doc_id: str) -> list[dict[str, Any]]:
        """All jobs whose payload targets this document, newest first —
        the per-document status feed (the reference's
        /documents/{id}/chunking/status + /embedding surfaces)."""
        with self._lock:
            rows = self.conn.execute(
                "SELECT job_id, kind, status, attempts, error, created_at "
                "FROM jobs WHERE payload LIKE ? ORDER BY created_at DESC",
                (f'%"doc_id": "{doc_id}"%',)).fetchall()
        return [{"job_id": r[0], "kind": r[1], "status": r[2],
                 "attempts": r[3], "error": r[4], "created_at": r[5]}
                for r in rows]

    def jobs_by_status(self, status: str, *, kind: str | None = None,
                       limit: int = 500) -> list[dict[str, Any]]:
        """Jobs in one state, oldest first — the pending-triage surface
        behind the reference's block_junk/block_old_pending admin ops."""
        sql = ("SELECT job_id, kind, status, payload, attempts, error, "
               "created_at FROM jobs WHERE status=?")
        args: list[Any] = [status]
        if kind:
            sql += " AND kind=?"
            args.append(kind)
        sql += " ORDER BY created_at ASC LIMIT ?"
        args.append(limit)
        with self._lock:
            rows = self.conn.execute(sql, args).fetchall()
        return [{"job_id": r[0], "kind": r[1], "status": r[2],
                 "payload": json.loads(r[3]), "attempts": r[4],
                 "error": r[5], "created_at": r[6]} for r in rows]

    def retry_job(self, job_id: str) -> bool:
        """Re-queue a failed job with a fresh attempt budget (the
        reference's /documents/{id}/retry)."""
        with self._lock, self.conn:
            cur = self.conn.execute(
                "UPDATE jobs SET status='queued', attempts=0, error=NULL, "
                "updated_at=? WHERE job_id=? AND status='failed'",
                (time.time(), job_id))
        if cur.rowcount > 0:
            self.emit(job_id, "retried", {})
            return True
        return False

    def depths(self) -> dict[str, dict[str, int]]:
        """Queue depths by kind × status (the pipeline_health feed)."""
        with self._lock:
            rows = self.conn.execute(
                "SELECT kind, status, COUNT(*) FROM jobs GROUP BY kind, status"
            ).fetchall()
        out: dict[str, dict[str, int]] = {}
        for kind, status, n in rows:
            out.setdefault(kind, {})[status] = n
        return out

    def cleanup_stale(self, older_than_s: float = 3600.0) -> int:
        """Park running jobs whose lease expired long ago and are out of
        attempts (fail_stale_jobs_for_cleanup parity)."""
        cutoff = time.time() - older_than_s
        with self._lock:
            cur = self.conn.execute(
                "UPDATE jobs SET status='failed', error='stale lease cleanup' "
                "WHERE status='running' AND lease_expires < ? AND attempts >= max_attempts",
                (cutoff,))
            self.conn.commit()
            return cur.rowcount
