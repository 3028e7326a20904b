"""Eval persistence: sqlite instead of the reference's Postgres pool
(eval/db.py) — durable runs/results with idempotent client-generated-id
inserts (the reference's ON CONFLICT DO NOTHING discipline,
eval/run.py:206-215).

Ported from ``mobius_rag_tpu.eval_harness.db`` with the port's imports.
"""
from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
import uuid
from typing import Any

from mobius_rag_tpu_torch.config import get_config

_SCHEMA = """
CREATE TABLE IF NOT EXISTS eval_runs (
  run_id TEXT PRIMARY KEY,
  bank_name TEXT, bank_version TEXT, bank_sha TEXT,
  started_at REAL, finished_at REAL,
  fingerprint TEXT, aggregates TEXT
);
CREATE TABLE IF NOT EXISTS eval_results (
  result_id TEXT PRIMARY KEY,
  run_id TEXT, query_id TEXT, payload TEXT,
  UNIQUE(run_id, query_id) ON CONFLICT IGNORE
);
CREATE TABLE IF NOT EXISTS calibration_runs (
  calib_id TEXT PRIMARY KEY,
  created_at REAL, fingerprint TEXT, matrix TEXT
);
"""


class EvalDB:
    def __init__(self, path: str | None = None):
        base = path or os.path.join(get_config().data_dir, "eval.sqlite")
        os.makedirs(os.path.dirname(base), exist_ok=True)
        # cross-thread use (API handlers + nightly daemon thread) is
        # coarse-grained — serialize through one lock
        self.conn = sqlite3.connect(base, check_same_thread=False)
        self._lock = threading.Lock()
        self.conn.executescript(_SCHEMA)

    def _execute(self, sql: str, args: tuple = ()):
        with self._lock:
            cur = self.conn.execute(sql, args)
            self.conn.commit()
            return cur

    def _fetchall(self, sql: str, args: tuple = ()):
        with self._lock:
            return self.conn.execute(sql, args).fetchall()

    def insert_run(self, bank, fingerprint: dict[str, Any]) -> str:
        run_id = uuid.uuid4().hex
        self._execute(
            "INSERT INTO eval_runs (run_id, bank_name, bank_version, bank_sha, "
            "started_at, fingerprint) VALUES (?,?,?,?,?,?)",
            (run_id, bank.name, bank.version, bank.sha, time.time(),
             json.dumps(fingerprint)),
        )
        return run_id

    def insert_result(self, run_id: str, query_id: str, payload: dict[str, Any]) -> None:
        self._execute(
            "INSERT OR IGNORE INTO eval_results (result_id, run_id, query_id, payload) "
            "VALUES (?,?,?,?)",
            (uuid.uuid4().hex, run_id, query_id, json.dumps(payload)),
        )

    def finalize_run(self, run_id: str, aggregates: dict[str, Any]) -> None:
        self._execute(
            "UPDATE eval_runs SET finished_at=?, aggregates=? WHERE run_id=?",
            (time.time(), json.dumps(aggregates), run_id),
        )

    def insert_calibration(self, fingerprint: dict[str, Any], matrix: dict[str, Any]) -> str:
        cid = uuid.uuid4().hex
        self._execute(
            "INSERT INTO calibration_runs (calib_id, created_at, fingerprint, matrix) "
            "VALUES (?,?,?,?)",
            (cid, time.time(), json.dumps(fingerprint), json.dumps(matrix)),
        )
        return cid

    def run(self, run_id: str) -> dict[str, Any] | None:
        rows = self._fetchall(
            "SELECT bank_name, bank_version, bank_sha, fingerprint, aggregates "
            "FROM eval_runs WHERE run_id=?", (run_id,))
        row = rows[0] if rows else None
        if not row:
            return None
        return {
            "bank_name": row[0], "bank_version": row[1], "bank_sha": row[2],
            "fingerprint": json.loads(row[3] or "{}"),
            "aggregates": json.loads(row[4] or "{}"),
        }

    def results(self, run_id: str) -> list[dict[str, Any]]:
        rows = self._fetchall(
            "SELECT query_id, payload FROM eval_results WHERE run_id=?", (run_id,))
        out = []
        for q, p in rows:
            d = {"query_id": q, **json.loads(p)}
            # effective verdict = human override when present (the
            # reference's COALESCE(human_verdict, judge_verdict))
            d["effective_verdict"] = d.get("human_verdict") or d.get("judge_verdict")
            out.append(d)
        return out

    def patch_verdict(self, run_id: str, query_id: str, verdict: str | None,
                      reasoning: str = "", by: str = "") -> dict[str, Any] | None:
        """Human-verdict override (routers/eval.py:1151 PATCH semantics):
        set verdict to correct|partial|incorrect, or None to clear the
        override. Idempotent — re-PATCH overwrites."""
        rows = self._fetchall(
            "SELECT payload FROM eval_results WHERE run_id=? AND query_id=?",
            (run_id, query_id))
        if not rows:
            return None
        payload = json.loads(rows[0][0])
        if verdict is None:
            for key in ("human_verdict", "human_reasoning", "human_verdict_at",
                        "human_verdict_by"):
                payload.pop(key, None)
        else:
            payload["human_verdict"] = verdict
            payload["human_reasoning"] = reasoning
            payload["human_verdict_at"] = time.time()
            payload["human_verdict_by"] = by
        self._execute(
            "UPDATE eval_results SET payload=? WHERE run_id=? AND query_id=?",
            (json.dumps(payload), run_id, query_id))
        payload["effective_verdict"] = payload.get("human_verdict") \
            or payload.get("judge_verdict")
        return {"query_id": query_id, **payload}

    def list_runs(self, limit: int = 50) -> list[dict[str, Any]]:
        rows = self._fetchall(
            "SELECT run_id, bank_name, bank_version, started_at, finished_at, aggregates "
            "FROM eval_runs ORDER BY started_at DESC LIMIT ?", (limit,))
        return [
            {"run_id": r[0], "bank_name": r[1], "bank_version": r[2],
             "started_at": r[3], "finished_at": r[4],
             "aggregates": json.loads(r[5] or "{}")}
            for r in rows
        ]
