"""Lexicon-candidate curation store.

Reference parity (policy_lexicon_candidates + catalog tables and the
candidate-review endpoints, main.py:8619-10448): Path-B mines n-gram /
abbreviation candidates per paragraph; curators review them and promote
the good ones into the live lexicon (which the retag sweep then applies
corpus-wide).

Ported from ``mobius_rag_tpu.candidates`` with the port's imports.
"""
from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from typing import Any

from mobius_rag_tpu_torch.config import get_config


class CandidateStore:
    def __init__(self, path: str | None = None):
        base = path or os.path.join(get_config().data_dir, "candidates.sqlite")
        os.makedirs(os.path.dirname(base), exist_ok=True)
        self.conn = sqlite3.connect(base, check_same_thread=False)
        self._lock = threading.Lock()
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS candidates ("
            "phrase TEXT PRIMARY KEY, kind_hint TEXT, expansion TEXT,"
            "occurrences INTEGER DEFAULT 0, docs TEXT,"
            "status TEXT DEFAULT 'pending',"  # pending | approved | rejected
            "promoted_code TEXT, first_seen REAL, updated_at REAL)")

    def record(self, candidates: list[dict[str, Any]], doc_id: str = "") -> int:
        now = time.time()
        n = 0
        with self._lock:
            for c in candidates:
                phrase = c.get("phrase", "").strip().lower()
                if not phrase:
                    continue
                row = self.conn.execute(
                    "SELECT occurrences, docs FROM candidates WHERE phrase=?",
                    (phrase,)).fetchone()
                if row:
                    docs = set(json.loads(row[1] or "[]"))
                    if doc_id:
                        docs.add(doc_id)
                    self.conn.execute(
                        "UPDATE candidates SET occurrences=?, docs=?, updated_at=? "
                        "WHERE phrase=?",
                        (row[0] + int(c.get("count", 1)), json.dumps(sorted(docs)),
                         now, phrase))
                else:
                    self.conn.execute(
                        "INSERT INTO candidates VALUES (?,?,?,?,?,?,?,?,?)",
                        (phrase, c.get("kind_hint", "ngram"),
                         c.get("expansion") or "", int(c.get("count", 1)),
                         json.dumps([doc_id] if doc_id else []),
                         "pending", "", now, now))
                n += 1
            self.conn.commit()
        return n

    def pending(self, *, min_occurrences: int = 2, limit: int = 100) -> list[dict]:
        with self._lock:
            rows = self.conn.execute(
                "SELECT phrase, kind_hint, expansion, occurrences, docs FROM candidates "
                "WHERE status='pending' AND occurrences >= ? "
                "ORDER BY occurrences DESC LIMIT ?",
                (min_occurrences, limit)).fetchall()
        return [{"phrase": r[0], "kind_hint": r[1], "expansion": r[2],
                 "occurrences": r[3], "docs": json.loads(r[4] or "[]")}
                for r in rows]

    def aggregate(self, *, status: str | None = None,
                  limit: int = 500) -> list[dict[str, Any]]:
        """Corpus-wide candidate rollup (reference
        GET /policy/candidates/aggregate): every phrase with its doc
        spread, newest-updated first."""
        sql = ("SELECT phrase, kind_hint, expansion, occurrences, docs, "
               "status, promoted_code FROM candidates")
        args: list[Any] = []
        if status:
            sql += " WHERE status=?"
            args.append(status)
        sql += " ORDER BY updated_at DESC LIMIT ?"
        args.append(limit)
        with self._lock:
            rows = self.conn.execute(sql, args).fetchall()
        return [{"phrase": r[0], "kind_hint": r[1], "expansion": r[2],
                 "occurrences": r[3], "docs": json.loads(r[4] or "[]"),
                 "n_docs": len(json.loads(r[4] or "[]")),
                 "status": r[5], "promoted_code": r[6]} for r in rows]

    def for_doc(self, doc_id: str, *, limit: int = 200) -> list[dict[str, Any]]:
        """Candidates mined from one document (reference
        GET /documents/{id}/policy/candidates)."""
        with self._lock:
            rows = self.conn.execute(
                "SELECT phrase, kind_hint, occurrences, docs, status "
                "FROM candidates WHERE docs LIKE ? "
                "ORDER BY occurrences DESC LIMIT ?",
                (f'%"{doc_id}"%', limit)).fetchall()
        return [{"phrase": r[0], "kind_hint": r[1], "occurrences": r[2],
                 "status": r[4]} for r in rows
                if doc_id in json.loads(r[3] or "[]")]

    def review(self, phrase: str, *, approve: bool, lexicon=None,
               kind: str = "d", code: str = "") -> dict[str, Any]:
        """Approve (optionally promoting straight into the live lexicon)
        or reject a candidate."""
        phrase = phrase.strip().lower()
        promoted = ""
        if approve and lexicon is not None:
            from mobius_rag_tpu_torch.query.lexicon import LexiconEntry

            code = code or f"curated.{phrase.replace(' ', '_')[:40]}"
            entry = lexicon.add_entry(LexiconEntry(kind=kind, code=code,
                                                   phrases=[phrase]))
            promoted = entry.full_code
        with self._lock:
            cur = self.conn.execute(
                "UPDATE candidates SET status=?, promoted_code=?, updated_at=? "
                "WHERE phrase=?",
                ("approved" if approve else "rejected", promoted, time.time(),
                 phrase))
            self.conn.commit()
        return {"phrase": phrase, "found": cur.rowcount > 0,
                "status": "approved" if approve else "rejected",
                "promoted_code": promoted}
