"""Curator: discovered-source registry + URL classifier (the port of
``mobius_rag_tpu.curator``).

Reference parity (app/curator/{routes,service,classifier}.py, 1.2k LoC):
a registry of discovered external sources (payer manuals, state policy
pages) with upsert/bulk/search/curate/stats/mark-ingested operations and
a URL classifier inferring payer + authority from the domain/path.
Network probes (robots/sitemap) are a pluggable hook — offline pods
skip them.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import sqlite3
import time
import uuid
from typing import Any, Callable
from urllib.parse import urlparse

from mobius_rag_tpu_torch.config import get_config

# Domain → (payer, authority 0-4). Authority mirrors the reference's
# scale: state agency 4, payer official 3, aggregator 1.
_DOMAIN_RULES: list[tuple[re.Pattern, str, int]] = [
    (re.compile(r"(^|\.)sunshinehealth\.com$"), "sunshine_health", 3),
    (re.compile(r"(^|\.)aetnabetterhealth\.com$"), "aetna", 3),
    (re.compile(r"(^|\.)aetna\.com$"), "aetna", 3),
    (re.compile(r"(^|\.)molinahealthcare\.com$"), "molina", 3),
    (re.compile(r"(^|\.)ahca\.myflorida\.com$"), "ahca", 4),
    (re.compile(r"(^|\.)myflorida\.com$"), "", 4),
    (re.compile(r"(^|\.)medicaid\.gov$"), "", 4),
    (re.compile(r"(^|\.)cms\.gov$"), "", 4),
]

_MANUALISH_PATH = re.compile(
    r"(provider.?(manual|handbook|guide)|billing.?(manual|guide)|"
    r"policy|prior.?auth|formulary|pdl)", re.IGNORECASE)


def classify_url(url: str) -> dict[str, Any]:
    """Infer payer/authority/document-likeness from a URL
    (curator/classifier.py:94-122 semantics)."""
    try:
        parsed = urlparse(url if "://" in url else f"https://{url}")
    except ValueError:
        return {"payer": "", "authority_level": 0, "looks_like_manual": False,
                "kind": "unknown"}
    host = (parsed.hostname or "").lower()
    payer, authority = "", 1
    for pat, p, a in _DOMAIN_RULES:
        if pat.search(host):
            payer, authority = p, a
            break
    path = parsed.path or ""
    manual = bool(_MANUALISH_PATH.search(path)) or path.lower().endswith(".pdf")
    kind = "manual" if manual else ("portal" if payer else "unknown")
    return {"payer": payer, "authority_level": authority,
            "looks_like_manual": manual, "kind": kind, "host": host}


@dataclasses.dataclass
class Source:
    source_id: str
    url: str
    payer: str = ""
    authority_level: int = 0
    kind: str = "unknown"
    status: str = "discovered"  # discovered | curated | rejected | ingested
    title: str = ""
    notes: str = ""
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)


class Curator:
    def __init__(self, path: str | None = None,
                 probe_fn: Callable[[str], dict[str, Any]] | None = None):
        base = path or os.path.join(get_config().data_dir, "curator.sqlite")
        os.makedirs(os.path.dirname(base), exist_ok=True)
        self.conn = sqlite3.connect(base)
        self.conn.execute(
            "CREATE TABLE IF NOT EXISTS sources ("
            "source_id TEXT PRIMARY KEY, url TEXT UNIQUE, payer TEXT,"
            "authority_level INTEGER, kind TEXT, status TEXT, title TEXT,"
            "notes TEXT, meta TEXT, created_at REAL, updated_at REAL)")
        self.probe_fn = probe_fn  # robots/sitemap prober; None offline

    def upsert(self, url: str, **fields: Any) -> Source:
        cls = classify_url(url)
        now = time.time()
        row = self.conn.execute(
            "SELECT source_id, payer, authority_level, kind, status, title, "
            "notes, meta FROM sources WHERE url=?", (url,)).fetchone()
        if row:
            src = Source(row[0], url, row[1], row[2], row[3], row[4], row[5],
                         row[6], json.loads(row[7] or "{}"))
        else:
            src = Source(uuid.uuid4().hex[:12], url, cls["payer"],
                         cls["authority_level"], cls["kind"])
        for k, v in fields.items():
            if hasattr(src, k) and v is not None:
                setattr(src, k, v)
        self.conn.execute(
            "INSERT INTO sources VALUES (?,?,?,?,?,?,?,?,?,?,?) "
            "ON CONFLICT(url) DO UPDATE SET payer=excluded.payer,"
            "authority_level=excluded.authority_level, kind=excluded.kind,"
            "status=excluded.status, title=excluded.title, notes=excluded.notes,"
            "meta=excluded.meta, updated_at=excluded.updated_at",
            (src.source_id, url, src.payer, src.authority_level, src.kind,
             src.status, src.title, src.notes, json.dumps(src.meta), now, now))
        self.conn.commit()
        return src

    def bulk_upsert(self, urls: list[str]) -> int:
        for u in urls:
            self.upsert(u)
        return len(urls)

    def curate(self, url: str, *, approve: bool, notes: str = "") -> Source:
        return self.upsert(url, status="curated" if approve else "rejected",
                           notes=notes)

    def mark_ingested(self, url: str, doc_id: str) -> Source:
        src = self.upsert(url, status="ingested")
        src.meta["doc_id"] = doc_id
        return self.upsert(url, status="ingested", meta=src.meta)

    def search(self, *, payer: str = "", status: str = "", q: str = "",
               limit: int = 100) -> list[Source]:
        sql = "SELECT source_id, url, payer, authority_level, kind, status, title, notes, meta FROM sources WHERE 1=1"
        args: list[Any] = []
        if payer:
            sql += " AND payer=?"
            args.append(payer)
        if status:
            sql += " AND status=?"
            args.append(status)
        if q:
            sql += " AND url LIKE ?"
            args.append(f"%{q}%")
        sql += " ORDER BY authority_level DESC, updated_at DESC LIMIT ?"
        args.append(limit)
        return [Source(r[0], r[1], r[2], r[3], r[4], r[5], r[6], r[7],
                       json.loads(r[8] or "{}"))
                for r in self.conn.execute(sql, args).fetchall()]

    def stats(self) -> dict[str, Any]:
        rows = self.conn.execute(
            "SELECT status, COUNT(*) FROM sources GROUP BY status").fetchall()
        by_payer = self.conn.execute(
            "SELECT payer, COUNT(*) FROM sources WHERE payer != '' GROUP BY payer"
        ).fetchall()
        return {"by_status": dict(rows), "by_payer": dict(by_payer)}

    def probe(self, url: str) -> dict[str, Any]:
        """robots/sitemap probe (curator/routes.py:385) — hook-gated."""
        if self.probe_fn is None:
            return {"probed": False, "reason": "offline (no probe hook)"}
        return {"probed": True, **self.probe_fn(url)}
