"""Multi-tenant namespaces: per-org isolated indexes (the port of
``mobius_rag_tpu.tenancy``).

Reference parity (org-docs: per-org pgvector schema with its own
HNSW index, mounted at /admin/org-docs/*; schemas/org_docs/v1 +
main.py:13740-14196). Here a namespace is simply its own ChunkStore +
SearchEngine over the shared lexicon/encoder — device arrays are cheap
to allocate and fully isolated by construction (no cross-namespace row
can ever surface, there is no shared table to filter)."""
from __future__ import annotations

import re
import threading
from typing import Any, Callable

from mobius_rag_tpu_torch.config import Config, get_config
from mobius_rag_tpu_torch.index.store import ChunkStore
from mobius_rag_tpu_torch.query.engine import SearchEngine
from mobius_rag_tpu_torch.query.lexicon import Lexicon

_NAME_RE = re.compile(r"^[a-z0-9][a-z0-9_-]{0,62}$")


class Namespace:
    def __init__(self, name: str, store: ChunkStore, engine: SearchEngine):
        self.name = name
        self.store = store
        self.engine = engine


class NamespaceRegistry:
    def __init__(self, lexicon: Lexicon | None, embed_fn: Callable,
                 cfg: Config | None = None, *, capacity: int | None = None,
                 telemetry=None, device="cuda"):
        self.lexicon = lexicon
        self.embed_fn = embed_fn
        self.cfg = cfg or get_config()
        self.capacity = capacity
        self.telemetry = telemetry
        self.device = device
        self._spaces: dict[str, Namespace] = {}
        self._lock = threading.Lock()

    def create(self, name: str) -> Namespace:
        if not _NAME_RE.match(name):
            raise ValueError(
                f"namespace {name!r} must match {_NAME_RE.pattern}")
        with self._lock:
            if name in self._spaces:
                raise ValueError(f"namespace {name!r} already exists")
            store = ChunkStore(self.cfg, capacity=self.capacity,
                               device=self.device)
            engine = SearchEngine(store, self.lexicon, self.cfg,
                                  embed_fn=self.embed_fn,
                                  telemetry=self.telemetry, device=self.device)
            ns = Namespace(name, store, engine)
            self._spaces[name] = ns
            return ns

    def get(self, name: str) -> Namespace | None:
        return self._spaces.get(name)

    def get_or_create(self, name: str) -> Namespace:
        ns = self.get(name)
        return ns if ns is not None else self.create(name)

    def delete(self, name: str) -> bool:
        with self._lock:
            return self._spaces.pop(name, None) is not None

    def list(self) -> list[dict[str, Any]]:
        return [
            {"name": ns.name, "chunks": ns.store.size,
             "capacity": ns.store.capacity}
            for ns in self._spaces.values()
        ]
