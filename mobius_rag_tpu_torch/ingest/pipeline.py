"""Ingest orchestration: upload + instant pipeline.

Reference parity: POST /upload (main.py:5126 — sha256 dedupe, metadata
canonicalization, auto-enqueue chunking) and the instant path for small
documents (main.py:4993 _run_instant_pipeline: chunk → embed → publish
inline so small uploads are queryable in seconds).

Ported from ``mobius_rag_tpu.ingest.pipeline`` with the port's imports.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Any, Callable

import numpy as np

from mobius_rag_tpu_torch.clients import LLMClient
from mobius_rag_tpu_torch.index.store import ChunkStore
from mobius_rag_tpu_torch.ingest.metadata import canonicalize_metadata
from mobius_rag_tpu_torch.ingest.queue import JobQueue
from mobius_rag_tpu_torch.ingest.worker import (CHUNKING_KIND, ChunkingWorker,
                                                DocumentBlob, DocumentStore,
                                                EmbeddingWorker)
from mobius_rag_tpu_torch.query.lexicon import Lexicon

INSTANT_MAX_BYTES = 512 * 1024
UPLOAD_MAX_BYTES = 100 * 1024 * 1024  # reference's 100MB cap (main.py:5176)


@dataclasses.dataclass
class UploadResult:
    doc_id: str
    sha256: str
    deduped: bool
    chunking_job: str | None
    instant: dict[str, Any] | None = None


class IngestPipeline:
    def __init__(self, store: ChunkStore, lexicon: Lexicon,
                 embed_fn: Callable[[list[str]], np.ndarray],
                 *, queue: JobQueue | None = None,
                 docs: DocumentStore | None = None,
                 llm: LLMClient | None = None,
                 extraction_enabled: bool = False,
                 candidate_sink=None):
        self.store = store
        self.lexicon = lexicon
        self.embed_fn = embed_fn
        self.queue = queue or JobQueue()
        self.docs = docs or DocumentStore()
        self._sha_index: dict[str, str] = {}
        self.chunking_worker = ChunkingWorker(
            self.queue, self.docs, lexicon, llm=llm,
            extraction_enabled=extraction_enabled,
            candidate_sink=candidate_sink)
        self.embedding_worker = EmbeddingWorker(
            self.queue, store, lexicon, embed_fn)

    def upload(self, data: bytes, filename: str, *, payer: str = "",
               state: str = "", program: str = "", authority_level: int = 0,
               summary: str = "", instant: bool | None = None) -> UploadResult:
        if len(data) > UPLOAD_MAX_BYTES:
            raise ValueError(f"upload exceeds {UPLOAD_MAX_BYTES} bytes")
        meta = canonicalize_metadata(payer=payer, state=state, program=program)
        sha = hashlib.sha256(data).hexdigest()
        if sha in self._sha_index:
            return UploadResult(self._sha_index[sha], sha, True, None)
        doc_id = filename.rsplit(".", 1)[0].replace(" ", "_").lower() or sha[:12]
        if self.docs.get(doc_id) is not None:
            doc_id = f"{doc_id}-{sha[:8]}"
        self._sha_index[sha] = doc_id
        self.docs.put(DocumentBlob(
            doc_id=doc_id, filename=filename, data=data,
            payer=meta["payer"], state=meta["state"], program=meta["program"],
            authority_level=authority_level, summary=summary,
        ))
        job_id = self.queue.enqueue(
            CHUNKING_KIND, {"doc_id": doc_id}, dedupe_key=f"chunk-{doc_id}-{sha[:12]}")

        instant_run = None
        if instant or (instant is None and len(data) <= INSTANT_MAX_BYTES):
            instant_run = self.drain(max_jobs_per_kind=4)
        return UploadResult(doc_id, sha, False, job_id, instant_run)

    def drain(self, *, max_jobs_per_kind: int = 100) -> dict[str, int]:
        """Run both workers inline until their queues are empty — the
        instant pipeline / test harness path."""
        chunked = self.chunking_worker.run_loop(max_jobs=max_jobs_per_kind)
        embedded = self.embedding_worker.run_loop(max_jobs=max_jobs_per_kind)
        return {"chunking_jobs": chunked, "embedding_jobs": embedded}
