"""Ingest workers: chunking and embedding.

Reference parity:
- ChunkingWorker ≙ app/worker/main.py + coordinator.py: claim a
  chunking job, extract pages, chunk to paragraphs, run Path B (and
  Path A when an LLM is attached), build embeddable units, atomically
  finalize by enqueueing the embedding job.
- EmbeddingWorker ≙ app/embedding_worker.py: claim an embedding job,
  diff already-embedded source_ids (incremental resume, :187-203),
  encode the missing tail in batches on the card (batch 128 vs the
  reference's 50-with-1-per-request Vertex ceiling), featurize, publish
  into the ChunkStore (DELETE+INSERT per document), emit progress
  events per batch.

Both loops are SIGTERM-aware (finish in-flight job, then exit) and
heartbeat their lease mid-job so long documents don't get zombie-
reclaimed while alive.

Ported from ``mobius_rag_tpu.ingest.worker`` with the port's imports.
"""
from __future__ import annotations

import dataclasses
import os
import time
import uuid
from typing import Any, Callable

import numpy as np

from mobius_rag_tpu_torch.clients import LLMClient
from mobius_rag_tpu_torch.config import get_config
from mobius_rag_tpu_torch.index.store import ChunkRecord, ChunkStore
from mobius_rag_tpu_torch.ingest import shutdown
from mobius_rag_tpu_torch.ingest.chunking import chunk_pages
from mobius_rag_tpu_torch.ingest.extract import extract_text_from_bytes
from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk
from mobius_rag_tpu_torch.ingest.paths import aggregate_document_tags, run_path_a, run_path_b
from mobius_rag_tpu_torch.ingest.queue import Job, JobQueue
from mobius_rag_tpu_torch.observability import PROGRESS
from mobius_rag_tpu_torch.query.lexicon import Lexicon

EMBED_BATCH = 128

CHUNKING_KIND = "chunking"
EMBEDDING_KIND = "embedding"


@dataclasses.dataclass
class DocumentBlob:
    """Host-side document registry entry (the Documents table's role)."""

    doc_id: str
    filename: str
    data: bytes
    payer: str = ""
    state: str = ""
    program: str = ""
    authority_level: int = 0
    summary: str = ""


class DocumentStore:
    """In-memory registry of uploaded originals (GCS's role in the
    reference). Pluggable: anything with get/put."""

    def __init__(self):
        self.docs: dict[str, DocumentBlob] = {}

    def put(self, blob: DocumentBlob) -> None:
        self.docs[blob.doc_id] = blob

    def get(self, doc_id: str) -> DocumentBlob | None:
        return self.docs.get(doc_id)

    def delete(self, doc_id: str) -> bool:
        return self.docs.pop(doc_id, None) is not None

    def mtime(self, doc_id: str) -> float | None:
        """Upload timestamp where the backing store records one (file
        store: blob mtime). None = unknown — TTL sweeps skip the doc."""
        return None


class FileDocumentStore(DocumentStore):
    """Durable blob store: originals + metadata persist under a
    directory (the GCS-bucket role, reference main.py /upload GCS write).
    Blobs survive process restarts; the in-memory map is a read cache
    rebuilt lazily from disk."""

    def __init__(self, root: str | None = None):
        import json

        from mobius_rag_tpu_torch.config import get_config

        super().__init__()
        self.root = root or os.path.join(get_config().data_dir, "documents")
        os.makedirs(self.root, exist_ok=True)
        self._json = json
        for name in os.listdir(self.root):
            if name.endswith(".meta.json"):
                with open(os.path.join(self.root, name)) as f:
                    meta = json.load(f)
                blob_path = os.path.join(self.root, meta["doc_id"] + ".bin")
                if os.path.exists(blob_path):
                    with open(blob_path, "rb") as f:
                        data = f.read()
                    self.docs[meta["doc_id"]] = DocumentBlob(data=data, **{
                        k: meta[k] for k in ("doc_id", "filename", "payer",
                                             "state", "program",
                                             "authority_level", "summary")})

    def put(self, blob: DocumentBlob) -> None:
        super().put(blob)
        safe = blob.doc_id.replace("/", "_")
        with open(os.path.join(self.root, safe + ".bin"), "wb") as f:
            f.write(blob.data)
        meta = {k: getattr(blob, k) for k in
                ("doc_id", "filename", "payer", "state", "program",
                 "authority_level", "summary")}
        tmp = os.path.join(self.root, safe + ".meta.json.tmp")
        with open(tmp, "w") as f:
            self._json.dump(meta, f)
        os.replace(tmp, os.path.join(self.root, safe + ".meta.json"))

    def delete(self, doc_id: str) -> bool:
        found = super().delete(doc_id)
        safe = doc_id.replace("/", "_")
        for suffix in (".bin", ".meta.json"):
            path = os.path.join(self.root, safe + suffix)
            if os.path.exists(path):
                os.remove(path)
                found = True
        return found

    def mtime(self, doc_id: str) -> float | None:
        path = os.path.join(self.root, doc_id.replace("/", "_") + ".bin")
        return os.path.getmtime(path) if os.path.exists(path) else None


class ChunkingWorker:
    def __init__(self, queue: JobQueue, docs: DocumentStore, lexicon: Lexicon,
                 *, llm: LLMClient | None = None, extraction_enabled: bool = False,
                 worker_id: str | None = None, candidate_sink=None):
        self.queue = queue
        self.docs = docs
        self.lexicon = lexicon
        self.llm = llm
        self.extraction_enabled = extraction_enabled and llm is not None
        self.worker_id = worker_id or f"chunk-{uuid.uuid4().hex[:8]}"
        # callable(candidates: list[dict], doc_id: str) — lexicon-candidate
        # curation feed (candidates.CandidateStore.record)
        self.candidate_sink = candidate_sink

    def process_job(self, job: Job) -> dict[str, Any]:
        doc_id = job.payload["doc_id"]
        blob = self.docs.get(doc_id)
        if blob is None:
            raise ValueError(f"document {doc_id!r} not found")
        extracted = extract_text_from_bytes(blob.data, blob.filename)
        self.queue.emit(job.job_id, "extracted",
                        {"pages": len(extracted.pages), "kind": extracted.kind})
        PROGRESS.emit(doc_id, "extracted", pages=len(extracted.pages))

        paragraphs = chunk_pages([(p.number, p.text) for p in extracted.pages])
        # mid-job resume: a re-claimed job (lease expiry / retry) skips
        # paragraphs whose partial results already persisted
        # (coordinator.py:235-239 paragraph-skip semantics)
        done = self.queue.partials(job.job_id)
        resumed = 0
        units: list[dict[str, Any]] = []
        per_para_tags: list[dict[str, list[int]]] = []
        n_facts = 0
        for i, para in enumerate(paragraphs):
            key = f"p{para.paragraph_index}"
            if key in done:
                part = done[key]
                units.extend(part["units"])
                per_para_tags.append(part["tags"])
                n_facts += part.get("n_facts", 0)
                resumed += 1
                continue
            pb = run_path_b(para.text, self.lexicon)
            per_para_tags.append(pb.paragraph_tags)
            if self.candidate_sink is not None and pb.candidates:
                try:
                    self.candidate_sink(pb.candidates, doc_id)
                except Exception:  # curation feed is best-effort
                    pass
            para_units: list[dict[str, Any]] = []
            unit = {
                "source_id": f"{doc_id}-p{para.paragraph_index}",
                "kind": "paragraph",
                "text": para.text,
                "section_path": para.section_path,
                "page": para.page,
                "j_tags": pb.paragraph_tags["j"],
                "d_tags": pb.paragraph_tags["d"],
                "p_tags": pb.paragraph_tags["p"],
                "candidates": pb.candidates,
            }
            para_facts = 0
            if self.extraction_enabled:
                facts = run_path_a(para.text, self.llm)
                para_facts = len(facts)
                n_facts += para_facts
                unit["facts"] = [dataclasses.asdict(f) for f in facts]
                # each fact is its own embeddable unit (embeddable_units
                # single-embed contract, models.py:283)
                for fi, f in enumerate(facts):
                    para_units.append({
                        "source_id": f"{doc_id}-p{para.paragraph_index}-f{fi}",
                        "kind": "fact", "text": f.text,
                        "section_path": para.section_path, "page": para.page,
                        "j_tags": pb.paragraph_tags["j"],
                        "d_tags": pb.paragraph_tags["d"],
                        "p_tags": pb.paragraph_tags["p"],
                        "critique_score": f.critique_score,
                    })
            para_units.append(unit)
            units.extend(para_units)
            self.queue.save_partial(job.job_id, key, {
                "units": para_units, "tags": pb.paragraph_tags,
                "n_facts": para_facts,
            })
            if i % 50 == 0:
                self.queue.heartbeat(job.job_id)
                self.queue.emit(job.job_id, "progress",
                                {"paragraphs": i + 1, "of": len(paragraphs)})
        if resumed:
            self.queue.emit(job.job_id, "resumed", {"paragraphs_skipped": resumed})

        doc_tags = aggregate_document_tags(per_para_tags)
        # atomic finalize: chunking result persists by enqueueing the
        # embedding job in the same logical step (worker/main.py:54)
        embed_job = self.queue.enqueue(
            EMBEDDING_KIND,
            {"doc_id": doc_id, "units": units, "doc_tags": doc_tags,
             "meta": {"filename": blob.filename, "payer": blob.payer,
                      "state": blob.state, "program": blob.program,
                      "authority_level": blob.authority_level,
                      "summary": blob.summary}},
            dedupe_key=f"embed-{doc_id}-{job.job_id}",
        )
        self.queue.clear_partials(job.job_id)
        return {"paragraphs": len(paragraphs), "units": len(units),
                "facts": n_facts, "doc_tags": doc_tags,
                "resumed_paragraphs": resumed,
                "embedding_job": embed_job}

    def run_loop(self, *, poll_s: float = 0.5, max_jobs: int | None = None) -> int:
        done = 0
        while not shutdown.is_shutting_down():
            job = self.queue.claim(CHUNKING_KIND, self.worker_id)
            if job is None:
                if max_jobs is not None:
                    break
                if shutdown.sleep_or_shutdown(poll_s):
                    break
                continue
            try:
                result = self.process_job(job)
                self.queue.complete(job.job_id, result)
                done += 1
            except Exception as e:  # job-level failure → retry ladder
                self.queue.fail(job.job_id, f"{type(e).__name__}: {e}")
            if max_jobs is not None and done >= max_jobs:
                break
        return done


class EmbeddingWorker:
    def __init__(self, queue: JobQueue, store: ChunkStore, lexicon: Lexicon,
                 embed_fn: Callable[[list[str]], np.ndarray],
                 *, worker_id: str | None = None, batch_size: int = EMBED_BATCH):
        self.queue = queue
        self.store = store
        self.lexicon = lexicon
        self.embed_fn = embed_fn
        self.worker_id = worker_id or f"embed-{uuid.uuid4().hex[:8]}"
        self.batch_size = batch_size

    def process_job(self, job: Job) -> dict[str, Any]:
        cfg = get_config()
        doc_id = job.payload["doc_id"]
        units = job.payload["units"]
        meta = job.payload.get("meta", {})
        doc_tags = job.payload.get("doc_tags", {"j": [], "d": [], "p": []})

        # incremental resume: skip already-embedded units, drop orphans
        # (embedding_worker.py:187-203)
        have = self.store.embedded_source_ids(doc_id)
        wanted_ids = {u["source_id"] for u in units}
        orphans = have - wanted_ids
        todo = [u for u in units if u["source_id"] not in have]
        if orphans or (have and todo):
            # membership changed → clean republish of the document
            self.store.delete_by_document(doc_id)
            todo = units
        self.queue.emit(job.job_id, "resume_diff",
                        {"have": len(have), "todo": len(todo),
                         "orphans": len(orphans)})
        if not todo:
            return {"embedded": 0, "skipped": len(units)}

        recs: list[ChunkRecord] = []
        embedded = 0
        src = units if todo == units else todo
        for off in range(0, len(src), self.batch_size):
            batch = src[off:off + self.batch_size]
            t0 = time.perf_counter()
            vecs = self.embed_fn([u["text"] for u in batch])
            dt = time.perf_counter() - t0
            for u, v in zip(batch, vecs):
                i = u["source_id"]
                rec = ChunkRecord(
                    chunk_id=i, doc_id=doc_id, source_id=i,
                    text=u["text"], embedding=np.asarray(v, np.float32),
                    payer=meta.get("payer", ""), state=meta.get("state", ""),
                    program=meta.get("program", ""),
                    authority_level=int(meta.get("authority_level", 0)),
                    filename=meta.get("filename", ""),
                    summary=meta.get("summary", ""),
                    section_path=u.get("section_path", ""),
                    page=int(u.get("page", 0)),
                    j_tags=sorted(set(u.get("j_tags", [])) | set(doc_tags.get("j", []))),
                    d_tags=list(u.get("d_tags", [])),
                    p_tags=list(u.get("p_tags", [])),
                    # unit provenance rides along so the facts surface can
                    # find Path-A fact rows (reference reader_facts tables)
                    extra={k: u[k] for k in ("kind", "critique_score")
                           if k in u},
                )
                recs.append(featurize_chunk(rec, self.lexicon, cfg))
            embedded += len(batch)
            self.queue.heartbeat(job.job_id)
            self.queue.emit(job.job_id, "batch_embedded",
                            {"n": len(batch), "items_per_s": round(len(batch) / max(dt, 1e-6), 1),
                             "done": embedded, "of": len(src)})
            PROGRESS.emit(doc_id, "embedding", done=embedded, of=len(src))

        # neighbor enrichment for the reranker haystack
        for i, rec in enumerate(recs):
            prev_t = recs[i - 1].text if i > 0 else ""
            next_t = recs[i + 1].text if i + 1 < len(recs) else ""
            rec.neighbor_text = (prev_t + "\n" + next_t).strip()
            if rec.neighbor_text:
                featurize_chunk(rec, self.lexicon, cfg)

        if todo == units:
            rows = self.store.publish_document(doc_id, recs)
        else:
            rows = self.store.add_chunks(recs)
        PROGRESS.emit(doc_id, "done", published=len(rows))
        return {"embedded": embedded, "published_rows": len(rows)}

    def run_loop(self, *, poll_s: float = 0.5, max_jobs: int | None = None) -> int:
        done = 0
        while not shutdown.is_shutting_down():
            job = self.queue.claim(EMBEDDING_KIND, self.worker_id)
            if job is None:
                if max_jobs is not None:
                    break
                if shutdown.sleep_or_shutdown(poll_s):
                    break
                continue
            try:
                result = self.process_job(job)
                self.queue.complete(job.job_id, result)
                done += 1
            except Exception as e:
                self.queue.fail(job.job_id, f"{type(e).__name__}: {e}")
            if max_jobs is not None and done >= max_jobs:
                break
        return done
