"""Integrity report and remediation (the port of
``mobius_rag_tpu.integrity``).

Finds drift between the host record map and the device index, between
the document registry and the published rows, and between the queue and
the index, then repairs it idempotently.

Checks:
- validity drift: rows valid on the device with no host record, and the
  other way round;
- registry orphans: documents with a blob and no live chunk, and
  published chunks whose document left the registry;
- dead embeddings: live rows whose stored vector is all zero (a failed
  encode that slipped through);
- queue dirt: running jobs.

Remediation re-publishes every document from its host records (the
source of truth for text and metadata) and clears dead device rows.
Under host residency the stored vectors are the host int8 matrix's rows.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _row_norms(store, n: int) -> np.ndarray:
    """Norms of the stored vectors of rows [0, n) (the raw stored values:
    int8 rows unscaled, as the JAX package reads them)."""
    if store.index.vectors.shape[0]:
        v = store.index.vectors[:n].float()
        return torch.linalg.norm(v, dim=1).cpu().numpy()
    return np.linalg.norm(store.host_vectors[:n].astype(np.float32), axis=1)


def integrity_report(ctx) -> dict[str, Any]:
    store = ctx.store
    valid = store.index.valid.cpu().numpy() > 0
    n_rows = len(store.records)

    device_live_host_dead = [int(i) for i in np.flatnonzero(valid[:n_rows])
                             if store.records[i] is None]
    host_live_device_dead = [i for i, r in enumerate(store.records)
                             if r is not None and not bool(valid[i])]
    # rows beyond the host record map that claim validity
    tail_live = [int(i) for i in np.flatnonzero(valid[n_rows:]) + n_rows]

    vec_norms = _row_norms(store, max(n_rows, 1))
    zero_vec_rows = [i for i, r in enumerate(store.records)
                     if r is not None and bool(valid[i]) and vec_norms[i] < 1e-6]

    doc_ids_with_chunks = {r.doc_id for r in store.records if r is not None}
    registry_docs = set(ctx.pipeline.docs.docs) if ctx.pipeline else set()
    docs_without_chunks = sorted(registry_docs - doc_ids_with_chunks)
    chunks_without_doc = sorted(doc_ids_with_chunks - registry_docs) if registry_docs else []

    stale_running = 0
    if ctx.pipeline:
        depths = ctx.pipeline.queue.depths()
        stale_running = sum(v.get("running", 0) for v in depths.values())

    issues = (len(device_live_host_dead) + len(host_live_device_dead)
              + len(tail_live) + len(zero_vec_rows))
    return {
        "ok": issues == 0,
        "device_live_host_dead": device_live_host_dead[:50],
        "host_live_device_dead": host_live_device_dead[:50],
        "tail_live_rows": tail_live[:50],
        "zero_vector_rows": zero_vec_rows[:50],
        "docs_without_chunks": docs_without_chunks[:50],
        "chunks_without_registry_doc": chunks_without_doc[:50],
        "running_jobs": stale_running,
        "counts": {
            "host_records": sum(1 for r in store.records if r is not None),
            "device_valid": int(valid.sum()),
        },
    }


def integrity_remediate(ctx) -> dict[str, Any]:
    """Idempotent repair: re-publish every document from its host records
    (embeddings taken from the records), dropping records whose embedding
    is dead, then invalidate device rows with no host record."""
    store = ctx.store
    report_before = integrity_report(ctx)
    by_doc: dict[str, list] = {}
    for rec in store.records:
        if rec is not None:
            by_doc.setdefault(rec.doc_id, []).append(rec)
    republished = 0
    dropped_docs = []
    for doc_id, recs in by_doc.items():
        # records with dead embeddings need a re-embed pass
        good = [r for r in recs if np.linalg.norm(np.asarray(r.embedding, np.float32)) > 1e-6]
        if good:
            store.publish_document(doc_id, good)
            republished += len(good)
        else:
            store.delete_by_document(doc_id)
            dropped_docs.append(doc_id)
    # ghosts: valid device rows with no host record (delete_by_document
    # cannot reach them: no record maps them to a document)
    mid = integrity_report(ctx)
    ghosts = mid["device_live_host_dead"] + mid["tail_live_rows"]
    if ghosts:
        store.invalidate_rows(ghosts)
    return {
        "before": report_before,
        "republished_chunks": republished,
        "dropped_docs": dropped_docs,
        "after": integrity_report(ctx),
    }
