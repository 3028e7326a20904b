"""GCS blob storage for document originals, over the JSON API (no SDK).

Reference parity: the reference writes uploaded originals to a GCS
bucket (app/main.py /upload → GCS write, bucket at config.py:94,
``/test_gcs`` main.py:2347) through google-cloud-storage. Here the
same role is a DocumentStore implementation speaking the GCS JSON API
over urllib — deployable against real GCS with a bearer token, and
contract-tested offline against a local fake server
(tests/test_blobstore.py). FileDocumentStore (ingest/worker.py)
remains the local default.

Selection: ``get_document_store()`` reads ``MRAG_BLOB_STORE``
(``fs`` default | ``gcs`` | ``memory``); gcs needs ``MRAG_GCS_BUCKET``
+ ``MRAG_GCS_TOKEN`` (a bearer, e.g. from the metadata server or
``gcloud auth print-access-token``), with ``MRAG_GCS_API`` overriding
the endpoint for gateways/test stubs.

Layout mirrors FileDocumentStore: ``{prefix}{doc_id}.bin`` holds the
original bytes, ``{prefix}{doc_id}.meta.json`` the metadata sidecar —
so an operator can inspect/restore a bucket with plain gsutil.

Ported from ``mobius_rag_tpu.blobstore`` with the port's imports.
"""
from __future__ import annotations

import json
import os
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable

from mobius_rag_tpu_torch.ingest.worker import DocumentBlob, DocumentStore

_META_KEYS = ("doc_id", "filename", "payer", "state", "program",
              "authority_level", "summary")


class GCSDocumentStore(DocumentStore):
    """Durable blob store over the GCS JSON API.

    Reads populate the in-memory cache lazily (a fresh process serves
    ``get`` straight from the bucket); writes go through to the bucket
    before updating the cache, so a crash mid-put never leaves the
    cache ahead of durable state (the reference's "commit before
    cross-store side effects" discipline, embedding_worker.py:323-340).
    """

    def __init__(self, bucket: str | None = None, *,
                 api_base: str | None = None,
                 token: str | Callable[[], str] | None = None,
                 prefix: str = "documents/", timeout_s: float = 30.0):
        super().__init__()
        env = os.environ.get
        self.bucket = bucket or env("MRAG_GCS_BUCKET", "")
        if not self.bucket:
            raise ValueError("GCSDocumentStore requires MRAG_GCS_BUCKET")
        self.api_base = (api_base or env(
            "MRAG_GCS_API", "https://storage.googleapis.com")).rstrip("/")
        self._token = token if token is not None else env("MRAG_GCS_TOKEN", "")
        self.prefix = prefix
        self.timeout_s = timeout_s

    # -- transport ----------------------------------------------------------

    def _auth(self) -> dict[str, str]:
        tok = self._token() if callable(self._token) else self._token
        return {"Authorization": f"Bearer {tok}"} if tok else {}

    def _object_name(self, doc_id: str, suffix: str) -> str:
        return f"{self.prefix}{doc_id.replace('/', '_')}{suffix}"

    def _upload(self, name: str, data: bytes, content_type: str) -> None:
        url = (f"{self.api_base}/upload/storage/v1/b/{self.bucket}/o"
               f"?uploadType=media&name={urllib.parse.quote(name, safe='')}")
        req = urllib.request.Request(
            url, method="POST", data=data,
            headers={"Content-Type": content_type, **self._auth()})
        with urllib.request.urlopen(req, timeout=self.timeout_s):
            pass

    def _fetch(self, name: str, *, media: bool = True) -> bytes | None:
        q = "?alt=media" if media else "?fields=updated,size"
        url = (f"{self.api_base}/storage/v1/b/{self.bucket}/o/"
               f"{urllib.parse.quote(name, safe='')}{q}")
        req = urllib.request.Request(url, headers=self._auth())
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s) as r:
                return r.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    def _remove(self, name: str) -> bool:
        url = (f"{self.api_base}/storage/v1/b/{self.bucket}/o/"
               f"{urllib.parse.quote(name, safe='')}")
        req = urllib.request.Request(url, method="DELETE",
                                     headers=self._auth())
        try:
            with urllib.request.urlopen(req, timeout=self.timeout_s):
                return True
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return False
            raise

    # -- DocumentStore contract ---------------------------------------------

    def put(self, blob: DocumentBlob) -> None:
        meta = {k: getattr(blob, k) for k in _META_KEYS}
        self._upload(self._object_name(blob.doc_id, ".bin"), blob.data,
                     "application/octet-stream")
        self._upload(self._object_name(blob.doc_id, ".meta.json"),
                     json.dumps(meta).encode(), "application/json")
        self.docs[blob.doc_id] = blob  # cache after durable write

    def get(self, doc_id: str) -> DocumentBlob | None:
        hit = self.docs.get(doc_id)
        if hit is not None:
            return hit
        raw_meta = self._fetch(self._object_name(doc_id, ".meta.json"))
        if raw_meta is None:
            return None
        data = self._fetch(self._object_name(doc_id, ".bin"))
        if data is None:
            return None
        meta = json.loads(raw_meta)
        blob = DocumentBlob(data=data,
                            **{k: meta.get(k, "" if k != "authority_level"
                                           else 0) for k in _META_KEYS})
        self.docs[doc_id] = blob
        return blob

    def delete(self, doc_id: str) -> bool:
        self.docs.pop(doc_id, None)
        found = self._remove(self._object_name(doc_id, ".bin"))
        return self._remove(self._object_name(doc_id, ".meta.json")) or found

    def mtime(self, doc_id: str) -> float | None:
        raw = self._fetch(self._object_name(doc_id, ".bin"), media=False)
        if raw is None:
            return None
        updated = json.loads(raw).get("updated", "")
        if not updated:
            return None
        import calendar
        import re
        import time as _time

        m = re.match(r"(\d{4})-(\d{2})-(\d{2})T(\d{2}):(\d{2}):(\d{2})",
                     updated)
        if not m:
            return None
        return float(calendar.timegm(
            _time.struct_time(tuple(map(int, m.groups())) + (0, 0, 0))))


def get_document_store() -> DocumentStore:
    """Env-selected blob store (MRAG_BLOB_STORE=fs|gcs|memory)."""
    kind = os.getenv("MRAG_BLOB_STORE", "fs").strip().lower()
    if kind == "gcs":
        return GCSDocumentStore()
    if kind == "memory":
        return DocumentStore()
    from mobius_rag_tpu_torch.ingest.worker import FileDocumentStore

    return FileDocumentStore()
