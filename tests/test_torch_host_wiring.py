"""The port's remaining host modules against the JAX package's:
integrity (report and remediation on twin contexts: equal dicts), the PDF
writer (byte-equal), the Drive client (against a local fake server, as
tests/test_infra_transports.py drives the JAX one; in-memory folder
imports through twin ingest pipelines) and the worker CLI
(``python -m mobius_rag_tpu_torch.ingest --once --device cpu``)."""
import json
import os
import subprocess
import sys
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mobius_rag_tpu import drive as jdrive
from mobius_rag_tpu import integrity as jintegrity
from mobius_rag_tpu import testing as jtesting
from mobius_rag_tpu.export_pdf import markdown_to_pdf as jpdf
from mobius_rag_tpu.index.store import ChunkRecord as JRecord, ChunkStore as JStore
from mobius_rag_tpu.ingest.featurize import featurize_chunk as jfeaturize
from mobius_rag_tpu_torch import drive as tdrive
from mobius_rag_tpu_torch import integrity as tintegrity
from mobius_rag_tpu_torch import testing as ttesting
from mobius_rag_tpu_torch.export_pdf import markdown_to_pdf
from mobius_rag_tpu_torch.index.store import ChunkRecord as TRecord, ChunkStore as TStore
from mobius_rag_tpu_torch.ingest.featurize import featurize_chunk as tfeaturize

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# ---------------------------------------------------------------------------
# integrity
# ---------------------------------------------------------------------------


def _ctx(pkg):
    """A context with drift of every kind the report checks: a device row
    with no host record, a host record whose device row is invalid, a
    document whose embedding is all zero, a registry document without
    chunks and a running job."""
    if pkg == "jax":
        testing, store, rec_cls, feat = jtesting, JStore(), JRecord, jfeaturize
    else:
        testing, store, rec_cls, feat = ttesting, TStore(device="cpu"), TRecord, tfeaturize
    lex = testing.sample_lexicon()
    store.add_chunks(testing.toy_corpus(lex, pad_docs=6))
    store.publish_document("zero_doc", [feat(rec_cls(
        chunk_id="z0", doc_id="zero_doc", text="dead embedding row",
        embedding=np.zeros(testing.hash_embed(["x"]).shape[1], np.float32)), lex)])
    store.records[3] = None
    if pkg == "jax":
        store.index.valid = store.index.valid.at[5].set(0.0)
    else:
        store.index.valid[5] = 0.0
    docs = types.SimpleNamespace(docs={"sunshine_provider_manual": b"", "ghost_doc": b""})
    queue = types.SimpleNamespace(depths=lambda: {"chunking": {"running": 1, "queued": 2}})
    return types.SimpleNamespace(store=store, pipeline=types.SimpleNamespace(docs=docs,
                                                                             queue=queue))


def test_integrity_report_and_remediation_match_jax():
    jctx, tctx = _ctx("jax"), _ctx("port")
    want, got = jintegrity.integrity_report(jctx), tintegrity.integrity_report(tctx)
    assert got == want
    assert not got["ok"] and got["device_live_host_dead"] == [3]
    assert got["host_live_device_dead"] == [5] and got["zero_vector_rows"]
    assert got["docs_without_chunks"] == ["ghost_doc"] and got["running_jobs"] == 1
    want, got = jintegrity.integrity_remediate(jctx), tintegrity.integrity_remediate(tctx)
    assert got == want
    assert got["dropped_docs"] == ["zero_doc"] and got["after"]["ok"]


def test_integrity_under_host_residency():
    """Under host residency the stored vectors are the host matrix's rows."""
    import dataclasses

    from mobius_rag_tpu_torch.config import get_config

    cfg = dataclasses.replace(get_config(), vector_residency="host", vector_dtype="int8",
                              vector_backend="proj")
    store = TStore(cfg, device="cpu")
    store.add_chunks(ttesting.toy_corpus(ttesting.sample_lexicon(), pad_docs=4))
    rep = tintegrity.integrity_report(types.SimpleNamespace(store=store, pipeline=None))
    assert rep["ok"] and rep["counts"]["device_valid"] == rep["counts"]["host_records"]


# ---------------------------------------------------------------------------
# PDF export
# ---------------------------------------------------------------------------

MARKDOWN = [
    "# Title\n\nA paragraph (with parentheses) and a back\\slash.",
    "## Section\n\n- first bullet\n- second bullet\n\n### Sub\n\nText.",
    "# Long\n\n" + "\n\n".join(f"Paragraph {i}: " + "word " * 120 for i in range(40)),
    "",
]


@pytest.mark.parametrize("i", range(len(MARKDOWN)))
def test_pdf_bytes_equal_jax(i):
    got = markdown_to_pdf(MARKDOWN[i], title=f"doc {i}")
    assert got.startswith(b"%PDF") and got == jpdf(MARKDOWN[i], title=f"doc {i}")


# ---------------------------------------------------------------------------
# Drive
# ---------------------------------------------------------------------------

def test_httpdrive_oauth_list_and_download():
    from test_infra_transports import _drive_stub, _server

    state = {"token_requests": [], "gets": []}
    srv, base = _server(_drive_stub(state))
    try:
        client = tdrive.HTTPDrive(api_base=base, token_url=base + "/token",
                                  client_id="cid", client_secret="cs", refresh_token="rt")
        files = client.list_folder("folder-1")
        assert [f["file_id"] for f in files] == ["f1", "f2"] and files[0]["size"] == 120
        assert len(state["token_requests"]) == 1
        assert state["token_requests"][0]["grant_type"] == ["refresh_token"]
        assert all(g["auth"] == "Bearer at-123" for g in state["gets"])
        assert client.download("f1") == b"%PDF-raw-bytes"
        assert client.download("f2", mime="application/vnd.google-apps.document") == \
            b"exported text"
        want = jdrive.HTTPDrive(api_base=base, access_token="at-123").list_folder("folder-1")
        assert files == want
    finally:
        srv.shutdown()
    with pytest.raises(RuntimeError, match="no access token"):
        tdrive.HTTPDrive(api_base="http://127.0.0.1:1").list_folder("f")


@pytest.mark.parametrize("name", ["FL_Sunshine_Provider_Manual.pdf", "notes.gdoc",
                                  "Molina TX Billing Guide 2024.docx", "random.txt",
                                  "aetna_prior_auth_policy.PDF"])
def test_classify_file_matches_jax(name):
    assert tdrive.classify_file(name) == jdrive.classify_file(name)


def test_import_folder_matches_jax(tmp_path):
    """An in-memory folder through twin ingest pipelines (files under
    tmp_path): the same scan, imports and skips."""
    from mobius_rag_tpu.ingest.pipeline import IngestPipeline as JPipeline
    from mobius_rag_tpu.ingest.queue import JobQueue as JQueue
    from mobius_rag_tpu.ingest.worker import FileDocumentStore as JDocs
    from mobius_rag_tpu_torch.ingest.pipeline import IngestPipeline
    from mobius_rag_tpu_torch.ingest.queue import JobQueue
    from mobius_rag_tpu_torch.ingest.worker import FileDocumentStore

    folder = {"f": [("Sunshine_FL_Provider_Manual.txt",
                     b"TIMELY FILING\nClaims within 180 days of service."),
                    ("meeting_notes.txt", b"lunch at noon"),
                    ("Molina_TX_Billing_Guide.txt", b"BILLING\nUse the 837P format.")]}
    jp = JPipeline(JStore(), jtesting.sample_lexicon(), jtesting.hash_embed,
                   queue=JQueue(str(tmp_path / "j.sqlite")), docs=JDocs(str(tmp_path / "jd")))
    tp = IngestPipeline(TStore(device="cpu"), ttesting.sample_lexicon(), ttesting.hash_embed,
                        queue=JobQueue(str(tmp_path / "t.sqlite")),
                        docs=FileDocumentStore(str(tmp_path / "td")))
    for manuals_only in (True, False):
        want = jdrive.import_folder(jp, jdrive.InMemoryDrive(folder), "f",
                                    manuals_only=manuals_only)
        got = tdrive.import_folder(tp, tdrive.InMemoryDrive(folder), "f",
                                   manuals_only=manuals_only)
        assert (got.scanned, got.imported, got.skipped) == \
            (want.scanned, want.imported, want.skipped)
    assert got.scanned == 3 and got.imported


# ---------------------------------------------------------------------------
# the worker CLI
# ---------------------------------------------------------------------------

def _cli(tmp_path, *args):
    env = dict(os.environ, MRAG_DATA_DIR=str(tmp_path / "data"),
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return subprocess.run([sys.executable, "-m", "mobius_rag_tpu_torch.ingest", *args],
                          env=env, cwd=REPO, capture_output=True, text=True, timeout=300)


def test_worker_cli_embeds_once_into_the_snapshot(tmp_path):
    """An embedding job on a shared queue: the CLI on the CPU embeds and
    publishes it into the snapshot, which the serving side reloads."""
    from mobius_rag_tpu_torch.ingest.queue import JobQueue
    from mobius_rag_tpu_torch.ingest.worker import EMBEDDING_KIND

    queue_path, snap = str(tmp_path / "jobs.sqlite"), str(tmp_path / "snap")
    units = [{"source_id": f"cli-p{i}", "kind": "paragraph", "text": t, "section_path": "S",
              "page": 1, "j_tags": [], "d_tags": [], "p_tags": []}
             for i, t in enumerate(["Worker plan timely filing is 211 days.",
                                    "Worker plan appeals are due in 45 days."])]
    JobQueue(queue_path).enqueue(EMBEDDING_KIND, {"doc_id": "cli_doc", "units": units,
                                                  "meta": {"filename": "cli.txt"}})
    out = _cli(tmp_path, "--kind", "embedding", "--once", "--device", "cpu", "--provider",
               "hash", "--queue", queue_path, "--snapshot", snap)
    assert out.returncode == 0, out.stderr[-3000:]
    store = TStore.restore(snap, device="cpu")
    assert sorted(store.embedded_source_ids("cli_doc")) == ["cli-p0", "cli-p1"]
    assert JobQueue(queue_path).depths()[EMBEDDING_KIND].get("done") == 1
    out = _cli(tmp_path, "--kind", "chunking", "--once", "--queue", queue_path)
    assert out.returncode == 0, out.stderr[-3000:]


def test_worker_health_endpoint():
    from mobius_rag_tpu_torch.ingest.__main__ import _start_health_server

    tick, srv = _start_health_server(0, stale_after_s=3600)
    try:
        url = f"http://127.0.0.1:{srv.server_port}/health"
        with urllib.request.urlopen(url, timeout=10) as r:
            assert json.loads(r.read())["status"] == "ok"
        stale_tick, stale = _start_health_server(0, stale_after_s=0)
        try:
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"http://127.0.0.1:{stale.server_port}/health",
                                       timeout=10)
            assert e.value.code == 503
        finally:
            stale.shutdown()
        tick()
    finally:
        srv.shutdown()
