"""The port's ingest path (mobius_rag_tpu_torch.ingest) against the JAX
package's on the same inputs: extraction (txt, html, the built-in pdf
reader), chunking and code-list gluing, paths A and B, metadata
canonicalization, the job queue's ladder and leases, the chunking resume,
and upload → chunk → embed → publish → query end to end with hash_embed
(the same chunk texts and the same hits: ids equal, scores within 1e-5).
Every sqlite file lives under tmp_path.
"""
import dataclasses
import json
import time

import numpy as np
import pytest

from mobius_rag_tpu.export_pdf import markdown_to_pdf
from mobius_rag_tpu.index.store import ChunkStore as JaxStore
from mobius_rag_tpu.ingest import chunking as jchunk
from mobius_rag_tpu.ingest import extract as jextract
from mobius_rag_tpu.ingest import metadata as jmeta
from mobius_rag_tpu.ingest import paths as jpaths
from mobius_rag_tpu.ingest import worker as jworker
from mobius_rag_tpu.ingest.pipeline import IngestPipeline as JaxPipeline
from mobius_rag_tpu.ingest.queue import JobQueue as JaxQueue
from mobius_rag_tpu.query.engine import QueryRequest as JaxRequest
from mobius_rag_tpu.query.engine import SearchEngine as JaxEngine
from mobius_rag_tpu.testing import hash_embed as jax_hash_embed
from mobius_rag_tpu.testing import sample_lexicon as jax_sample_lexicon
from mobius_rag_tpu_torch.index.store import ChunkStore
from mobius_rag_tpu_torch.ingest import chunking, extract, metadata, paths, worker
from mobius_rag_tpu_torch.ingest.pipeline import IngestPipeline
from mobius_rag_tpu_torch.ingest.queue import JobQueue
from mobius_rag_tpu_torch.query.engine import QueryRequest, SearchEngine
from mobius_rag_tpu_torch.testing import hash_embed, sample_lexicon

SCORE_TOL = 1e-5

_MANUAL = b"""SUNSHINE HEALTH PROVIDER MANUAL

TIMELY FILING
Participating providers must submit initial claims within 180 days
from the date of service. Non-participating providers have 365 days.

PRIOR AUTHORIZATION
Residential substance use treatment under H0019 requires prior
authorization from Sunshine Health. Durable medical equipment over
$500 also requires prior authorization.
"""

_HTML = b"""<html><body>
<h1>Claims</h1><p>Intro text about claims.</p>
<h2>Timely Filing</h2><p>180 days window.</p>
<h3>Exceptions</h3><p>COB claims differ.</p>
<script>ignore()</script>
<h2>Appeals</h2><p>90 day appeals window.</p>
</body></html>"""

_PDF_MD = ("# Timely Filing\n\nParticipating providers must submit initial "
           "claims within 180 days from the date of service.\n\n"
           "## Disputes\n\nReconsiderations are due within 90 days of the EOP.")

_MOLINA = b"""MOLINA HEALTHCARE CLAIMS GUIDE

CORRECTED CLAIMS
Corrected claims must be resubmitted within 90 days of the original
denial. Covered genetic tests include 81410, 81415,

and G0659.

APPEALS
Members may appeal a denial within 60 days of the notice.
"""


def _plain(obj):
    """A dataclass tree as plain data (both packages define their own
    classes with the same fields)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _plain(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_plain(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    return obj


@pytest.mark.parametrize("data,filename", [
    (b"page one text\fpage two text", "doc.txt"),
    (_HTML, "manual.html"),
    (b"%PDF-1.4 fake", "doc.pdf"),
    (markdown_to_pdf(_PDF_MD, title="Test Manual"), "manual.pdf"),
    (_MANUAL, "manual.txt"),
], ids=["txt", "html", "pdf_garbage", "pdf_builtin", "manual"])
def test_extract_matches_jax(data, filename):
    want = jextract.extract_text_from_bytes(data, filename)
    got = extract.extract_text_from_bytes(data, filename)
    assert _plain(got) == _plain(want)


@pytest.mark.parametrize("md", [
    "# Claims\n\nFirst paragraph text.\n\n## Appeals\n\nSecond paragraph.",
    "# Lab Codes\n\nCovered genetic tests include 81410, 81415,\n\n"
    "and G0659.\n\nSeparate paragraph about something else entirely.",
    jchunk.page_to_markdown(_MOLINA.decode()),
], ids=["sections", "code_glue", "molina"])
def test_split_paragraphs_matches_jax(md):
    assert _plain(chunking.split_paragraphs_from_markdown(md, page=3)) == \
        _plain(jchunk.split_paragraphs_from_markdown(md, page=3))


@pytest.mark.parametrize("text", [
    "TIMELY FILING\nClaims must be filed timely.\n\nProvider Enrollment\nmore text here.",
    _MANUAL.decode(), _MOLINA.decode()])
def test_page_to_markdown_and_chunk_pages_match_jax(text):
    assert chunking.page_to_markdown(text) == jchunk.page_to_markdown(text)
    pages = [(1, text), (2, "second page para."), (3, "")]
    assert _plain(chunking.chunk_pages(pages)) == _plain(jchunk.chunk_pages(pages))


@pytest.mark.parametrize("text", [
    "and G0659.", "(Genemarkers): 81418", "Added HCPCS code [Q5129].  04.17.23",
    "Deny CON #10715.", "This is a long paragraph that happens to mention G0659 "
    "but is not a fragment.", ""])
def test_code_list_fragment_matches_jax(text):
    assert chunking.is_code_list_fragment(text) == jchunk.is_code_list_fragment(text)


class FakeLLM:
    """Scripted extraction/critique client (tests/test_ingest.py's)."""

    def __init__(self, first_score=0.4, fail_at=None):
        self.calls = []
        self.first_score = first_score
        self._critiques = 0
        self.extractions = 0
        self.fail_at = fail_at

    def generate(self, prompt, *, system="", max_tokens=1024, temperature=0.0, stage=""):
        self.calls.append(stage)
        if stage == "extraction":
            self.extractions += 1
            if self.extractions == self.fail_at:
                raise TimeoutError("llm connection timeout")
        if stage in ("extraction", "extraction_retry"):
            return json.dumps([{"text": "PA is required for H0019",
                                "category": "authorization"}])
        if stage == "critique":
            self._critiques += 1
            return str(self.first_score if self._critiques == 1 else 0.9)
        return ""


@pytest.mark.parametrize("first_score", [0.4, 0.95])
def test_path_a_matches_jax(first_score):
    para = "Prior authorization is required for H0019."
    a, b = FakeLLM(first_score), FakeLLM(first_score)
    got, want = paths.run_path_a(para, a), jpaths.run_path_a(para, b)
    assert _plain(got) == _plain(want) and a.calls == b.calls
    assert got and got[0].retried == (first_score < 0.5)


@pytest.mark.parametrize("para", [
    "Prior authorization is required for DME over $500; submit via the portal. "
    "Sunshine Health reviews within 14 days.",
    _MANUAL.decode(), "Members of Molina may appeal within 60 days."])
def test_path_b_matches_jax(para):
    got = paths.run_path_b(para, sample_lexicon())
    want = jpaths.run_path_b(para, jax_sample_lexicon())
    assert _plain(got) == _plain(want)
    assert paths.find_fact_span("prior authorization is required", para) == \
        jpaths.find_fact_span("prior authorization is required", para)


def test_aggregate_document_tags_matches_jax():
    per_para = [{"j": [1], "d": [2]}, {"j": [1], "d": [3]}, {"j": [1], "d": [2], "p": [4]}]
    assert paths.aggregate_document_tags(per_para) == jpaths.aggregate_document_tags(per_para)


@pytest.mark.parametrize("kw", [
    dict(payer="Sunshine Health Florida", state="florida", program="MMA"),
    dict(payer="  AETNA better health ", state="TX", program="chip"),
    dict(payer="", state="", program=""),
    dict(payer="Molina Healthcare of Ohio", state="oh", program="Medicare Advantage"),
])
def test_metadata_matches_jax(kw):
    assert metadata.canonicalize_metadata(**kw) == jmeta.canonicalize_metadata(**kw)


def _queue_trace(Queue, path):
    """A fixed script of queue operations; what each step returned."""
    q = Queue(str(path))
    out = []
    jid = q.enqueue("chunking", {"doc_id": "d1"}, dedupe_key="d1")
    out.append(q.enqueue("chunking", {"doc_id": "d1"}, dedupe_key="d1"))
    job = q.claim("chunking", "w1")
    out.append((job.attempts, job.payload, q.claim("chunking", "w2")))
    q.complete(jid, {"ok": True})
    out.append((q.job(jid)["status"], [e["stage"] for e in q.events(jid)]))
    jid2 = q.enqueue("chunking", {"doc_id": "d2"}, max_attempts=2)
    for _ in range(2):
        job = q.claim("chunking", "w1")
        q.fail(job.job_id, "boom")
        out.append(q.job(jid2)["status"])
    out.append((q.claim("chunking", "w1"), q.depths()))
    return out


def test_queue_ladder_matches_jax(tmp_path):
    assert _queue_trace(JobQueue, tmp_path / "t.sqlite") == \
        _queue_trace(JaxQueue, tmp_path / "j.sqlite")


def test_queue_zombie_recovery(tmp_path):
    q = JobQueue(str(tmp_path / "q.sqlite"), lease_seconds=0.05)
    q.enqueue("chunking", {"doc_id": "d1"})
    j1 = q.claim("chunking", "w1")
    time.sleep(0.1)  # lease expires → zombie
    j2 = q.claim("chunking", "w2")
    assert j2 is not None and j2.job_id == j1.job_id and j2.attempts == 2


@pytest.mark.parametrize("side", ["port", "jax"])
def test_chunking_resume_skips_done_paragraphs(tmp_path, side):
    """A chunking job that dies in its third paragraph resumes from its
    persisted partials: 5 extraction calls in all, in both packages."""
    mod, Queue, lex = ((worker, JobQueue, sample_lexicon()) if side == "port"
                       else (jworker, JaxQueue, jax_sample_lexicon()))
    q = Queue(str(tmp_path / "q.sqlite"))
    docs = mod.DocumentStore()
    doc = (b"P1 first paragraph text here.\n\nP2 second paragraph text.\n\n"
           b"P3 third paragraph text.\n\nP4 fourth paragraph text.")
    docs.put(mod.DocumentBlob(doc_id="d1", filename="d1.txt", data=doc))
    llm = FakeLLM(first_score=0.9, fail_at=3)
    w = mod.ChunkingWorker(q, docs, lex, llm=llm, extraction_enabled=True)
    jid = q.enqueue("chunking", {"doc_id": "d1"})
    w.run_loop(max_jobs=1)
    assert q.job(jid)["status"] == "done"
    events = [e["stage"] for e in q.events(jid)]
    assert "requeued" in events and "resumed" in events
    assert llm.extractions == 5
    assert q.partials(jid) == {}


def _ingest(side, tmp_path, uploads):
    """Upload each document (instant) into a fresh store; return the store's
    live chunk texts by id and an engine over it."""
    if side == "port":
        lex, store = sample_lexicon(), ChunkStore(device="cpu")
        pipe = IngestPipeline(store, lex, hash_embed,
                              queue=JobQueue(str(tmp_path / "port.sqlite")))
    else:
        lex, store = jax_sample_lexicon(), JaxStore()
        pipe = JaxPipeline(store, lex, jax_hash_embed,
                           queue=JaxQueue(str(tmp_path / "jax.sqlite")))
    results = [pipe.upload(data, name, **kw) for data, name, kw in uploads]
    chunks = {r.chunk_id: (r.doc_id, r.text, r.payer, r.state, list(r.d_tags),
                           list(r.j_tags), r.section_path)
              for r in store.records if r is not None}
    if side == "port":
        engine = SearchEngine(store, lex, embed_fn=hash_embed, device="cpu")
    else:
        engine = JaxEngine(store, lex, embed_fn=jax_hash_embed)
    return pipe, store, results, chunks, engine


_UPLOADS = [
    (_MANUAL, "sunshine_manual.txt", dict(payer="Sunshine Health", state="Florida",
                                          program="medicaid", authority_level=4)),
    (_MOLINA, "molina_guide.txt", dict(payer="Molina", state="OH", authority_level=2)),
    (_HTML, "appeals.html", dict(payer="Aetna", state="TX")),
    (markdown_to_pdf("# Zebra Plan Filing\n\nZebra Plan timely filing deadline is 222 "
                     "days from the date of service for participating providers."),
     "Zebra Plan Manual.pdf", dict(payer="zebra")),
]

_QUERIES = [
    dict(query="timely filing deadline for sunshine health claims", payer="sunshine_health"),
    dict(query="corrected claims resubmission window"),
    dict(query="appeals window after a denial", tag_mode="relaxed"),
    dict(query="zebra plan timely filing deadline"),
    dict(query="prior authorization for H0019", mode="precision"),
]


def test_upload_to_query_matches_jax(tmp_path):
    """upload → chunk → Path B → embed → publish → search in both packages:
    the same chunk texts, tags and metadata, and the same hits (ids equal,
    scores within SCORE_TOL)."""
    p_pipe, p_store, p_res, p_chunks, p_engine = _ingest("port", tmp_path, _UPLOADS)
    j_pipe, j_store, j_res, j_chunks, j_engine = _ingest("jax", tmp_path, _UPLOADS)
    assert [(r.doc_id, r.sha256, r.deduped, r.instant) for r in p_res] == \
        [(r.doc_id, r.sha256, r.deduped, r.instant) for r in j_res]
    assert p_chunks == j_chunks and len(p_chunks) >= 8
    # re-upload dedupes on sha
    assert p_pipe.upload(_MANUAL, "again.txt").deduped
    assert j_pipe.upload(_MANUAL, "again.txt").deduped

    got = p_engine.search([QueryRequest(**q) for q in _QUERIES], k=3)
    want = j_engine.search([JaxRequest(**q) for q in _QUERIES], k=3)
    for g, w in zip(got, want):
        assert [h.chunk_id for h in g.hits] == [h.chunk_id for h in w.hits], g.query
        np.testing.assert_allclose([h.score for h in g.hits], [h.score for h in w.hits],
                                   atol=SCORE_TOL)
        assert g.confidence_label == w.confidence_label
    assert got[0].hits and "180 days" in got[0].hits[0].text
    assert got[3].hits and "222" in got[3].hits[0].text

    # incremental resume: the same source ids re-enqueued add no rows
    size = p_store.size
    doc_id = p_res[0].doc_id
    p_pipe.queue.enqueue("embedding", {
        "doc_id": doc_id,
        "units": [{"source_id": sid, "kind": "paragraph", "text": "ignored",
                   "j_tags": [], "d_tags": [], "p_tags": []}
                  for sid in sorted(p_store.embedded_source_ids(doc_id))],
        "meta": {}}, dedupe_key="resume-test")
    p_pipe.embedding_worker.run_loop(max_jobs=1)
    assert p_store.size == size
    assert p_store.embedded_source_ids(doc_id) == j_store.embedded_source_ids(doc_id)
    assert [p_store.records[r].chunk_id for r in p_store.rows_for_document(doc_id)] == \
        [j_store.records[r].chunk_id for r in j_store.rows_for_document(doc_id)]


def test_queued_uploads_publish_after_drain(tmp_path):
    """Uploads with instant=False wait in the queue until the workers
    drain it; then they are published and served."""
    lex, store = sample_lexicon(), ChunkStore(device="cpu")
    pipe = IngestPipeline(store, lex, hash_embed, queue=JobQueue(str(tmp_path / "q.sqlite")))
    res = [pipe.upload(data, name, instant=False, **kw) for data, name, kw in _UPLOADS]
    assert store.size == 0 and all(r.instant is None for r in res)
    assert pipe.drain() == {"chunking_jobs": 4, "embedding_jobs": 4}
    for r in res:
        assert store.rows_for_document(r.doc_id), r.doc_id
    engine = SearchEngine(store, lex, embed_fn=hash_embed, device="cpu")
    hit = engine.search(QueryRequest(**_QUERIES[0]), k=1)[0].hits[0]
    assert "180 days" in hit.text
