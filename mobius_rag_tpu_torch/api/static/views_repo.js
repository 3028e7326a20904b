/* Repository tabs: corpus dashboard with registry search + per-doc
   drill-down (status, pages, policy paragraphs, text-tags editor,
   facts, errors, markdown download) — the console form of the
   reference's Repository/DocumentDetail/Reader tabs — plus upload and
   the facts browser. */
"use strict";

UI.tab("repository", `
  <div class="row"><input id="rq" placeholder="search documents (id, filename, payer, text)">
    <button class="go" onclick="searchRepo()">search</button>
    <button onclick="loadRepo()">all</button></div>
  <div id="rout">…</div>`, loadRepo);

async function loadRepo() {
  const r = await UI.get("/documents");
  renderRepo(r.documents.map((d) => ({ doc_id: d.doc_id, payer: d.payer,
    state: d.state, chunks: d.chunks })));
}
async function searchRepo() {
  if (!rq.value.trim()) return loadRepo();
  const r = await UI.get(`/documents/search?q=${encodeURIComponent(rq.value)}`);
  renderRepo((r.hits || []).map((h) => ({ doc_id: h.doc_id, payer: h.payer || "",
    state: h.state || "", chunks: h.chunks ?? "" })));
}
function renderRepo(docs) {
  rout.innerHTML = UI.table(["doc (click for detail)", "payer", "state", "chunks"],
    docs.map((d) => `<tr class=click onclick="loadDocDetail(UI.d('${UI.arg(d.doc_id)}'))">
      <td>${UI.esc(d.doc_id)}</td><td>${UI.esc(d.payer)}</td>
      <td>${UI.esc(d.state)}</td><td>${d.chunks}</td></tr>`))
    + "<div id=docdetail></div>";
}

async function loadDocDetail(id) {
  const [st, pol, fx, er, tags, det, ps] = await Promise.all([
    UI.get(`/documents/${id}/status`).catch(() => null),
    UI.get(`/documents/${id}/policy/summary`).catch(() => null),
    UI.get(`/documents/${id}/facts`).catch(() => null),
    UI.get(`/documents/${id}/errors`).catch(() => null),
    UI.get(`/documents/${id}/text-tags`).catch(() => null),
    UI.get(`/documents/${id}/detail`).catch(() => null),
    UI.get(`/documents/${id}/publish-status`).catch(() => null)]);
  document.getElementById("docdetail").innerHTML = `
    <div class=hit><b>${UI.esc(id)}</b>
      <span class=meta> · ${ps && ps.published ? UI.lbl("high") + " published" : UI.lbl("low") + " unpublished"}
        · <a href="/documents/${id}/download/markdown" style="color:var(--acc)">markdown</a>
        · <a href="/documents/${id}/file" style="color:var(--acc)">original</a></span>
      <div class=row style="margin-top:8px">
        <button onclick="docAct(UI.d('${UI.arg(id)}'),'chunking/restart',{drain:true})">restart chunking</button>
        <button onclick="docAct(UI.d('${UI.arg(id)}'),'chunking/start')">chunk</button>
        <button onclick="docAct(UI.d('${UI.arg(id)}'),'chunking/stop')">stop</button>
        <button onclick="docAct(UI.d('${UI.arg(id)}'),'chunking/kill-and-reset')">kill+reset</button>
        <button onclick="docAct(UI.d('${UI.arg(id)}'),'embedding/start')">re-embed</button>
        <button onclick="docAct(UI.d('${UI.arg(id)}'),'embedding/reset')">reset embeddings</button>
        <button onclick="docAct(UI.d('${UI.arg(id)}'),'publish')">publish</button>
        <button onclick="docAct(UI.d('${UI.arg(id)}'),'retag')">retag</button></div>
      <div class=row style="margin-top:4px">
        <button onclick="docAct(UI.d('${UI.arg(id)}'),'retry')">retry failed</button>
        <button onclick="docAct(UI.d('${UI.arg(id)}'),'extract/restart',{drain:true})">re-extract</button>
        <button onclick="docAct(UI.d('${UI.arg(id)}'),'errors/resolve-all')">resolve errors</button>
        <button onclick="loadDocPages(UI.d('${UI.arg(id)}'))">pages</button>
        <button onclick="loadDocParagraphs(UI.d('${UI.arg(id)}'))">paragraphs</button>
        <button onclick="loadDocCandidates(UI.d('${UI.arg(id)}'))">candidates</button></div>
      <div class=row style="margin-top:4px">
        <input id="mpayer" value="${UI.esc(det?.payer || "")}" placeholder="payer" style="max-width:160px">
        <input id="mstate" value="${UI.esc(det?.state || "")}" placeholder="state" style="max-width:80px">
        <input id="mprog" value="${UI.esc(det?.program || "")}" placeholder="program" style="max-width:140px">
        <button onclick="patchDocMeta(UI.d('${UI.arg(id)}'))">save metadata (republishes)</button></div>
      <div class=row style="margin-top:4px">
        <input id="ttag" placeholder="add text-tag e.g. d:benefits.dme" style="max-width:280px">
        <button onclick="addTextTag(UI.d('${UI.arg(id)}'))">tag</button>
        <span class=meta id="ttags">${UI.esc(JSON.stringify(tags && tags.tags))}</span></div>
      <pre>${UI.esc(JSON.stringify({ status: st, detail: det,
        policy: pol && pol.tag_chunk_counts,
        facts: fx && (fx.facts || []).length, errors: er && (er.errors || []).length }, null, 2))}</pre>
      <div id="docsub"></div></div>`;
}
async function patchDocMeta(id) {
  // PATCH /documents/{id} canonicalizes payer/state and republishes
  const body = {};
  const p = document.getElementById("mpayer").value.trim();
  const s = document.getElementById("mstate").value.trim();
  const g = document.getElementById("mprog").value.trim();
  if (p) body.payer = p;
  if (s) body.state = s;
  if (g) body.program = g;
  const r = await UI.post(`/documents/${id}`, body, "PATCH");
  document.getElementById("docsub").innerHTML = UI.pre(r);
}
async function loadDocCandidates(id) {
  const r = await UI.get(`/documents/${id}/policy/candidates`);
  document.getElementById("docsub").innerHTML = UI.table(
    ["phrase", "kind", "occurs", "status"],
    (r.candidates || []).map((c) => `<tr><td>${UI.esc(c.phrase)}</td>
      <td>${UI.esc(c.kind_hint)}</td><td>${c.occurrences}</td>
      <td>${UI.esc(c.status)}</td></tr>`));
}
async function docAct(id, action, body) {
  const r = await UI.post(`/documents/${id}/${action}`, body || {});
  document.getElementById("docsub").innerHTML = UI.pre(r);
  setTimeout(() => loadDocDetail(id), 600);
}
async function addTextTag(id) {
  const v = document.getElementById("ttag").value.trim();
  if (!v) return;
  await UI.post(`/documents/${id}/text-tags`, { tags: [v] });
  loadDocDetail(id);
}
async function loadDocPages(id) {
  const r = await UI.get(`/documents/${id}/pages`);
  document.getElementById("docsub").innerHTML = UI.pre(r);
}
async function loadDocParagraphs(id) {
  const r = await UI.get(`/documents/${id}/policy/paragraphs`);
  const rows = (r.paragraphs || []).map((p) => `<tr>
    <td class=meta>${p.page ?? ""}</td><td>${UI.esc((p.text || "").slice(0, 90))}</td>
    <td class=meta>${UI.esc(JSON.stringify(p.tags || p.d_tags || []))}</td></tr>`);
  document.getElementById("docsub").innerHTML =
    UI.table(["page", "text", "tags"], rows);
}

UI.tab("upload", `
  <div class="row"><input id="ufn" placeholder="filename.txt" style="max-width:220px">
    <input id="upayer" placeholder="payer" style="max-width:160px">
    <input id="ustate" placeholder="state" style="max-width:90px">
    <input id="uprog" placeholder="program" style="max-width:140px">
    <button class="go" onclick="doUpload()">upload (instant)</button></div>
  <div class="row"><input type="file" id="ufile" style="max-width:320px">
    <button class="go" onclick="doFileUpload()">upload file (queued + progress)</button></div>
  <textarea id="utext" rows="10" placeholder="document text"></textarea>
  <div id="uprogress"></div>
  <div id="uout"></div>`);

async function doUpload() {
  const qs = new URLSearchParams({ filename: ufn.value || "upload.txt",
    payer: upayer.value || "", state: ustate.value || "",
    program: uprog.value || "", instant: "1" });
  const r = await fetch("/upload?" + qs, { method: "POST", body: utext.value }).then(UI.J);
  uout.innerHTML = UI.pre(r);
}

/* File upload with progress: queued path, then poll the document's job
   status until published/failed (reference UploadTab progress bar over
   chunking/embedding job events). */
async function doFileUpload() {
  const f = document.getElementById("ufile").files[0];
  if (!f) { uout.innerHTML = UI.pre("pick a file first"); return; }
  const qs = new URLSearchParams({ filename: ufn.value || f.name,
    payer: upayer.value || "", state: ustate.value || "",
    program: uprog.value || "" });
  const r = await fetch("/upload?" + qs, { method: "POST", body: f }).then(UI.J);
  uout.innerHTML = UI.pre(r);
  if (r.doc_id) pollUpload(r.doc_id, 0);
}
async function pollUpload(docId, n) {
  const box = document.getElementById("uprogress");
  let st;
  try { st = await UI.get(`/documents/${docId}/status`); }
  catch (e) { st = { jobs: [] }; }
  // stage = the most advanced live job, else published/pending
  const jobs = st.jobs || [];
  const active = jobs.find((j) => j.status === "running" || j.status === "pending");
  const failed = jobs.find((j) => j.status === "failed");
  const published = (st.published_chunks || 0) > 0 && !active;
  const stage = failed ? `failed: ${failed.kind}` :
    active ? `${active.kind} ${active.status}` :
    published ? "published" : "pending";
  const pct = published ? 100 : active && active.kind === "embedding" ? 66 :
    active ? 33 : 5;
  box.innerHTML = `<div class=hit><b>${UI.esc(docId)}</b>
    <span class=meta> ${UI.esc(stage)} · ${st.published_chunks ?? 0} chunks published
      · ${st.embedded_units ?? 0} embedded</span>
    <div style="background:#0c1115;border:1px solid #2a3742;border-radius:6px;height:10px;margin-top:6px">
      <div style="background:${failed ? "var(--bad)" : "var(--acc)"};height:100%;border-radius:6px;width:${pct}%"></div></div></div>`;
  if (!published && !failed && n < 120) setTimeout(() => pollUpload(docId, n + 1), 1000);
}

UI.tab("import", `
  <p class=meta>Drive sync + direct HTML / scraped-page ingestion
  (reference /drive/* router and /documents/import-* endpoints)</p>
  <div class=row>
    <input id="dfolder" placeholder="drive folder id" style="max-width:260px">
    <button onclick="driveScan()">scan</button>
    <button class=go onclick="driveImport()">import manuals</button>
    <button onclick="driveStat()">status</button>
    <button onclick="driveAuth()">oauth url</button></div>
  <div class=row>
    <input id="ihname" placeholder="filename" style="max-width:180px">
    <input id="ihpayer" placeholder="payer" style="max-width:140px">
    <input id="ihstate" placeholder="state" style="max-width:80px">
    <button class=go onclick="importHtml()">import html</button></div>
  <textarea id="ihtml" rows="6" placeholder="<html> to ingest — or JSON [{url, html}] for scraped pages"></textarea>
  <div class=row style="margin-top:4px">
    <button onclick="importScraped()">import scraped pages (JSON list)</button></div>
  <div id="iout"></div>`);

async function driveStat() {
  iout.innerHTML = UI.pre(await UI.get("/drive/status"));
}
async function driveAuth() {
  iout.innerHTML = UI.pre(await UI.get("/drive/auth-url"));
}
async function driveScan() {
  const r = await UI.post("/drive/scan-folder", { folder_id: dfolder.value });
  if (r.error) { iout.innerHTML = UI.pre(r); return; }
  iout.innerHTML = UI.table(["file", "payer", "state", "manual?"],
    (r.files || []).map((f) => `<tr><td>${UI.esc(f.name)}</td>
      <td>${UI.esc(f.payer || "")}</td><td>${UI.esc(f.state || "")}</td>
      <td>${f.looks_like_manual ? "✓" : ""}</td></tr>`));
}
async function driveImport() {
  iout.innerHTML = "importing…";
  const r = await UI.post("/drive/import-folder", { folder_id: dfolder.value });
  iout.innerHTML = UI.pre(r);
}
async function importHtml() {
  const r = await UI.post("/documents/import-from-html", {
    html: ihtml.value, filename: ihname.value || "import",
    payer: ihpayer.value, state: ihstate.value });
  iout.innerHTML = UI.pre(r);
}
async function importScraped() {
  let pages;
  try { pages = JSON.parse(ihtml.value); }
  catch (e) { iout.innerHTML = UI.pre("textarea must hold JSON [{url, html}]: " + e); return; }
  const r = await UI.post("/documents/import-scraped-pages", { pages });
  iout.innerHTML = UI.pre(r);
}

UI.tab("facts", `
  <p class=meta>Path-A fact review (reference ReviewFactsTab): accept /
  reject / edit — edits re-embed + republish; reject can unpublish</p>
  <div class=row>
    <button class=go onclick="loadFacts(true)">needs review</button>
    <button onclick="loadFacts(false)">all facts</button>
    <span class=meta id="fstats"></span></div>
  <div id="fout">…</div>`, () => loadFacts(true));

async function loadFacts(needsReview) {
  const r = await UI.get(`/facts?limit=200${needsReview ? "&needs_review=1" : ""}`);
  document.getElementById("fstats").textContent =
    `${r.total} fact${r.total === 1 ? "" : "s"}${needsReview ? " awaiting review" : ""}`;
  fout.innerHTML = UI.table(["doc", "fact", "critique", "review", ""],
    (r.facts || []).map((f, i) => {
      const v = (f.review || {}).verdict || "";
      return `<tr><td class=meta>${UI.esc(f.doc_id)}</td>
      <td id="ftext-${i}">${UI.esc((f.text || "").slice(0, 110))}</td>
      <td class="${(f.critique_score ?? 1) < 0.6 ? "lbl-low" : ""}">${f.critique_score ?? ""}</td>
      <td>${v ? UI.lbl(v === "accepted" ? "correct" : "incorrect") + " " + UI.esc(v) : "<span class=meta>—</span>"}</td>
      <td><button onclick="reviewFact(UI.d('${UI.arg(f.doc_id)}'),UI.d('${UI.arg(f.fact_id)}'),'accepted')">accept</button>
          <button onclick="reviewFact(UI.d('${UI.arg(f.doc_id)}'),UI.d('${UI.arg(f.fact_id)}'),'rejected')">reject</button>
          <button onclick="editFact(UI.d('${UI.arg(f.doc_id)}'),UI.d('${UI.arg(f.fact_id)}'),${i})">edit</button>
          <button onclick="delFact(UI.d('${UI.arg(f.doc_id)}'),UI.d('${UI.arg(f.fact_id)}'))">delete</button></td></tr>`;
    }));
}
async function reviewFact(doc, fid, verdict) {
  const remove = verdict === "rejected" &&
    confirm("Also unpublish this fact from retrieval?");
  await UI.post("/facts/review", { doc_id: doc, fact_id: fid,
    verdict, remove });
  loadFacts(false);
}
async function editFact(doc, fid, i) {
  const cur = document.getElementById(`ftext-${i}`).textContent;
  const text = prompt("Edit fact (re-embeds + republishes):", cur);
  if (text === null || !text.trim()) return;
  await UI.post(`/documents/${doc}/facts/${fid}`, { text }, "PUT");
  loadFacts(false);
}
async function delFact(doc, fid) {
  await UI.post(`/documents/${doc}/facts/${fid}`, undefined, "DELETE");
  loadFacts(false);
}
