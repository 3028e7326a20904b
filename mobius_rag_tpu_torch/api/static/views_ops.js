/* Ops tabs: health + worker fleet + profiling, live updates (SSE),
   nightly, curation, policy/lexicon, errors, DB browser, admin
   actions (snapshot/restore/vacuum/integrity/retag/backfill/SQL). */
"use strict";

UI.tab("health", `
  <div class=row>
    <button class=go onclick="loadHealth()">refresh</button>
    <button onclick="runProfile()">profile device stages</button></div>
  <div id="hout">…</div>`, loadHealth);

async function loadHealth() {
  const [p, deep, w, i] = await Promise.all([
    UI.get("/pipeline_health").catch(() => null),
    fetch("/health/deep").then(UI.J).catch(() => null),
    fetch("/admin/workers").then(UI.J).catch(() => null),
    UI.get("/admin/integrity").catch(() => null)]);
  const fleet = Object.entries(w?.workers || {}).map(([id, x]) =>
    `<tr><td>${UI.esc(id)}</td><td>${UI.esc(x.kind)}</td>
     <td>${x.tick_age_s}s</td><td>${x.stale ? UI.lbl("low") : UI.lbl("high")}</td></tr>`);
  hout.innerHTML =
    `<p>deep health: ${deep?.status === "ok" ? UI.lbl("high") : UI.lbl("low")}
      · workers ${w?.ok ? "ok" : "STALE"}</p>`
    + (fleet.length ? UI.table(["worker", "kind", "tick age", "state"], fleet)
                    : "<p class=meta>no workers registered</p>")
    + UI.pre({ pipeline: p, deep, integrity: i });
}
async function runProfile() {
  hout.innerHTML = "profiling (compiles stage programs)…";
  const r = await UI.post("/admin/profile", { iters: 3 });
  const st = r.profile?.device_stages_ms || {};
  const rows = Object.entries(st).map(([s, v]) =>
    `<tr><td>${UI.esc(s)}</td><td>${v}</td></tr>`);
  hout.innerHTML = UI.table(["device stage", "ms (median)"], rows) + UI.pre(r);
}

UI.tab("live", `
  <div class=row><input id="lvcid" placeholder="progress channel (doc/job id)" style="max-width:280px">
    <button class=go onclick="liveSub()">follow</button>
    <button onclick="liveRecent()">recent queries</button></div>
  <div id="lvout">…</div>`, liveRecent);

let _es = null;
function liveSub() {
  if (_es) _es.close();
  lvout.innerHTML = "<p class=meta>listening…</p>";
  _es = new EventSource(`/api/progress/${encodeURIComponent(lvcid.value || "default")}/stream`);
  _es.onmessage = (ev) => {
    const d = document.createElement("pre");
    d.textContent = ev.data;
    lvout.prepend(d);
  };
  _es.onerror = () => { lvout.innerHTML += "<p class=meta>stream closed</p>"; _es.close(); };
}
async function liveRecent() {
  const r = await UI.get("/recent_queries").catch(() => ({}));
  lvout.innerHTML = UI.pre(r);
}

UI.tab("nightly", `
  <div class="row"><button class="go" onclick="runNightly()">run nightly</button>
  <button onclick="loadNightly()">status</button>
  <button onclick="stopNightly()">stop (graceful)</button>
  <button onclick="nightlyRuns()">run history</button></div>
  <div id="nout">…</div>`, loadNightly);

async function runNightly() {
  const r = await UI.post("/admin/nightly/run", {});
  nout.innerHTML = UI.pre(r);
  setTimeout(loadNightly, 1000);
}
async function loadNightly() {
  const r = await UI.get("/admin/nightly/status");
  nout.innerHTML = UI.pre(r);
  if (r.running) setTimeout(loadNightly, 2000);
}
async function stopNightly() {
  // graceful: in-flight step finishes, infra_down still runs
  const r = await UI.post("/admin/nightly/stop", {});
  nout.innerHTML = UI.pre(r);
  setTimeout(loadNightly, 1000);
}
async function nightlyRuns() {
  const r = await UI.get("/admin/nightly/runs");
  const rows = (r.runs || []).map((x) => {
    const steps = Object.entries(x.steps || {})
      .map(([s, st]) => `${s}:${st.status}`).join(" ");
    return `<tr><td>${UI.esc(x.run_id || "")}</td>
      <td>${x.stopped ? "stopped" : "completed"}</td>
      <td class=meta>${UI.esc(steps)}</td></tr>`;
  });
  nout.innerHTML = UI.table(["run", "outcome", "steps"], rows)
    || "<p class=meta>no finished runs</p>";
}

UI.tab("curation", `<div id="cout">…</div>`, loadCuration);

async function loadCuration() {
  const c = await UI.get("/api/lexicon/candidates?min_occurrences=1");
  const s = await UI.get("/api/curator/stats");
  const src = await UI.get("/api/curator/sources").catch(() => ({ sources: [] }));
  const agg = await UI.get("/policy/candidates/aggregate?limit=100")
    .catch(() => ({ candidates: [] }));
  cout.innerHTML = `<p class=meta>curator: ${UI.esc(JSON.stringify(s))}</p>`
    + UI.table(["phrase", "kind", "occurs", "docs", ""],
      c.candidates.map((x) => `<tr><td>${UI.esc(x.phrase)}</td><td>${UI.esc(x.kind_hint)}</td>
        <td>${x.occurrences}</td><td>${x.docs.length}</td>
        <td><button onclick="reviewCand(UI.d('${UI.arg(x.phrase)}'), true)">approve</button>
            <button onclick="reviewCand(UI.d('${UI.arg(x.phrase)}'), false)">reject</button></td></tr>`))
    + `<p class=meta style="margin-top:10px">corpus-wide aggregate (doc spread
       + review state — /policy/candidates/aggregate)</p>`
    + UI.table(["phrase", "kind", "occurs", "n docs", "status", "promoted"],
      (agg.candidates || []).map((x) => `<tr><td>${UI.esc(x.phrase)}</td>
        <td>${UI.esc(x.kind_hint)}</td><td>${x.occurrences}</td><td>${x.n_docs}</td>
        <td>${UI.esc(x.status)}</td><td class=meta>${UI.esc(x.promoted_code || "")}</td></tr>`))
    + `<p class=meta style="margin-top:10px">discovered sources
       (reference SourcesTab: register → classify → probe → curate →
       mark ingested)</p>`
    + `<div class=row><input id="srcurl" placeholder="https://payer.example/manuals"
         style="max-width:420px">
       <button onclick="srcAdd()">register</button>
       <button onclick="srcClassify()">classify</button></div>`
    + UI.table(["url", "payer", "status", "authority", ""],
      (src.sources || []).map((x) => `<tr><td>${UI.esc(x.url)}</td>
        <td>${UI.esc(x.payer)}</td><td>${UI.esc(x.status)}</td>
        <td>${x.authority_level ?? ""}</td>
        <td><button onclick="srcCurate(UI.d('${UI.arg(x.url)}'), true)">approve</button>
            <button onclick="srcCurate(UI.d('${UI.arg(x.url)}'), false)">reject</button>
            <button onclick="srcProbe(UI.d('${UI.arg(x.url)}'))">probe</button>
            <button onclick="srcIngested(UI.d('${UI.arg(x.url)}'))">mark ingested</button></td></tr>`))
    + `<div id="srcout"></div>`;
}
async function reviewCand(phrase, approve) {
  await UI.post("/api/lexicon/candidates/review", { phrase, approve });
  loadCuration();
}
async function srcAdd() {
  const url = document.getElementById("srcurl").value.trim();
  if (!url) return;
  await UI.post("/api/curator/sources", { url });
  loadCuration();
}
async function srcClassify() {
  const url = document.getElementById("srcurl").value.trim();
  if (!url) return;
  const r = await UI.post("/api/curator/classify", { url });
  document.getElementById("srcout").innerHTML = UI.pre(r);
}
async function srcCurate(url, approve) {
  await UI.post("/api/curator/curate", { url, approve });
  loadCuration();
}
async function srcProbe(url) {
  const r = await UI.post("/api/curator/probe", { url });
  document.getElementById("srcout").innerHTML = UI.pre(r);
}
async function srcIngested(url) {
  await UI.post("/api/curator/mark-ingested", { url });
  loadCuration();
}

UI.tab("policy", `<div id="pout">…</div>`, loadPolicy);

async function loadPolicy() {
  const o = await UI.get("/policy/lexicon/overview");
  const s = await UI.get("/policy/lexicon/stats");
  const d = await UI.get("/policy/lexicon/doc-stats");
  const rows = Object.entries(d.tag_doc_counts).sort((a, b) => b[1] - a[1])
    .map(([tag, n]) => `<tr class=click onclick="loadTagDetail(UI.d('${UI.arg(tag)}'))">
      <td>${UI.esc(tag)}</td><td>${n}</td></tr>`);
  pout.innerHTML = `<p class=meta>entries ${o.entries} · phrases ${o.phrases}
      · by kind ${UI.esc(JSON.stringify(o.by_kind))}
      · selectivity median ${s.selectivity.median}</p>`
    + UI.table(["tag (click for detail)", "docs"], rows)
    + `<div id="tagdetail"></div>`;
}
async function loadTagDetail(tag) {
  const kind = tag.slice(0, tag.indexOf(":")), code = tag.slice(tag.indexOf(":") + 1);
  const t = await UI.get(`/policy/lexicon/tags/${kind}/${code}`);
  document.getElementById("tagdetail").innerHTML = UI.pre(t);
}

UI.tab("errors", `<div id="erout">…</div>`, loadErrors);

async function loadErrors() {
  const s = await UI.get("/errors/stats");
  const r = await UI.get("/errors?limit=100");
  erout.innerHTML = `<p class=meta>total ${s.total} · unresolved
      <span class="${s.unresolved ? "lbl-low" : "lbl-high"}">${s.unresolved}</span></p>`
    + UI.table(["ts", "service", "sev", "message", ""],
      r.errors.map((e) => `<tr><td class=meta>${new Date(e.ts * 1000).toISOString().slice(5, 19)}</td>
        <td>${UI.esc(e.service)}</td>
        <td class="lbl-${e.severity === "critical" ? "low" : "medium"}">${UI.esc(e.severity)}</td>
        <td>${UI.esc(e.message.slice(0, 80))}</td>
        <td>${e.resolved ? "<span class=meta>resolved</span>"
          : `<button onclick="resolveErr(UI.d('${UI.arg(e.error_id)}'))">resolve</button>`}</td></tr>`));
}
async function resolveErr(id) {
  await UI.post(`/errors/${id}/resolve`);
  loadErrors();
}

UI.tab("db", `
  <div class="row">
    <select id="dbsel" style="max-width:180px"></select>
    <select id="tbsel" style="max-width:260px"></select>
    <button class="go" onclick="loadDbRecords()">browse</button></div>
  <div id="dbout">…</div>`, loadDbTables);

async function loadDbTables() {
  const t = await UI.get("/admin/db/tables");
  window._dbTables = t;
  dbsel.innerHTML = Object.keys(t).map((d) => `<option>${UI.esc(d)}</option>`).join("");
  dbsel.onchange = () => {
    tbsel.innerHTML = (_dbTables[dbsel.value] || [])
      .map((x) => `<option>${UI.esc(x)}</option>`).join("");
  };
  dbsel.onchange();
}
async function loadDbRecords() {
  const r = await UI.get(`/admin/db/${dbsel.value}/${tbsel.value}/records?limit=50`);
  if (r.error) { dbout.innerHTML = UI.pre(r.error); return; }
  dbout.innerHTML = `<p class=meta>${r.total} rows</p>`
    + UI.table(r.columns.map(UI.esc),
      r.rows.map((row) => "<tr>" + row.map((c) =>
        `<td>${UI.esc(String(c ?? "").slice(0, 60))}</td>`).join("") + "</tr>"));
}

UI.tab("admin", `
  <div class=row>
    <button onclick="adm('POST','/admin/snapshot')">snapshot</button>
    <button onclick="adm('POST','/admin/vacuum')">vacuum</button>
    <button onclick="adm('GET','/admin/vacuum/status')">vacuum status</button>
    <button onclick="adm('POST','/admin/retag')">retag</button>
    <button onclick="adm('POST','/admin/backfill_metadata')">backfill metadata</button></div>
  <div class=row>
    <button onclick="adm('POST','/admin/publish_unpublished')">publish unpublished</button>
    <button onclick="adm('POST','/admin/cleanup-stale-jobs')">cleanup stale jobs</button>
    <button onclick="adm('GET','/admin/integrity')">integrity report</button>
    <button onclick="adm('POST','/admin/integrity/remediate')">remediate</button>
    <select id="vbe" style="max-width:120px"><option>exact</option><option>ivf</option>
      <option>packed</option><option>pq</option></select>
    <button onclick="setBackend()">set backend</button></div>
  <div class=row>
    <button onclick="adm('GET','/admin/repository_audit')">repository audit</button>
    <button onclick="adm('POST','/admin/block_junk_pending')">block junk pending</button>
    <button onclick="adm('GET','/admin/list_blocked_docs')">blocked docs</button>
    <button onclick="adm('POST','/admin/dedupe_policy_paragraphs')">dedupe paragraphs</button>
    <button onclick="adm('POST','/admin/normalize-payer')">normalize payers</button>
    <button onclick="adm('POST','/admin/backfill_chunk_tags')">backfill chunk tags</button></div>
  <div class=row>
    <button onclick="adm('POST','/documents/retag')">bulk retag all</button>
    <button onclick="adm('GET','/documents/retag/status')">retag status</button>
    <input id="vsq" placeholder="raw vector probe query" style="max-width:240px">
    <button onclick="vecProbe()">vector search</button></div>
  <div class=row><textarea id="sqlq" rows="3" placeholder="SELECT ... (read-only SQL console)"></textarea>
    <button class=go onclick="runSql()">run</button></div>
  <div id="admout">…</div>`);

async function vecProbe() {
  // pure vector arm, no fusion — the debugging probe (/admin/vector_search)
  const r = await UI.get(`/admin/vector_search?q=${encodeURIComponent(vsq.value)}&k=10`);
  admout.innerHTML = UI.table(["chunk", "doc", "similarity"],
    (r.hits || []).map((h) => `<tr><td>${UI.esc(h.chunk_id)}</td>
      <td class=meta>${UI.esc(h.doc_id)}</td>
      <td>${(h.similarity ?? 0).toFixed(4)}</td></tr>`));
}

UI.tab("config", `
  <p class=meta>LLM provider configs (secrets redacted) + versioned
  prompt registry (reference /config/llm/*, /config/prompts/*)</p>
  <div class=row>
    <input id="llmName" placeholder="config name" style="max-width:160px">
    <select id="llmProv" style="max-width:120px"><option>offline</option><option>http</option></select>
    <input id="llmModel" placeholder="model" style="max-width:160px">
    <input id="llmUrl" placeholder="url (http provider)" style="max-width:240px">
    <button class=go onclick="saveLlm()">save</button>
    <button onclick="listLlm()">list</button></div>
  <div class=row>
    <input id="prStage" placeholder="prompt stage e.g. synthesis" style="max-width:200px">
    <input id="prVer" placeholder="version" style="max-width:100px">
    <button onclick="getPrompt()">get</button>
    <button onclick="savePrompt()">save</button>
    <button onclick="delPrompt()">delete</button></div>
  <textarea id="prText" rows="5" placeholder="prompt text"></textarea>
  <div id="cfgout"></div>`, listLlm);

async function listLlm() {
  const [p, prompts] = await Promise.all([
    UI.get("/config/llm/providers"),
    UI.post("/config/prompts/names")]);
  document.getElementById("cfgout").innerHTML =
    UI.pre({ providers: p, prompt_stages: prompts.names });
}
async function saveLlm() {
  const body = { provider: llmProv.value, model: llmModel.value, params: {} };
  if (llmUrl.value) body.params.url = llmUrl.value;
  const r = await UI.post(`/config/llm/${llmName.value}`, body, "PUT");
  const t = await UI.post(`/config/llm/${llmName.value}/test`).catch(() => null);
  document.getElementById("cfgout").innerHTML = UI.pre({ saved: r, test: t });
}
async function getPrompt() {
  const r = await UI.get(`/config/prompts/${prStage.value}/${prVer.value}`);
  if (!r.error) document.getElementById("prText").value = r.text || "";
  document.getElementById("cfgout").innerHTML = UI.pre(r);
}
async function savePrompt() {
  const r = await UI.post(`/config/prompts/${prStage.value}/${prVer.value}`,
    { text: document.getElementById("prText").value }, "PUT");
  document.getElementById("cfgout").innerHTML = UI.pre(r);
}
async function delPrompt() {
  const r = await UI.post(`/config/prompts/${prStage.value}/${prVer.value}`,
    undefined, "DELETE");
  document.getElementById("cfgout").innerHTML = UI.pre(r);
}

async function adm(method, url) {
  const r = method === "GET" ? await UI.get(url) : await UI.post(url, {});
  admout.innerHTML = UI.pre(r);
}
async function setBackend() {
  const r = await UI.post("/admin/vector_backend", { backend: vbe.value });
  admout.innerHTML = UI.pre(r);
}
async function runSql() {
  const r = await UI.post("/admin/sql", { sql: sqlq.value });
  if (r.error) { admout.innerHTML = UI.pre(r); return; }
  admout.innerHTML = UI.table((r.columns || []).map(UI.esc),
    (r.rows || []).map((row) => "<tr>" + row.map((c) =>
      `<td>${UI.esc(String(c ?? "").slice(0, 80))}</td>`).join("") + "</tr>"));
}
