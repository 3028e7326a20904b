/* Eval tabs: runs + per-run detail with human-verdict override, run
   compare, PR curve (inline SVG), timeline, calibration trigger and
   bank editor — the console form of the reference's Eval/Calibration
   panel (routers/eval.py + EvalTab.tsx). */
"use strict";

UI.tab("eval", `
  <div class="row">
    <input id="ebank" value="toy" style="max-width:160px" placeholder="bank">
    <button class="go" onclick="doEval()">run bank</button>
    <button onclick="doCalibrate()">calibrate (forced-arm matrix)</button>
    <button onclick="loadEvalRuns()">refresh</button></div>
  <div class="row">
    <input id="cmpA" placeholder="run_a id" style="max-width:180px">
    <input id="cmpB" placeholder="run_b id" style="max-width:180px">
    <button onclick="doCompare()">compare</button>
    <button onclick="loadTimeline()">timeline</button>
    <button onclick="loadDrift()">drift</button>
    <button onclick="loadBank()">bank editor</button>
    <button onclick="factCompareUi()">fact compare</button></div>
  <div id="eactive" class=meta></div>
  <div id="eout">…</div>`, loadEvalRuns);

async function loadDrift() {
  // metric drift across the bank's recent runs (GET /api/eval/drift)
  const r = await UI.get(`/api/eval/drift?bank=${encodeURIComponent(ebank.value)}`);
  const rows = (r.runs || []).map((x) => `<tr>
    <td>${UI.esc((x.run_id || "").slice(0, 10))}</td>
    <td class=meta>${new Date((x.ts || 0) * 1000).toISOString().slice(5, 16)}</td>
    <td>${x.accuracy ?? ""}</td><td>${x.mean_chunk_recall ?? ""}</td>
    <td>${x.answer_rate ?? ""}</td><td>${x.latency_ms_median ?? ""}</td></tr>`);
  document.getElementById("erun").innerHTML =
    `<p class=meta>newest vs oldest: ${UI.esc(JSON.stringify(r.drift_newest_vs_oldest))}</p>`
    + UI.table(["run", "ts", "acc", "recall", "answer rate", "p50 ms"], rows);
}
function factCompareUi() {
  document.getElementById("erun").innerHTML = `
    <p class=meta>judge two answers against the same must-facts rubric
    (POST /api/eval/fact_compare)</p>
    <textarea id="fcA" rows="3" placeholder="answer A"></textarea>
    <textarea id="fcB" rows="3" placeholder="answer B" style="margin-top:6px"></textarea>
    <div class=row style="margin-top:6px">
      <input id="fcFacts" placeholder="must facts, one per ; separator">
      <button class=go onclick="doFactCompare()">judge</button></div>
    <div id="fcOut"></div>`;
}
async function doFactCompare() {
  const r = await UI.post("/api/eval/fact_compare", {
    answer_a: document.getElementById("fcA").value,
    answer_b: document.getElementById("fcB").value,
    must_facts: document.getElementById("fcFacts").value.split(";")
      .map((s) => s.trim()).filter(Boolean) });
  document.getElementById("fcOut").innerHTML = UI.pre(r);
}

async function doEval() {
  eout.innerHTML = "running…";
  const poll = setInterval(async () => {
    const a = await UI.get("/api/eval/active").catch(() => null);
    document.getElementById("eactive").textContent = a && a.active
      ? `eval running: ${a.active.bank} (${Math.round(Date.now() / 1000 - a.active.started_at)}s)`
      : "";
  }, 1500);
  const r = await UI.post("/api/eval/run", { bank: ebank.value });
  clearInterval(poll);
  document.getElementById("eactive").textContent = "";
  eout.innerHTML = UI.pre(r);
  setTimeout(loadEvalRuns, 400);
}
async function doCalibrate() {
  eout.innerHTML = "calibrating (forces every strategy per query)…";
  const r = await UI.post("/api/eval/calibrate", { bank: ebank.value });
  eout.innerHTML = UI.pre(r);
}
async function loadEvalRuns() {
  const r = await UI.get("/api/eval/runs");
  eout.innerHTML = UI.table(
    ["run (click for detail)", "bank", "acc", "recall", "p50 ms", ""],
    r.runs.map((x) => `<tr class=click onclick="loadRunDetail(UI.d('${UI.arg(x.run_id)}'))">
      <td>${UI.esc(x.run_id.slice(0, 10))}</td><td>${UI.esc(x.bank_name)}</td>
      <td>${x.aggregates?.accuracy ?? ""}</td>
      <td>${x.aggregates?.mean_chunk_recall ?? ""}</td>
      <td>${x.aggregates?.latency_ms_median ?? ""}</td>
      <td><button onclick="event.stopPropagation(); loadPr(UI.d('${UI.arg(x.run_id)}'))">PR curve</button></td></tr>`))
    + "<div id=erun></div>";
}
async function loadRunDetail(id) {
  const r = await UI.get(`/api/eval/runs/${id}`);
  const rows = (r.results || []).map((x) => `<tr>
    <td>${UI.esc(x.query_id)}</td><td>${UI.esc(x.strategy || "")}</td>
    <td>${UI.lbl(x.confidence || "")}</td>
    <td>${UI.esc(x.effective_verdict || x.verdict || "")}</td>
    <td>${(x.chunk_recall ?? "")}</td>
    <td>
      <button onclick="setVerdict(UI.d('${UI.arg(id)}'),UI.d('${UI.arg(x.query_id)}'),'correct')">✓</button>
      <button onclick="setVerdict(UI.d('${UI.arg(id)}'),UI.d('${UI.arg(x.query_id)}'),'incorrect')">✗</button></td></tr>`);
  document.getElementById("erun").innerHTML =
    `<p class=meta>run ${UI.esc(id)} · aggregates ${UI.esc(JSON.stringify(r.aggregates))}</p>`
    + UI.table(["query", "strategy", "conf", "verdict", "recall", "human override"], rows);
}
async function setVerdict(run, qid, verdict) {
  await UI.post(`/api/eval/results/${run}/${qid}/verdict`, { verdict }, "PATCH");
  loadRunDetail(run);
}
async function doCompare() {
  const r = await UI.get(`/api/eval/compare?run_a=${cmpA.value}&run_b=${cmpB.value}`);
  document.getElementById("erun").innerHTML = UI.pre(r);
}
async function loadTimeline() {
  const r = await UI.get("/api/eval/timeline");
  document.getElementById("erun").innerHTML = UI.pre(r);
}
const PR_COLORS = ["#4cc2ff", "#58d68d", "#f5b041", "#ec7063", "#af7ac5"];

async function loadPr(id) {
  const r = await UI.get(`/api/eval/runs/${id}/pr_curve`);
  if (r.error) { document.getElementById("erun").innerHTML = UI.pre(r); return; }
  // one path per strategy: x = recall, y = precision (null precision =
  // nothing answered at that tau — skipped)
  const W = 440, H = 310, pad = 36;
  const x = (v) => pad + v * (W - 2 * pad), y = (v) => H - pad - v * (H - 2 * pad);
  let paths = "", legend = "";
  Object.entries(r.curves || {}).forEach(([sid, pts], i) => {
    const c = PR_COLORS[i % PR_COLORS.length];
    const live = pts.filter((p) => p.precision !== null);
    const d = live.map((p, j) =>
      `${j ? "L" : "M"}${x(p.recall).toFixed(1)},${y(p.precision).toFixed(1)}`).join(" ");
    paths += `<path d="${d}" fill="none" stroke="${c}" stroke-width="2"/>`
      + live.map((p) => `<circle cx="${x(p.recall)}" cy="${y(p.precision)}" r="2.5" fill="${c}"/>`).join("");
    legend += `<text x="${W - pad - 70}" y="${pad + 14 * i}" fill="${c}" font-size="12">${UI.esc(sid)}</text>`;
  });
  document.getElementById("erun").innerHTML = `
    <p class=meta>PR curve by strategy (confidence-tier threshold sweep) — run ${UI.esc(id)}</p>
    <svg width="${W}" height="${H}" style="background:#0c1115;border:1px solid #222c35;border-radius:8px">
      <line x1="${pad}" y1="${H - pad}" x2="${W - pad}" y2="${H - pad}" stroke="#2a3742"/>
      <line x1="${pad}" y1="${pad}" x2="${pad}" y2="${H - pad}" stroke="#2a3742"/>
      <text x="${W / 2}" y="${H - 8}" fill="#7c8a96" font-size="11">recall</text>
      <text x="10" y="${H / 2}" fill="#7c8a96" font-size="11" transform="rotate(-90 12,${H / 2})">precision</text>
      ${paths}${legend}
    </svg>` + UI.pre(r);
}
async function loadBank() {
  const r = await UI.get(`/api/eval/bank?name=${ebank.value}`);
  document.getElementById("erun").innerHTML = `
    <p class=meta>bank editor — edit the queries JSON array; save writes an
    editable copy under data_dir/banks (reference banks are read-only)</p>
    <textarea id="bankText" rows="18">${UI.esc(JSON.stringify(r.queries || [], null, 2))}</textarea>
    <div class=row style="margin-top:6px">
      <input id="bankPath" value="custom.yaml" style="max-width:200px">
      <button class=go onclick="saveBank()">save bank</button></div>
    <div id="bankOut"></div>`;
}
async function saveBank() {
  let queries;
  try { queries = JSON.parse(document.getElementById("bankText").value); }
  catch (e) { document.getElementById("bankOut").innerHTML = UI.pre("bad JSON: " + e); return; }
  const r = await UI.post("/api/eval/bank",
    { queries, rel_path: document.getElementById("bankPath").value }, "PUT");
  document.getElementById("bankOut").innerHTML = UI.pre(r);
}
